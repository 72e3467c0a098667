"""The port's multi-device pieces (``repro_torch.models.dist``,
``launch.mesh``, ``train.sharding``, ``grad_compress.compressed_psum``,
``fault.elastic_restore``) against the JAX package.

What each comparison holds:

* spec trees: ``param_pspecs``, ``sanitize_pspecs``, ``opt_state_pspecs``
  (AdamW, and Adafactor's factored moments for llama4-maverick),
  ``batch_pspecs`` and ``decode_state_pspecs`` equal the reference's entry
  for entry, for all ten configs at full width (shapes from
  ``jax.eval_shape`` and from the port's ``init_params`` on the meta
  device), on stand-in meshes (1, 1), (16, 16) and (2, 16, 16) that have
  only axis names and sizes;
* ``_attn_shard_mode`` and ``_full_batch_axes``: equal to the reference's
  for every config (and with ``attn_param_replication`` on) over a grid of
  batch sizes, with both packages' mesh context set to a stand-in;
* ``compressed_psum``: means and feedback bit for bit against the
  reference under ``jax.jit(shard_map(...))`` on 1-4 fake CPU devices
  (its own process, ``--xla_force_host_platform_device_count=4``), the
  port on 1-4 gloo ranks (processes joined through a ``FileStore``) on the
  same per-rank gradients, for k = 2, 4, 8, 12 over int8, int16 and int32
  wires, with a NaN, an all-zero, a bfloat16, an odd-sized leaf and codes at
  +-2^k in both packing lanes; and a group larger than the wire was
  chosen for, where both sums wrap;
* ``elastic_restore`` at tau 0 and 1e-4 onto (1, 1), (2, 1), (1, 2) and
  (2, 2) gloo meshes, FSDP off and on: each rank's ``to_local()`` bit-equal
  to the reference's ``addressable_shards`` at the same mesh coordinate;
  ``full_tensor()`` bit-equal to the one-process restore; equal bytes
  moved; the loss on the restored tree within the reference test's rtol
  1e-6 of the loss before (tau 0) and within the model tests' rtol 1e-5 of
  the reference's loss on its restored tree;
* ``hint`` on DTensors: the placements its entries name, values unchanged;
  with a mesh registered, reduced-config logits and gradients bit-identical
  to no mesh (plain tensors), batch-parallel attention's hints included.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro._x64  # noqa: E402,F401  (the reference trainer's mode)
from repro import configs as ref_configs  # noqa: E402
from repro.launch.mesh import make_mesh as ref_make_mesh  # noqa: E402
from repro.models import dist as RD  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.train import checkpoint as RC  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import sharding as RS  # noqa: E402
from repro.train.grad_compress import compressed_psum as ref_psum  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.data.batches import make_train_batch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import dist  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.train import grad_compress as G  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train.pytree import (flatten_with_paths,  # noqa: E402
                                      tree_from_paths)

REPO = Path(__file__).resolve().parents[1]
RANKS = Path(__file__).resolve().parent / "_torch_dist_ranks.py"
LAUNCH_TIMEOUT_S = 300

ARCHS = configs.names()
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
NAME = "internlm2-1.8b"
RESTORE_MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
TAUS = [0.0, 1e-4]
KS = [2, 4, 8, 12]
# a group larger than the wire was chosen for (n_ranks = 1): four ranks'
# codes at +2^k sum to 128 (int8 at k = 5) and 32768 (int16 at k = 13)
WRAP_CASES = {"int8": (5, 1), "int16": (13, 1)}
LEAVES = ["w", "tiny", "big", "bf", "zero", "nan", "edge"]


class StandIn:
    """A mesh of only axis names and sizes, as both packages read one."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------


_SHAPES = {}


def _shapes(arch):
    """(reference cfg, port cfg, reference param and optimizer shapes,
    port's on the meta device) at full width."""
    if arch not in _SHAPES:
        rcfg, cfg = ref_configs.get(arch), configs.get(arch)
        rp = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                   rcfg))
        pp = T.init_params(cfg, generator=torch.Generator(), device="meta")
        if cfg.optimizer == "adafactor":
            ro, po = jax.eval_shape(RO.adafactor_init, rp), \
                O.adafactor_init(pp)
        else:
            ro, po = jax.eval_shape(RO.adamw_init, rp), O.adamw_init(pp)
        _SHAPES[arch] = (rcfg, cfg, rp, pp, ro, po)
    return _SHAPES[arch]


def _ref_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(RS._path_str(kp), tuple(v)) for kp, v in flat]


def _port_flat(tree):
    out = []
    for path, v in flatten_with_paths(tree):
        assert isinstance(v, S.PartitionSpec)
        out.append(("/".join(map(str, path)), tuple(v)))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_the_reference(arch, mesh_name):
    rcfg, cfg, rp, pp, ro, po = _shapes(arch)
    mesh = StandIn(*MESHES[mesh_name])
    rspec, pspec = RS.param_pspecs(rcfg, rp, mesh), \
        S.param_pspecs(cfg, pp, mesh)
    assert _port_flat(pspec) == _ref_flat(rspec)
    assert _port_flat(S.sanitize_pspecs(pspec, pp, mesh)) == \
        _ref_flat(RS.sanitize_pspecs(rspec, rp, mesh))
    # the optimizer state's leaves in order (the reference's NamedTuple
    # fields are attribute keys, the port's positions)
    ropt = RS.opt_state_pspecs(rcfg, ro, rspec)
    popt = S.opt_state_pspecs(cfg, po, pspec)
    assert isinstance(popt, O.OptState)
    assert [v for _, v in _port_flat(popt)] == [v for _, v in _ref_flat(ropt)]
    assert [len(v) for _, v in _port_flat(popt)] == \
        [len(leaf.shape) for _, leaf in flatten_with_paths(po)]
    for port_fn, ref_fn in ((S.batch_pspecs, RS.batch_pspecs),
                            (S.decode_state_pspecs, RS.decode_state_pspecs)):
        got = {k: tuple(v) for k, v in port_fn(cfg, mesh).items()}
        assert got == {k: tuple(v) for k, v in ref_fn(rcfg, mesh).items()}
    assert S.dp_axes(mesh) == RS.dp_axes(mesh)


def test_partition_spec_normalises_as_jax_does():
    for entries in [(), (None,), ("model", None), (("data",), None),
                    (("pod", "data"), None, "model"), ((), "data")]:
        assert tuple(S.P(*entries)) == tuple(JP(*entries))
    assert S.P(("data",)) == S.P("data")
    assert hash(S.P("data", None)) == hash(S.P(("data",), None))
    mesh = StandIn((2, 3), ("data", "model"))
    from torch.distributed.tensor import Replicate, Shard
    assert S.placements(S.P("model", None), mesh) == (Replicate(), Shard(0))
    assert S.placements(S.P(("data", "model"), None), mesh) == \
        (Shard(0), Shard(0))
    assert S.placements(S.P(), mesh) == (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# the attention's sharding mode under a mesh
# ---------------------------------------------------------------------------

MODE_MESHES = [((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")),
               ((4, 2), ("data", "model")), ((2, 4), ("data", "model")),
               ((2, 3, 5), ("pod", "data", "model"))]
BATCHES = [1, 2, 3, 4, 6, 8, 16, 24, 30, 32, 64, 128, 256, 512]


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_shard_mode_equals_the_reference(arch):
    seen = set()
    for replicate in (False, True):
        rcfg = ref_configs.get(arch).replace(attn_param_replication=replicate)
        cfg = dataclasses.replace(configs.get(arch),
                                  attn_param_replication=replicate)
        for shape, names in MODE_MESHES:
            mesh = StandIn(shape, names)
            prev = RD._CTX["mesh"]
            RD._CTX["mesh"] = mesh
            try:
                with dist.use_mesh(mesh):
                    for b in BATCHES:
                        want = (RL._attn_shard_mode(rcfg, b),
                                RL._full_batch_axes(b))
                        got = (L._attn_shard_mode(cfg, b),
                               L._full_batch_axes(b))
                        assert got == want, (shape, b)
                        seen.add(want[0])
                        assert dist.axis_size("pod") == RD.axis_size("pod")
            finally:
                RD._CTX["mesh"] = prev
    assert dist._CTX["mesh"] is None
    assert L._attn_shard_mode(configs.get(arch), 256) == ""
    assert seen >= {""}


# ---------------------------------------------------------------------------
# the gloo ranks and the reference's process
# ---------------------------------------------------------------------------


def _grads(n=4):
    """Per-rank gradients and feedback (rank r reads row r), seeded."""
    rng = np.random.default_rng(27)
    g = {"w": rng.standard_normal((n, 1000)),
         "tiny": rng.standard_normal((n, 2, 33)) * 1e-20,
         "big": rng.standard_normal((n, 17)) * 1e25,
         "bf": rng.standard_normal((n, 8, 8)),
         "zero": np.zeros((n, 5)),
         "nan": rng.standard_normal((n, 12)),
         "edge": rng.uniform(-0.9, 0.9, (n, 10))}
    # rank 0's NaN drops out of the cross-rank max; its 50 then lies far
    # past the others' amax, so its codes saturate
    g["nan"][0, 3] = np.nan
    g["nan"][0, 7] = 50.0
    # amax exactly 1: codes +2^k and -2^k in the low and the high lane
    g["edge"][:, 0] = 1.0
    g["edge"][:, 5] = -1.0
    g = {k: v.astype(np.float32) for k, v in g.items()}
    g["bf"] = torch.from_numpy(g["bf"]).to(torch.bfloat16).float().numpy()
    fb = {k: np.zeros_like(v) for k, v in g.items()}
    fb["w"] = (rng.standard_normal((n, 1000)) * 1e-3).astype(np.float32)
    fb["tiny"] = (rng.standard_normal((n, 2, 33)) * 1e-22).astype(np.float32)
    return g, fb


def _psum_cases(n):
    cases = [(k, n_ranks) for k in KS for n_ranks in (n, 0)]
    if n == 4:
        cases += list(WRAP_CASES.values())
    return cases


def _spawn(args, env, log):
    return subprocess.Popen([sys.executable, str(RANKS), *args], env=env,
                            stdout=log, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every multi-rank run at once: gloo groups of 1, 2, 3 and 4 ranks
    (each its own ``FileStore``), and the reference on 4 fake devices;
    joined under ``LAUNCH_TIMEOUT_S`` and read back."""
    tmp = tmp_path_factory.mktemp("dist")
    g, fb = _grads()
    arrays = dict(g)
    arrays.update({"fb|" + k: v for k, v in fb.items()})
    arrays["substrate"] = np.random.default_rng(0).standard_normal(
        64).astype(np.float32)
    np.savez(tmp / "grads.npz", **arrays)

    # the same parameters in both checkpoints: the reference's init,
    # carried across
    cfg_ref = ref_configs.get_reduced(NAME)
    params = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(0),
                                                     cfg_ref))
    RC.save_checkpoint(str(tmp / "ref_ckpt"), params, step=0)
    port_params = params_from_arrays(params, configs.get_reduced(NAME),
                                     device="cpu").tree()
    C.save_checkpoint(str(tmp / "port_ckpt"), port_params, step=0,
                      device="cpu")

    base = {"grads": str(tmp / "grads.npz"), "leaves": LEAVES,
            "dtypes": {"bf": "bfloat16"}, "arch": NAME, "taus": TAUS,
            "ckpt": str(tmp / "port_ckpt"), "ref_ckpt": str(tmp / "ref_ckpt")}
    jobs = {
        1: {"parts": ["psum", "restore", "logits"], "substrate": True,
            "meshes": [(1, 1)], "logits_mesh": (1, 1),
            "logits_archs": [(a, {}) for a in ARCHS]},
        2: {"parts": ["psum", "restore"], "meshes": [(2, 1), (1, 2)]},
        3: {"parts": ["psum"]},
        4: {"parts": ["psum", "restore", "hint", "logits"],
            "meshes": [(2, 2)], "logits_mesh": (2, 2),
            "logits_archs": [
                (NAME, {"attn_param_replication": True, "n_kv_heads": 1}),
                ("olmoe-1b-7b", {})]},
    }
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs, logs = [], []
    for world, job in jobs.items():
        job = dict(base, **job, world=world,
                   store=str(tmp / f"store{world}"), out=str(tmp / f"w{world}"),
                   psum_cases=_psum_cases(world))
        path = tmp / f"job{world}.json"
        path.write_text(json.dumps(job))
        for r in range(world):
            logs.append(open(tmp / f"w{world}.{r}.log", "w"))
            procs.append(_spawn([str(path), str(r)], env, logs[-1]))
    ref_job = dict(base, out=str(tmp / "ref"), meshes=RESTORE_MESHES,
                   psum_cases={n: _psum_cases(n) for n in (1, 2, 3, 4)})
    (tmp / "ref.json").write_text(json.dumps(ref_job))
    logs.append(open(tmp / "ref.log", "w"))
    procs.append(_spawn([str(tmp / "ref.json"), "ref"], env, logs[-1]))

    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = [(f.name, p.returncode) for f, p in zip(logs, procs)
              if p.returncode != 0]
    assert not failed, (failed, "\n".join(
        Path(name).read_text()[-3000:] for name, _ in failed))
    ranks = {w: [dict(np.load(tmp / f"w{w}.{r}.npz")) for r in range(w)]
             for w in jobs}
    ref = dict(np.load(tmp / "ref.npz"))
    return {"ranks": ranks, "ref": ref, "tmp": tmp, "params": params,
            "port_params": port_params}


def _same(a, b) -> bool:
    """Equal dtype, shape and bits, any NaN standing for any NaN."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind != "f":
        return np.array_equal(a, b)
    nan = np.isnan(a)
    if not np.array_equal(nan, np.isnan(b)):
        return False
    u = {2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize]
    return np.array_equal(a[~nan].view(u), b[~nan].view(u))


def _key(*parts):
    return "|".join(str(p) for p in parts)


def _check_psum(launched, n, k, n_ranks):
    ranks, ref = launched["ranks"][n], launched["ref"]
    for r in range(n):
        for name in LEAVES:
            for what in ("mean", "fb"):
                got = ranks[r][_key("psum", k, n_ranks, what, name)]
                want = ref[_key("psum", n, k, n_ranks, what, name)][r]
                assert _same(got, want), (n, k, n_ranks, what, name, r)


def _buffer_bytes(n, k, n_ranks) -> int:
    """Bytes the port hands to its all-reduces for the seven leaves."""
    wire = G.sum_safe_int_dtype(k, n_ranks or 64)
    sizes = [int(np.prod(v.shape[1:])) for v in _grads()[0].values()]
    nan_leaf = LEAVES.index("nan")
    total = 0
    for i, m in enumerate(sizes):
        if wire == torch.int16:
            lanes = n << (k + 1) < 1 << 16 and not (n > 1 and i == nan_leaf)
            total += (m + 1) // 2 * 4 if lanes else m * 4
        else:
            total += m * torch.tensor([], dtype=wire).element_size()
        total += 8 if n > 1 else 0
    return total


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_compressed_psum_bit_equal_to_the_reference(launched, n, k):
    wires = set()
    for n_ranks in (n, 0):
        _check_psum(launched, n, k, n_ranks)
        wires.add(G.sum_safe_int_dtype(k, n_ranks or 64))
        for r in range(n):
            got = launched["ranks"][n][r][_key("psum", k, n_ranks, "bytes")]
            assert int(got) == _buffer_bytes(n, k, n_ranks)
    # int8 (k <= 4 over n ranks), int16, and int32 (k = 12 over 64)
    assert wires == {2: {torch.int8, torch.int16}, 4: {torch.int8,
                     torch.int16}, 8: {torch.int16},
                     12: {torch.int16, torch.int32}}[k]


@pytest.mark.parametrize("wire", list(WRAP_CASES))
def test_compressed_psum_wraps_like_the_reference_past_n_ranks(launched,
                                                              wire):
    k, n_ranks = WRAP_CASES[wire]
    assert G.sum_safe_int_dtype(k, n_ranks) == getattr(torch, wire)
    _check_psum(launched, 4, k, n_ranks)
    # the edge leaf's +2^k codes summed past the wire's range: the mean
    # there is the wrapped sum's, negative, in both packages
    mean = launched["ranks"][4][0][_key("psum", k, n_ranks, "mean", "edge")]
    assert mean[0] == -1.0 and mean[5] == -1.0


def test_compressed_psum_on_the_reference_tests_one_device_mesh(launched):
    """``tests/test_train_substrate.py``'s setup: 64 normals, k = 8,
    n_ranks = 1, a one-device mesh."""
    from jax.sharding import PartitionSpec as P
    g = {"w": jnp.asarray(np.random.default_rng(0).standard_normal(64),
                          jnp.float32)}
    fb = {"w": jnp.zeros(64, jnp.float32)}
    mesh = ref_make_mesh((1,), ("data",))
    sm = jax.shard_map(lambda a, b: ref_psum(a, b, 8, "data", n_ranks=1),
                       mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                       check_vma=False)
    mean, new_fb = jax.jit(sm)(g, fb)
    rank0 = launched["ranks"][1][0]
    assert _same(rank0[_key("substrate", "mean")], mean["w"])
    assert _same(rank0[_key("substrate", "fb")], new_fb["w"])
    # the one-process form is the same function at n = 1
    one_mean, one_fb = G._compressed_mean(
        {"w": torch.from_numpy(np.array(g["w"]))},
        {"w": torch.zeros(64)}, 8, 1, None)
    assert _same(one_mean["w"].numpy(), mean["w"])
    assert _same(one_fb["w"].numpy(), new_fb["w"])


def test_compressed_psum_without_a_mesh_raises():
    g = {"w": torch.ones(4)}
    with pytest.raises(RuntimeError, match="use_mesh"):
        G.compressed_psum(g, G.zeros_like_feedback(g), 8, "data")


def test_make_mesh_refuses_without_a_group_or_cuda():
    import torch.distributed as tdist
    assert not tdist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1, 1), ("data", "model"), device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="device_type"):
        make_mesh((1,), ("data",), device_type="mps")


def test_make_mesh_refuses_another_backend(tmp_path):
    """A CPU mesh over an NCCL group, or a CUDA one over gloo, raises: no
    fallback.  (One gloo rank in this process, destroyed after.)"""
    import torch.distributed as tdist
    tdist.init_process_group("gloo", store=tdist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(ValueError, match="ranks"):
            make_mesh((2, 1), ("data", "model"), device_type="cpu")
        if torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="nccl"):
                make_mesh((1, 1), ("data", "model"))
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# elastic_restore onto gloo meshes
# ---------------------------------------------------------------------------


def _world(shape):
    return math.prod(shape)


@pytest.fixture(scope="module")
def one_process(launched):
    """The port's restore in this process, per tau (what every rank's
    ``full_tensor()`` must equal)."""
    out = {}
    for tau in TAUS:
        tree, _ = C.restore_checkpoint(str(launched["tmp"] / "port_ckpt"),
                                       tau_rel=tau, device="cpu")
        out[tau] = {"/".join(map(str, p)): v
                    for p, v in flatten_with_paths(tree)}
    return out


def _loss(cfg, flat):
    """The port's loss on a tree given as {"a/b": leaf}."""
    tree = tree_from_paths([tuple(p.split("/")) for p in flat],
                           list(flat.values()))
    batch = make_train_batch(cfg, batch=2, seq=16, device="cpu")
    with torch.no_grad():
        return float(T.loss_fn(tree, cfg, batch)[0])


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("shape", RESTORE_MESHES,
                         ids=[f"{d}x{m}" for d, m in RESTORE_MESHES])
def test_elastic_restore_shards_bit_equal_to_the_reference(
        launched, one_process, shape, fsdp, tau):
    ranks, ref = launched["ranks"][_world(shape)], launched["ref"]
    n_leaves = 0
    for r, out in enumerate(ranks):
        coord = ",".join(map(str, out[_key("coord", *shape)]))
        prefix = _key("restore", *shape, fsdp, tau) + "|"
        for key in out:
            if not (key.startswith(prefix) and key.endswith("|local")):
                continue
            path = key[len(prefix):-len("|local")]
            want = ref[prefix + path + "|" + coord]
            assert _same(out[key], want), (shape, fsdp, tau, path, r)
            if r == 0:
                n_leaves += 1
                full = out[prefix + path + "|full"]
                assert _same(full, one_process[tau][path].numpy()), path
        assert int(out[_key("moved", *shape, fsdp, tau)]) == \
            int(ref[_key("moved", *shape, fsdp, tau)])
    assert n_leaves == len(flatten_with_paths(launched["params"]))
    # the loss on the restored tree
    cfg = configs.get_reduced(NAME)
    prefix = _key("restore", *shape, fsdp, tau) + "|"
    flat = {k[len(prefix):-len("|full")]: torch.from_numpy(v)
            for k, v in ranks[0].items()
            if k.startswith(prefix) and k.endswith("|full")}
    loss = _loss(cfg, flat)
    ref_loss = float(ref[_key("loss", *shape, fsdp, tau)])
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    if tau == 0:
        before = _loss(cfg, {"/".join(map(str, p)): v for p, v in
                             flatten_with_paths(launched["port_params"])})
        np.testing.assert_allclose(loss, before, rtol=1e-6)


def test_sharded_specs_shard_the_data_axis_with_fsdp():
    """The FSDP cases above place weights on "data": the reduced config's
    specs on (2, 1) and (2, 2) shard some leaf over "data" only with
    ``fsdp``."""
    cfg = configs.get_reduced(NAME)
    shapes = T.init_params(cfg, generator=torch.Generator(), device="meta")
    for shape in ((2, 1), (2, 2)):
        mesh = StandIn(shape, ("data", "model"))
        for fsdp in (False, True):
            specs = S.param_pspecs(dataclasses.replace(cfg, fsdp=fsdp),
                                   shapes, mesh)
            on_data = any("data" in tuple(v)
                          for _, v in flatten_with_paths(specs))
            assert on_data == fsdp


# ---------------------------------------------------------------------------
# hint
# ---------------------------------------------------------------------------

HINT_WANT = {
    "data_model": ("S0", "S2"),
    "both_on_0": ("S0", "S0"),
    "not_dividing": ("R", "R"),
    "rep_keeps_unconstrained": ("R", "S2"),
    "rep_all": ("R", "R"),
    "none_keeps": ("S0", "S2"),
    "reshard_other_dim": ("S0", "R"),
}


def _placement_str(code):
    from torch.distributed.tensor import Replicate, Shard
    return str(Replicate()) if code == "R" else str(Shard(int(code[1:])))


@pytest.mark.parametrize("case", list(HINT_WANT))
def test_hint_gives_the_named_placements(launched, case):
    for out in launched["ranks"][4]:
        got = tuple(out[_key("hint", case, "placements")])
        assert got == tuple(_placement_str(c) for c in HINT_WANT[case])
        assert bool(out[_key("hint", case, "same")])


@pytest.mark.parametrize("world", [1, 4])
def test_hint_keeps_logits_and_gradients(launched, world):
    outs = launched["ranks"][world]
    keys = [k for k in outs[0] if k.startswith("logits|")]
    assert len(keys) == (len(ARCHS) if world == 1 else 2)
    for out in outs:
        for k in keys:
            same, batch_mode = out[k]
            assert same, k
            # (2, 2) with one kv head and replicated attention weights:
            # the batch-parallel hints ran
            assert batch_mode == (world == 4 and "n_kv_heads" in k)


def test_hint_is_the_identity_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert dist._CTX["mesh"] is None
    assert dist.hint(x, "data", None) is x
    assert dist.axis_size("model") == 1
    with dist.use_mesh(StandIn((2, 4), ("data", "model"))):
        assert dist.hint(x, "data", "model") is x
        assert dist.axis_size("model") == 4
        assert dist.axis_size("pod") == 1
    assert dist._CTX["mesh"] is None
