"""Processes for ``tests/test_torch_dist.py``: the port's gloo ranks, and the
reference on fake CPU devices.

    python tests/_torch_dist_ranks.py JOB.json RANK     # one gloo rank
    python tests/_torch_dist_ranks.py JOB.json ref      # the JAX package

A rank joins the default process group through a ``FileStore`` (no port
number), runs the job's parts and writes its results to
``<out>.<rank>.npz`` (the reference to ``<out>.npz``).  The reference part runs with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` in its own process,
and only it imports jax.
"""
import dataclasses
import json
import math
import sys

import numpy as np

MESH_AXES = ("data", "model")


def _key(*parts) -> str:
    return "|".join(str(p) for p in parts)


# --------------------------------------------------------------- the port --

def _port_grads(data, rank: int, names, cfg_dtypes):
    import torch
    grads, fb = {}, {}
    for name in names:
        g = torch.from_numpy(np.array(data[name][rank]))
        if cfg_dtypes.get(name) == "bfloat16":
            g = g.to(torch.bfloat16)
        grads[name] = g
        fb[name] = torch.from_numpy(np.array(data["fb|" + name][rank]))
    return grads, fb


def port_psum(job, rank, out):
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import dist
    from repro_torch.train import grad_compress as G

    n = job["world"]
    mesh = make_mesh((n,), ("data",), device_type="cpu")
    data = np.load(job["grads"])
    for k, n_ranks in job["psum_cases"]:
        grads, fb = _port_grads(data, rank, job["leaves"], job["dtypes"])
        with dist.use_mesh(mesh):
            mean, new_fb = G.compressed_psum(grads, fb, k, "data", n_ranks)
        assert all(new_fb[name] is fb[name] for name in fb)
        out[_key("psum", k, n_ranks, "bytes")] = G.compressed_psum.buffer_bytes
        for name in job["leaves"]:
            out[_key("psum", k, n_ranks, "mean", name)] = \
                mean[name].to(torch.float32).numpy()
            out[_key("psum", k, n_ranks, "fb", name)] = new_fb[name].numpy()
    if job.get("substrate"):
        g = {"w": torch.from_numpy(np.array(data["substrate"]))}
        fb = {"w": torch.zeros(64, dtype=torch.float32)}
        with dist.use_mesh(mesh):
            mean, new_fb = G.compressed_psum(g, fb, 8, "data", n_ranks=1)
        out[_key("substrate", "mean")] = mean["w"].numpy()
        out[_key("substrate", "fb")] = new_fb["w"].numpy()


def port_restore(job, rank, out):
    import torch
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train import sharding as S
    from repro_torch.train.fault import elastic_restore
    from repro_torch.train.pytree import flatten_with_paths

    base = configs.get_reduced(job["arch"])
    shapes = T.init_params(base, generator=torch.Generator(), device="meta")
    for shape in job["meshes"]:
        mesh = make_mesh(shape, MESH_AXES, device_type="cpu")
        out[_key("coord", *shape)] = np.asarray(mesh.get_coordinate())
        for fsdp in (False, True):
            cfg = dataclasses.replace(base, fsdp=fsdp)
            specs = S.param_pspecs(cfg, shapes, mesh)
            for tau in job["taus"]:
                tree, rep = elastic_restore(job["ckpt"], mesh, specs,
                                            tau_rel=tau)
                out[_key("moved", *shape, fsdp, tau)] = rep.bytes_moved
                for path, leaf in flatten_with_paths(tree):
                    p = "/".join(map(str, path))
                    key = _key("restore", *shape, fsdp, tau, p)
                    spec = specs
                    for k in path:
                        spec = spec[k]
                    assert tuple(leaf.placements) == S.placements(spec, mesh)
                    assert leaf.device_mesh is mesh
                    out[key + "|local"] = leaf.to_local().numpy()
                    full = leaf.full_tensor()      # a collective
                    if rank == 0:
                        out[key + "|full"] = full.numpy()


def port_hint(job, rank, out):
    """``hint`` on DTensors of a (2, 2) mesh: the placements it gives and
    the values it keeps."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import dist

    mesh = make_mesh((2, 2), MESH_AXES, device_type="cpu")
    full = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    x = distribute_tensor(full, mesh, [Replicate(), Replicate()],
                          src_data_rank=None)
    assert dist.hint(x, "data") is x          # no mesh registered
    z = distribute_tensor(full, mesh, [Shard(1), Replicate()],
                          src_data_rank=None)
    with dist.use_mesh(mesh):
        y = dist.hint(x, "data", None, "model")
        results = {
            "data_model": y,
            "both_on_0": dist.hint(x, ("data", "model"), None, None),
            # 6 rows do not divide over data x model: unconstrained
            "not_dividing": dist.hint(x, None, ("data", "model"), None),
            "rep_keeps_unconstrained": dist.hint(y, dist.REP, None),
            "rep_all": dist.hint(y, dist.REP, None, dist.REP),
            "none_keeps": dist.hint(y, None, None, None),
            "reshard_other_dim": dist.hint(z, "data", None, None),
        }
        assert dist.hint(x, "pod", None, None) is x   # an absent axis
        assert dist.hint(full, "data") is full        # a plain tensor
    for name, t in results.items():
        out[_key("hint", name, "placements")] = np.asarray(
            [str(p) for p in t.placements])
        same = torch.equal(t.full_tensor(), full)
        out[_key("hint", name, "same")] = np.asarray(same)


def port_logits(job, rank, out):
    """Logits and gradients of reduced configs with no mesh and with a mesh
    registered (plain tensors): equal bit for bit."""
    import torch
    from repro_torch import configs
    from repro_torch.data.batches import make_train_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import dist
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train.pytree import tree_leaves, tree_unflatten_like

    shape = tuple(job["logits_mesh"])
    mesh = make_mesh(shape, MESH_AXES, device_type="cpu")
    for arch, replace in job["logits_archs"]:
        cfg = dataclasses.replace(configs.get_reduced(arch), **replace)
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        batch = make_train_batch(cfg, batch=4, seq=16, device="cpu")
        runs = []
        for ctx in (None, mesh):
            with dist.use_mesh(ctx):
                leaves = [p.detach().clone().requires_grad_(True)
                          for p in tree_leaves(params)]
                tree = tree_unflatten_like(params, leaves)
                loss, _ = T.loss_fn(tree, cfg, batch)
                loss.backward()
                logits, _ = T.forward(tree, cfg, batch)
                runs.append((logits.detach(), [p.grad for p in leaves]))
        (la, ga), (lb, gb) = runs
        # a leaf the loss does not reach has no gradient in either run
        same = torch.equal(la, lb) and all(
            (a is None and b is None) or torch.equal(a, b)
            for a, b in zip(ga, gb))
        with dist.use_mesh(mesh):
            mode = L._attn_shard_mode(cfg, 4)
        out[_key("logits", arch, json.dumps(replace, sort_keys=True))] = \
            np.asarray([same, mode == "batch"])


def run_rank(job, rank: int) -> None:
    import torch.distributed as tdist
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(job["store"], job["world"]),
        rank=rank, world_size=job["world"])
    out = {}
    try:
        for part in job["parts"]:
            globals()["port_" + part](job, rank, out)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    np.savez(f"{job['out']}.{rank}.npz", **out)


# ---------------------------------------------------------- the reference --

def run_reference(job) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import repro._x64  # noqa: F401  (the reference trainer's mode)
    from repro import configs as RCF
    from repro.data.batches import make_train_batch
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as RT
    from repro.train import sharding as RS
    from repro.train.fault import elastic_restore
    from repro.train.grad_compress import compressed_psum

    devs = jax.devices()
    out = {}
    data = np.load(job["grads"])
    for n_str, cases in job["psum_cases"].items():
        n = int(n_str)
        mesh = make_mesh((n,), ("data",), devices=devs[:n])
        grads = {}
        for name in job["leaves"]:
            g = jnp.asarray(data[name][:n])
            if job["dtypes"].get(name) == "bfloat16":
                g = g.astype(jnp.bfloat16)
            grads[name] = g
        fb = {name: jnp.asarray(data["fb|" + name][:n])
              for name in job["leaves"]}
        for k, n_ranks in cases:
            def f(gr, fbk, k=k, n_ranks=n_ranks):
                mean, new_fb = compressed_psum(
                    {a: b[0] for a, b in gr.items()},
                    {a: b[0] for a, b in fbk.items()}, k, "data", n_ranks)
                return ({a: b[None] for a, b in mean.items()},
                        {a: b[None] for a, b in new_fb.items()})
            sm = jax.shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                               out_specs=(P("data"), P("data")),
                               check_vma=False)
            mean, new_fb = jax.jit(sm)(grads, fb)
            for name in job["leaves"]:
                out[_key("psum", n, k, n_ranks, "mean", name)] = np.asarray(
                    mean[name].astype(jnp.float32))
                out[_key("psum", n, k, n_ranks, "fb", name)] = \
                    np.asarray(new_fb[name])

    base = RCF.get_reduced(job["arch"])
    shapes = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                   base))
    batch = make_train_batch(base, batch=2, seq=16)
    for shape in job["meshes"]:
        mesh = make_mesh(tuple(shape), MESH_AXES,
                         devices=devs[:math.prod(shape)])
        for fsdp in (False, True):
            cfg = base.replace(fsdp=fsdp)
            pspecs = RS.param_pspecs(cfg, shapes, mesh)
            for tau in job["taus"]:
                placed, rep = elastic_restore(job["ref_ckpt"], mesh, pspecs,
                                              tau_rel=tau)
                out[_key("moved", *shape, fsdp, tau)] = rep.bytes_moved
                flat = jax.tree_util.tree_flatten_with_path(placed)[0]
                for kp, arr in flat:
                    key = _key("restore", *shape, fsdp, tau,
                               RS._path_str(kp))
                    for sh in arr.addressable_shards:
                        coord = np.argwhere(mesh.devices == sh.device)[0]
                        out[key + "|" + ",".join(map(str, coord))] = \
                            np.asarray(sh.data)
                loss = RT.loss_fn(jax.tree.map(jnp.asarray, placed), base,
                                  batch)[0]
                out[_key("loss", *shape, fsdp, tau)] = np.asarray(loss)
    np.savez(job["out"] + ".npz", **out)


def main(argv) -> int:
    with open(argv[1]) as f:
        job = json.load(f)
    if argv[2] == "ref":
        run_reference(job)
    else:
        run_rank(job, int(argv[2]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
