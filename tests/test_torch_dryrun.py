"""The port's dry run (``repro_torch.launch.mesh.make_production_mesh``,
``launch.dryrun.lower_cell``, ``launch.grad_sync_dryrun.lower_grad_sync``
and the analyser on DTensors) against the JAX package's.

Each world size runs in processes of its own (``tests/_torch_launch_jobs.py``;
a process has one default group, and jax one device count), all started at
once by a module fixture and joined under ``LAUNCH_TIMEOUT_S``:

* the port on fake process groups of 256 and 512 ranks, and the reference
  on 512 fake XLA host devices: ``make_production_mesh`` gives the
  reference's shapes and axis names, (16, 16) ("data", "model") and (2,
  16, 16) ("pod", "data", "model"); 256 ranks hold no pod mesh, and a
  process makes no second default group;
* the port on fake groups of 4 ranks (three processes, the configs split
  among them) and the reference on 4 XLA host devices (two processes):
  every reduced config (``configs.get`` patched to ``get_reduced``) at
  every shape of ``SHAPES`` cut to ``SMALL_SHAPES`` (patched in place in
  both packages) on a (2, 2) ("data", "model") mesh gives the reference's
  status, and a per-device ``argument_bytes`` equal to the reference's
  ``memory_analysis().argument_size_in_bytes``.  Both count the inputs the
  step reads (XLA drops the rest); one difference is stated: zamba2's
  decode steps, where the reference keeps part of the stacked
  ``layers/norm2/scale`` that no SSD layer reads in its argument (its
  layer loop takes the stacked leaf), and the port does not;
* ``lower_grad_sync`` on that mesh's "data" axis: the float32 psum's
  per-device collective bytes equal the reference's; with k = 8 the port
  moves the reference's bytes plus 4 a leaf (its scale all-reduce carries
  a NaN flag beside the amax) plus 2 a leaf of odd size (the int16 wire is
  lane-packed, two codes to an int32 word, ROADMAP C10);
* the analyser per device: a psum of 64 float32 over "data" counts one
  256-byte all-reduce (the reference's ``analyze_hlo`` on its psum counts
  the same); a matmul sharded by rows over "data" and by columns over
  "model" counts a quarter of the global product's FLOPs, and one with a
  contraction sharded over "model" half of them and the all-reduce of its
  partial sums.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402

from repro_torch import configs  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
JOBS = REPO / "tests" / "_torch_launch_jobs.py"
LAUNCH_TIMEOUT_S = 300
ARCHS = configs.names()
SMALL_SHAPES = {"train_4k": ["train", 64, 8],
                "prefill_32k": ["prefill", 128, 4],
                "decode_32k": ["decode", 64, 8],
                "long_500k": ["decode", 256, 1]}
GRAD_ARCHS = ["internlm2-1.8b", "olmoe-1b-7b"]
K = 8
# the reduced configs split among the processes of each package
PORT_SPLIT = [ARCHS[0:4], ARCHS[4:7], ARCHS[7:10]]
REF_SPLIT = [ARCHS[0:5], ARCHS[5:10]]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    jobs = {"port256": {"kind": "port", "world": 256, "parts": ["meshes"]},
            "port512": {"kind": "port", "world": 512, "parts": ["meshes"]},
            "ref512": {"kind": "ref", "world": 512, "parts": ["meshes"]}}
    for i, archs in enumerate(PORT_SPLIT):
        parts = ["cells"] + (["grad_sync", "analyzer"] if i == 0 else [])
        jobs[f"port4.{i}"] = {"kind": "port", "world": 4, "parts": parts,
                              "archs": archs}
    for i, archs in enumerate(REF_SPLIT):
        parts = ["cells"] + (["grad_sync"] if i == 0 else [])
        jobs[f"ref4.{i}"] = {"kind": "ref", "world": 4, "parts": parts,
                             "archs": archs}
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {}
    logs = []
    for name, job in jobs.items():
        job = dict(job, shapes=SMALL_SHAPES, grad_archs=GRAD_ARCHS, ks=[K],
                   out=str(tmp / f"{name}.json"))
        path = tmp / f"{name}.job.json"
        path.write_text(json.dumps(job))
        logs.append(open(tmp / f"{name}.log", "w"))
        procs[name] = subprocess.Popen(
            [sys.executable, str(JOBS), str(path)], env=env,
            stdout=logs[-1], stderr=subprocess.STDOUT)
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    try:
        for p in procs.values():
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    out = {}
    for name in jobs:
        path = tmp / f"{name}.json"
        if procs[name].returncode != 0 or not path.exists():
            log = (tmp / f"{name}.log").read_text()[-3000:]
            pytest.fail(f"{name} exited {procs[name].returncode}:\n{log}")
        out[name] = json.loads(path.read_text())
    for pkg, n in (("port", len(PORT_SPLIT)), ("ref", len(REF_SPLIT))):
        out[f"{pkg}4"] = {"cells": {}}
        for i in range(n):
            part = out[f"{pkg}4.{i}"]
            out[f"{pkg}4"]["cells"].update(part["cells"])
            for key in ("grad_sync", "analyzer"):
                if key in part:
                    out[f"{pkg}4"][key] = part[key]
    return out


def test_production_meshes_match_reference(launched):
    ref = launched["ref512"]["meshes"]
    assert ref["False"] == {"shape": [16, 16], "axes": ["data", "model"]}
    assert launched["port512"]["meshes"] == ref
    assert launched["port256"]["meshes"]["False"] == ref["False"]
    assert "512 ranks" in launched["port256"]["meshes"]["True"]["error"]
    for name in ("port256", "port512"):
        got = launched[name]
        assert (got["backend"], got["world"]) == ("fake", int(name[4:]))
        assert "process of its own" in got["second_group"]
        if not torch.cuda.is_available():
            assert "CUDA is not available" in got["cuda_without_cuda"]


def _norm2_bytes(arch):
    from repro_torch.launch.analytic import abstract_params
    leaf = abstract_params(configs.get_reduced(arch))["layers"]["norm2"]
    return int(leaf["scale"].numel()) * leaf["scale"].element_size()


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_cells_match_reference(arch, launched):
    port, ref = launched["port4"]["cells"], launched["ref4"]["cells"]
    for shape in SMALL_SHAPES:
        key = f"{arch}/{shape}"
        got, want = port[key], ref[key]
        assert got["status"] == want["status"], \
            (key, got["error"], got["traceback"])
        if want["status"] != "ok":
            continue
        mem = got["memory"]
        assert set(want["memory"]) <= set(mem)
        gap = want["memory"]["argument_bytes"] - mem["argument_bytes"]
        if arch == "zamba2-2.7b" and shape in ("decode_32k", "long_500k"):
            assert 0 < gap <= _norm2_bytes(arch), key
        else:
            assert gap == 0, key
        assert mem["input_bytes"] >= mem["argument_bytes"] > 0
        assert mem["temp_bytes"] >= 0 and mem["output_bytes"] > 0


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_grad_sync_bytes_match_reference(arch, launched):
    port = launched["port4"]["grad_sync"][arch]
    ref = launched["ref4"]["grad_sync"][arch]
    assert port["0"]["bytes"] == ref["0"]["bytes"] == 4 * sum(port["sizes"])
    assert port["0"]["collectives"]["all-reduce"]["bytes"] == \
        ref["0"]["bytes"]
    leaves = len(port["sizes"])
    odd = sum(n % 2 for n in port["sizes"])
    assert port[str(K)]["bytes"] == ref[str(K)]["bytes"] + 4 * leaves + 2 * odd
    assert port[str(K)]["bytes"] == 8 * leaves + sum(
        2 * ((n + 1) // 2) * 2 for n in port["sizes"])


def test_psum_counts_its_all_reduce(launched):
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_mesh
    mesh = make_mesh((1,), ("x",))
    g = jax.shard_map(lambda v: jax.lax.psum(v, "x"), mesh=mesh,
                      in_specs=P("x"), out_specs=P())
    want = analyze_hlo(jax.jit(g).lower(
        jax.ShapeDtypeStruct((64,), jnp.float32)).compile().as_text())
    got = launched["port4"]["analyzer"]["psum"]
    assert got["collectives"]["all-reduce"] == \
        want.collectives["all-reduce"] == {"count": 1.0, "bytes": 256.0}
    assert got["bytes"] == want.collective_bytes == 256


def test_sharded_matmul_counts_local_work(launched):
    got = launched["port4"]["analyzer"]
    mm = got["matmul"]
    assert mm["global"] == [128, 64] and mm["local"] == [64, 32]
    assert mm["flops"] == 2 * 64 * 32 * 256 == 2 * 128 * 64 * 256 / 4
    assert mm["n_dots"] == 1 and mm["collective_bytes"] == 0
    assert mm["memory_bytes"] == 64 * 32 * 4
    part = got["contracted"]
    assert part["flops"] == 2 * 128 * 64 * 256 / 2
    assert part["collectives"]["all-reduce"] == {"count": 1.0,
                                                 "bytes": 128 * 64 * 4}
