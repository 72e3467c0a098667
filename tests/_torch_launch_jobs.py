"""One process of ``tests/test_torch_dryrun.py``: the port's launch tools on
a fake process group of ``world`` ranks, or the reference's on
``world`` fake XLA host devices, writing what it measured as JSON.

    python tests/_torch_launch_jobs.py JOB.json

A process has one default group and one XLA device count, so each world
size runs in a process of its own.  Both packages run the reduced configs
(``configs.get`` patched to ``get_reduced`` in this process) at the small
shapes in the job (the ``SHAPES`` dict patched in place); neither package's
files change.
"""
import json
import os
import sys
import traceback


def _patch(configs, shapes_mod, shapes):
    configs.get = configs.get_reduced
    spec = type(next(iter(shapes_mod.SHAPES.values())))
    shapes_mod.SHAPES.clear()
    shapes_mod.SHAPES.update({name: spec(name, kind, seq, batch)
                              for name, (kind, seq, batch) in shapes.items()})


def _cells(job, lower, mesh):
    out = {}
    for arch in job["archs"]:
        for shape in job["shapes"]:
            try:
                st = lower(arch, shape, mesh)
            except Exception as e:  # recorded as the dry run records it
                st = {"status": "error", "error": str(e)[-400:],
                      "traceback": traceback.format_exc()[-1500:]}
            out[f"{arch}/{shape}"] = {
                "status": st["status"],
                "memory": st.get("memory"),
                "error": st.get("error", ""),
                "traceback": st.get("traceback", "")}
    return out


def run_port(job):
    import torch
    import torch.distributed as tdist

    from repro_torch import configs
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import grad_sync_dryrun as G
    from repro_torch.launch import mesh as M
    from repro_torch.models import config as C

    world = job["world"]
    M.init_fake_process_group(world)
    res = {"backend": tdist.get_backend(), "world": tdist.get_world_size()}
    if "meshes" in job["parts"]:
        meshes = {}
        for multi in (False, True):
            try:
                m = M.make_production_mesh(multi_pod=multi, device_type="cpu")
                meshes[str(multi)] = {"shape": [int(s) for s in m.shape],
                                      "axes": list(m.mesh_dim_names)}
            except Exception as e:
                meshes[str(multi)] = {"error": f"{type(e).__name__}: {e}"}
        res["meshes"] = meshes
        try:
            M.init_fake_process_group(world)
        except RuntimeError as e:
            res["second_group"] = str(e)
        if not torch.cuda.is_available():
            try:
                M.make_production_mesh()
            except RuntimeError as e:
                res["cuda_without_cuda"] = str(e)
    if world == 4:
        mesh = M.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    if "cells" in job["parts"]:
        _patch(configs, C, job["shapes"])
        res["cells"] = _cells(
            job, lambda a, s, m: D.lower_cell(a, s, m, device="cpu"), mesh)
    if "grad_sync" in job["parts"]:
        from repro_torch.launch.analytic import abstract_params
        from repro_torch.train.pytree import tree_leaves
        sync = {}
        for arch in job["grad_archs"]:
            sizes = [int(p.numel())
                     for p in tree_leaves(abstract_params(configs.get(arch)))]
            sync[arch] = {"sizes": sizes}
            for k in [0] + job["ks"]:
                st = G.lower_grad_sync(arch, k, mesh=mesh, device="cpu")
                sync[arch][str(k)] = {
                    "bytes": st.collective_bytes,
                    "collectives": st.collectives}
        res["grad_sync"] = sync
    if "analyzer" in job["parts"]:
        res["analyzer"] = _analyzer(mesh)
    return res


def _analyzer(mesh):
    """A psum over "data" and a matmul sharded over the mesh, counted."""
    import torch
    import torch.distributed as tdist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.hlo_analysis import analyze

    out = {}
    group = mesh.get_group("data")

    def psum(v):
        tdist.all_reduce(v, group=group)
        return v

    with FakeTensorMode():
        _, st = analyze(psum, torch.empty(64, dtype=torch.float32))
        out["psum"] = {"collectives": st.collectives,
                       "bytes": st.collective_bytes,
                       "memory_bytes": st.memory_bytes}
        # (128, 256) sharded by rows over "data", (256, 64) by columns
        # over "model": each device multiplies (64, 256) by (256, 32)
        a = DTensor.from_local(torch.empty(64, 256), mesh,
                               [Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(256, 32), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        c, st = analyze(lambda x, y: x @ y, a, b)
        out["matmul"] = {"flops": st.flops, "n_dots": st.n_dots,
                         "memory_bytes": st.memory_bytes,
                         "collective_bytes": st.collective_bytes,
                         "global": list(c.shape),
                         "local": list(c.to_local().shape)}
        # the same product with a sharded contraction: a partial sum each
        a = DTensor.from_local(torch.empty(128, 128), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        b = DTensor.from_local(torch.empty(128, 64), mesh,
                               [Replicate(), Shard(0)], run_check=False)
        _, st = analyze(lambda x, y: (x @ y).full_tensor(), a, b)
        out["contracted"] = {"flops": st.flops,
                             "collectives": st.collectives}
    return out


def run_ref(job):
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={job['world']}"
    import jax  # noqa: F401

    from repro import configs
    from repro.launch import mesh as M
    from repro.models import config as C

    res = {}
    if "meshes" in job["parts"]:
        res["meshes"] = {}
        for multi in (False, True):
            m = M.make_production_mesh(multi_pod=multi)
            res["meshes"][str(multi)] = {
                "shape": [int(s) for s in m.devices.shape],
                "axes": list(m.axis_names)}
    if job["world"] != 4:
        return res
    mesh = M.make_mesh((2, 2), ("data", "model"))
    if "cells" in job["parts"]:
        from repro.launch import dryrun as D
        _patch(configs, C, job["shapes"])
        res["cells"] = _cells(job, D.lower_cell, mesh)
    if "grad_sync" in job["parts"]:
        from repro.launch import grad_sync_dryrun as G
        G.make_production_mesh = lambda: mesh
        sync = {}
        for arch in job["grad_archs"]:
            sync[arch] = {}
            for k in [0] + job["ks"]:
                st = G.lower_grad_sync(arch, k)
                sync[arch][str(k)] = {"bytes": st.collective_bytes,
                                      "collectives": st.collectives}
        res["grad_sync"] = sync
    return res


def main(path):
    with open(path) as f:
        job = json.load(f)
    res = run_ref(job) if job["kind"] == "ref" else run_port(job)
    with open(job["out"], "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
