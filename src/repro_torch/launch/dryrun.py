"""Multi-pod dry run: trace every (architecture × input shape × mesh) cell
once on fake tensors and dump memory / cost / collective statistics for
the roofline.

Counterpart of ``repro/launch/dryrun.py``::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \
      --shape train_4k --mesh single            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
      --out results/dryrun_torch.json           # the full 40-cell matrix

The reference lowers and compiles each cell for 512 fake XLA host devices
and reads the partitioned module.  The port makes this process rank 0 of
a fake process group of 256 or 512 ranks (``launch/mesh.py``), builds the
parameters, optimizer state, batch and decode state as DTensors of fake
tensors placed by the sharding rules (``train/sharding.py``), and runs the
step once under ``FakeTensorMode``: the train step, the prefill forward,
or ``make_serve_step``.  Nothing is allocated and no collective moves a
byte; ``launch/hlo_analysis.py::OpCounter`` records the ops one device
runs.  ``--device`` names the fake tensors' device: CUDA by default (it
needs CUDA present, and raises otherwise), ``cpu`` for the tests.

Each cell produces JSON with the reference's keys where their meaning
holds: per-device ``memory`` (``argument_bytes``: the local shards of the
step's inputs that it reads, as XLA drops an argument nothing reads;
``input_bytes``: of them all; ``output_bytes``: of its outputs;
``alias_bytes``: outputs that are inputs' storage, i.e. the optimizer
moments and the decode state, which the port updates in place;
``temp_bytes``: the most bytes the step's own allocations held at once,
less the outputs it allocated), ``cost`` (dot FLOPs and the output-bytes
proxy), ``hlo`` (the analyser's totals) and ``collectives`` by kind.
Where the reference has ``lower_s`` and ``compile_s`` the port has
``trace_s``, the seconds of the traced step.
Results are cached by (arch, shape, mesh, tag): reruns skip built cells.

The model code was made traceable on DTensors without changing what it
computes on plain tensors: constants made inside the step are replicated
(``implicit_replication``), and where GSPMD chooses a layout by itself
the layers name one DTensor can propagate (``layers.batch_only``), or
compute shard by shard on local tensors (``layers._gqa_attend_sharded``
and ``_write_slot``; ``dist.take_rows``, ``gather_last``,
``batch_einsum`` and ``along``).  A cell that stops on an op DTensor
cannot propagate is recorded as ``status: "error"`` with the op named.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from repro_torch import configs
from repro_torch.data.batches import decode_token_spec, train_input_specs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.analytic import abstract_params, param_counts
from repro_torch.launch.mesh import init_fake_process_group, \
    make_production_mesh
from repro_torch.models import dist
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, cell_is_runnable
from repro_torch.train.pytree import tree_leaves, tree_map
from repro_torch.train.sharding import (
    batch_pspecs, decode_state_pspecs, opt_state_pspecs, param_pspecs,
    placements, sanitize_pspecs,
)
from repro_torch.train.train_step import make_serve_step, make_train_step


def _local_shape(shape, places, mesh) -> List[int]:
    local = list(shape)
    for size, p in zip(mesh.shape, places):
        if p.is_shard():
            local[p.dim] //= size
    return local


def fake_shard(like: torch.Tensor, spec, mesh, device: torch.device):
    """A DTensor of ``like``'s global shape and dtype on ``mesh``, placed
    by ``spec``, its local shard a fresh tensor on ``device`` (a fake one
    under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    places = placements(spec, mesh)
    local = torch.empty(_local_shape(like.shape, places, mesh),
                        dtype=like.dtype, device=device)
    return DTensor.from_local(local, mesh, places, run_check=False)


def _locals(tree) -> List[torch.Tensor]:
    from torch.distributed.tensor import DTensor
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(ts) -> int:
    return sum(int(t.numel()) * t.element_size() for t in ts)


def _mesh_devices(mesh) -> int:
    return int(math.prod(mesh.shape))


def lower_cell(arch: str, shape_name: str, mesh, *,
               moe_dispatch: str = "scatter", device: DeviceLike = None,
               records: Optional[list] = None) -> Dict[str, Any]:
    """Trace one (arch, shape) step on ``mesh`` with fake tensors on
    ``device`` (default CUDA); return its stats dict.  ``records``, if
    given, receives the analyser's per-op records."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = configs.get(arch)
    if cfg.n_experts and moe_dispatch != cfg.moe_dispatch:
        cfg = cfg.replace(moe_dispatch=moe_dispatch)
    shape = SHAPES[shape_name]
    runnable, why = cell_is_runnable(cfg, shape)
    if not runnable:
        return {"status": "skipped", "reason": why}
    dev = resolve_device(device)
    model_size = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]

    if shape.kind == "train" and cfg.n_kv_heads % model_size != 0:
        cfg = cfg.replace(attn_param_replication=True)  # §Perf
    if shape.kind == "decode" and cfg.fsdp:
        # serving shards params model-only when they fit (FSDP's data-dim
        # weight sharding exists for optimizer memory, which decode doesn't
        # have); the ~0.8T llama4 keeps FSDP
        if param_counts(cfg)["total"] * 2 / 16 < 12e9:
            cfg = cfg.replace(fsdp=False)

    t0 = time.time()
    with FakeTensorMode(), dist.use_mesh(mesh), implicit_replication():
        params = abstract_params(cfg)
        pspecs = param_pspecs(cfg, params, mesh)
        dparams = tree_map(lambda p, s: fake_shard(p, s, mesh, dev),
                           params, pspecs)
        if shape.kind in ("train", "prefill"):
            specs = train_input_specs(cfg, shape)
            bspecs = batch_pspecs(cfg, mesh)
            batch = {k: fake_shard(v, bspecs[k], mesh, dev)
                     for k, v in specs.items()}
        if shape.kind == "train":
            opt_init, step = make_train_step(cfg)
            with torch.no_grad():
                opt = opt_init(params)
            opt = tree_map(lambda o, s: fake_shard(o, s, mesh, dev), opt,
                           opt_state_pspecs(cfg, opt, pspecs))
            args = (dparams, opt, batch)
        elif shape.kind == "prefill":   # forward only
            def step(params, batch):
                with torch.no_grad():
                    return T.forward(params, cfg, batch)[0]
            args = (dparams, batch)
        else:  # decode
            state = T.init_decode_state(cfg, shape.global_batch,
                                        shape.seq_len, device="cpu")
            sspecs = decode_state_pspecs(cfg, mesh)
            sspecs = sanitize_pspecs({k: sspecs[k] for k in state}, state,
                                     mesh)
            state = {k: fake_shard(v, sspecs[k], mesh, dev)
                     for k, v in state.items()}
            tok = decode_token_spec(cfg, shape)
            tspec = sanitize_pspecs(batch_pspecs(cfg, mesh)["tokens"], tok,
                                    mesh)
            step = make_serve_step(cfg)
            args = (dparams, state, fake_shard(tok, tspec, mesh, dev))
        in_locals = _locals(args)
        in_keys = {t.untyped_storage()._cdata for t in in_locals}
        counter = H.OpCounter(keep_records=records is not None,
                              watch=in_locals)
        with counter:
            out = step(*args)
        out_locals = _locals(out)
    t_trace = time.time() - t0

    h = counter.stats()
    if records is not None:
        records.extend(h.records)
    aliased = [t for t in out_locals
               if t.untyped_storage()._cdata in in_keys]
    out_bytes = _bytes(out_locals)
    alias_bytes = _bytes(aliased)
    stats: Dict[str, Any] = {
        "status": "ok", "arch": arch, "shape": shape_name,
        "kind": shape.kind, "mesh": [int(s) for s in mesh.shape],
        "n_devices": _mesh_devices(mesh), "device": dev.type,
        "trace_s": round(t_trace, 2),
        "memory": {
            "argument_bytes": _bytes(
                t for t in in_locals
                if t.untyped_storage()._cdata in counter.read),
            "input_bytes": _bytes(in_locals),
            "output_bytes": out_bytes,
            "temp_bytes": int(max(h.peak_bytes - (out_bytes - alias_bytes),
                                  0)),
            "alias_bytes": alias_bytes,
        },
        "cost": {"flops": h.flops, "bytes_accessed": h.memory_bytes},
        "hlo": H.stats_dict(h),
        "collectives": H.collectives_by_kind(h),
        "trace_ops": h.n_ops,
    }
    return stats


def cell_key(arch: str, shape: str, mesh_name: str, tag: str = "") -> str:
    return f"{arch}__{shape}__{mesh_name}" + (f"__{tag}" if tag else "")


def production_meshes(mesh_names, device: DeviceLike = None) -> Dict:
    """The named production meshes over this process's default group,
    made first as a fake group of 512 ranks (if "multipod" is wanted) or
    256."""
    import torch.distributed as tdist
    kind = resolve_device(device).type
    if not tdist.is_initialized():
        init_fake_process_group(512 if "multipod" in mesh_names else 256)
    return {mn: make_production_mesh(multi_pod=(mn == "multipod"),
                                     device_type=kind)
            for mn in mesh_names}


def run_cells(archs, shapes, mesh_names, out_path: str, tag: str = "",
              moe_dispatch: str = "scatter", force: bool = False,
              device: DeviceLike = None):
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    results: Dict[str, Any] = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    meshes = production_meshes(mesh_names, device)
    for arch in archs:
        for shape in shapes:
            for mn in mesh_names:
                keyname = cell_key(arch, shape, mn, tag)
                if not force and keyname in results and \
                        results[keyname].get("status") in ("ok", "skipped"):
                    print(f"[cache] {keyname}")
                    continue
                print(f"[run]   {keyname} ...", flush=True)
                try:
                    stats = lower_cell(arch, shape, meshes[mn],
                                       moe_dispatch=moe_dispatch,
                                       device=device)
                except Exception as e:
                    stats = {"status": "error", "error": str(e),
                             "traceback": traceback.format_exc()[-2000:]}
                    print(f"[ERROR] {keyname}: {str(e)[-300:]}")
                results[keyname] = stats
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
                if stats.get("status") == "ok":
                    m = stats["memory"]
                    kinds = " ".join(
                        f"{k}={v['bytes']:.3e}B"
                        for k, v in stats["hlo"]["collectives"].items())
                    print(f"[ok]    {keyname} trace={stats['trace_s']}s "
                          f"arg/dev={m['argument_bytes']:.3e}B "
                          f"temp/dev={m['temp_bytes']:.3e}B "
                          f"dotflops/dev={stats['hlo']['dot_flops']:.3e} "
                          f"coll/dev={stats['hlo']['collective_bytes']:.3e}B"
                          + (f" [{kinds}]" if kinds else ""), flush=True)
                elif stats.get("status") == "skipped":
                    print(f"[skip]  {keyname}: {stats['reason']}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run the full arch × shape matrix")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--tag", default="")
    ap.add_argument("--moe-dispatch", default="scatter",
                    choices=["scatter", "onehot", "sort"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default cuda)")
    args = ap.parse_args(argv)

    archs = configs.names() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    mesh_names = {"single": ["single"], "multipod": ["multipod"],
                  "both": ["single", "multipod"]}[args.mesh]
    results = run_cells(archs, shapes, mesh_names, args.out, tag=args.tag,
                        moe_dispatch=args.moe_dispatch, force=args.force,
                        device=args.device)
    bad = {k: v for k, v in results.items() if v.get("status") == "error"}
    print(f"\n{len(results)} cells recorded, {len(bad)} errors")
    for k in bad:
        print(f"  ERROR {k}: {bad[k]['error'][:200]}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
