"""Dry run of the gradient-synchronisation collective, uncompressed vs
bitplane-compressed (the paper's technique on the collective path).

Counterpart of ``repro/launch/grad_sync_dryrun.py``: over the production
mesh's "data" axis it syncs one full float32 gradient tree of the given
arch -- once as a psum mean, once with ``compressed_psum``'s top-k
bitplane integer codes (error feedback carried) -- and counts the
per-device collective bytes.  The reference lowers a ``shard_map`` whose
trees are replicated over the mesh; the port runs the sync on fake
tensors (every device holds the whole tree) over the fake process group's
"data" group, under ``launch/hlo_analysis.py::OpCounter``.

    PYTHONPATH=src python -m repro_torch.launch.grad_sync_dryrun \
        --arch internlm2-1.8b --k 4 8 [--device cpu]

The compressed wire differs from the reference's by construction (ROADMAP
C10): an int16 wire is lane-packed, two codes to an int32 word (a leaf of
odd size carries one pad code), and each leaf's scale all-reduce carries
the amax and a NaN flag (8 bytes) where the reference's carries the amax
(4 bytes).
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import configs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.analytic import abstract_params
from repro_torch.launch.hlo_analysis import HloStats, OpCounter
from repro_torch.models import dist
from repro_torch.train.grad_compress import compressed_psum
from repro_torch.train.pytree import tree_map


def lower_grad_sync(arch: str, k_planes: int = 0, *, mesh=None,
                    device: DeviceLike = None) -> HloStats:
    """Per-device collective stats of one gradient sync of ``arch``'s tree
    over ``mesh``'s "data" axis (default: the production (16, 16) mesh
    over a fake group); ``k_planes`` 0 is the float32 psum mean."""
    import torch.distributed as tdist
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = resolve_device(device)
    if mesh is None:
        from repro_torch.launch.dryrun import production_meshes
        mesh = production_meshes(["single"], dev)["single"]
    cfg = configs.get(arch)
    group = mesh.get_group("data")
    n_data = tdist.get_world_size(group)
    with FakeTensorMode(), dist.use_mesh(mesh):
        grads = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                               device=dev),
                         abstract_params(cfg))
        if k_planes:
            feedback = tree_map(torch.zeros_like, grads)

        def psum_mean(g):
            out = g.clone()
            tdist.all_reduce(out, group=group)
            return out / n_data

        with OpCounter(keep_records=False) as counter:
            if k_planes == 0:
                tree_map(psum_mean, grads)
            else:
                compressed_psum(grads, feedback, k_planes, "data",
                                n_ranks=n_data)
    return counter.stats()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--k", type=int, nargs="*", default=[8, 4])
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default cuda)")
    args = ap.parse_args(argv)
    base = lower_grad_sync(args.arch, 0, device=args.device)
    print(f"{args.arch} grad sync, f32 baseline: "
          f"{base.collective_bytes:.4e} B/dev")
    for k in args.k:
        st = lower_grad_sync(args.arch, k, device=args.device)
        print(f"  k={k:2d} bitplanes: {st.collective_bytes:.4e} B/dev "
              f"({base.collective_bytes / st.collective_bytes:.2f}x fewer)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
