"""Fault tolerance: checkpoint/restart and stragglers.

Counterpart of ``repro/train/fault.py``:

* restart: ``launch/train.py`` checkpoints asynchronously every N steps
  (``AsyncCheckpointer``); on a step failure :func:`run_with_failures`
  restores the latest checkpoint (exact restore) and replays from there;
* elastic re-mesh: checkpoints are mesh-agnostic (per-leaf bitplanes and
  the tree's paths), so :func:`elastic_restore` places the same state on
  any ``DeviceMesh``: scaling a job is a restore with other placements, no
  format conversion;
* stragglers: :class:`StragglerPolicy` implements bounded-staleness
  dispatch — a shard that misses the deadline contributes nothing this
  step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import numpy as np

from repro_torch.train.checkpoint import restore_checkpoint
from repro_torch.train.pytree import tree_leaves, tree_map, \
    tree_unflatten_like
from repro_torch.train.sharding import placements

Pytree = Any


def elastic_restore(path: str, mesh, pspecs: Pytree, tau_rel: float = 0.0,
                    executor=None):
    """Restore a checkpoint onto an arbitrary mesh (elastic scaling):
    ``restore_checkpoint`` on the mesh's device type (on CUDA its decode is
    B2), then each leaf a ``DTensor`` with the placements its spec in
    ``pspecs`` names.  Every rank restores the whole tree and keeps its own
    shards, so placing moves nothing between ranks.  Returns (tree,
    report)."""
    from torch.distributed.tensor import distribute_tensor

    params, report = restore_checkpoint(path, tau_rel=tau_rel,
                                        device=mesh.device_type,
                                        executor=executor)
    placed = tree_map(
        lambda ps, x: distribute_tensor(x, mesh, placements(ps, mesh),
                                        src_data_rank=None),
        pspecs, params)
    return placed, report


@dataclass
class FailureInjector:
    """Deterministic fault injection for the restart test: raises at the
    given steps (once each)."""
    fail_at: List[int] = field(default_factory=list)
    _fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclass
class StragglerPolicy:
    """Bounded-staleness dispatch: wait at most ``deadline_s`` for a shard's
    batch; a shard that misses contributes nothing this step and the mean is
    rescaled by the number of arrivals."""
    deadline_s: float = 1.0
    skipped: int = 0

    def gather(self, fetchers: List[Callable[[], np.ndarray]]
               ) -> List[np.ndarray]:
        out = []
        start = time.monotonic()
        for fetch in fetchers:
            remaining = self.deadline_s - (time.monotonic() - start)
            try:
                if remaining <= 0:
                    raise TimeoutError
                out.append(fetch())
            except TimeoutError:
                self.skipped += 1
        return out


def run_with_failures(train_loop: Callable[[int, Pytree], tuple],
                      init_state: Pytree, n_steps: int, ckpt,
                      injector: FailureInjector, ckpt_every: int = 5):
    """Generic restart harness over one training-state tree (params and
    optimizer state packed together): run step by step; on an injected or
    real failure restore the latest checkpoint (on the checkpointer's
    device) and replay from there.  Returns (state, log)."""
    state = init_state
    log: Dict[str, Any] = {"losses": {}, "restarts": 0}
    step = 0
    while step < n_steps:
        try:
            injector.check(step)
            state, loss = train_loop(step, state)
            log["losses"][step] = float(loss)
            if step % ckpt_every == 0:
                ckpt.save(state, step)
                ckpt.wait()  # publish before advancing (simple + safe)
            step += 1
        except RuntimeError:
            ckpt.wait()
            restored, report = restore_checkpoint(
                ckpt.path, device=ckpt.device, executor=ckpt.executor)
            state = tree_unflatten_like(state, [
                a.to(b.device, b.dtype).reshape(b.shape)
                for a, b in zip(tree_leaves(restored), tree_leaves(state))])
            step = report.step + 1
            log["restarts"] += 1
    return state, log
