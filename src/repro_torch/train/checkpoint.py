"""Progressive QoI-bounded checkpointing: the paper's technique in the
training stack.

Counterpart of ``repro/train/checkpoint.py``.  Every leaf of the saved tree
is bitplane-coded as one group (Algorithm 1 on the training state): the
quantisation and plane packing are one launch of the bitplane encode kernel
on ``device`` (B1, ``kernels/csrc/bitplane.cu``), then the host entropy
stage.  Restores are progressive: a restart that tolerates a relative
L-inf error tau on every tensor reads only the top planes it needs
(``planes_needed``), and each leaf decodes in one launch of the bitplane
decode kernel (B2, through ``decode_prefix``).  tau = 0 reads every plane
and gives the saved values back within 2^(E-48) of a leaf whose largest
magnitude is below 2^E: bit for bit unless the leaf spans more than 2^24
below float32's precision (an optimizer moment's tiniest values lose
bits, as in the reference).  The report bounds each
leaf's RMS, sqrt . mean . square, from the L-inf bound alone (Theorems 1,
4 and 2).

The file format is the port's own: the reference pickles a jax treedef and
its ``LevelBitplanes`` class, which the port cannot read.  The payload here
is plain data — leaf paths, shapes, the reference's dtype strings
(``"bfloat16"``, ``"float32"``, ``"int32"``) and per leaf ``count``,
``exponent``, ``nbits``, ``planes``, ``plane_raw_bits`` and ``signs`` —
and the leaves are the reference's, in its order, with byte-identical
planes and signs.  The protocol is the reference's: write
``ckpt-{step}.tmp``, ``os.replace`` it to ``ckpt-{step}.pkl``, then write
``LATEST``.

The host entropy stage (per plane, pure Python and numpy under the
interpreter lock) is what a save of a large model waits on.
:func:`entropy_pool` makes a process pool for a tree large enough to
repay it, and ``save_checkpoint``, ``restore_checkpoint`` and
:class:`AsyncCheckpointer` map the stage over it when given one; the blobs
are the same with or without it.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import threading
from concurrent.futures import Executor, ProcessPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bitplane.encoder import (
    LevelBitplanes, decode_prefix, encode_level, plane_bound, planes_needed,
)
from repro_torch.core import estimators as est
from repro_torch.device import DTYPE_NAMES, DTYPES, F64, DeviceLike, \
    resolve_device
from repro_torch.train.pytree import flatten_with_paths, tree_from_paths, \
    tree_map

Pytree = Any
NBITS = 48
FORMAT = "repro_torch.checkpoint/1"
# A tree of at least this many elements runs its host entropy stage on a
# pool of processes.  In process the stage takes about 0.4 us per element
# (76.72 s for a 189,530,112-element leaf, tools/time_checkpoint.py on the
# H100 machine's host), so a smaller tree's stage lasts a few seconds,
# against the pool's spawned workers, which each import numpy and the
# codecs before their first task.
POOL_MIN_ELEMENTS = 1 << 24


def default_workers() -> int:
    """One entropy worker per core this process may run on, at most 8."""
    return min(8, len(os.sched_getaffinity(0)))


def entropy_pool(n_elements: int) -> Optional[Executor]:
    """A pool of :func:`default_workers` processes for the host entropy
    stage of a tree of ``n_elements`` (spawned, so no CUDA state is
    inherited), or None where the tree is below ``POOL_MIN_ELEMENTS`` or
    the process has one core: the stage then runs in process.  The caller
    shuts it down.  Spawned workers import the main module, so a script
    that makes one keeps its work under ``if __name__ == "__main__":``."""
    workers = default_workers()
    if n_elements < POOL_MIN_ELEMENTS or workers <= 1:
        return None
    return ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.as_tensor(np.asarray(leaf))


def save_checkpoint(path: str, params: Pytree, step: int,
                    extra: Optional[Dict] = None, device: DeviceLike = None,
                    executor: Optional[Executor] = None) -> Dict[str, int]:
    """Refactor the tree into per-leaf bitplane groups, each encoded on
    ``device`` (default CUDA)."""
    dev = resolve_device(device)
    os.makedirs(path, exist_ok=True)
    blobs = []
    total = 0
    for leaf_path, leaf in flatten_with_paths(params):
        t = _as_tensor(leaf)
        if t.dtype not in DTYPE_NAMES:
            raise TypeError(f"checkpoint leaf {leaf_path}: unsupported "
                            f"dtype {t.dtype}")
        lbp = encode_level(t.to(dev).to(F64).reshape(-1), nbits=NBITS,
                           executor=executor)
        blobs.append({"path": leaf_path, "shape": tuple(t.shape),
                      "dtype": DTYPE_NAMES[t.dtype], "count": lbp.count,
                      "exponent": lbp.exponent, "nbits": lbp.nbits,
                      "planes": lbp.planes,
                      "plane_raw_bits": lbp.plane_raw_bits,
                      "signs": lbp.signs})
        total += lbp.total_nbytes
    payload = {"format": FORMAT, "blobs": blobs, "step": step,
               "extra": extra or {}}
    tmp = os.path.join(path, f"ckpt-{step}.tmp")
    final = os.path.join(path, f"ckpt-{step}.pkl")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, final)  # atomic publish (crash-safe)
    with open(os.path.join(path, "LATEST"), "w") as f:
        f.write(str(step))
    return {"bytes": total, "step": step}


# ---------------------------------------------------------------------------
# Restore (progressive)
# ---------------------------------------------------------------------------


@dataclass
class RestoreReport:
    step: int
    bytes_moved: int
    bytes_full: int
    tensor_bounds: Dict[int, float]     # achieved L-inf bound per leaf
    rms_bounds: Dict[int, float]        # guaranteed |ΔRMS| bound per leaf


def latest_step(path: str) -> Optional[int]:
    f = os.path.join(path, "LATEST")
    if not os.path.exists(f):
        return None
    with open(f) as fh:
        return int(fh.read().strip())


def read_payload(path: str, step: int) -> Dict[str, Any]:
    """The plain-data payload of ``ckpt-{step}.pkl`` (a file this module
    wrote: it is unpickled)."""
    with open(os.path.join(path, f"ckpt-{step}.pkl"), "rb") as f:
        payload = pickle.load(f)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path}: ckpt-{step}.pkl is not a "
                         f"{FORMAT} checkpoint")
    return payload


def _group(blob: Dict[str, Any]) -> LevelBitplanes:
    return LevelBitplanes(count=blob["count"], exponent=blob["exponent"],
                          nbits=blob["nbits"], planes=blob["planes"],
                          plane_raw_bits=blob["plane_raw_bits"],
                          signs=blob["signs"])


def _rms_bound(vals: torch.Tensor, achieved: float) -> float:
    """Guaranteed bound on |RMS(restored) - RMS(saved)|: Theorem 1 per
    element (x^2 under an L-inf bound a: 2|x|a + a^2), Theorem 4 for the
    mean, Theorem 2 for the square root.  The per-element bound is the
    reference's ``bound_intpow(|x|, a, 2)`` as it evaluates it, op by op
    outside ``jit`` (nothing contracted into an FMA); ``est.bound_intpow``
    reproduces the jit'd graph instead, so it is not called here."""
    mean_sq = torch.mean(vals * vals)
    d_mean = torch.mean((2.0 * vals.abs()) * achieved + achieved * achieved)
    return float(est.bound_sqrt(mean_sq, d_mean))


def restore_checkpoint(path: str, tau_rel: float = 0.0,
                       step: Optional[int] = None, device: DeviceLike = None,
                       executor: Optional[Executor] = None
                       ) -> Tuple[Pytree, RestoreReport]:
    """Progressive restore on ``device`` (default CUDA): per leaf, read the
    top planes until the relative L-inf bound <= tau_rel (0 => exact
    restore, all planes).  The tree comes back as nested dicts and tuples
    of tensors (a NamedTuple as a plain tuple: see
    ``pytree.tree_unflatten_like``)."""
    dev = resolve_device(device)
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    payload = read_payload(path, step)
    leaves = []
    moved = 0
    full = 0
    tbounds: Dict[int, float] = {}
    rms_bounds: Dict[int, float] = {}
    for i, blob in enumerate(payload["blobs"]):
        lbp = _group(blob)
        full += lbp.total_nbytes
        if lbp.exponent is None:
            vals = torch.zeros(lbp.count, dtype=F64, device=dev)
            achieved = 0.0
        else:
            scale = 2.0 ** lbp.exponent   # >= max|w|
            eps_abs = tau_rel * scale if tau_rel > 0 else 0.0
            k = planes_needed(lbp, eps_abs) if tau_rel > 0 else lbp.nbits
            vals = decode_prefix(lbp, k, dev, executor)
            achieved = plane_bound(lbp, k)
            moved += sum(lbp.plane_nbytes(b) for b in range(k)) \
                + lbp.sign_nbytes
        tbounds[i] = achieved
        rms_bounds[i] = _rms_bound(vals, achieved)
        leaves.append(vals.reshape(blob["shape"]).to(DTYPES[blob["dtype"]]))
    tree = tree_from_paths([b["path"] for b in payload["blobs"]], leaves)
    return tree, RestoreReport(step=step, bytes_moved=moved,
                               bytes_full=full, tensor_bounds=tbounds,
                               rms_bounds=rms_bounds)


# ---------------------------------------------------------------------------
# Async writer (fault-tolerance path)
# ---------------------------------------------------------------------------


class AsyncCheckpointer:
    """Background-thread writer: ``save()`` takes a host copy of the tree,
    queues it and returns; the thread encodes on ``device`` (B1 on the
    card) and writes.  A failure in the thread is raised by the next
    ``wait()`` or ``close()``."""

    def __init__(self, path: str, device: DeviceLike = None,
                 executor: Optional[Executor] = None):
        self.path = path
        self.device = resolve_device(device)
        self.executor = executor
        self._q: "queue.Queue" = queue.Queue()
        self._results: Dict[int, Dict[str, int]] = {}
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                params, step, extra = item
                if self._error is None:
                    self._results[step] = save_checkpoint(
                        self.path, params, step, extra, self.device,
                        self.executor)
            except Exception as exc:   # kept for wait(), which raises it
                self._error = exc
            finally:
                self._q.task_done()

    def save(self, params: Pytree, step: int,
             extra: Optional[Dict] = None) -> None:
        # device -> host now: later steps cannot change the snapshot
        host = tree_map(lambda x: _as_tensor(x).to("cpu", copy=True),
                        params)
        self._q.put((host, step, extra))

    def wait(self) -> None:
        self._q.join()
        if self._error is not None:
            raise RuntimeError(f"checkpoint write under {self.path} "
                               f"failed") from self._error

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join()
