"""Cross-session decode batching: one launch per shape bucket and serve tick.

Counterpart of ``repro/serve/batch.py``.  Each reader pays one decode
launch per group flush, and under the concurrent serve plane many readers
flush at the same moment — the coalescer already merges *identical*
requests, but distinct sessions tightening distinct variables each launch
alone.  ``DecodeBatcher`` closes that gap:

  * readers ``submit_decode`` / ``submit_recompose`` work items and block
    on ``Ticket.result()``;
  * the FIRST waiter sleeps one batching window (``window_ms``) and then
    drains everything pending, bucketing by shape —
    ``("decode", P_pad, W)`` for plane flushes (P_pad: the reference's
    padded plane count, ``ops.plane_slots``) and
    ``("recompose", shape, levels, start, n_idx, is_ip)`` for
    contributions (hb and ip items recompose through different graphs,
    so they never share a bucket; an ip item's quantum is an operand and
    does not split buckets);
  * buckets with >= 2 items go through ONE batched dispatch: the decode
    as one launch of ``bitplane_decode_batch``
    (``ops.decode_values_fused_batch``) over a grid of groups, the
    recompose as ``scatter_recompose_from_batch``; a singleton bucket — a
    straggler whose shape matched nobody — takes the reader's own dispatch
    (the solo ``bitplane_decode`` kernel) inside the same drain.

A batched decode computes each group exactly as a solo launch, and the
batched recompose runs the solo recompose's elementwise ops over one more
axis, so batched results are bit-identical to per-reader results
(``tests/test_torch_serve.py`` and ``chip_smoke.py``'s serve phase pin
this).  Unlike the reference, nothing pads: the decode kernel reads each
item's own plane count (``plane_slots`` only keys the buckets, exactly as
the reference's zero planes do), and batches are not padded to a power of
two, since nothing here compiles per shape.

Decode is a pure function of (plane words, state), so the scheme needs no
rollback path: if a waiter's window expires without anyone flushing it, it
simply flushes itself — worst case the batch is smaller, never wrong.  An
error in a bucket's dispatch reaches every waiter of that bucket.  The
batcher is shared across sessions of one device (it lives on the server and
rides into readers via ``SessionOptions.decode_batcher``); all entry points
are thread-safe.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.bitplane_unpack import bitplane_unpack


@dataclass
class BatcherStats:
    """Dispatch accounting — the serve plane's ``dispatch_ratio`` (items
    per dispatch) comes straight from these counters."""
    decode_items: int = 0
    decode_dispatches: int = 0
    decode_batched: int = 0        # items that rode a batched dispatch
    recompose_items: int = 0
    recompose_dispatches: int = 0
    recompose_batched: int = 0
    flushes: int = 0
    _mu: threading.Lock = field(default_factory=threading.Lock,
                                repr=False, compare=False)

    def as_dict(self) -> Dict[str, float]:
        with self._mu:
            items = self.decode_items + self.recompose_items
            disp = self.decode_dispatches + self.recompose_dispatches
            return {
                "decode_items": float(self.decode_items),
                "decode_dispatches": float(self.decode_dispatches),
                "decode_batched": float(self.decode_batched),
                "recompose_items": float(self.recompose_items),
                "recompose_dispatches": float(self.recompose_dispatches),
                "recompose_batched": float(self.recompose_batched),
                "flushes": float(self.flushes),
                "dispatch_ratio": float(items) / disp if disp else 0.0,
            }


class Ticket:
    """One submitted work item; ``result()`` blocks until a flush ran it."""

    def __init__(self, batcher: "DecodeBatcher", kind: str, key: Tuple,
                 payload: Tuple):
        self._batcher = batcher
        self.kind = kind
        self.key = key
        self.payload = payload
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def _finish(self, result=None, error: Optional[BaseException] = None):
        self._result = result
        self._error = error
        self._done.set()

    def result(self):
        # first waiter gives the window a chance to fill, then drains the
        # whole pending set itself; later waiters usually find _done set
        if not self._done.wait(self._batcher.window_s):
            self._batcher.flush()
            self._done.wait()
        if self._error is not None:
            raise self._error
        return self._result


class DecodeBatcher:
    """Shape-bucketed batching front for decode + recompose."""

    def __init__(self, window_ms: float = 2.0,
                 batch_recompose: bool = True, plane_slots: int = 64):
        self.window_s = max(0.0, float(window_ms)) / 1e3
        self.batch_recompose = bool(batch_recompose)
        # the reference pads every decode item to this many plane slots so
        # same-width groups share one bucket; here it only keys the bucket
        # (archives with more planes keep their power-of-two count)
        self.plane_slots = int(plane_slots)
        self.stats = BatcherStats()
        self._mu = threading.Lock()
        self._pending: List[Ticket] = []

    # -- submission -------------------------------------------------------
    def submit_decode(self, words: np.ndarray, shifts: np.ndarray, state,
                      sign_bytes: np.ndarray, scale: float, count: int,
                      device: torch.device) -> Ticket:
        """Queue one group flush.  Arguments mirror
        ``ops.decode_values_fused``; the inputs cross to ``device`` here,
        on the submitting thread, so a drain only launches.  Items with
        different fetched-plane counts still share a bucket: the key is
        the reference's padded plane count."""
        prepared = ops.prepare_fused_decode(words, shifts, state, sign_bytes,
                                            count, device)
        w = prepared[0]
        key = ("decode", ops.plane_slots(w.shape[0], self.plane_slots),
               w.shape[1])
        t = Ticket(self, "decode", key, (prepared, float(scale), int(count)))
        with self._mu:
            self._pending.append(t)
        return t

    def submit_recompose(self, idx: torch.Tensor, vals: torch.Tensor,
                         shape: Tuple[int, ...], levels: int, start: int,
                         quantum: Optional[float] = None) -> Ticket:
        """Queue one contribution scatter+recompose
        (``transform.hierarchical.scatter_recompose_from``).  A non-None
        ``quantum`` routes through the ip variant
        (``scatter_recompose_ip_from``); the quantum is an operand, so ip
        items with different quanta still share a bucket — only the hb/ip
        split keys it."""
        key = ("recompose", tuple(shape), int(levels), int(start),
               int(len(idx)), quantum is not None)
        t = Ticket(self, "recompose", key,
                   (idx, vals, tuple(shape), int(levels), int(start),
                    quantum))
        with self._mu:
            self._pending.append(t)
        return t

    # -- draining ---------------------------------------------------------
    def flush(self) -> int:
        """Drain everything pending in shape buckets.  Returns the number
        of dispatches issued.  Safe to call from any thread at any time
        (decode is pure; an extra flush only shrinks batches)."""
        with self._mu:
            batch, self._pending = self._pending, []
        if not batch:
            return 0
        buckets: Dict[Tuple, List[Ticket]] = {}
        for t in batch:
            buckets.setdefault(t.key, []).append(t)
        dispatches = 0
        for key, tickets in buckets.items():
            try:
                if key[0] == "decode":
                    dispatches += self._run_decode(tickets)
                else:
                    dispatches += self._run_recompose(tickets)
            except BaseException as e:   # propagate to every waiter
                for t in tickets:
                    t._finish(error=e)
        with self.stats._mu:
            self.stats.flushes += 1
        return dispatches

    def _run_decode(self, tickets: List[Ticket]) -> int:
        n = len(tickets)
        with self.stats._mu:
            self.stats.decode_items += n
            self.stats.decode_dispatches += 1
            if n > 1:
                self.stats.decode_batched += n
        if n == 1:
            (w, sh, st, sb), scale, count = tickets[0].payload
            mag, vals = bitplane_unpack(w, sh, st, sb, scale)
            tickets[0]._finish((mag, vals[:count]))
            return 1
        out = ops.decode_values_fused_batch(
            [t.payload[0] for t in tickets], [t.payload[1] for t in tickets],
            [t.payload[2] for t in tickets])
        for t, res in zip(tickets, out):
            t._finish(res)
        return 1

    def _run_recompose(self, tickets: List[Ticket]) -> int:
        from repro_torch.transform.hierarchical import (
            scatter_recompose_from, scatter_recompose_from_batch,
            scatter_recompose_ip_from, scatter_recompose_ip_from_batch)
        n = len(tickets)
        batched = n > 1 and self.batch_recompose
        with self.stats._mu:
            self.stats.recompose_items += n
            self.stats.recompose_dispatches += 1 if batched else n
            if batched:
                self.stats.recompose_batched += n
        if not batched:
            for t in tickets:
                idx, vals, shape, levels, start, quantum = t.payload
                if quantum is None:
                    t._finish(scatter_recompose_from(idx, vals, shape,
                                                     levels, start))
                else:
                    t._finish(scatter_recompose_ip_from(
                        idx, vals, shape, levels, start, quantum))
            return n
        _, vals0, shape, levels, start, quantum = tickets[0].payload
        idx_b = torch.stack([t.payload[0] for t in tickets])
        vals_b = torch.stack([t.payload[1] for t in tickets])
        if quantum is None:
            out = scatter_recompose_from_batch(idx_b, vals_b, shape, levels,
                                               start)
        else:
            q_b = torch.tensor([t.payload[5] for t in tickets],
                               dtype=torch.float64, device=vals0.device)
            out = scatter_recompose_ip_from_batch(idx_b, vals_b, shape,
                                                  levels, start, q_b)
        # each reader retains its field (a contribution slot, a lease of
        # one field's bytes): a slice of its own, not a view that would
        # keep the whole batch alive
        for i, t in enumerate(tickets):
            t._finish(out[i].clone())
        return 1
