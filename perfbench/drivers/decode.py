"""The decode window: a batch of requests decoded greedily over a context
filled at set-up, the next tokens taken on the device and copied to the
host each step, as a server streams them.

Set-up draws the weights and the context from the seed, makes the
program's decode state (``init_decode_state``) with every row's context in
it, and warms up with the cell's own steps.  A step is the program's
``make_serve_step`` on the whole batch; when ``pos`` would reach
``max_seq`` the batch restarts at the context's end as new requests (a new
epoch).  The first tokens of each epoch are drawn from the seed; every
later input is the token the step before served.

End to end: ``tok_s.decode``, every token served in the window over the
window's seconds, and ``itl_ms.p95``, the 95th percentile of the gaps
between one step's tokens reaching the host and the next step's, pooled
over the window.  ``correct``: the gaps of the served tokens' logits below
the reference's best, over every position of every request (the widest,
``gap``, and the mean, ``gap_mean``), against the workload's limits.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import traffic, work
from perfbench.weights import make_tree

# faults a check can plant in the timed path (tests and calibration only)
FAULTS = ("stale_state", "half_batch", "token")


class Driver:
    kind = "decode"

    def __init__(self, cell, seed: int, device, fault: str = ""):
        if fault and fault not in FAULTS:
            raise ValueError(f"decode fault {fault!r}")
        self.cell, self.seed, self.dev, self.fault = cell, seed, device, fault
        self.cfg, self.wl = cell.config, cell.workload
        self.b, self.ctx = self.wl["batch"], self.wl["context"]
        self.max_seq = self.wl["max_seq"]

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from repro_torch.models import transformer as T
        from repro_torch.train.train_step import make_serve_step
        cfg, wl, dev = self.cfg, self.wl, self.dev
        self.params = make_tree(cfg, self.seed, dev)
        self.state = T.init_decode_state(self.cell.model_config(), self.b,
                                         self.max_seq, device=dev)
        for key in ("k", "v"):
            cache = self.state[key]
            for layer in range(cfg["n_layers"]):
                cache[layer, :, :self.ctx].copy_(traffic.context_block(
                    cfg, wl, self.seed, layer, key, dev))
        self.step_fn = make_serve_step(self.cell.model_config())
        self.epoch, self.pos = -1, self.max_seq
        self.inputs: List[List[np.ndarray]] = []
        self.served: List[List[np.ndarray]] = []
        self.valid_sum = 0
        for _ in range(wl["warmup_steps"]):
            self.step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _restart(self) -> None:
        self.epoch += 1
        self.pos = self.ctx
        self.state["pos"].fill_(self.ctx)
        first = traffic.first_tokens(self.cfg, self.wl, self.seed, self.epoch)
        self.tok_host = first
        self.tok = torch.from_numpy(first).to(self.dev).view(self.b, 1)
        self.inputs.append([])
        self.served.append([])

    def step(self) -> None:
        if self.pos >= self.max_seq:
            self._restart()
        pos = self.state["pos"]
        logits, state = self.step_fn(self.params, self.state, self.tok)
        if self.fault == "stale_state":
            state["pos"] = pos
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        if self.fault == "half_batch":
            nxt[self.b // 2:] = nxt[:self.b - self.b // 2]
        if self.fault == "token" and self.epoch == 0 and \
                len(self.served[0]) == 1:
            nxt[0] = (nxt[0] + 1) % self.cfg["vocab"]
        self.state = state
        host = nxt.cpu().numpy()
        self.inputs[self.epoch].append(self.tok_host)
        self.served[self.epoch].append(host)
        self.valid_sum += self.pos + 1
        self.tok_host, self.tok = host, nxt.view(self.b, 1)
        self.pos += 1

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> Dict[str, float]:
        start = self.valid_sum
        arrivals = [time.perf_counter()]
        while arrivals[-1] - arrivals[0] < seconds:
            self.step()
            arrivals.append(time.perf_counter())
        steps = len(arrivals) - 1
        wall = arrivals[-1] - arrivals[0]
        gaps = np.diff(np.asarray(arrivals))
        self.window_valid = (self.valid_sum - start) / steps
        return {"steps": steps, "window_s": wall,
                "attempted": steps * self.b,
                "tok_s.decode": steps * self.b / wall,
                "itl_ms.p95": float(np.percentile(gaps, 95)) * 1e3}

    def step_work(self) -> Dict[str, float]:
        return work.decode_step_work(self.cfg, self.b, self.window_valid)

    # ------------------------------------------------------------- check
    def release(self) -> None:
        self.requests = [
            (torch.from_numpy(np.stack(i, 1)).to(torch.int64),
             torch.from_numpy(np.stack(s, 1)).to(torch.int64))
            for i, s in zip(self.inputs, self.served)]
        del self.params, self.state, self.step_fn

    def readings(self, control: bool = False) -> Dict[str, float]:
        """The reference's readings over every served request (with
        ``control``: also the fp8 control's, at the same positions)."""
        from perfbench.reference import decode as R
        inputs = [i.to(self.dev) for i, _ in self.requests]
        served = [s.to(self.dev) for _, s in self.requests]
        ctl = R.control_tokens(self.cfg, self.wl, self.seed, inputs,
                               self.dev) if control else None
        out = R.gaps(self.cfg, self.wl, self.seed, inputs, served, self.dev,
                     ctl)
        return out
