"""The training window: the program's ``make_train_step`` with the bitplane
compressor and its error feedback as the gradient transform, the clip and
the configuration's optimizer, one step after another with no
synchronisation between them, as a training loop runs.

Set-up draws the weights and a ring of token batches from the seed and
runs the first steps through the same step and the same feed as the
window (ring entries 0, 1, 2, ...), reading what the check compares:
each step's loss, each leaf's first gradient as the optimizer got it
(AdamW's first moment after one step over 1 - b1), and each leaf's change
after the set-up steps.  The window goes on from there, round the ring.

End to end: ``tok_s.train``, batch × sequence × the steps completed over
the window's seconds, the window ending in a synchronisation.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

from perfbench import traffic, work
from perfbench.weights import flat, make_leaf, make_tree

FAULTS = ("stale_state", "half_batch", "answer")

B1 = 0.9        # AdamW's first-moment decay in the program's optimizer


class Driver:
    kind = "train"

    def __init__(self, cell, seed: int, device, fault: str = ""):
        if fault and fault not in FAULTS:
            raise ValueError(f"train fault {fault!r}")
        self.cell, self.seed, self.dev, self.fault = cell, seed, device, fault
        self.cfg, self.wl = cell.config, cell.workload

    def setup(self) -> None:
        from repro_torch.train.grad_compress import compress_decompress, \
            zeros_like_feedback
        from repro_torch.train.train_step import make_train_step
        wl, dev = self.wl, self.dev
        self.params = make_tree(self.cfg, self.seed, dev)
        feedback = zeros_like_feedback(self.params)
        k = wl["k_planes"]

        def transform(grads):
            return compress_decompress(grads, feedback, k)[0]

        opt_init, self.step_fn = make_train_step(
            self.cell.model_config(), lr=wl["lr"],
            max_grad_norm=wl["max_grad_norm"], grad_transform=transform)
        self.feedback = feedback
        self.opt = opt_init(self.params)
        self.ring = traffic.train_ring(self.cfg, wl, self.seed, dev)
        self.n = 0
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.losses: List[float] = []
        for i in range(wl["checked_steps"]):
            out = self.step()
            self.losses.append(float(out["loss"]))
            if i == 0:
                first = {p: m / (1.0 - B1)
                         for p, m in flat(self.opt.inner["m"]).items()}
                self.first_grad = {p: float(torch.linalg.vector_norm(g))
                                   for p, g in first.items()}
                self.first_host = {p: g.to(torch.bfloat16).cpu()
                                   for p, g in first.items()}
                del first
        self.change = {
            p: float(torch.linalg.vector_norm(
                x.to(torch.float32) - make_leaf(self.cfg, self.seed, p, dev)
                .to(torch.float32)))
            for p, x in flat(self.params).items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step(self):
        batch = self.ring[self.n % len(self.ring)]
        if self.fault == "half_batch":
            labels = batch["labels"].clone()
            labels.view(-1)[labels.numel() // 2:] = -1
            batch = dict(batch, labels=labels)
        params, self.opt, out = self.step_fn(self.params, self.opt, batch)
        if self.fault == "answer":
            params["lm_head"] = self.params["lm_head"]
        if self.fault != "stale_state":
            self.params = params
        self.bad += ~torch.isfinite(out["loss"])
        self.n += 1
        return out

    def window(self, seconds: float) -> Dict[str, float]:
        first = self.n
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.step()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        wall = time.perf_counter() - t0
        steps = self.n - first
        tokens = self.wl["batch"] * self.wl["seq"]
        return {"steps": steps, "window_s": wall, "attempted": steps,
                "tok_s.train": steps * tokens / wall}

    def failed(self) -> int:
        return int(self.bad)

    def step_work(self) -> Dict[str, float]:
        return work.train_step_work(self.cfg, self.wl["batch"],
                                    self.wl["seq"])

    def release(self) -> None:
        self.batches = [self.ring[i] for i in
                        range(self.wl["checked_steps"])]
        del self.params, self.opt, self.feedback, self.step_fn

    def readings(self, control: bool = False) -> Dict[str, float]:
        """The gaps of the program's set-up steps from the reference's (and
        with ``control``, the fp8 control's gaps from the same reference)."""
        from perfbench.reference import train as R
        against = {"program": self.first_host}
        if control:
            ctl = R.run(self.cfg, self.wl, self.seed, self.batches, self.dev,
                        fp8=True, keep_first=True)
            against["control"] = ctl.pop("first")
        ref = R.run(self.cfg, self.wl, self.seed, self.batches, self.dev,
                    against=against)
        mine = {"loss": self.losses, "grad": self.first_grad,
                "change": self.change}
        out = gaps(mine, ref, ref["diff"]["program"])
        self.leaf_diff = {p: ref["diff"]["program"][p] / ref["grad"][p]
                          for p in ref["grad"]}
        if control:
            out.update({f"control_{k}": v for k, v in
                        gaps(ctl, ref, ref["diff"]["control"]).items()})
        return out


def _leaf_gap(mine: Dict[str, float], ref: Dict[str, float],
              leaves) -> float:
    """The widest gap of a leaf's norm from the reference's, over the
    larger of the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[p] for p in leaves)
    return max(abs(mine[p] - ref[p]) / max(ref[p], med, 1e-30)
               for p in leaves)


def gaps(mine, ref, diff: Dict[str, float]) -> Dict[str, float]:
    """``loss_gap``: the widest relative gap of a step's loss, and
    ``loss1_gap`` the first step's; ``grad_gap`` and ``change_gap`` by the
    worst leaf's norm; ``grad_diff`` by the worst leaf's norm of the
    difference of the first gradients (``diff``), and ``grad_diff_med`` by
    the median leaf's, each over the larger of the reference's norm of
    that leaf and of the median leaf.  The change
    leaves out leaves whose reference gradient is under a thousandth of
    the median leaf's (moved by round-off alone)."""
    grads = ref["grad"]
    med = statistics.median(grads.values())
    moved = [p for p in grads if grads[p] >= 1e-3 * med]
    steps = [abs(a - b) / abs(b) for a, b in zip(mine["loss"], ref["loss"])]
    rel = [diff[p] / max(grads[p], med, 1e-30) for p in grads]
    return {
        "loss_gap": max(steps), "loss1_gap": steps[0],
        "grad_gap": _leaf_gap(mine["grad"], grads, list(grads)),
        "grad_diff": max(rel), "grad_diff_med": statistics.median(rel),
        "change_gap": _leaf_gap(mine["change"], ref["change"], moved)}
