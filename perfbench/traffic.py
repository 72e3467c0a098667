"""The one general generator of traffic: everything a cell sends is drawn
here from the run's seed and the parameters of its workload file.

* ``train_ring``: a ring of token batches drawn on the device, Zipf over
  the vocabulary (rank ``r`` with probability proportional to ``r ** -s``,
  the ranks given to token ids by a seeded permutation), labels the next
  token and -1 at each row's end.
* ``context_block``: one layer's K or V context for every row of a decode
  batch, normal at the workload's scale, drawn in the cache's dtype from a
  generator of its own so the reference can draw it again.
* ``first_tokens``: the first input token of each row of a decode epoch
  (an epoch is a batch of requests that starts at the context's end).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.weights import DTYPES, generator, sub_seed


def zipf_ids(gen: torch.Generator, vocab: int, n: int, s: float,
             device) -> torch.Tensor:
    """``n`` token ids, Zipf(``s``) over the vocabulary, int64."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    probs = (ranks ** -s).to(torch.float32)
    perm = torch.randperm(vocab, generator=gen, device=device)
    draw = torch.multinomial(probs, n, replacement=True, generator=gen)
    return perm[draw]


def train_ring(cfg, wl, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``wl["ring"]`` batches of ``wl["batch"]`` × ``wl["seq"]`` tokens,
    each ``{"tokens", "labels"}`` int32 on the device."""
    gen = generator(device, seed, "ring")
    b, s = wl["batch"], wl["seq"]
    ring = []
    for _ in range(wl["ring"]):
        ids = zipf_ids(gen, cfg["vocab"], b * s, wl["zipf_s"], device)
        tokens = ids.reshape(b, s).to(torch.int32)
        labels = torch.roll(tokens, -1, dims=1)
        labels[:, -1] = -1
        ring.append({"tokens": tokens, "labels": labels})
    return ring


def context_block(cfg, wl, seed: int, layer: int, which: str,
                  device) -> torch.Tensor:
    """Layer ``layer``'s ``which`` ("k" or "v") context, (batch, context,
    kv heads, head dim), in the cache's dtype."""
    hd = cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]
    shape = (wl["batch"], wl["context"], cfg["n_kv_heads"], hd)
    out = torch.randn(shape, generator=generator(device, seed, "ctx", layer,
                                                 which),
                      dtype=DTYPES[cfg["dtype"]], device=device)
    return out.mul_(wl[f"{which}_scale"])


def first_tokens(cfg, wl, seed: int, epoch: int) -> np.ndarray:
    """(batch,) int32 first tokens of epoch ``epoch``, on the host."""
    rng = np.random.default_rng(sub_seed(seed, "first", epoch))
    return rng.integers(0, cfg["vocab"], size=wl["batch"], dtype=np.int32)
