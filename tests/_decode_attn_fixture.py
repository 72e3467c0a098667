"""One decode attention at the olmoe-decode-4k cell's row shape (T 4,096,
K 16, G 1, hd 128) over 8 rows at pos 3,583, and the JAX package's output
for it: ``fixtures/decode_attn_jax.npz``, which the card test holds the
split-KV kernel to (the card's machine has no JAX) and a CPU test holds to
``jax.jit(repro.models.layers.gqa_attend)``.

    python tests/_decode_attn_fixture.py      # rewrite the fixture

The inputs come from numpy's PCG64 stream and are rounded to bfloat16 by
torch, the same on every machine; keys at 3× the queries' scale, as the
decode cells draw them.  The fixture holds ``gqa_attend``'s output for the
bfloat16 inputs (the reference's own path) and for their values in
float32, a near-exact attention of the same inputs.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent / "fixtures" / "decode_attn_jax.npz"
B, T, K, G, HD = 8, 4096, 16, 1, 128
POS, SEED = 3583, 20261018


def inputs():
    """q (B, 1, K·G, hd) and the caches (B, T, K, hd), bfloat16 on the
    CPU."""
    import torch
    rng = np.random.default_rng(SEED)

    def draw(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(x).to(torch.bfloat16)
    return (draw((B, 1, K * G, HD), 1.0), draw((B, T, K, HD), 3.0),
            draw((B, T, K, HD), 1.0))


def jax_attend(q, k, v, pos: int, window: int, dtype: str) -> np.ndarray:
    """``jax.jit`` of the reference's ``gqa_attend`` under its decode mask
    (``gqa_scores_mask``), float64 enabled as in the reference's trainer,
    on the torch tensors' values cast to ``dtype`` ("bfloat16" or
    "float32"); the output as float32."""
    import jax
    import jax.numpy as jnp
    import repro._x64  # noqa: F401
    from repro.models import layers as RL
    t = k.shape[1]
    mask = RL.gqa_scores_mask(jnp.asarray([pos], jnp.int32),
                              jnp.arange(t, dtype=jnp.int32), window > 0,
                              window)
    cast = [jnp.asarray(x.float().numpy(), dtype=getattr(jnp, dtype))
            for x in (q, k, v)]
    out = jax.jit(RL.gqa_attend)(*cast, mask)
    return np.array(out.astype(jnp.float32))


def outputs(q, k, v) -> dict:
    return {d: jax_attend(q, k, v, POS, 0, d) for d in ("bfloat16",
                                                         "float32")}


if __name__ == "__main__":
    out = outputs(*inputs())
    np.savez_compressed(PATH, pos=POS, seed=SEED, **out)
    print(f"wrote {PATH} ({PATH.stat().st_size} B)")
