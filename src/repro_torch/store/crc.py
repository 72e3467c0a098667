# Copy of repro/store/crc.py with the port's imports: the port keeps its
# own copy of this jax-free module instead of importing the JAX package.
"""crc32c (Castagnoli) — per-segment transport integrity checksums.

The container stores one crc32c per segment (bitplane, sign plane, mask
bitmap, snapshot blob); every fetch re-hashes the received bytes before they
reach the decoder, so a flipped bit anywhere between `save_archive` and the
reconstruction raises instead of silently corrupting a "guaranteed-error"
answer.  crc32c is the iSCSI/object-store polynomial (reflected 0x82F63B78),
chosen over zlib's crc32 for parity with real storage services.

No compiled crc32c is available in the container, so two paths:

  * scalar slicing-by-8 (8 table lookups per 8 input bytes) for short
    segments and tails;
  * a vectorized tree reduction for buffers >= 1 KiB.  CRC tables are
    GF(2)-linear (``T[a ^ b] == T[a] ^ T[b]``), so one 8-byte step is
    ``crc' = F(crc) ^ G(block)`` with *linear* F.  Per-block G values are
    pure numpy gathers, and the chained prefix ``XOR_i F^(N-1-i)(G_i)``
    folds pairwise with operator doubling (``F^(2^l)`` kept as four
    256-entry lookup tables, squared per level) — log2(N) vectorized
    levels, ~2 orders of magnitude over the scalar loop.
"""
from __future__ import annotations

from typing import List

import numpy as np

_POLY = np.uint32(0x82F63B78)  # reflected CRC-32C polynomial


def _build_tables(n: int = 8) -> List[List[int]]:
    table = np.zeros((n, 256), dtype=np.uint32)
    crc = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        crc = np.where(crc & 1, (crc >> np.uint32(1)) ^ _POLY,
                       crc >> np.uint32(1)).astype(np.uint32)
    table[0] = crc
    for i in range(1, n):
        table[i] = table[0][table[i - 1] & 0xFF] ^ (table[i - 1] >> np.uint32(8))
    return [t.tolist() for t in table]  # python ints: no uint32 boxing in the loop


_T = _build_tables()
_TN = np.asarray(_build_tables(), dtype=np.uint32)     # (8, 256) for gathers
_FAST_THRESHOLD = 1024


def _apply_op(op: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Apply a 32-bit GF(2)-linear operator (four 256-entry uint32 tables,
    one per input byte, low byte first) to an array of uint32."""
    return (op[0][v & 0xFF] ^ op[1][(v >> np.uint32(8)) & 0xFF]
            ^ op[2][(v >> np.uint32(16)) & 0xFF] ^ op[3][v >> np.uint32(24)])


def _build_ops(n_levels: int) -> List[np.ndarray]:
    """Operator ladder for the tree reduction: ops[l] applies F^(2^l), where
    F is the shift-by-one-8-byte-block operator.  Input-independent, built
    once at import by repeated squaring (fully, not on demand — crc32c runs
    concurrently on the SegmentFetcher's prefetch workers, and a lazily
    grown shared ladder would race).  33 levels cover 2^33 blocks = 64 GiB
    buffers, far past anything this code hashes."""
    ops = [np.stack([_TN[7], _TN[6], _TN[5], _TN[4]])]
    for _ in range(n_levels - 1):
        prev = ops[-1]
        ops.append(np.stack([_apply_op(prev, prev[i]) for i in range(4)]))
    return ops


_OPS = _build_ops(33)


def _crc32c_blocks(blocks: np.ndarray, crc: int) -> int:
    """Fold (N, 8) uint8 blocks into ``crc`` (raw register, pre-final-xor)."""
    b = blocks.astype(np.intp)
    # G(block): data-byte contributions of one slicing-by-8 step
    g = (_TN[7][b[:, 0]] ^ _TN[6][b[:, 1]] ^ _TN[5][b[:, 2]]
         ^ _TN[4][b[:, 3]] ^ _TN[3][b[:, 4]] ^ _TN[2][b[:, 5]]
         ^ _TN[1][b[:, 6]] ^ _TN[0][b[:, 7]])
    # fold the incoming register into the first block so the reduction is a
    # pure XOR_i F^(N-1-i)(g_i)
    g[0] ^= _apply_op(_OPS[0], np.asarray([crc], dtype=np.uint32))[0]
    n = 1 << int(np.ceil(np.log2(len(g))))  # leading zero-pad: F(0)=0, G(0)=0
    if n != len(g):
        g = np.concatenate([np.zeros(n - len(g), dtype=np.uint32), g])
    level = 0
    while len(g) > 1:
        g = _apply_op(_OPS[level], g[0::2]) ^ g[1::2]
        level += 1
    return int(g[0])


def crc32c(data: bytes, value: int = 0) -> int:
    """CRC-32C of ``data``; ``value`` chains a previous result."""
    crc = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    mv = memoryview(data)
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    n8 = len(mv) - (len(mv) % 8)
    if n8 >= _FAST_THRESHOLD:
        arr = np.frombuffer(mv[:n8], dtype=np.uint8).reshape(-1, 8)
        crc = _crc32c_blocks(arr, crc)
        n8_start = n8
    else:
        n8_start = 0
    for i in range(n8_start, n8, 8):
        lo = crc ^ int.from_bytes(mv[i:i + 4], "little")
        hi = int.from_bytes(mv[i + 4:i + 8], "little")
        crc = (t7[lo & 0xFF] ^ t6[(lo >> 8) & 0xFF]
               ^ t5[(lo >> 16) & 0xFF] ^ t4[lo >> 24]
               ^ t3[hi & 0xFF] ^ t2[(hi >> 8) & 0xFF]
               ^ t1[(hi >> 16) & 0xFF] ^ t0[hi >> 24])
    for b in mv[n8:]:
        crc = t0[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF
