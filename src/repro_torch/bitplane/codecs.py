# Verbatim copy of repro/bitplane/codecs.py (numpy and zlib only): the port
# keeps its own copy instead of importing the JAX package.
"""Pluggable plane codecs: the real entropy stage behind the bitplane coder.

Every encoded plane (and sign plane) is a *tagged* blob: one codec-id byte
followed by that codec's payload.  ``encode_tagged`` is the cost model — it
tries candidate codecs on the packed plane bytes and keeps the smallest
encoding (so a plane never costs more than ``1 + len(raw)`` bytes), and
``decode_tagged`` dispatches on the id byte and hands back exactly
``out_len`` bytes or raises `CodecError`.  Registered codecs:

    id 0  raw    the bytes themselves (incompressible ~0.5-density planes)
    id 1  zlib   deflate level 1 (the former stand-in, kept as a candidate)
    id 2  rle    zero-run/literal run-length coding — near-empty MSB planes
                 of smooth data collapse to a handful of bytes
    id 3  rans   static order-0 rANS over plane bytes (lane-interleaved so
                 encode/decode vectorize with numpy) — skewed-but-not-empty
                 byte distributions that deflate's LZ window wastes bits on

The id byte doubles as the on-disk format: container manifests (format v3,
repro.store.container) record it per segment so transport stats can break
bytes down per codec without touching payloads, but decode never *needs*
the manifest — blobs are self-describing.  Legacy archives (format v1/v2)
tagged planes with ``b"R"`` (raw) / ``b"Z"`` (zlib) and stored sign planes
as bare zlib streams; ``decode_tagged`` / ``decode_sign_blob`` keep both
decoding bit-identically, and the numeric id space deliberately avoids
0x52/0x5A/0x78 so old and new blobs can never be confused.

The registry is open: ``register(codec)`` adds an experiment's coder and the
cost model picks it up automatically; unknown ids on decode raise
`CodecError` — garbage must never be silently interpreted as plane data.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np


class CodecError(IOError):
    """A codec payload failed to decode (truncated, corrupt, or tagged with
    an unknown codec id) — same integrity family as the store's
    ChecksumError: the decoder must raise, never return garbage planes."""


# Legacy single-character tags written by the pre-registry entropy stage and
# still present in v1/v2 archives; kept out of the numeric id space.
_LEGACY_RAW = 0x52     # b"R"
_LEGACY_ZLIB = 0x5A    # b"Z"
_LEGACY_SIGN = 0x78    # zlib CMF byte: bare (untagged) legacy sign streams

# Density band in which a plane is at ~maximum entropy and stored raw
# without trying any candidate (same gate as the legacy stand-in).
RAW_DENSITY_BAND = (0.45, 0.55)


# Decoders accept and may return any bytes-like buffer (bytes or a
# memoryview into a fetched segment): raw planes dominate an archive by
# bytes, and forcing a copy per plane would put a memcpy back on the
# retrieval hot path the old zero-copy `_inflate_plane` never paid.
BytesLike = Union[bytes, memoryview]


class PlaneCodec:
    """One entropy coder over packed plane bytes.

    ``encode`` returns the payload (no tag byte); ``decode`` must return a
    bytes-like buffer of exactly ``out_len`` bytes or raise `CodecError`.
    ``estimate`` may return a cheap projected payload size (from the byte
    histogram) so the cost model can skip encoding candidates that cannot
    win; ``None`` means "encode to find out".
    """

    codec_id: int
    name: str

    def encode(self, data: bytes) -> bytes:
        raise NotImplementedError

    def decode(self, payload: BytesLike, out_len: int) -> BytesLike:
        raise NotImplementedError

    def estimate(self, data: bytes, counts: np.ndarray) -> Optional[int]:
        return None


class RawCodec(PlaneCodec):
    codec_id = 0
    name = "raw"

    def encode(self, data: bytes) -> bytes:
        return data

    def decode(self, payload: BytesLike, out_len: int) -> BytesLike:
        if len(payload) != out_len:
            raise CodecError(f"raw payload is {len(payload)} bytes, "
                             f"expected {out_len}")
        return payload                    # zero-copy: the dominant codec

    def estimate(self, data: bytes, counts: np.ndarray) -> Optional[int]:
        return len(data)


class ZlibCodec(PlaneCodec):
    codec_id = 1
    name = "zlib"

    def encode(self, data: bytes) -> bytes:
        return zlib.compress(data, 1)

    def decode(self, payload: BytesLike, out_len: int) -> BytesLike:
        try:
            out = zlib.decompress(payload)
        except zlib.error as e:
            raise CodecError(f"zlib payload failed to inflate: {e}") from e
        if len(out) != out_len:
            raise CodecError(f"zlib payload inflated to {len(out)} bytes, "
                             f"expected {out_len}")
        return out


def _write_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(buf):
            raise CodecError("rle payload: truncated varint")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7
        if shift > 63:
            raise CodecError("rle payload: varint overflow")


class RleCodec(PlaneCodec):
    """Zero-run / literal-run coding for near-empty planes.

    Payload is a sequence of ``(zero_run varint, literal_len varint,
    literal bytes)`` records; the output is complete when the running total
    reaches ``out_len``.  Zero runs shorter than ``_MIN_RUN`` are folded
    into the surrounding literal — a 2-byte record header to skip 2 zero
    bytes is a loss, and folding bounds the record count on adversarial
    alternating input."""

    codec_id = 2
    name = "rle"
    _MIN_RUN = 4

    def encode(self, data: bytes) -> bytes:
        a = np.frombuffer(data, dtype=np.uint8)
        out = bytearray()
        n = a.size
        if n == 0:
            return bytes(out)
        nz = a != 0
        # run boundaries: starts[i]..starts[i+1] is one homogeneous run
        starts = [0] + (np.flatnonzero(np.diff(nz)) + 1).tolist() + [n]
        pend_zero = 0
        lit_start = lit_stop = 0          # current literal span [start, stop)
        for i in range(len(starts) - 1):
            s, e = starts[i], starts[i + 1]
            if nz[s] or e - s < self._MIN_RUN:
                # literal run, or a short zero run folded into the literal
                if lit_stop == lit_start:
                    lit_start = lit_stop = s
                lit_stop = e
            else:
                # a zero run worth a record: flush the open record first
                if pend_zero or lit_stop > lit_start:
                    _write_varint(out, pend_zero)
                    _write_varint(out, lit_stop - lit_start)
                    out += data[lit_start:lit_stop]
                pend_zero = e - s
                lit_start = lit_stop = e
        if pend_zero or lit_stop > lit_start:
            _write_varint(out, pend_zero)
            _write_varint(out, lit_stop - lit_start)
            out += data[lit_start:lit_stop]
        return bytes(out)

    def decode(self, payload: BytesLike, out_len: int) -> BytesLike:
        buf = payload if isinstance(payload, memoryview) \
            else memoryview(payload)
        out = bytearray()
        pos = 0
        while pos < len(buf):
            zrun, pos = _read_varint(buf, pos)
            lit, pos = _read_varint(buf, pos)
            # bound BOTH lengths before materialising anything: a corrupt
            # varint must raise CodecError, not attempt a huge allocation
            if zrun > out_len - len(out):
                raise CodecError(f"rle payload decodes past {out_len} bytes")
            if pos + lit > len(buf):
                raise CodecError("rle payload: literal run overruns payload")
            out += bytes(zrun)
            out += buf[pos:pos + lit]
            pos += lit
            if len(out) > out_len:
                raise CodecError(f"rle payload decodes past {out_len} bytes")
        if len(out) != out_len:
            raise CodecError(f"rle payload decoded {len(out)} bytes, "
                             f"expected {out_len}")
        return bytes(out)

    def estimate(self, data: bytes, counts: np.ndarray) -> Optional[int]:
        n = len(data)
        zeros = int(counts[0]) if counts.size else 0
        # run-length only earns its keep on mostly-zero planes; below that
        # the run scan is wasted work on a plane zlib/rans handle better —
        # report "no better than raw" so the cost model skips the encode
        if zeros < 0.6 * n:
            return n
        # cheap lower bound: every non-zero byte is a literal, zero bytes
        # are (optimistically) free
        return n - zeros


class RansCodec(PlaneCodec):
    """Static order-0 rANS over plane bytes, lane-interleaved.

    32-bit states with 16-bit renormalisation (the "rans word" variant:
    state invariant ``[L, L<<16)`` with ``L = 2^16`` guarantees at most one
    renorm per symbol), ``scale_bits = 12``.  ``lanes`` independent states
    encode strided sub-sequences so every per-symbol step is a handful of
    numpy ops over a ``(lanes,)`` vector instead of a Python byte loop;
    renorm words from all lanes share ONE stream in deterministic
    (step, ascending-lane) order, so the only per-lane overhead is the
    4-byte final state.

    Payload: ``u16 lanes | u16 n_sym | n_sym * (u8 sym, u16 freq) |
    lanes * u32 state | 16-bit stream words to end of payload`` (all
    little-endian; the stream length is implied by the payload size).
    Decode re-derives everything else from ``out_len`` and checks that
    every lane's state lands back on ``L`` with the stream fully consumed —
    corrupt payloads fail loudly.
    """

    codec_id = 3
    name = "rans"
    _L = 1 << 16
    _SCALE = 12
    _M = 1 << _SCALE

    @staticmethod
    def _lanes_for(n: int) -> int:
        # more lanes = fewer (vectorized) steps = faster encode AND decode,
        # but 4 bytes of final-state overhead per lane.  Lean toward speed:
        # the cost model charges the states against the payload size, so
        # rANS only gets selected when it wins *despite* the overhead — and
        # then decodes at the wide-lane rate on the retrieval hot path.
        if n >= 1 << 16:
            return 256
        if n >= 1 << 13:
            return 128
        if n >= 1 << 11:
            return 64
        if n >= 1 << 8:
            return 16
        return 4 if n >= 64 else 1

    def _normalize(self, counts: np.ndarray, total: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        syms = np.flatnonzero(counts)
        f = np.maximum(1, np.round(
            counts[syms] * (self._M / total)).astype(np.int64))
        diff = int(self._M - f.sum())
        while diff != 0:
            if diff > 0:
                f[int(np.argmax(f))] += diff
                diff = 0
            else:
                i = int(np.argmax(np.where(f > 1, f, -1)))
                step = max(diff, 1 - int(f[i]))
                f[i] += step
                diff -= step
        return syms, f

    def encode(self, data: bytes) -> bytes:
        a = np.frombuffer(data, dtype=np.uint8)
        n = a.size
        if n == 0:
            return struct.pack("<HH", 1, 0)
        counts = np.bincount(a, minlength=256)
        syms, f = self._normalize(counts, n)
        freq = np.zeros(256, dtype=np.uint64)
        cum = np.zeros(256, dtype=np.uint64)
        freq[syms] = f
        cum[syms] = np.cumsum(f) - f
        lanes = self._lanes_for(n)
        T = -(-n // lanes)
        if T * lanes != n:                # pad tail with a present symbol
            a = np.concatenate([a, np.full(T * lanes - n, syms[0],
                                           dtype=np.uint8)])
        m = a.reshape(T, lanes)
        x = np.full(lanes, self._L, dtype=np.uint64)
        chunks: List[np.ndarray] = []
        thresh = np.uint64((self._L >> self._SCALE) << 16)
        shift = np.uint64(16)
        scale = np.uint64(self._SCALE)
        for t in range(T - 1, -1, -1):
            fs = freq[m[t]]
            mask = x >= thresh * fs
            if mask.any():
                # decoder reads these words in ascending-lane order at the
                # matching step; chunk order is reversed below
                chunks.append((x[mask] & np.uint64(0xFFFF)
                               ).astype(np.uint16))
                x = np.where(mask, x >> shift, x)
            x = ((x // fs) << scale) + (x % fs) + cum[m[t]]
        stream = (np.concatenate(chunks[::-1]) if chunks
                  else np.empty(0, dtype=np.uint16))
        out = bytearray(struct.pack("<HH", lanes, len(syms)))
        out += np.rec.fromarrays(
            [syms.astype(np.uint8), f.astype(np.uint16)],
            dtype=[("s", "u1"), ("f", "<u2")]).tobytes()
        out += x.astype("<u4").tobytes()
        out += stream.astype("<u2").tobytes()
        return bytes(out)

    def decode(self, payload: BytesLike, out_len: int) -> BytesLike:
        buf = payload if isinstance(payload, memoryview) \
            else memoryview(payload)
        if len(buf) < 4:
            raise CodecError("rans payload: truncated header")
        lanes, n_sym = struct.unpack_from("<HH", buf, 0)
        if out_len == 0:
            return b""
        if lanes == 0 or n_sym == 0:
            raise CodecError("rans payload: empty model for non-empty output")
        pos = 4
        table_len = 3 * n_sym
        states_len = 4 * lanes
        if len(buf) < pos + table_len + states_len:
            raise CodecError("rans payload: truncated symbol table / states")
        rec = np.frombuffer(buf, dtype=[("s", "u1"), ("f", "<u2")],
                            count=n_sym, offset=pos)
        pos += table_len
        syms = rec["s"].astype(np.int64)
        f = rec["f"].astype(np.int64)
        if np.unique(syms).size != n_sym or f.min() < 1 \
                or int(f.sum()) != self._M:
            raise CodecError("rans payload: invalid symbol table")
        freq = np.zeros(256, dtype=np.uint64)
        cum = np.zeros(256, dtype=np.uint64)
        freq[syms] = f
        cum[syms] = np.cumsum(f) - f
        lut = np.repeat(syms.astype(np.uint8), f)
        x = np.frombuffer(buf, dtype="<u4", count=lanes,
                          offset=pos).astype(np.uint64)
        pos += states_len
        if (len(buf) - pos) % 2:
            raise CodecError("rans payload: odd stream length")
        stream = np.frombuffer(buf, dtype="<u2",
                               count=(len(buf) - pos) // 2, offset=pos)
        T = -(-out_len // lanes)
        out = np.empty((T, lanes), dtype=np.uint8)
        spos = 0
        mask_slot = np.uint64(self._M - 1)
        scale = np.uint64(self._SCALE)
        shift = np.uint64(16)
        low = np.uint64(self._L)
        for t in range(T):
            slot = x & mask_slot
            s = lut[slot]
            out[t] = s
            x = freq[s] * (x >> scale) + slot - cum[s]
            need = x < low
            k = int(need.sum())
            if k:
                if spos + k > stream.size:
                    raise CodecError("rans payload: stream underrun")
                x[need] = (x[need] << shift) | stream[spos:spos + k
                                                      ].astype(np.uint64)
                spos += k
        if spos != stream.size:
            raise CodecError("rans payload: trailing stream words")
        if not bool(np.all(x == low)):
            raise CodecError("rans payload: final state mismatch")
        return out.reshape(-1)[:out_len].tobytes()

    def estimate(self, data: bytes, counts: np.ndarray) -> Optional[int]:
        n = len(data)
        if n == 0:
            return 4
        syms = np.flatnonzero(counts)
        p = counts[syms] / n
        bits = float(n * -(p * np.log2(p)).sum())
        lanes = self._lanes_for(n)
        return int(np.ceil(bits / 8)) + 4 + 3 * syms.size + 4 * lanes


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_BY_ID: Dict[int, PlaneCodec] = {}
_BY_NAME: Dict[str, PlaneCodec] = {}


def register(codec: PlaneCodec) -> PlaneCodec:
    """Add a codec to the registry (and the cost model's candidate pool)."""
    cid = codec.codec_id
    if not 0 <= cid < 0x40:
        # ids must stay clear of the legacy tag bytes (0x52/0x5A) and the
        # bare-zlib sign sentinel (0x78)
        raise ValueError(f"codec id {cid} outside the reserved range [0, 64)")
    if cid in _BY_ID or codec.name in _BY_NAME:
        raise ValueError(f"codec id {cid} / name {codec.name!r} "
                         f"already registered")
    _BY_ID[cid] = codec
    _BY_NAME[codec.name] = codec
    return codec


def get_codec(codec_id: int) -> PlaneCodec:
    codec = _BY_ID.get(codec_id)
    if codec is None:
        raise CodecError(f"unknown codec id {codec_id}")
    return codec


def codec_name(codec_id: Optional[int]) -> str:
    """Human label for stats output; tolerates unregistered/None ids."""
    if codec_id is None:
        return "untagged"
    if codec_id == _LEGACY_RAW:
        return "raw(legacy)"
    if codec_id == _LEGACY_ZLIB:
        return "zlib(legacy)"
    codec = _BY_ID.get(codec_id)
    return codec.name if codec is not None else f"id{codec_id}"


def registered_codecs() -> Dict[str, PlaneCodec]:
    return dict(_BY_NAME)


RAW = register(RawCodec())
ZLIB = register(ZlibCodec())
RLE = register(RleCodec())
RANS = register(RansCodec())

# The cost model's default candidate pool, overridable per process (e.g.
# `repro.launch.serve --codecs raw,zlib` pins the encoder to the legacy
# pair).  Order matters twice: earlier wins ties, and cheap encoders come
# first so their actual sizes tighten the estimate gate before the
# expensive ones (rANS) decide whether to run at all.
DEFAULT_CANDIDATES: Tuple[str, ...] = ("rle", "zlib", "rans")


def set_default_candidates(names: Iterable[str]) -> Tuple[str, ...]:
    """Set the process-wide candidate pool; returns the previous one.
    ``raw`` is always implied (the fallback that caps any plane's cost at
    1 + len(data) bytes) and need not be listed."""
    global DEFAULT_CANDIDATES
    prev = DEFAULT_CANDIDATES
    pool = tuple(n for n in names if n != "raw")
    for n in pool:
        if n not in _BY_NAME:
            raise ValueError(f"unknown codec {n!r}; registered: "
                             f"{sorted(_BY_NAME)}")
    DEFAULT_CANDIDATES = pool
    return prev


# ---------------------------------------------------------------------------
# Tagged encode / decode (the cost model)
# ---------------------------------------------------------------------------


def encode_tagged(data: bytes, density: Optional[float] = None,
                  candidates: Optional[Sequence[str]] = None) -> bytes:
    """Encode ``data`` under the smallest candidate codec; returns the
    one-byte codec id + payload.

    ``density`` is the plane's set-bit density when known: planes inside
    ``RAW_DENSITY_BAND`` are at ~maximum entropy and are stored raw without
    trying any candidate (skipping both compress and later decompress work,
    exactly like the legacy stand-in's gate).  The cost model computes each
    candidate's cheap size *estimate* first and only runs encoders that
    could still beat the current best, so e.g. rANS is never paid for on a
    plane RLE already collapsed."""
    names = DEFAULT_CANDIDATES if candidates is None else candidates
    best_id, best_payload = RawCodec.codec_id, data
    if density is not None and \
            RAW_DENSITY_BAND[0] <= density <= RAW_DENSITY_BAND[1]:
        return bytes([best_id]) + best_payload
    counts = np.bincount(np.frombuffer(data, dtype=np.uint8), minlength=256)
    for name in names:
        codec = _BY_NAME[name]
        est = codec.estimate(data, counts)
        if est is not None and est >= len(best_payload):
            continue                      # cannot win even in the best case
        payload = codec.encode(data)
        if len(payload) < len(best_payload):
            best_id, best_payload = codec.codec_id, payload
    return bytes([best_id]) + best_payload


def decode_tagged(blob: BytesLike, out_len: int) -> BytesLike:
    """Inverse of ``encode_tagged``; also decodes the legacy ``b"R"`` /
    ``b"Z"`` tags of v1/v2 archives.  Returns a bytes-like buffer (raw
    planes decode zero-copy as a view into ``blob``).  Raises `CodecError`
    on unknown ids or payloads that do not decode to exactly ``out_len``
    bytes."""
    if len(blob) == 0:
        raise CodecError("empty tagged blob")
    tag = blob[0]
    payload = memoryview(blob)[1:]
    if tag == _LEGACY_RAW:
        return RAW.decode(payload, out_len)
    if tag == _LEGACY_ZLIB:
        return ZLIB.decode(payload, out_len)
    return get_codec(tag).decode(payload, out_len)


def decode_sign_blob(blob: BytesLike, out_len: int) -> BytesLike:
    """Decode a sign-plane blob: codec-tagged (current archives) or a bare
    zlib stream (v1/v2 archives, whose CMF first byte 0x78 can never be a
    codec id)."""
    if len(blob) > 0 and blob[0] == _LEGACY_SIGN:
        return ZLIB.decode(blob, out_len)
    return decode_tagged(blob, out_len)


def blob_codec_id(blob: bytes) -> Optional[int]:
    """The codec id byte of a tagged blob (manifest metadata); None for
    empty blobs."""
    return blob[0] if blob else None
