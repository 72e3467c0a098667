"""Bitplane codec: the entropy stage (``codecs``, host), group encode and
decode (``encoder``) and progressive per-group streams (``segments``)."""
from repro_torch.bitplane.codecs import (
    CodecError,
    PlaneCodec,
    codec_name,
    decode_tagged,
    encode_tagged,
    get_codec,
    register,
    registered_codecs,
)
from repro_torch.bitplane.encoder import (
    LevelBitplanes,
    PlaneGroupMeta,
    accumulate_planes,
    decode_magnitudes,
    encode_level,
    plane_bound,
    values_from_planes,
)
from repro_torch.bitplane.segments import (
    InMemoryPlaneSource,
    LevelStream,
    PlaneSegment,
    PlaneSource,
)

__all__ = [
    "LevelBitplanes", "PlaneGroupMeta", "encode_level", "decode_magnitudes",
    "accumulate_planes", "values_from_planes", "plane_bound",
    "LevelStream", "PlaneSegment", "PlaneSource", "InMemoryPlaneSource",
    "CodecError", "PlaneCodec", "codec_name", "decode_tagged",
    "encode_tagged", "get_codec", "register", "registered_codecs",
]
