"""Seeded synthetic stand-ins for the paper's datasets (numpy), and the
trainer's token batches (``batches``)."""
from repro_torch.data.synthetic import (
    ge_like_fields,
    nyx_like_fields,
    s3d_like_fields,
    smooth_field,
)

__all__ = ["smooth_field", "ge_like_fields", "nyx_like_fields", "s3d_like_fields"]
