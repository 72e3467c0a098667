"""Session options of the port.

Counterpart of ``repro/options.py``, reduced to the field the hb reader
reads.  The reference's other session fields (prefetch depth, shared
contribution pool, decode batcher) and its ``OpenOptions`` belong to the
store and serve plane, which later slices port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SessionOptions:
    """How one retrieval session reads.

      * ``contrib_budget_bytes`` — per-variable cap on each bitplane
        reader's retained contribution cache (None = unbounded; outputs are
        bit-identical at any budget).
    """
    contrib_budget_bytes: Optional[int] = None

    @classmethod
    def memory_bounded(cls, budget_bytes: int) -> "SessionOptions":
        """Cap each variable's resident recompose state; spilled levels are
        rebuilt on demand (outputs stay bit-identical)."""
        return cls(contrib_budget_bytes=int(budget_bytes))
