"""Scan-pruning domains (reference: presto_tpu/storage/shard.py; only
the Domain class is ported, the shard file format is not)."""

from __future__ import annotations

from typing import Optional


class Domain:
    """A per-column value constraint for scan pruning — the engine's
    TupleDomain analog (presto-spi/.../spi/predicate/TupleDomain.java),
    trimmed to ranges + point sets over orderable types."""

    def __init__(self, lo=None, hi=None, values: Optional[list] = None):
        self.lo = lo
        self.hi = hi
        self.values = values  # discrete IN-list; None = range-only

    def overlaps(self, zmin, zmax) -> bool:
        if zmin is None or zmax is None:
            return True  # no stats -> cannot prune
        if self.values is not None:
            return any(zmin <= v <= zmax for v in self.values)
        if self.lo is not None and zmax < self.lo:
            return False
        if self.hi is not None and zmin > self.hi:
            return False
        return True

    def __repr__(self):
        if self.values is not None:
            return f"Domain(in={self.values!r})"
        return f"Domain([{self.lo!r}, {self.hi!r}])"
