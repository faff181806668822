"""Connector SPI surface shared by every connector package.

Reference parity: presto-spi/.../spi/connector/ConnectorPageSinkProvider
+ ConnectorPageSink (PAPER.md §L4): a write is `begin -> appendPage* ->
finish` against a sink the CONNECTOR provides, never an ad-hoc
materialize-then-bulk-append.  The engine-side orchestration (bucket
partitioning, within-bucket sorting, layout verification, TableWriter /
TableFinish plan nodes) lives in exec/writer.py; this module owns only
the sink contract the connectors implement:

- `append_page(arrays, bucket=..., partition=...)` streams ONE host
  page into staged storage (a file sink writes a staged file per page,
  invisible to readers until commit);
- `finish()` publishes every staged page ATOMICALLY (file sinks rename
  + rewrite a manifest in one os.replace; in-flight readers holding the
  previous manifest keep reading the previous snapshot's files);
- `abort()` deletes staged output, leaving the table byte-identical.

Memory tables have no native sink and adapt through AppendPageSink,
which appends a write's pages to the table at finish: no staging, but
the same streaming surface, so the writer has one code path in every
execution mode.  The file connectors' staged sink (StagedFileSink) is not ported:
open_sink raises for a table that would need it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class WriteResult:
    """What a committed sink reports back to TableFinish (reference:
    ConnectorPageSink.finish()'s fragments, collapsed to counters +
    the published file names)."""

    rows: int = 0
    bytes: int = 0
    files: List[str] = field(default_factory=list)


@dataclass
class PageMeta:
    """Per-page bookkeeping a sink records for every append_page call:
    the ordering-claim verifier (exec/writer.py) and the manifest's
    per-file pruning metadata both read it back at finish."""

    seq: int
    rows: int
    bucket: Optional[int] = None
    partition: Optional[tuple] = None  # (col, value) pairs
    # per-sort-column (min, max) over the page, in sorted_by order —
    # boundary monotonicity across the final file sequence is what
    # upgrades a per-file sort into a table-level ordering() claim
    key_ranges: Optional[list] = None


class PageSink:
    """One write's sink: begin (construction) -> append_page* -> finish
    | abort.  Implementations must tolerate append_page from several
    writer threads (distributed writes allocate page sequence numbers
    through _next_seq's lock)."""

    #: sinks that carry a null channel (parquet/orc definition levels,
    #: masked-array forwarding) accept masked pages; raw-array sinks
    #: must keep rejecting NULLs loudly (see executor null handling)
    supports_null_append = False

    def __init__(self):
        self._seq_lock = threading.Lock()
        self._seq = 0
        self.pages: List[PageMeta] = []
        self.finished: Optional[WriteResult] = None

    def _next_seq(self) -> int:
        with self._seq_lock:
            s = self._seq
            self._seq += 1
            return s

    def _record(self, meta: PageMeta) -> None:
        with self._seq_lock:
            self.pages.append(meta)

    # -- contract ------------------------------------------------------
    def append_page(self, arrays: Dict[str, np.ndarray],
                    bucket: Optional[int] = None,
                    partition: Optional[tuple] = None,
                    key_ranges: Optional[list] = None) -> int:
        raise NotImplementedError

    def finish(self) -> WriteResult:
        raise NotImplementedError

    def abort(self) -> None:
        raise NotImplementedError


class AppendPageSink(PageSink):
    """Adapter over the `table.append` SPI of the memory connector.  Its
    pages join the table in one `append_pages` at finish (a write of k
    pages copies the table once); abort appends them too, as the
    reference's sink, which forwards each page at once, leaves a failed
    write's pages in the table.  Not snapshot-isolated: transactional
    undo (the pre-image) is the transaction manager's job."""

    def __init__(self, table):
        super().__init__()
        self.table = table
        self._pages: List[Dict[str, np.ndarray]] = []
        self._rows = 0
        self._bytes = 0

    @property
    def supports_null_append(self):  # delegate to the table's declaration
        return bool(getattr(self.table, "supports_null_append", False))

    def append_page(self, arrays, bucket=None, partition=None,
                    key_ranges=None) -> int:
        seq = self._next_seq()
        n = len(next(iter(arrays.values()))) if arrays else 0
        if n:
            self._pages.append(dict(arrays))
        self._rows += n
        self._bytes += sum(int(getattr(a, "nbytes", 0))
                           for a in arrays.values())
        self._record(PageMeta(seq=seq, rows=n, bucket=bucket,
                              partition=partition, key_ranges=key_ranges))
        return n

    def _flush(self) -> None:
        pages, self._pages = self._pages, []
        if pages:
            self.table.append_pages(pages)

    def finish(self) -> WriteResult:
        if self.finished is None:
            self._flush()
            self.finished = WriteResult(rows=self._rows, bytes=self._bytes)
        return self.finished

    def abort(self) -> None:
        self._flush()


def files_ordered(ranges_seq) -> bool:
    """Verifier shared by the writer and the file-sink commits: given
    each file's [first-row, last-row] sort-key tuples IN FILE ORDER,
    True iff the concatenated scan is globally nondecreasing — every
    file internally sorted (first <= last is implied by how the writer
    produces ranges) and every boundary lexicographically monotone.
    Any file without ranges makes the sequence unverifiable (False)."""
    prev_last = None
    for kr in ranges_seq:
        if not kr or len(kr) != 2:
            return False
        first, last = kr[0], kr[1]
        if prev_last is not None and tuple(first) < tuple(prev_last):
            return False
        prev_last = last
    return True


def open_sink(table, write_props=None) -> PageSink:
    """The engine's getPageSinkProvider dispatch for memory tables: a
    table with `append` adapts through AppendPageSink.  A table that
    provides a staged sink of its own (`page_sink`, the file connectors'
    StagedFileSink) is not ported and raises."""
    if hasattr(table, "page_sink"):
        raise NotImplementedError(
            f"writes to {type(table).__name__} '{table.name}' need the "
            "file connectors' staged sink, which is not ported")
    if hasattr(table, "append"):
        return AppendPageSink(table)
    raise TypeError(f"table '{getattr(table, 'name', table)}' does not "
                    "support writes (no page_sink / append SPI)")
