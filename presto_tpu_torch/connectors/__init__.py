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

Connectors without a native sink (memory, blackhole, hive) are adapted
through AppendPageSink, which forwards pages to the legacy
`table.append` — no staging, but the same streaming surface, so the
writer has ONE code path in all execution modes.
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
    """Adapter over the legacy `table.append` SPI (memory / blackhole /
    hive): pages forward immediately, finish is a no-op commit.  Not
    snapshot-isolated — connectors wanting staged atomic publishes
    implement page_sink() natively (localfile/parquet/orc)."""

    def __init__(self, table):
        super().__init__()
        self.table = table
        self._rows = 0
        self._bytes = 0

    @property
    def supports_null_append(self):  # delegate to the table's declaration
        return bool(getattr(self.table, "supports_null_append", False))

    def append_page(self, arrays, bucket=None, partition=None,
                    key_ranges=None) -> int:
        seq = self._next_seq()
        n = self.table.append(dict(arrays))
        self._rows += n
        self._bytes += sum(int(getattr(a, "nbytes", 0))
                           for a in arrays.values())
        self._record(PageMeta(seq=seq, rows=n, bucket=bucket,
                              partition=partition, key_ranges=key_ranges))
        return n

    def finish(self) -> WriteResult:
        if self.finished is None:
            self.finished = WriteResult(rows=self._rows, bytes=self._bytes)
        return self.finished

    def abort(self) -> None:
        # pages were applied eagerly; transactional undo (pre-image /
        # manifest snapshot) is the transaction manager's job
        pass


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


class StagedFileSink(PageSink):
    """Staged file sink shared by the file connectors (localfile PTSH
    shards, parquet parts, orc parts): every append_page writes one
    invisible `.stg` file; finish renames them (partition-major, then
    bucket, then append seq) and publishes through the table's manifest
    commit in one atomic step (reference: HivePageSink's staging
    directory + the metastore commit).

    The table provides three hooks:
      - `_sink_write_file(path, arrays, schema)` encodes one page;
      - `_commit_write(new_files, file_meta, write_props, replace,
        schema, gc)` publishes the manifest;
      - `sink_file_prefix` / `sink_file_ext` name the final files.
    """

    def __init__(self, table, write_props=None, replace: bool = False,
                 schema=None, defer_gc: bool = False):
        super().__init__()
        self.table = table
        self.write_props = write_props
        self.replace = replace
        self.schema_override = schema
        self.defer_gc = defer_gc
        import itertools as _it
        import os as _os

        cnt = getattr(type(self), "_stage_counter", None)
        if cnt is None:
            cnt = type(self)._stage_counter = _it.count()
        self.token = f"{_os.getpid():x}-{next(cnt):x}"
        self._staged: Dict[int, tuple] = {}  # seq -> (meta, staged path)
        self._bytes = 0

    @property
    def supports_null_append(self):
        return bool(getattr(self.table, "supports_null_append", False))

    def append_page(self, arrays, bucket=None, partition=None,
                    key_ranges=None, seq=None) -> int:
        import os as _os

        schema = self.schema_override or self.table.schema
        n = len(next(iter(arrays.values()))) if arrays else 0
        if n == 0:
            return 0
        if seq is None:
            s = self._next_seq()
        else:
            s = seq
            with self._seq_lock:  # explicit seqs must not collide with
                self._seq = max(self._seq, s + 1)  # allocated ones
        d = getattr(self.table, "dir", None) or self.table.path
        path = _os.path.join(d, f".stg-{self.token}-{s:06d}.stg")
        self.table._sink_write_file(path, {c: arrays[c] for c in schema},
                                    schema)
        nbytes = _os.path.getsize(path)
        meta = PageMeta(seq=s, rows=n, bucket=bucket, partition=partition,
                        key_ranges=key_ranges)
        with self._seq_lock:
            self._staged[s] = (meta, path)
            self._bytes += nbytes
        self._record(meta)
        return n

    def finish(self) -> WriteResult:
        import os as _os

        if self.finished is not None:
            return self.finished
        # publish order: partition-major, then bucket, then append seq —
        # range-bucketed pages land in global sort order, hash buckets
        # land bucket-contiguous (split scans stay bucket-aligned)
        entries = sorted(
            self._staged.values(),
            key=lambda e: (e[0].partition is not None,
                           e[0].partition if e[0].partition is not None
                           else (), e[0].bucket is not None,
                           e[0].bucket if e[0].bucket is not None else -1,
                           e[0].seq))
        gen = int(self.table._manifest.get("generation", 0)) + 1
        d = getattr(self.table, "dir", None) or self.table.path
        new_files: List[str] = []
        file_meta: Dict[str, dict] = {}
        rows = 0
        for i, (meta, staged) in enumerate(entries):
            fname = f"{self.table.sink_file_prefix}_g{gen:04d}_{i:06d}"
            if meta.bucket is not None:
                fname += f"_b{meta.bucket:04d}"
            fname += self.table.sink_file_ext
            _os.replace(staged, _os.path.join(d, fname))
            new_files.append(fname)
            fm = {"rows": meta.rows}
            if meta.key_ranges is not None:
                fm["ranges"] = meta.key_ranges
            if meta.bucket is not None:
                fm["bucket"] = meta.bucket
            if meta.partition is not None:
                fm["partition"] = [[c, v] for c, v in meta.partition]
            file_meta[fname] = fm
            rows += meta.rows
        wp = self.write_props
        wp_dict = wp.to_dict() if hasattr(wp, "to_dict") else wp
        self.table._commit_write(new_files, file_meta, wp_dict,
                                 replace=self.replace,
                                 schema=self.schema_override,
                                 gc=not bool(self.defer_gc))
        self.finished = WriteResult(rows=rows, bytes=self._bytes,
                                    files=new_files)
        return self.finished

    def abort(self) -> None:
        import os as _os

        for _meta, path in self._staged.values():
            try:
                _os.remove(path)
            except OSError:
                pass
        self._staged.clear()


def open_sink(table, write_props=None, defer_gc: bool = False) -> PageSink:
    """The engine's getPageSinkProvider dispatch: a connector exposing
    `page_sink` provides a staged sink; anything else with `append`
    adapts through AppendPageSink.  `defer_gc` (an open transaction
    could still roll the manifest back) keeps retired generations on
    disk through the commit."""
    fn = getattr(table, "page_sink", None)
    if fn is not None:
        return fn(write_props, defer_gc=defer_gc)
    if hasattr(table, "append"):
        return AppendPageSink(table)
    raise TypeError(f"table '{getattr(table, 'name', table)}' does not "
                    "support writes (no page_sink / append SPI)")
