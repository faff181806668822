"""Catalog & connector interfaces.

Reference parity: presto-spi/.../spi/connector/Connector.java:27
(getMetadata / getSplitManager / getPageSourceProvider) and
metadata/MetadataManager.  Trimmed to the TPU engine's needs: a connector
exposes table schemas and serves host-columnar data per split; ingestion to
device batches happens in the scan operator.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors import tpcds as tpcds_gen
from presto_tpu_torch.connectors import tpch as tpch_gen


class ConnectorTable:
    """Metadata + data access for one table."""

    def __init__(self, name: str, schema: Dict[str, T.Type]):
        self.name = name
        self.schema = dict(schema)

    def row_count(self) -> int:
        raise NotImplementedError

    def splits(self, n_splits: int) -> List[Tuple[int, int]]:
        raise NotImplementedError

    def read(self, columns: Optional[List[str]] = None,
             split: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
        """Host columnar data for the given columns (projection pushdown)."""
        raise NotImplementedError

    # ---- statistics SPI (reference: ConnectorMetadata.getTableStatistics
    # feeding cost/StatsCalculator; here also the source of STATIC shapes
    # for the compiled execution mode — see plan/stats.py) ----
    def column_stats(self, column: str):
        return None

    def unique_keys(self) -> List[tuple]:
        return []

    def key_layout(self, column: str):
        """Invertible layout of a unique integer key column, or None.
        Returns (base, block_keys, block_rows): row i holds key
        base + (i // block_rows) * block_keys + (i % block_rows).
        Dense surrogate keys are (min, 1, 1); dbgen's sparse orderkey
        (8 keys per 32-key block) is (1, 32, 8).  Index joins use this
        to turn the probe into one gather (P10), with an in-trace
        layout verification guarding staleness."""
        return None

    def max_rows_per_key(self) -> Dict[tuple, int]:
        return {}

    def ordering(self) -> List[Tuple[str, bool]]:
        """Declared physical row ordering: [(column, ascending), ...] —
        rows are emitted lexicographically nondecreasing on this column
        prefix (reference: ConnectorMetadata table layout
        LocalProperties).  A CLAIM consumed behind runtime monotonicity
        guards (plan/properties.py), so a wrong declaration costs the
        elided sort back, never correctness.  Empty = unordered."""
        return []

    # ---- write-layout SPI (exec/writer.py): the physical properties a
    # write DECLARED (bucketed_by/bucket_count/sorted_by/partitioned_by)
    # and — when the written file sequence verified as globally ordered
    # — the ordering() claim derived from them.  SHOW CREATE TABLE and
    # DESCRIBE surface these so a round-trip reproduces the layout. ----
    def write_properties(self) -> Optional[dict]:
        return None

    # ---- bucketing SPI (reference: Connector.getNodePartitioningProvider,
    # presto-spi/.../spi/connector/Connector.java:74 + BucketNodeMap;
    # here the metadata that lets grouped/chunked execution stream this
    # table bucket-by-bucket, exec/chunked.py) ----
    def bucketing(self):
        """ChunkFamily this table belongs to, or None if it cannot
        stream chunk-wise."""
        return None

    def _invalidate(self) -> None:
        """Drop cached device columns + bump the catalog version after a
        write (compiled-plan caches key on catalog version)."""
        _drop_device_cache(self)
        cat = getattr(self, "_catalog", None)
        if cat is not None:
            cat.version += 1


class MemoryTable(ConnectorTable):
    """In-memory table (reference: presto-memory connector)."""

    def __init__(self, name, schema, data: Dict[str, np.ndarray]):
        super().__init__(name, schema)
        # np.asarray would silently STRIP a null mask
        self.data = {k: (v if isinstance(v, np.ma.MaskedArray)
                         else np.asarray(v)) for k, v in data.items()}
        self._rows = len(next(iter(self.data.values()))) if self.data else 0

    def _invalidate(self) -> None:
        self.__dict__.pop("_col_stats", None)
        super()._invalidate()

    def column_stats(self, column: str):
        """The column's statistics, computed once a column and kept until
        the next write (`_invalidate`)."""
        cache = self.__dict__.setdefault("_col_stats", {})
        if column not in cache:
            cache[column] = self._column_stats(column)
        return cache[column]

    def _column_stats(self, column: str):
        from presto_tpu_torch.plan.stats import ColStats

        a = self.data.get(column)
        if a is None or len(a) == 0:
            return ColStats(ndv=0)
        if a.dtype == object:  # strings: ndv only
            return ColStats(ndv=len(set(a.tolist())))
        return ColStats(min=float(np.min(a)), max=float(np.max(a)),
                        ndv=int(len(np.unique(a))))

    def row_count(self) -> int:
        return self._rows

    def splits(self, n_splits):
        edges = np.linspace(0, self._rows, n_splits + 1).astype(int)
        return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]) if a < b]

    def read(self, columns=None, split=None):
        cols = columns if columns is not None else list(self.schema)
        a, b = split if split is not None else (0, self._rows)
        return {c: self.data[c][a:b] for c in cols}

    # ---- write SPI (reference: ConnectorPageSinkProvider; the memory
    # connector's MemoryPagesStore.add).  The memory connector has no
    # staged sink; engine writes adapt through connectors.AppendPageSink
    # and the writer records layout properties post-commit. ----
    def record_write_properties(self, props, ordered: bool = False) -> None:
        self._write_props = props
        self._layout_ordered = bool(ordered)

    def write_properties(self):
        return getattr(self, "_write_props", None)

    def ordering(self):
        if getattr(self, "_layout_ordered", False) and self._write_props:
            return [(c, bool(a))
                    for c, a in self._write_props.get("sorted_by", [])]
        return []

    def append(self, arrays: Dict[str, np.ndarray]) -> int:
        return self.append_pages([arrays])

    def append_pages(self, pages: List[Dict[str, np.ndarray]]) -> int:
        """Append pages in one concatenation a column (a write of k pages
        copies the table once, not k times); the result is the
        reference's page-by-page append."""
        def keep_mask(v):
            return v if isinstance(v, np.ma.MaskedArray) else np.asarray(v)

        pages = [{c: keep_mask(p[c]) for c in self.schema} for p in pages
                 if p and len(next(iter(p.values())))]
        if not pages:
            return 0
        n = sum(len(next(iter(p.values()))) for p in pages)
        if self._rows:
            pages.insert(0, self.data)
        if len(pages) == 1:
            self.data = pages[0]
        else:
            def cat(parts):
                # masked concat ONLY for columns that carry a mask —
                # null-free columns must stay plain ndarrays
                if any(isinstance(p, np.ma.MaskedArray) for p in parts):
                    return np.ma.concatenate(parts)
                return np.concatenate(parts)

            self.data = {c: cat([p[c] for p in pages]) for c in self.schema}
        self._rows += n
        self._invalidate()
        return n

    def delete_where(self, keep_mask: np.ndarray) -> int:
        deleted = int((~keep_mask).sum())
        self.data = {c: v[keep_mask] for c, v in self.data.items()}
        self._rows -= deleted
        # deletes break the append-only MV delta contract even when the
        # row count later recovers (connectors/delta.py watermark)
        self._mv_delete_epoch = getattr(self, "_mv_delete_epoch", 0) + 1
        self._invalidate()
        return deleted

def _generated(table, gen, file_name: str):
    """A generator table's columns, generated once (gen.generate) and
    kept on the table, and pickled to `file_name` under its cache_dir
    when it has one.  The file name is this package's own: the cache
    never unpickles anything written by another package.  A per-table
    lock: concurrent scans must not generate or unpickle the same table
    twice."""
    lock = table.__dict__.setdefault("_mat_lock", threading.Lock())
    with lock:
        if not hasattr(table, "_data"):
            path = None
            if table.cache_dir:
                os.makedirs(table.cache_dir, exist_ok=True)
                path = os.path.join(table.cache_dir, file_name)
            if path and os.path.exists(path):
                with open(path, "rb") as f:
                    table._data = pickle.load(f)
            else:
                table._data = gen.generate(table.name, table.sf)
                if path:
                    # renamed into place whole: a process reading the
                    # cache beside this one never sees half a file
                    tmp = f"{path}.{os.getpid()}.tmp"
                    with open(tmp, "wb") as f:
                        pickle.dump(table._data, f, protocol=4)
                    os.replace(tmp, path)
        return table._data


class TpchTable(ConnectorTable):
    """TPC-H generator table (reference: presto-tpch), with a host disk
    cache so repeated test/bench runs skip regeneration."""

    def __init__(self, name: str, sf: float, cache_dir: Optional[str] = None):
        super().__init__(name, tpch_gen.SCHEMAS[name])
        self.sf = sf
        self.cache_dir = cache_dir

    def row_count(self) -> int:
        return tpch_gen.row_count(self.name, self.sf)

    def column_stats(self, column: str):
        from presto_tpu_torch.plan.stats import ColStats

        return tpch_gen.column_stats(self.name, column, self.sf, ColStats)

    def unique_keys(self):
        return tpch_gen.UNIQUE_KEYS.get(self.name, [])

    def key_layout(self, column: str):
        if self.name == "orders" and column == "o_orderkey":
            return (1, 32, 8)  # dbgen sparse orderkey: 8 per 32 block
        return None

    def max_rows_per_key(self):
        return tpch_gen.MAX_ROWS_PER_KEY.get(self.name, {})

    def ordering(self):
        # generator emits every table in primary-key order (validated
        # against generated data in tests/test_ordering_properties.py);
        # split/chunk scans preserve it — ranges are contiguous,
        # ascending, and concatenated in index order
        return tpch_gen.ORDERINGS.get(self.name, [])

    def splits(self, n_splits):
        return tpch_gen.split_ranges(self.name, self.sf, n_splits)

    def pushdown_like(self, column: str, pattern: str):
        """Connector LIKE pushdown: returns a BOOLEAN virtual column
        name evaluable at scan (generator word draws), or None."""
        return tpch_gen.like_pushdown_virtual(self.name, column, pattern)

    def read(self, columns=None, split=None):
        cols = columns if columns is not None else list(self.schema)
        virtual = [c for c in cols if "$contains$" in c]
        cols = [c for c in cols if "$contains$" not in c]
        data = self._full_table()
        if split is not None:
            a, b = split
            if self.name == "lineitem":
                lo, hi = tpch_gen.lineitem_offsets(a, b)
                out = {c: data[c][lo:hi] for c in cols}
            else:
                out = {c: data[c][a:b] for c in cols}
        else:
            out = {c: data[c] for c in cols}
        for v in virtual:
            word = v.rsplit("$", 1)[1]
            a, b = split if split is not None else (0, self.row_count())
            out[v] = tpch_gen.part_name_contains(a, b - a, word)
        return out

    def _full_table(self):
        return _generated(self, tpch_gen,
                          f"presto_tpu_torch_tpch_{self.name}_sf{self.sf}.pkl")


#: every live catalog, for bulk cache release (the test suite frees
#: device-column caches between modules to bound one-process memory)
import weakref

_live_catalogs: "weakref.WeakSet[Catalog]" = weakref.WeakSet()


def _drop_device_cache(table) -> None:
    """The ONE device-column-cache drop (used by writes via
    ConnectorTable._invalidate and by release_device_caches); instance
    attrs only — some tables expose _device_cols as a property.  The
    distributed data plane keeps per-mesh-size sharded copies
    (_dist_cols_<ndev>, parallel/dist_executor.sharded_scan) that must
    drop with the rest or post-write reads serve stale shards."""
    for attr in list(getattr(table, "__dict__", {})):
        if attr in ("_device_cols", "_device_cols_f32") \
                or attr.startswith("_dist_cols_"):
            delattr(table, attr)


def release_device_caches() -> None:
    """Drop cached device columns on every live catalog's tables (they
    re-upload lazily).  Host memory otherwise accumulates one copy per
    (catalog, sf) across a long test session."""
    for cat in list(_live_catalogs):
        for t in cat.tables.values():
            _drop_device_cache(t)


class Catalog:
    """Named schemas of tables (reference: MetadataManager + StaticCatalogStore).
    `version` bumps on registration so compiled-plan caches invalidate;
    in-place mutation of a registered MemoryTable's arrays is unsupported —
    re-register instead."""

    def __init__(self):
        self.tables: Dict[str, ConnectorTable] = {}
        #: materialized-view registry: flat name -> exec.matview.MvDefinition
        self.matviews: Dict[str, object] = {}
        self.version = 0
        _live_catalogs.add(self)
        # per-instance copy: a connector attaching a new qualifier (e.g.
        # sqlite) must not change name resolution in OTHER catalogs
        self.known_qualifiers = set(self.KNOWN_QUALIFIERS)
        # prefixes CLAIMED by a connector: a qualified miss under them is
        # an error, never a fallback to a same-named internal table
        self.claimed_prefixes: set = set()

    def register(self, table: ConnectorTable) -> None:
        self.tables[table.name.lower()] = table
        table._catalog = self  # mutation hooks bump version (write path)
        self.version += 1

    def drop(self, name: str, if_exists: bool = False) -> bool:
        n = name.lower()
        if n not in self.tables and "." in n:
            # qualified name over a flat registration: resolve the same
            # way get() does, or DROP memory.default.t would delete the
            # table's data and then fail to unregister it
            flat = self._flat_name(n)
            if flat is not None and flat in self.tables:
                n = flat
        t = self.tables.pop(n, None)
        if t is None:
            if if_exists:
                return False
            raise KeyError(f"Table '{name}' does not exist")
        self.version += 1
        return True

    def register_memory(self, name: str, schema: Dict[str, T.Type],
                        data: Dict[str, np.ndarray]) -> None:
        self.register(MemoryTable(name, schema, data))

    #: catalog/schema qualifiers accepted for flat registrations; a bogus
    #: prefix must NOT silently resolve to the bare table
    KNOWN_QUALIFIERS = {"tpch", "tpcds", "memory", "localfile", "blackhole",
                        "parquet", "orc",
                        "presto_tpu", "default", "system"}

    def _flat_name(self, name: str) -> Optional[str]:
        parts = name.lower().split(".")
        if len(parts) < 2:
            return None
        if parts[0] in self.claimed_prefixes:
            return None  # connector-owned namespace: exact matches only
        import re as _re

        if all(p in self.known_qualifiers
               or _re.fullmatch(r"sf\d+(_\d+)?", p) for p in parts[:-1]):
            return parts[-1]
        return None

    def get(self, name: str) -> ConnectorTable:
        t = self.tables.get(name.lower())
        if t is None and "." in name:
            # catalog.schema.table written against a flat registration
            flat = self._flat_name(name)
            t = self.tables.get(flat) if flat else None
        if t is None:
            raise KeyError(f"Table '{name}' does not exist")
        return t

    def __contains__(self, name: str) -> bool:
        n = name.lower()
        if n in self.tables:
            return True
        flat = self._flat_name(n)
        return flat is not None and flat in self.tables


def tpch_catalog(sf: float = 0.01, cache_dir: Optional[str] = None) -> Catalog:
    cat = Catalog()
    for name in tpch_gen.SCHEMAS:
        cat.register(TpchTable(name, sf, cache_dir))
    return cat


class TpcdsTable(ConnectorTable):
    """TPC-DS generator table (reference: presto-tpcds), same disk-cache
    scheme as TpchTable.  No bucketing(): the reference's chunk families
    serve chunked mode only, which this package does not run."""

    def __init__(self, name: str, sf: float, cache_dir: Optional[str] = None):
        super().__init__(name, tpcds_gen.SCHEMAS[name])
        self.sf = sf
        self.cache_dir = cache_dir

    def row_count(self) -> int:
        return tpcds_gen.row_count(self.name, self.sf)

    def column_stats(self, column: str):
        from presto_tpu_torch.plan.stats import ColStats

        return tpcds_gen.column_stats(self.name, column, self.sf, ColStats)

    def unique_keys(self):
        return tpcds_gen.UNIQUE_KEYS.get(self.name, [])

    def max_rows_per_key(self):
        return tpcds_gen.MAX_ROWS_PER_KEY.get(self.name, {})

    def ordering(self):
        return tpcds_gen.ORDERINGS.get(self.name, [])

    def splits(self, n_splits):
        return tpcds_gen.split_ranges(self.name, self.sf, n_splits)

    def read(self, columns=None, split=None):
        cols = columns if columns is not None else list(self.schema)
        data = self._full_table()
        if split is not None:
            a, b = split
            return {c: data[c][a:b] for c in cols}
        return {c: data[c] for c in cols}

    def _full_table(self):
        return _generated(
            self, tpcds_gen,
            f"presto_tpu_torch_tpcds_{self.name}_sf{self.sf}_v2.pkl")


def tpcds_catalog(sf: float = 0.01, cache_dir: Optional[str] = None) -> Catalog:
    cat = Catalog()
    for name in tpcds_gen.SCHEMAS:
        cat.register(TpcdsTable(name, sf, cache_dir))
    return cat


def catalog_from_numpy(tables: Dict[str, dict]) -> Catalog:
    """A catalog of memory tables from plain numpy: `{table: {"schema":
    {column: type name}, "columns": {column: ndarray}}}`.  Type names are
    strings (parsed with types.parse_type), so the data can come from any
    producer — the differential tests hand over the reference package's
    generated columns this way."""
    cat = Catalog()
    for name, t in tables.items():
        schema = {c: T.parse_type(ty) for c, ty in t["schema"].items()}
        cat.register_memory(name, schema,
                            {c: t["columns"][c] for c in schema})
    return cat
