"""Host builders of collection values for the executor: UNNEST's element
tables and the aggregates that return ARRAY or MAP values.

Reference: presto_tpu/exec/executor.py (`_exec_unnest`, `_unnest_static`,
the array_agg, map_agg / multimap_agg, histogram / numeric_histogram /
map_union branches of `_agg_column`, `_agg_column_host`'s set_agg and
set_union, and `_tuples_to_dict_column`).  The reference builds the
aggregates with a Python loop over the input rows; here numpy orders
and deduplicates the rows first (a stable sort by group, first
occurrences through np.unique), so Python touches each distinct element
once.  The tuples, their order and the dictionaries they form are the
reference's, value for value: an element is a Python object
(`functions.scalar._host`), never a numpy scalar, whose repr() would
order the dictionary differently.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Column, Dictionary, upload
from presto_tpu_torch.functions.scalar import _host, _map_sort, repr_order


def tuples_to_dict_column(tuples: List[tuple], valid, typ: T.Type,
                          device: torch.device) -> Column:
    """Host tuples as a dictionary column: the dictionary sorted by repr
    (reference: _tuples_to_dict_column, whose order differs from the
    semantic one of functions/scalar.py's _tuple_dict_normalize)."""
    uniq = repr_order(list(set(tuples)))
    cmap = {t: i for i, t in enumerate(uniq)}
    codes = np.fromiter((cmap[t] for t in tuples), np.int32, len(tuples))
    u = np.empty(len(uniq), dtype=object)
    u[:] = uniq
    return Column(upload(codes, device), valid, typ, Dictionary(u))


def host_values(data: np.ndarray, dictionary: Optional[Dictionary]) -> list:
    """A pulled column's values as Python objects (strings as str,
    collections as tuples, numbers as int, float or bool)."""
    if dictionary is not None:
        if len(dictionary) == 0:
            return [None] * len(data)
        vals = dictionary.values[np.clip(data, 0, len(dictionary) - 1)]
        if vals.dtype.kind == "U":
            return vals.tolist()
        return [_host(v) for v in vals]
    return data.tolist()


#: the most (group, value) slots a direct table counts; past it the
#: builders sort the combined keys (np.unique)
DIRECT_KEYS_MAX = 1 << 24


def value_ids(data: np.ndarray, dictionary: Optional[Dictionary]):
    """An integer id >= 0 per value, equal ids for equal values (a
    dictionary's codes; integers in a narrow range offset by their
    minimum; else np.unique's inverse)."""
    if dictionary is not None:
        return data.astype(np.int64)
    if data.dtype.kind in "iub" and len(data):
        lo, hi = int(data.min()), int(data.max())
        if hi - lo < DIRECT_KEYS_MAX:
            return data.astype(np.int64) - lo
    return np.unique(data, return_inverse=True)[1].reshape(-1) \
        .astype(np.int64)


def rows_by_group(gid: np.ndarray, take: np.ndarray, n_groups: int):
    """The rows of `take` with a group in range, ordered by group and,
    within a group, by row: (rows, their groups, each group's start in
    them)."""
    rows = np.flatnonzero(take & (gid >= 0) & (gid < n_groups))
    g = gid[rows]
    # numpy sorts 16-bit keys stably by radix
    order = np.argsort(g.astype(np.uint16) if n_groups <= 1 << 16 else g,
                       kind="stable")
    rows, g = rows[order], g[order]
    starts = np.searchsorted(g, np.arange(n_groups + 1))
    return rows, g, starts


def _group_keys(gid, ids, rows):
    """(group x distinct id) slot of each row, and the slot count."""
    width = int(ids.max(initial=0)) + 1
    return gid[rows].astype(np.int64) * width + ids[rows], \
        (int(gid[rows].max(initial=0)) + 1) * width


def _first_of_each(key: np.ndarray, slots: int):
    """(the distinct keys ascending, the position of each one's first
    occurrence in `key`, its count)."""
    if slots <= DIRECT_KEYS_MAX:
        counts = np.bincount(key, minlength=slots)
        first = np.full(slots, len(key), dtype=np.int64)
        # a reversed assignment leaves each slot its first position
        first[key[::-1]] = np.arange(len(key) - 1, -1, -1)
        present = np.flatnonzero(counts)
        return present, first[present], counts[present]
    return np.unique(key, return_index=True, return_counts=True)


def first_rows(gid: np.ndarray, ids: np.ndarray, rows: np.ndarray):
    """Of `rows` (ordered by group, then row), the first row of each
    distinct (group, id), still ordered by group and then row."""
    if len(rows) == 0:
        return rows
    _, first, _ = _first_of_each(*_group_keys(gid, ids, rows))
    return rows[np.sort(first)]


def array_agg(gid, take, valid, data, dictionary, n_groups) -> List[tuple]:
    """Each group's values in row order, a NULL input as a NULL
    element."""
    rows, _, starts = rows_by_group(gid, take, n_groups)
    vals = host_values(data[rows], dictionary)
    ok = valid[rows].tolist()
    vals = [v if k else None for v, k in zip(vals, ok)]
    return [tuple(vals[starts[g]:starts[g + 1]]) for g in range(n_groups)]


def set_agg(gid, valid, data, dictionary, n_groups) -> List[tuple]:
    """Each group's distinct non-NULL values in order of first
    appearance."""
    rows, _, _ = rows_by_group(gid, valid, n_groups)
    rows = first_rows(gid, value_ids(data, dictionary), rows)
    return _per_group(gid[rows], host_values(data[rows], dictionary),
                      n_groups)


def _per_group(g: np.ndarray, items: list, n_groups: int) -> List[tuple]:
    starts = np.searchsorted(g, np.arange(n_groups + 1))
    return [tuple(items[starts[k]:starts[k + 1]]) for k in range(n_groups)]


def set_union(gid, valid, data, dictionary, n_groups) -> List[tuple]:
    """Each group's distinct array elements in order of first
    appearance."""
    rows, _, _ = rows_by_group(gid, valid, n_groups)
    rows = first_rows(gid, value_ids(data, dictionary), rows)
    groups = [dict() for _ in range(n_groups)]
    for g, arr in zip(gid[rows].tolist(), host_values(data[rows],
                                                      dictionary)):
        for e in arr:
            groups[g].setdefault(e)
    return [tuple(d) for d in groups]


def map_agg(gid, valid, keys, kdict, vals, vdict, vvalid, n_groups,
            multi: bool) -> List[tuple]:
    """map_agg (each key's first value) or multimap_agg (each key's
    values in row order) over the rows with a non-NULL key, the pairs
    ordered by repr(key)."""
    rows, _, _ = rows_by_group(gid, valid, n_groups)
    kid = value_ids(keys, kdict)
    if multi:
        key, _ = _group_keys(gid, kid, rows)
        order = np.argsort(key, kind="stable")
        rows, key = rows[order], key[order]
        heads = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) \
            if len(key) else np.zeros(0, np.int64)
        v = host_values(vals[rows], vdict)
        ok = vvalid[rows].tolist()
        v = [x if k else None for x, k in zip(v, ok)]
        bounds = list(heads) + [len(rows)]
        first = rows[heads]
        items = [tuple(v[bounds[i]:bounds[i + 1]]) for i in range(len(heads))]
    else:
        first = first_rows(gid, kid, rows)
        v = host_values(vals[first], vdict)
        ok = vvalid[first].tolist()
        items = [x if k else None for x, k in zip(v, ok)]
    groups = [[] for _ in range(n_groups)]
    for g, k, x in zip(gid[first].tolist(), host_values(keys[first], kdict),
                       items):
        groups[g].append((k, x))
    return [_map_sort(p) for p in groups]


def histogram(gid, valid, data, dictionary, n_groups) -> List[tuple]:
    """Each group's (value, count) pairs, ordered by repr(value)."""
    rows, _, _ = rows_by_group(gid, valid, n_groups)
    _, first, counts = _first_of_each(*_group_keys(
        gid, value_ids(data, dictionary), rows))
    first_r = rows[first]
    groups = [[] for _ in range(n_groups)]
    for g, k, c in zip(gid[first_r].tolist(),
                       host_values(data[first_r], dictionary),
                       counts.tolist()):
        groups[g].append((k, c))
    return [_map_sort(p) for p in groups]


def map_union(gid, valid, data, dictionary, n_groups) -> List[tuple]:
    """Each group's maps merged in row order, a key's first value
    winning."""
    rows, _, _ = rows_by_group(gid, valid, n_groups)
    rows = first_rows(gid, value_ids(data, dictionary), rows)
    groups = [dict() for _ in range(n_groups)]
    for g, m in zip(gid[rows].tolist(), host_values(data[rows],
                                                    dictionary)):
        for k, mv in m:
            groups[g].setdefault(k, mv)
    return [_map_sort(d.items()) for d in groups]


def numeric_histogram(gid, valid, vdata: np.ndarray, n_buckets: int,
                      n_groups) -> List[tuple]:
    """Each group's sorted values cut into at most n_buckets runs of near
    equal length (np.array_split), as (mean, count) pairs in order."""
    rows, _, starts = rows_by_group(gid, valid, n_groups)
    out = []
    for g in range(n_groups):
        vals = np.sort(vdata[rows[starts[g]:starts[g + 1]]])
        if not len(vals):
            out.append(())
            continue
        bins = np.array_split(vals, max(min(n_buckets, len(vals)), 1))
        out.append(tuple(sorted((float(np.mean(b)), float(len(b)))
                                for b in bins if len(b))))
    return out


# ---- UNNEST -----------------------------------------------------------------


class UnnestTables:
    """What UNNEST needs of an ARRAY dictionary, built once on the host
    and kept beside it (`Dictionary.derived`).

    - lens[i], starts[i]: entry i's length and first position in the
      flat element list
    - static (reference: _unnest_static): the element dictionary (non-NULL
      strings sorted, nested values by repr), each flat element's code or
      value and whether it is non-NULL
    - dynamic (reference: _exec_unnest, which builds the element column
      from the live elements): for strings the sorted distinct texts
      with a NULL element as the text 'None' (the reference's
      np.asarray(..., dtype=object).astype(str)), for numbers a NULL as
      NaN (DOUBLE) or False (BOOLEAN), or a TypeError where an integer
      column cannot hold it."""

    def __init__(self, dictionary: Dictionary, elem_t: T.Type):
        dvals = dictionary.values
        lens = np.fromiter((len(t) for t in dvals), np.int64, len(dvals))
        self.lens = lens
        self.starts = np.concatenate([[0], np.cumsum(lens)[:-1]]) \
            .astype(np.int64) if len(lens) else np.zeros(0, np.int64)
        self.maxlen = int(lens.max()) if len(lens) else 0
        flat = [e for t in dvals for e in t]
        self.n_flat = len(flat)
        present = np.fromiter((e is not None for e in flat), bool, len(flat))
        self.present = present
        self.nested = elem_t.name in ("ARRAY", "MAP", "ROW")
        self.coded = elem_t.is_string or self.nested
        if self.coded:
            uniq = {e for e in flat if e is not None}
            order = sorted(uniq) if elem_t.is_string else sorted(uniq,
                                                                 key=repr)
            index = {e: i for i, e in enumerate(order)}
            edict = np.empty(len(order), dtype=object)
            edict[:] = order
            self.edict = Dictionary(edict)
            self.values = np.fromiter(
                (index[e] if e is not None else 0 for e in flat), np.int32,
                len(flat))
            if elem_t.is_string:
                texts = np.asarray(flat, dtype=object).astype(str) \
                    if flat else np.empty(0, dtype=str)
                self.texts, inv = np.unique(texts, return_inverse=True)
                self.text_codes = inv.reshape(-1).astype(np.int32)
        else:
            self.edict = None
            dt = elem_t.numpy_dtype()
            self.values = np.asarray([0 if e is None else e for e in flat],
                                     dtype=dt)
            self.dynamic_null = None
            if not present.all():
                if np.issubdtype(dt, np.floating):
                    self.dynamic_null = np.nan
                elif dt == np.bool_:
                    self.dynamic_null = False

    def matrix(self):
        """The static executor's (entries x maxlen) element matrix and
        validity, row-major and flattened."""
        m = max(self.maxlen, 1)
        n = max(len(self.lens), 1)
        mat = np.zeros(n * m, dtype=self.values.dtype)
        ok = np.zeros(n * m, dtype=bool)
        if self.n_flat:
            entry = np.repeat(np.arange(len(self.lens)), self.lens)
            slot = np.arange(self.n_flat) - self.starts[entry]
            cell = entry * m + slot
            mat[cell] = self.values
            ok[cell] = self.present
        return mat, ok


def unnest_tables(dictionary: Dictionary, elem_t: T.Type) -> UnnestTables:
    return dictionary.derived(("unnest", elem_t),
                              lambda: UnnestTables(dictionary, elem_t))
