"""Host builders of the aggregates whose states are sketches or other
host values: approx_set, merge, qdigest_agg, tdigest_agg, map_union_sum,
approx_most_frequent, min_by / max_by with a count, reduce_agg, and
approx_percentile over an ARRAY of percentiles or with a weight.

Reference: presto_tpu/exec/executor.py (the sketch branch of
`_agg_column`, `_agg_column_host` and `_approx_percentile_host`), which
the dynamic executor alone runs (the static one raises StaticFallback,
exec/executor.py).  The reference loops over the input rows in Python;
here one stable argsort of the group ids orders the rows by group and,
within a group, by row (collections.rows_by_group), and each group's
slice goes to the builder whole.  The results are the reference's:

- an HLL register keeps a maximum, so each distinct value is hashed
  once (distinct by the bytes the hash reads: floats by their bit
  pattern) and each group's registers take the maximum over its rows
  (sketches.hll_from_hashes);
- a q-digest sorts its values first, so their order is free;
- a t-digest takes the group's float64 values and weights in row order,
  as the reference's lists hold them, and a merge the group's blobs in
  row order;
- approx_most_frequent counts each distinct (group, value) at once and
  orders the counts by (-count, repr), as the reference does;
- min_by / max_by with a count orders each group by (key, row), which is
  Python's stable sort by key over the rows in order (reverse=True keeps
  the order of equal keys too);
- reduce_agg applies its input lambda to every row and then combines
  each group's states pairwise, level by level, one lambda call a level,
  the pairs in the reference's order, so floats add as they add there;
- approx_percentile reads each group's (value, cumulative weight) in row
  order, as the reference's boolean mask does;
- map_union_sum adds each group's map values in row order.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Column, Dictionary, upload
from presto_tpu_torch.exec import collections as CL
from presto_tpu_torch.functions import scalar as S
from presto_tpu_torch.functions import sketches as SK
from presto_tpu_torch.functions import tdigest as TD


def numeric_values(data: np.ndarray, typ: T.Type) -> np.ndarray:
    """A numeric column's values as float64, a short decimal scaled (the
    reference's float of each value)."""
    if typ.is_decimal:
        if data.ndim == 2:
            raise NotImplementedError(
                "a sketch of a long DECIMAL is not ported")
        return data.astype(np.float64) / (10 ** typ.decimal_scale)
    return np.asarray(data, np.float64)


def _hash_ids(data: np.ndarray, dictionary: Optional[Dictionary]):
    """Equal ids for values whose hash reads equal bytes: dictionary codes,
    integers and booleans by value, floats by bit pattern."""
    if dictionary is None and data.dtype.kind == "f":
        data = data.astype(np.float64).view(np.int64)
    return CL.value_ids(data, dictionary)


def approx_set(gid, valid, data, dictionary, typ, n_groups) -> List[bytes]:
    """Each group's HLL: every distinct value hashed once, each group's
    registers the largest rho of its rows' hashes."""
    if dictionary is None and typ.is_decimal:
        data, dictionary = numeric_values(data, typ), None
    rows, _, starts = CL.rows_by_group(gid, valid, n_groups)
    _, first, inverse = np.unique(_hash_ids(data, dictionary)[rows],
                                  return_index=True, return_inverse=True)
    hashes = SK.hash_all(CL.host_values(data[rows[first]], dictionary))
    h = hashes[inverse.reshape(-1)]
    return [SK.hll_from_hashes(h[starts[g]:starts[g + 1]])
            for g in range(n_groups)]


def qdigest_agg(gid, valid, data, typ, n_groups) -> List[bytes]:
    x = numeric_values(data, typ)
    rows, _, starts = CL.rows_by_group(gid, valid, n_groups)
    return [SK.qdigest_from_values(x[rows[starts[g]:starts[g + 1]]])
            for g in range(n_groups)]


def tdigest_agg(gid, valid, data, typ, weights, compression,
                n_groups) -> List[bytes]:
    x = numeric_values(data, typ)
    rows, _, starts = CL.rows_by_group(gid, valid, n_groups)
    out = []
    for g in range(n_groups):
        r = rows[starts[g]:starts[g + 1]]
        out.append(TD.tdigest_from_values(
            x[r], None if weights is None else weights[r],
            compression=compression))
    return out


def merge(gid, valid, data, dictionary, typ, n_groups) -> List[bytes]:
    rows, _, starts = CL.rows_by_group(gid, valid, n_groups)
    blobs = CL.host_values(data[rows], dictionary)
    fn = SK.hll_merge if typ.name in ("HLL", "P4HLL") \
        else TD.tdigest_merge if typ.name == "TDIGEST" else SK.qdigest_merge
    return [fn(blobs[starts[g]:starts[g + 1]]) for g in range(n_groups)]


def map_union_sum(gid, valid, data, dictionary, n_groups) -> List[tuple]:
    """Each group's maps merged in row order, a key's values summed (a
    NULL value counts only where the key has no other)."""
    rows, _, starts = CL.rows_by_group(gid, valid, n_groups)
    maps = CL.host_values(data[rows], dictionary)
    out = []
    for g in range(n_groups):
        acc: dict = {}
        for m in maps[starts[g]:starts[g + 1]]:
            for k, mv in m:
                if mv is None:
                    acc.setdefault(k, None)
                else:
                    cur = acc.get(k)
                    acc[k] = mv if cur is None else cur + mv
        out.append(tuple(sorted(acc.items(), key=lambda p: repr(p[0]))))
    return out


def approx_most_frequent(gid, take, data, dictionary, buckets: int,
                         n_groups):
    """(each group's top `buckets` values by count as (value, count) pairs
    ordered by repr, whether the group counted any value)."""
    rows, _, _ = CL.rows_by_group(gid, take, n_groups)
    counts = [[] for _ in range(n_groups)]
    if len(rows):
        _, first, cnt = CL._first_of_each(*CL._group_keys(
            gid, CL.value_ids(data, dictionary), rows))
        first_r = rows[first]
        for g, k, c in zip(gid[first_r].tolist(),
                           CL.host_values(data[first_r], dictionary),
                           cnt.tolist()):
            counts[g].append((k, c))
    tuples = [tuple(sorted(sorted(g, key=lambda p: (-p[1], repr(p[0])))
                           [:buckets], key=lambda p: repr(p[0])))
              for g in counts]
    return tuples, np.asarray([len(g) > 0 for g in counts], bool)


def _dictionary_ranks(dictionary: Dictionary) -> np.ndarray:
    """Each dictionary entry's rank in Python's order of the values (equal
    values, equal ranks)."""
    vals = CL.host_values(np.arange(len(dictionary)), dictionary)
    order = sorted(range(len(vals)), key=vals.__getitem__)
    rank = np.zeros(max(len(vals), 1), np.int64)
    for pos in range(1, len(order)):
        i, j = order[pos], order[pos - 1]
        rank[i] = rank[j] + (vals[i] != vals[j])
    return rank


def _top_n(key: np.ndarray, n: int, is_min: bool) -> np.ndarray:
    """Positions of the n least (is_min) or greatest keys, equal keys in
    position order: Python's stable sort of the positions by key, cut to
    n, over the candidates at or past the n-th key alone."""
    if len(key) > n > 0:
        kth = np.partition(key, n - 1 if is_min else len(key) - n)[
            n - 1 if is_min else len(key) - n]
        cand = np.flatnonzero(key <= kth if is_min else key >= kth)
    else:
        cand = np.arange(len(key))
    rank = np.unique(key[cand], return_inverse=True)[1].reshape(-1)
    return cand[np.argsort(rank if is_min else -rank, kind="stable")][:n]


def min_max_by_n(gid, take, xdata, xdict, xvalid, ydata, ydict, n: int,
                 is_min: bool, n_groups) -> List[tuple]:
    """Each group's values of the n rows of least (is_min) or greatest
    key, equal keys in row order.  A float key with a NaN in the group
    sorts as the reference's does, by Python's sort of the group's rows
    (NaN orders against nothing there)."""
    rows, _, starts = CL.rows_by_group(gid, take, n_groups)
    key = _dictionary_ranks(ydict)[np.clip(ydata[rows], 0, None)] \
        if ydict is not None else ydata[rows]
    n = max(n, 0)
    out = []
    for k in range(n_groups):
        grp, seg = rows[starts[k]:starts[k + 1]], key[starts[k]:starts[k + 1]]
        if seg.dtype.kind == "f" and np.isnan(seg).any():
            order = sorted(range(len(seg)), key=seg.tolist().__getitem__,
                           reverse=not is_min)
            top = grp[np.asarray(order[:n], np.int64)]
        else:
            top = grp[_top_n(seg, n, is_min)]
        vals = CL.host_values(xdata[top], xdict)
        ok = xvalid[top].tolist()
        out.append(tuple(v if o else None for v, o in zip(vals, ok)))
    return out


def reduce_agg(gid, valid, data, dictionary, col_type: T.Type, init,
               in_lam, comb_lam, state_type: T.Type, n_groups) -> list:
    """Each group's state: the input lambda over (init, value) for every
    row, then a pairwise combine per level, as in the reference."""
    rows = np.flatnonzero(valid)
    vals = CL.host_values(data[rows], dictionary)
    if len(vals):
        states = S._pylist_from_colval(in_lam.apply({
            in_lam.params[0]: S._colval_from_pylist(
                [init] * len(vals), state_type),
            in_lam.params[1]: S._colval_from_pylist(vals, col_type)}),
            len(vals))
    else:
        states = []
    g = gid[rows]
    keep = (g >= 0) & (g < n_groups)
    # each group's states in row order, groups in order
    order = np.argsort(g[keep], kind="stable")
    flat = [states[i] for i in np.flatnonzero(keep)[order].tolist()]
    lens = np.bincount(g[keep], minlength=n_groups)[:n_groups] \
        if n_groups else np.zeros(0, np.int64)
    while (lens > 1).any():
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        pairs = lens // 2
        # the left state of every pair, group by group
        base = np.repeat(starts, pairs)
        step = np.arange(int(pairs.sum())) - np.repeat(
            np.cumsum(pairs) - pairs, pairs)
        left = (base + 2 * step).tolist()
        combined = S._pylist_from_colval(comb_lam.apply({
            comb_lam.params[0]: S._colval_from_pylist(
                [flat[i] for i in left], state_type),
            comb_lam.params[1]: S._colval_from_pylist(
                [flat[i + 1] for i in left], state_type)}), len(left))
        nxt, c = [], 0
        for k, (p, ln) in enumerate(zip(pairs.tolist(), lens.tolist())):
            nxt.extend(combined[c:c + p])
            c += p
            if ln % 2:
                nxt.append(flat[starts[k] + ln - 1])
        flat = nxt
        lens = pairs + lens % 2
    out, pos = [], 0
    for ln in lens.tolist():
        out.append(flat[pos] if ln else None)
        pos += ln
    return out


def approx_percentile(gid, valid, data, typ, weights, ps, n_groups):
    """Each group's percentiles: the first value (in value order, rows in
    order among equal values) whose cumulative weight reaches p times the
    group's total; None for a group without a row of positive weight."""
    x = numeric_values(data, typ)
    rows, _, starts = CL.rows_by_group(gid, valid & (weights > 0), n_groups)
    outs = []
    for g in range(n_groups):
        r = rows[starts[g]:starts[g + 1]]
        if not len(r):
            outs.append(None)
            continue
        v, w = x[r], weights[r]
        o = np.argsort(v, kind="stable")
        v, w = v[o], w[o]
        cw = np.cumsum(w)
        qs = []
        for p in ps:
            i = int(np.searchsorted(cw, float(p) * cw[-1], side="left"))
            qs.append(float(v[min(i, len(v) - 1)]))
        outs.append(tuple(qs))
    return outs


def percentile_column(outs, array_out: bool, typ: T.Type, nonempty,
                      device) -> Column:
    """approx_percentile's host results as its column: an ARRAY a group
    (integers truncated for an integer element type), or the first
    percentile (rounded for an integer type)."""
    ok = upload(np.asarray([t is not None for t in outs], bool), device) \
        & nonempty
    if array_out:
        et = typ.params[0]
        tuples = [() if t is None else
                  (tuple(int(x) for x in t) if et.is_integer else t)
                  for t in outs]
        return CL.tuples_to_dict_column(tuples, ok, typ, device)
    vals = np.asarray([0.0 if t is None else t[0] for t in outs])
    if typ.is_integer:
        vals = np.rint(vals)
    return Column(upload(vals.astype(typ.numpy_dtype()), device), ok, typ)


# ---------------------------------------------------------------------------
# the ML aggregates (reference: the learn_*, evaluate_classifier_predictions
# and classification_* branches of _agg_column): each group's rows in row
# order, as the reference's boolean masks select them
# ---------------------------------------------------------------------------


def _group_slices(gid, valid, n_groups):
    """Each group's valid rows, ascending."""
    rows, _, starts = CL.rows_by_group(gid, valid, n_groups)
    return [rows[starts[g]:starts[g + 1]] for g in range(n_groups)]


def learn(fn: str, gid, valid, labels: np.ndarray, feats: np.ndarray,
          n_groups: int) -> list:
    """learn_classifier / learn_regressor: one model blob a group (b""
    for a group without rows), trained by functions/ml.py on the group's
    labels and feature rows."""
    from presto_tpu_torch.functions import ml as ML

    blobs = []
    for rows in _group_slices(gid, valid, n_groups):
        if not len(rows):
            blobs.append(b"")
        elif fn == "learn_classifier":
            blobs.append(ML.train_classifier(labels[rows], feats[rows]))
        else:
            blobs.append(ML.train_regressor(
                labels[rows].astype(np.float64), feats[rows]))
    return blobs


def _label_ids(data: np.ndarray, dictionary, index: dict) -> np.ndarray:
    """Each row's label as an id into `index` ({value: id}, extended
    with the values not in it yet): equal Python values (1 and 1.0 too)
    share an id, as the reference's `==` of host values does."""
    if dictionary is not None:
        codes = np.clip(data, 0, max(len(dictionary) - 1, 0))
        uniq, inverse = np.unique(codes, return_inverse=True)
        values = CL.host_values(uniq, dictionary) if len(uniq) else []
    else:
        uniq, inverse = np.unique(data, return_inverse=True)
        values = CL.host_values(uniq, None)
    ids = np.fromiter((index.setdefault(v, len(index)) for v in values),
                      np.int64, len(values))
    return ids[inverse.reshape(-1)] if len(values) else \
        np.zeros(len(data), np.int64)


def evaluate_predictions(gid, valid, truth, truth_dict, pred, pred_dict,
                         n_groups: int) -> list:
    """evaluate_classifier_predictions(truth, prediction): each group's
    accuracy and per-label precision and recall as text, labels in repr
    order (reference: presto-ml EvaluateClassifierPredictionsAggregation).
    The labels are compared as ids of their host values (_label_ids), so
    the per-row work is integer numpy."""
    index: dict = {}
    t_all = _label_ids(truth, truth_dict, index)
    p_all = _label_ids(pred, pred_dict, index)
    labels = list(index)
    texts = []
    for rows in _group_slices(gid, valid, n_groups):
        n = len(rows)
        if n == 0:
            texts.append("")
            continue
        t, p = t_all[rows], p_all[rows]
        correct = int((t == p).sum())
        lines = [f"Accuracy: {correct}/{n} ({100.0 * correct / n:.2f}%)"]
        ap_all = np.bincount(t, minlength=len(labels))
        pp_all = np.bincount(p, minlength=len(labels))
        tp_all = np.bincount(t[t == p], minlength=len(labels))
        present = np.flatnonzero((ap_all > 0) | (pp_all > 0))
        for i in sorted(present.tolist(), key=lambda i: repr(labels[i])):
            lab = labels[i]
            tp, pp, ap = int(tp_all[i]), int(pp_all[i]), int(ap_all[i])
            if pp:
                lines.append(f"Precision({lab}): {tp}/{pp} "
                             f"({100.0 * tp / pp:.2f}%)")
            if ap:
                lines.append(f"Recall({lab}): {tp}/{ap} "
                             f"({100.0 * tp / ap:.2f}%)")
        texts.append("\n".join(lines))
    return texts


def classification(fn: str, gid, valid, truth: np.ndarray,
                   pred: np.ndarray, wts: Optional[np.ndarray],
                   buckets: int, n_groups: int) -> list:
    """classification_{miss_rate, fall_out, precision, recall,
    thresholds}: a tuple of doubles a group at the thresholds
    i / buckets (a prediction at or above one counts as a positive
    call); an undefined ratio is None.  wts None: every row weighs 1."""
    th = np.arange(buckets) / buckets
    weighted = wts is not None
    out_rows = []
    for rows in _group_slices(gid, valid, n_groups):
        if not len(rows):
            out_rows.append(())
            continue
        t, p = truth[rows], pred[rows]
        if weighted:
            w = wts[rows]
            pos = p[:, None] >= th[None, :]  # (rows, buckets)
            tp = (w[:, None] * (pos & t[:, None])).sum(0)
            fp = (w[:, None] * (pos & ~t[:, None])).sum(0)
            fn_ = (w[:, None] * (~pos & t[:, None])).sum(0)
            tn = (w[:, None] * (~pos & ~t[:, None])).sum(0)
        else:
            # unit weights: the sums are counts, exact in float64 in any
            # order, so each row adds to the thresholds at or below its
            # prediction through one bincount of how many it passes
            passed = np.where(np.isnan(p), 0,  # NaN passes no threshold
                              np.searchsorted(th, p, side="right"))
            pos_t = np.bincount(passed[t], minlength=buckets + 1)
            pos_f = np.bincount(passed[~t], minlength=buckets + 1)
            tp = np.cumsum(pos_t[::-1])[::-1][1:].astype(np.float64)
            fp = np.cumsum(pos_f[::-1])[::-1][1:].astype(np.float64)
            fn_ = float(t.sum()) - tp
            tn = float((~t).sum()) - fp
        with np.errstate(invalid="ignore", divide="ignore"):
            if fn == "classification_thresholds":
                out = th
            elif fn == "classification_precision":
                out = tp / (tp + fp)
            elif fn == "classification_recall":
                out = tp / (tp + fn_)
            elif fn == "classification_miss_rate":
                out = fn_ / (tp + fn_)
            else:  # fall_out
                out = fp / (fp + tn)
        out_rows.append(tuple(None if np.isnan(x) else float(x)
                              for x in np.broadcast_to(out, th.shape)))
    return out_rows
