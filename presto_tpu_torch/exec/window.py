"""Window function execution on torch tensors.

Reference: presto_tpu/exec/window.py.  The batch is sorted once by
(liveness, partition keys, order keys) and every function is a
vectorized prefix or segment scan over the sorted columns: ranking from
the partition and peer bounds, lag/lead and the value functions as
gathers, count/sum/avg and the variance family as prefix-sum
differences over per-row [frame start, frame end] bounds, min/max as
segmented scans or, for bounded ROWS frames, a sparse table.  The frame
shape is decided from the spec, never from the data.

Masked rows sort last and form their own partition runs (liveness is
the leading partition key), so the static executor needs no compaction:
their outputs stay masked.  The dynamic executor compacts first.

One difference from the reference is deliberate: the partition and
peer bounds come from one running count of the change flags (each row's
run id) and one scatter of each run's start position, where the
reference takes four cummax/cummin scans.  The positions are the same
integers.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.exec import kernels as K
from presto_tpu_torch.functions.scalar import torch_dtype
from presto_tpu_torch.plan import ir
from presto_tpu_torch.plan import nodes as P


class WindowError(Exception):
    pass


def execute_window(ex, node: P.Window) -> Batch:
    b = ex.exec_node(node.source)
    if not ex.static:
        b = K.compact(b)
    n = b.capacity
    # sort by (liveness, partition keys ASC, order keys as specified):
    # sort_perm puts masked rows last, and liveness as the leading
    # partition key fences them into runs of their own
    keys = [(b.columns[s], True, None) for s in node.partition_by]
    keys += [(b.columns[s], asc, nf) for s, asc, nf in node.order_by]
    if keys or (ex.static and n):
        # the static executor sorts even for OVER (): interleaved masked
        # rows would split the one partition into runs by liveness
        b = K.gather_batch(b, K.sort_perm(b, keys))
    cols = dict(b.columns)
    if n == 0:
        for sym, call in node.functions.items():
            cols[sym] = Column(torch.zeros(0, dtype=torch_dtype(call.type),
                                           device=b.device),
                               None, call.type, None)
        return Batch(cols, b.sel)
    live_col = Column(b.sel, None, T.BOOLEAN)
    part_cols = [live_col] + [b.columns[s] for s in node.partition_by]
    order_cols = [b.columns[s] for s, _, _ in node.order_by]
    ctx = _FrameContext(n, part_cols, order_cols, bool(node.order_by),
                        node.frame, b.device)
    for sym, call in node.functions.items():
        cols[sym] = _compute(ctx, b, call)
    return Batch(cols, b.sel)


def _adjacent_change(cols: List[Column], n: int,
                     device: torch.device) -> torch.Tensor:
    """new[i]: row i differs from row i - 1 on some column (NULLs equal);
    new[0] is set.  (Built by concatenation: storing a Python scalar into
    a CUDA tensor synchronizes, which graph capture forbids.)"""
    rest = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=device)
    for c in cols:
        d = c.data
        diff = d[1:] != d[:-1]
        v = c.valid
        if v is not None:
            both_null = ~v[1:] & ~v[:-1]
            diff = torch.where(both_null, False, diff | (v[1:] != v[:-1]))
        rest = rest | diff
    return torch.cat([torch.ones(1, dtype=torch.bool, device=device), rest])


def _run_bounds(new: torch.Tensor, ar: torch.Tensor):
    """(start, end): the first and last position of each row's run,
    where `new` flags each run's first row.  The run id is the running
    count of the flags; one scatter puts each run's start at its id
    (positions past the last run stay n), and a run ends where the next
    one starts.  No host read, and the same integers as the reference's
    cummax/cummin scans."""
    n = new.shape[0]
    rid = torch.cumsum(new.to(torch.int64), 0) - 1
    starts = torch.full((n + 2,), n, dtype=torch.int64, device=new.device)
    # rows that start no run write to the spare slot n + 1
    starts.scatter_(0, torch.where(new, rid, n + 1), ar)
    return starts[rid], starts[rid + 1] - 1


class _FrameContext:
    """One window spec's row geometry: partition and peer bounds and the
    frame bounds (reference: WindowPartition's frame computation)."""

    def __init__(self, n, part_cols, order_cols, has_order, frame, device):
        self.n = n
        ar = torch.arange(n, dtype=torch.int64, device=device)
        self.ar = ar
        self.part_new = _adjacent_change(part_cols, n, device)
        # no ORDER BY: every row of a partition is a peer of every other
        if order_cols:
            self.peer_new = self.part_new | _adjacent_change(order_cols, n,
                                                             device)
        else:
            self.peer_new = self.part_new
        self.part_start, self.part_end = _run_bounds(self.part_new, ar)
        self.part_size = self.part_end - self.part_start + 1
        if order_cols:
            self.peer_start, self.peer_end = _run_bounds(self.peer_new, ar)
        else:
            self.peer_start, self.peer_end = self.part_start, self.part_end
        self.rn = ar - self.part_start + 1
        self.has_order = has_order
        self.frame = frame

    def frame_bounds(self):
        """(fs, fe, shape): inclusive per-row bounds and the frame's shape
        from the spec: 'prefix' (fs is the partition start), 'suffix' (fe
        is its end), 'whole', 'single', 'peer' or 'sliding:<max width>'."""
        if self.frame is None:
            if self.has_order:
                ftype, start, end = ("RANGE", "UNBOUNDED PRECEDING",
                                     "CURRENT ROW")
            else:
                ftype, start, end = ("ROWS", "UNBOUNDED PRECEDING",
                                     "UNBOUNDED FOLLOWING")
        else:
            ftype, start, end = self.frame
        fs, s_off = self._bound(ftype, start, is_start=True)
        fe, e_off = self._bound(ftype, end, is_start=False)
        fs = torch.maximum(fs, self.part_start)
        fe = torch.minimum(fe, self.part_end)
        if start == "UNBOUNDED PRECEDING" and end == "UNBOUNDED FOLLOWING":
            shape = "whole"
        elif start == "UNBOUNDED PRECEDING":
            shape = "prefix"
        elif end == "UNBOUNDED FOLLOWING":
            shape = "suffix"
        elif ftype == "ROWS" and start == end == "CURRENT ROW":
            shape = "single"
        elif ftype == "RANGE" and start == end == "CURRENT ROW":
            shape = "peer"  # the whole peer group, of data-dependent width
        else:
            maxw = (s_off or 0) + (e_off or 0) + 1
            shape = f"sliding:{maxw}"
        return fs, fe, shape

    def _bound(self, ftype, spec, is_start):
        """(position per row, the static offset or None)."""
        ar = self.ar
        if spec == "UNBOUNDED PRECEDING":
            return self.part_start, None
        if spec == "UNBOUNDED FOLLOWING":
            return self.part_end, None
        if spec == "CURRENT ROW":
            if ftype == "ROWS":
                return ar, 0
            return (self.peer_start, None) if is_start \
                else (self.peer_end, None)
        k_str, direction = spec.split()
        k = int(k_str)
        if ftype != "ROWS":
            raise WindowError("RANGE with offset frame bounds not supported")
        return (ar - k if direction == "PRECEDING" else ar + k), k


# ---- function dispatch ------------------------------------------------------

def _compute(ctx: _FrameContext, b: Batch, call: ir.AggCall) -> Column:
    fn = call.fn
    if fn == "row_number":
        return _int_col(ctx.rn, call.type)
    if fn == "rank":
        return _int_col(ctx.peer_start - ctx.part_start + 1, call.type)
    if fn == "dense_rank":
        dr = torch.cumsum(ctx.peer_new.to(torch.int64), 0)
        return _int_col(dr - dr[ctx.part_start] + 1, call.type)
    if fn == "percent_rank":
        rank = ctx.peer_start - ctx.part_start + 1
        denom = torch.clamp(ctx.part_size - 1, min=1)
        out = torch.where(ctx.part_size > 1,
                          (rank - 1).to(torch.float64) / denom, 0.0)
        return Column(out.to(torch.float64), None, call.type, None)
    if fn == "cume_dist":
        out = (ctx.peer_end - ctx.part_start + 1).to(torch.float64) \
            / ctx.part_size
        return Column(out.to(torch.float64), None, call.type, None)
    if fn == "ntile":
        k = _lit_int(call.args[0], "ntile bucket count")
        if k < 1:
            raise WindowError("ntile bucket count must be positive")
        return _int_col(_ntile(ctx, k), call.type)
    if fn in ("lag", "lead"):
        return _lag_lead(ctx, b, call)
    if fn in ("first_value", "last_value", "nth_value"):
        return _value_fn(ctx, b, call)
    return _frame_aggregate(ctx, b, call)


def _int_col(a, t):
    return Column(a.to(torch.int64), None, t, None)


def _lit_int(e: ir.RowExpr, what: str) -> int:
    if isinstance(e, ir.Lit):
        return int(e.value)
    raise WindowError(f"{what} must be a literal")


def _ntile(ctx, k):
    rn0 = ctx.rn - 1
    size = ctx.part_size // k
    rem = ctx.part_size % k
    thresh = rem * (size + 1)
    big = torch.where(size > 0, rn0 // torch.clamp(size + 1, min=1), rn0)
    small = rem + torch.where(size > 0,
                              (rn0 - thresh) // torch.clamp(size, min=1), 0)
    return torch.where(rn0 < thresh, big, small) + 1


def _arg_column(b: Batch, e: ir.RowExpr) -> Column:
    if isinstance(e, ir.Ref):
        return b.columns[e.name]
    if isinstance(e, ir.Lit):
        n = b.capacity
        if e.type.is_string:
            raise WindowError("string literal window argument")
        d = torch.full((n,), e.value if e.value is not None else 0,
                       dtype=torch_dtype(e.type), device=b.device)
        v = None if e.value is not None \
            else torch.zeros(n, dtype=torch.bool, device=b.device)
        return Column(d, v, e.type, None)
    raise WindowError("window argument must be a column or literal")


def _gather_col(c: Column, idx, in_frame) -> Column:
    d = c.data
    safe = idx.clamp(0, d.shape[0] - 1).long()
    out = d[safe]
    valid = in_frame
    if c.valid is not None:
        valid = valid & c.valid[safe]
    if c.type.is_string and c.dictionary is None:
        raise WindowError("non-dictionary string window values")
    out = torch.where(valid, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))
    return Column(out, valid, c.type, c.dictionary)


def _nn_machinery(ctx, src):
    """(inclusive count of non-NULLs, exclusive count, validity) over the
    sorted rows: the basis of IGNORE NULLS, where the m-th non-NULL's
    position is searchsorted(count, m) (reference: the value functions'
    nullTreatment)."""
    valid = src.valid if src.valid is not None \
        else torch.ones(ctx.n, dtype=torch.bool, device=ctx.ar.device)
    cnt = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32)
    return cnt, cnt - valid.to(torch.int32), valid


def _lag_lead(ctx, b, call):
    off = _lit_int(call.args[1], "offset") if len(call.args) > 1 else 1
    src = _arg_column(b, call.args[0])
    if getattr(call, "ignore_nulls", False):
        cnt, cnt0, _valid = _nn_machinery(ctx, src)
        if call.fn == "lag":
            # the off-th non-NULL strictly before this row
            m = cnt0 - off + 1
            in_part = m >= cnt0[ctx.part_start] + 1
        else:
            # the off-th non-NULL strictly after this row
            m = cnt + off
            in_part = m <= cnt[ctx.part_end]
        m = torch.clamp(m, min=1)
        idx = torch.searchsorted(cnt, m).to(torch.int32)
    elif call.fn == "lag":
        idx = ctx.ar - off
        in_part = idx >= ctx.part_start
    else:
        idx = ctx.ar + off
        in_part = idx <= ctx.part_end
    out = _gather_col(src, idx, in_part)
    if len(call.args) > 2:  # the default fills rows outside the partition
        dflt = _arg_column(b, call.args[2])
        same_dict = out.dictionary is dflt.dictionary
        if out.type.is_string and not same_dict:
            raise WindowError(
                "lag/lead string default requires matching encoding")
        use_d = ~in_part
        d = torch.where(use_d, dflt.data, out.data)
        ones = torch.ones(ctx.n, dtype=torch.bool, device=d.device)
        valid = torch.where(
            use_d,
            dflt.valid if dflt.valid is not None else ones,
            out.valid if out.valid is not None else ones)
        out = Column(d, valid, out.type, out.dictionary)
    return out


def _value_fn(ctx, b, call):
    src = _arg_column(b, call.args[0])
    fs, fe, _shape = ctx.frame_bounds()
    nonempty = fs <= fe
    if getattr(call, "ignore_nulls", False):
        cnt, cnt0, _valid = _nn_machinery(ctx, src)
        if call.fn == "first_value":
            m = cnt0[fs] + 1  # the first non-NULL at or after the start
        elif call.fn == "last_value":
            m = cnt[fe]  # the last non-NULL at or before the end
        else:
            k = _lit_int(call.args[1], "nth_value offset")
            if k < 1:
                raise WindowError("nth_value offset must be positive")
            m = cnt0[fs] + k
        nonempty = nonempty & (m >= cnt0[fs] + 1) & (m <= cnt[fe])
        idx = torch.searchsorted(cnt, torch.clamp(m, min=1)).to(torch.int32)
        return _gather_col(src, idx, nonempty)
    if call.fn == "first_value":
        idx = fs
    elif call.fn == "last_value":
        idx = fe
    else:
        k = _lit_int(call.args[1], "nth_value offset")
        if k < 1:
            raise WindowError("nth_value offset must be positive")
        idx = fs + k - 1
        nonempty = nonempty & (idx <= fe)
    return _gather_col(src, idx, nonempty)


# ---- aggregates over frames -------------------------------------------------

def _prefix_at(csum, idx):
    """The sum of x[0..idx] from the inclusive prefix csum; idx may be
    -1."""
    return torch.where(idx >= 0, csum[idx.clamp(0, csum.shape[0] - 1)], 0)


def _frame_aggregate(ctx, b, call):
    fn = call.fn
    fs, fe, shape = ctx.frame_bounds()
    nonempty = fs <= fe
    if fn == "count" and not call.args:
        cnt = torch.where(nonempty, fe - fs + 1, 0)
        return _int_col(cnt, call.type)

    src = _arg_column(b, call.args[0]) if call.args else None
    d = src.data
    notnull = src.valid if src.valid is not None \
        else torch.ones(ctx.n, dtype=torch.bool, device=d.device)
    cs = torch.cumsum(notnull.to(torch.int64), 0)
    cnt = _prefix_at(cs, fe) - _prefix_at(cs, fs - 1)
    cnt = torch.where(nonempty, cnt, 0)
    if fn == "count":
        return _int_col(cnt, call.type)

    if fn in ("sum", "avg", "stddev", "stddev_samp", "stddev_pop",
              "variance", "var_samp", "var_pop"):
        if src.type.is_string:
            raise WindowError(f"{fn} over strings")
        acc = torch.float32 if d.dtype == torch.float32 else torch.float64
        x = torch.where(notnull, d, torch.zeros((), dtype=d.dtype,
                                                device=d.device)).to(acc)
        s = torch.cumsum(x, 0)
        tot = _prefix_at(s, fe) - _prefix_at(s, fs - 1)
        valid = nonempty & (cnt > 0)
        if fn == "sum":
            if call.type.is_integer or call.type.name == "DECIMAL":
                si = torch.cumsum(torch.where(
                    notnull, d, torch.zeros((), dtype=d.dtype,
                                            device=d.device)
                ).to(torch.int64), 0)
                tot = _prefix_at(si, fe) - _prefix_at(si, fs - 1)
            return Column(tot, valid, call.type, None)
        mean = tot / torch.clamp(cnt, min=1)
        if fn == "avg":
            return Column(mean.to(torch.float64), valid, call.type, None)
        s2 = torch.cumsum(x * x, 0)
        tot2 = _prefix_at(s2, fe) - _prefix_at(s2, fs - 1)
        m2 = tot2 - tot * tot / torch.clamp(cnt, min=1)
        if fn in ("stddev", "stddev_samp", "variance", "var_samp"):
            denom = torch.clamp(cnt - 1, min=1)
            valid = valid & (cnt > 1)
        else:
            denom = torch.clamp(cnt, min=1)
        var = torch.clamp(m2 / denom, min=0.0)
        out = torch.sqrt(var) if fn.startswith("stddev") else var
        return Column(out.to(torch.float64), valid, call.type, None)

    if fn in ("min", "max"):
        return _minmax(ctx, src, d, notnull, fs, fe, shape,
                       nonempty & (cnt > 0), call)
    raise WindowError(f"window aggregate {fn} not supported")


def _segmented_scan(vals, seg_new, op, identity):
    """Hillis-Steele segmented inclusive scan: log2(n) vectorized
    passes."""
    n = vals.shape[0]
    res = vals
    flag = seg_new
    shift = 1
    while shift < n:
        prev = torch.cat([torch.full((shift,), identity, dtype=res.dtype,
                                     device=res.device), res[:-shift]])
        prev_flag = torch.cat([torch.ones(shift, dtype=torch.bool,
                                          device=flag.device),
                               flag[:-shift]])
        res = torch.where(flag, res, op(res, prev))
        flag = flag | prev_flag
        shift <<= 1
    return res


def _minmax(ctx, src, d, notnull, fs, fe, shape, valid, call):
    op = torch.minimum if call.fn == "min" else torch.maximum
    if src.type.is_string and src.dictionary is None:
        raise WindowError("min/max over non-dictionary strings")
    if d.is_floating_point() and src.dictionary is None:
        work = d.to(torch.float64)
        ident = np.inf if call.fn == "min" else -np.inf
    else:
        # dictionary codes are sorted and unique: their order is the
        # strings' order
        work = d.to(torch.int64)
        ident = int(K.I64_MAX if call.fn == "min" else K.I64_MIN)
    work = torch.where(notnull, work, torch.full((), ident, dtype=work.dtype,
                                                 device=work.device))
    n = ctx.n
    # the frame shape comes from the spec: the strategy never branches
    # on data
    if shape in ("prefix", "whole"):
        run_fwd = _segmented_scan(work, ctx.part_new, op, ident)
        raw = run_fwd[fe.clamp(0, n - 1)]
    elif shape == "peer":
        # the frame is the peer group: a forward scan over peer runs,
        # read at each row's peer end (fe)
        run_fwd = _segmented_scan(work, ctx.peer_new, op, ident)
        raw = run_fwd[fe.clamp(0, n - 1)]
    elif shape == "suffix":
        nxt = torch.cat([ctx.part_new[1:],
                         torch.ones(1, dtype=torch.bool, device=work.device)])
        run_bwd = torch.flip(_segmented_scan(
            torch.flip(work, (0,)), torch.flip(nxt, (0,)), op, ident), (0,))
        raw = run_bwd[fs.clamp(0, n - 1)]
    elif shape == "single":
        raw = work[fs.clamp(0, n - 1)]
    else:  # sliding:<max width>
        maxw = int(shape.split(":")[1])
        raw = _minmax_sliding(work, fs, fe, op, ident, maxw)
    out = torch.where(valid, raw, torch.zeros((), dtype=raw.dtype,
                                              device=raw.device))
    if src.dictionary is not None:
        out = out.to(d.dtype)
    return Column(out, valid, call.type, src.dictionary)


def _minmax_sliding(work, fs, fe, op, ident, max_w):
    """Bounded ROWS frames: a sparse table (doubling) range min/max,
    O(n log w) to build and O(1) a row; max_w comes from the frame
    spec's offsets."""
    n = work.shape[0]
    width = fe - fs + 1
    levels = [work]
    span = 1
    while span < max(max_w, 1):
        cur = levels[-1]
        nxt = op(cur, torch.cat([cur[span:],
                                 torch.full((span,), ident, dtype=cur.dtype,
                                            device=cur.device)]))
        levels.append(nxt)
        span <<= 1
    k = torch.clamp(width, min=1)
    lev = torch.floor(torch.log2(k.to(torch.float64))).to(torch.int64)
    span_arr = torch.bitwise_left_shift(torch.ones_like(lev), lev)
    out = torch.full((n,), ident, dtype=work.dtype, device=work.device)
    first = fs.clamp(0, n - 1)
    second = (fe - span_arr + 1).clamp(0, n - 1)
    for li, table in enumerate(levels):
        out = torch.where(lev == li, op(table[first], table[second]), out)
    return out
