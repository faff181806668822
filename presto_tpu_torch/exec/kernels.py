"""Relational kernels over columnar torch tensors.

Reference: presto_tpu/exec/kernels.py.  The slice of TPC-H Q1/Q3/Q6/Q18
needs key packing, sort-based grouping, segmented reductions, the ORDER
BY permutation, the join probe, packed row gathers (whose large staged
gathers run the block_gather CUDA kernel, exec/gather.py) and the fused
multi-aggregate reduction `fused_group_sums`, whose CUDA kernel lives in
presto_tpu_torch/csrc/fused_group_sums.cu.

Two differences from the reference's JAX code are deliberate:
- torch has no multi-operand sort, so lexicographic sorts are built
  from stable single-key sorts, minor key to major (`sort_perm`);
- torch's CPU kernels have no `>>` on unsigned integers, so the 64-bit
  mixing in `_hash_keys` runs on int64 bit patterns with the logical
  shift emulated by a mask (`_lsr`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.exec import gather as G

I64_MIN = np.iinfo(np.int64).min
I64_MAX = np.iinfo(np.int64).max
I32_MAX = np.iinfo(np.int32).max


def key_sentinel(key: torch.Tensor) -> int:
    """Masked-row sentinel for a packed key tensor: the dtype's max."""
    return I32_MAX if key.dtype == torch.int32 else I64_MAX


# ---------------------------------------------------------------------------
# key packing: N key columns -> one integer per row (exact, runtime ranges)
# ---------------------------------------------------------------------------


def pack_keys(cols: List[Column], sel: torch.Tensor,
              extra_cols: Optional[List[Column]] = None):
    """Pack key columns into a single integer key per row — int32 when
    the packed widths fit 30 bits, else int64.  Masked-out rows get the
    dtype's max as sentinel; NULL in any key column gets its own code.

    Returns (key, layout); layout is None when the packing would exceed
    62 bits and the key is a 64-bit hash instead."""
    def _minmax(col):
        d = _orderable_int(col)
        if d.shape[0] == 0:
            return I64_MAX, I64_MIN
        v = _valid_arr(col)
        return (int(torch.where(v, d, I64_MAX).min()),
                int(torch.where(v, d, I64_MIN).max()))

    parts = []
    for i, c in enumerate(cols):
        lo, hi = _minmax(c)
        if extra_cols is not None:
            elo, ehi = _minmax(extra_cols[i])
            lo, hi = min(lo, elo), max(hi, ehi)
        if hi < lo:  # all null / empty
            lo, hi = 0, 0
        parts.append((lo, hi - lo + 2))  # +1 for range, +1 for null code

    total_bits = sum(int(np.ceil(np.log2(max(card, 2)))) for _, card in parts)
    if total_bits > 62:
        return _hash_keys(cols, sel), None

    layout = _assign_strides(parts)
    key = _apply_layout(cols, layout)
    return torch.where(sel, key, key_sentinel(key)), layout


def _assign_strides(parts) -> list:
    """(lo, card) per column -> (lo, stride, width) with the FIRST column
    most significant: ascending packed-key order == lexicographic order
    of the columns as listed."""
    widths = [int(np.ceil(np.log2(max(card, 2)))) for _, card in parts]
    layout = []
    stride = 1
    for (lo_h, _card), width in zip(reversed(parts), reversed(widths)):
        layout.append((lo_h, stride, width))
        stride <<= width
    layout.reverse()
    return layout


def _apply_layout(cols: List[Column], layout) -> torch.Tensor:
    total_bits = sum(w for _, _, w in layout)
    kt = torch.int32 if total_bits <= 30 else torch.int64
    key = None
    for c, (lo, stride, _width) in zip(cols, layout):
        d = _orderable_int(c)
        code = torch.where(_valid_arr(c), d - lo + 1, 0)  # 0 = null code
        contrib = code.to(kt) * stride
        key = contrib if key is None else key + contrib
    return key


_POW2 = None  # exact power-of-two table, built on first use


def _f64_orderable_arith(d: torch.Tensor) -> torch.Tensor:
    """Order-preserving, injective f64 -> i64 over the normal range, the
    reference's arithmetic construction: |x| = m * 2^e with e from log2
    plus comparison fixups and m recovered by an exact power-of-two table
    multiply.  Layout: normals map to (e+1023)*2^52 + mant52; negatives
    mirror; +-0 and subnormals map to 0; +-inf and NaN get sentinels
    with NaN largest (Presto sort order).  Bit for bit the keys of
    presto_tpu.exec.kernels._f64_orderable_arith."""
    global _POW2
    if _POW2 is None:
        _POW2 = torch.tensor([2.0 ** i for i in range(-1099, 1024)],
                             dtype=torch.float64)
    pow2 = _POW2.to(d.device)

    min_normal = 2.2250738585072014e-308
    ax = d.abs()
    e = torch.floor(torch.log2(ax.clamp_min(min_normal))).to(torch.int64)
    e = e.clamp(-1022, 1023)
    # ax * 2^-e in two half-exponent steps: 2^-1023 alone is subnormal
    e1 = e // 2
    e2 = e - e1
    m = (ax * pow2[1099 - e1]) * pow2[1099 - e2]  # exact
    # log2 can be off by one near power-of-two boundaries
    for _ in range(2):
        too_big = m >= 2.0
        e = torch.where(too_big, e + 1, e)
        m = torch.where(too_big, m * 0.5, m)
        too_small = m < 1.0
        e = torch.where(too_small & (e > -1022), e - 1, e)
        m = torch.where(too_small & (e >= -1022), m * 2.0, m)
    mant = (m * (2.0 ** 52)).to(torch.int64) - (1 << 52)
    key_norm = (e + 1023) * (1 << 52) + mant
    key_mag = torch.where(ax < min_normal, 0, key_norm)
    key = torch.where(d < 0, -key_mag, key_mag)
    key = torch.where(torch.isinf(d),
                      torch.where(d > 0, I64_MAX - 16, -(I64_MAX - 16)), key)
    return torch.where(torch.isnan(d), I64_MAX - 8, key)


def _f64_orderable_pair(d: torch.Tensor) -> torch.Tensor:
    """The reference's TPU key for f64: a lexicographic (hi, lo) float32
    pair packed into i64 through 32-bit bitcasts.  Monotone for all
    doubles, injective down to 48-bit significands.  Bit for bit the
    keys of presto_tpu.exec.kernels._f64_orderable_pair; the port groups
    and sorts with the exact `_f64_orderable_arith` on every device."""
    hi = d.to(torch.float32).clamp(-3.4e38, 3.4e38)
    lo = (d - hi.to(torch.float64)).to(torch.float32)
    lo = torch.where(torch.isfinite(d), lo.clamp(-3.4e38, 3.4e38), lo)

    def o32(f):
        b = f.view(torch.int32)
        return torch.where(b < 0, (~b) + torch.iinfo(torch.int32).min, b)

    key = (o32(hi).to(torch.int64) * (1 << 32)
           + o32(lo).to(torch.int64) + (1 << 31))
    key = torch.where(d == 0, 0, key)  # +-0 compare equal in SQL
    return torch.where(torch.isnan(d), I64_MAX - 8, key)


def _orderable_int(c: Column) -> torch.Tensor:
    d = c.data
    if d.dtype == torch.bool:
        return d.to(torch.int64)
    if d.is_floating_point():
        return _f64_orderable_arith(d.to(torch.float64))
    return d.to(torch.int64)


def _valid_arr(c: Column) -> torch.Tensor:
    if c.valid is None:
        return torch.ones(c.data.shape, dtype=torch.bool,
                          device=c.data.device)
    return c.valid


def _u64(x: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return x - (1 << 64) if x >= (1 << 63) else x


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (uint64 `>>`)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


_GOLDEN = _u64(0x9E3779B97F4A7C15)


def _hash_keys(cols: List[Column], sel) -> torch.Tensor:
    """64-bit mix fallback when exact packing exceeds 62 bits; the
    reference's uint64 arithmetic on int64 bit patterns (multiplication
    and addition wrap identically)."""
    h = torch.zeros(cols[0].data.shape, dtype=torch.int64,
                    device=cols[0].data.device)
    for c in cols:
        d = torch.where(_valid_arr(c), _orderable_int(c), _GOLDEN)
        h = h ^ (d + _GOLDEN + (h << 6) + _lsr(h, 2))
        z = h
        z = (z ^ _lsr(z, 30)) * _u64(0xBF58476D1CE4E5B9)
        z = (z ^ _lsr(z, 27)) * _u64(0x94D049BB133111EB)
        h = z ^ _lsr(z, 31)
    key = _lsr(h, 1)  # keep positive, below I64_MAX
    return torch.where(sel, key, I64_MAX)


# ---------------------------------------------------------------------------
# group-by
# ---------------------------------------------------------------------------


def nonzero_i32(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """jnp.nonzero(mask, size=, fill_value=)[0] in int32: the first
    `size` positions where mask is set, padded with the (clipped) fill."""
    n = mask.shape[0]
    fill = min(max(int(fill), 0), max(n - 1, 0))
    idx = torch.nonzero(mask).flatten().to(torch.int32)[:size]
    if idx.shape[0] < size:
        pad = torch.full((size - idx.shape[0],), fill, dtype=torch.int32,
                         device=mask.device)
        idx = torch.cat([idx, pad])
    return idx


def unpermute(order: torch.Tensor, *payloads):
    """Carry payloads back to original row order: payload[i] moves to
    position order[i]."""
    o = order.long()
    out = []
    for p in payloads:
        r = torch.empty_like(p)
        r[o] = p
        out.append(r)
    return out[0] if len(out) == 1 else tuple(out)


def sort_pair(key: torch.Tensor):
    """(sorted key, int32 permutation), stable."""
    skey, order = torch.sort(key, stable=True)
    return skey, order.to(torch.int32)


def _live_runs(key: torch.Tensor):
    """Run-boundary scan over a key whose LIVE subsequence is claimed
    nondecreasing (masked rows carry key_sentinel).  Returns (live,
    newgrp, guard); guard is True when the claim is violated."""
    n = key.shape[0]
    live = key != key_sentinel(key)
    if n == 0:
        z = torch.zeros((0,), dtype=torch.bool, device=key.device)
        return z, z, torch.zeros((), dtype=torch.bool, device=key.device)
    # packed keys are nonnegative, so -1 is a safe "no previous live" floor
    floor = torch.where(live, key, -1)
    prev = torch.cat([torch.full((1,), -1, dtype=key.dtype,
                                 device=key.device),
                      torch.cummax(floor, 0).values[:-1]])
    guard = (live & (key < prev)).any()
    newgrp = live & (key != prev)
    return live, newgrp, guard


def group_ids_presorted(key: torch.Tensor, sel):
    """Sort-free grouping for a key already nondecreasing over its live
    rows: one run-boundary scan.  Returns (gid, newgrp, n_groups_t,
    guard) with gid semantics identical to group_ids; guard True means
    the ordering claim lied and callers MUST fall back to group_ids."""
    live, newgrp, guard = _live_runs(key)
    n_groups_t = newgrp.to(torch.int32).sum()
    if key.shape[0]:
        gid = torch.cumsum(newgrp.to(torch.int32), 0, dtype=torch.int32) - 1
    else:
        gid = torch.zeros((0,), dtype=torch.int32, device=key.device)
    gid = torch.where(live, gid, n_groups_t.to(torch.int32))
    return gid, newgrp, n_groups_t, guard


def group_ids(key: torch.Tensor, sel,
              sorted_pair=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Sort-based grouping.  Returns (gid[n] in [0, n_groups) for live
    rows, representative row index per group [n_groups], n_groups).
    Masked rows get gid = n_groups; groups are numbered in ascending key
    order."""
    n = key.shape[0]
    skey, order = sorted_pair if sorted_pair is not None \
        else sort_pair(key)  # masked rows sort last
    newgrp = torch.ones((n,), dtype=torch.bool, device=key.device)
    if n > 1:
        newgrp[1:] = skey[1:] != skey[:-1]
    live_sorted = skey != key_sentinel(key)
    newgrp = newgrp & live_sorted
    gid_sorted = torch.cumsum(newgrp.to(torch.int32), 0,
                              dtype=torch.int32) - 1
    n_groups = int(newgrp.sum())
    gid_sorted = torch.where(live_sorted, gid_sorted, n_groups)
    gid = unpermute(order, gid_sorted)
    # representative row per group = first sorted occurrence
    rep_sorted_pos = nonzero_i32(newgrp, max(n_groups, 1), 0)
    rep_rows = order[rep_sorted_pos.long()][:n_groups] if n_groups \
        else torch.zeros((0,), dtype=order.dtype, device=key.device)
    return gid, rep_rows, n_groups


def segment_sum(x: torch.Tensor, gid: torch.Tensor,
                n_groups: int) -> torch.Tensor:
    """Per-group sums; rows with gid == n_groups (masked) are dropped.
    Integer inputs accumulate exactly in int64 (two's-complement
    wraparound, the reference's three-limb contract); the result keeps
    the input dtype (bool -> int64)."""
    if n_groups == 1:
        return x.sum(dtype=_acc_dtype(x))[None].to(_out_dtype(x))
    acc = torch.zeros((n_groups + 1,), dtype=_acc_dtype(x), device=x.device)
    acc.index_add_(0, gid.long(), x.to(acc.dtype))
    return acc[:n_groups].to(_out_dtype(x))


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.is_floating_point() else torch.int64


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.int64 if x.dtype == torch.bool else x.dtype


def _reduce_identity(dtype: torch.dtype, for_min: bool):
    if dtype.is_floating_point:
        return float("inf") if for_min else float("-inf")
    if dtype == torch.bool:
        return for_min
    info = torch.iinfo(dtype)
    return info.max if for_min else info.min


def _segment_extreme(x, gid, n_groups, for_min: bool):
    ident = _reduce_identity(x.dtype, for_min)
    if n_groups == 1:
        if x.shape[0] == 0:
            return torch.full((1,), ident, dtype=x.dtype, device=x.device)
        return (x.min() if for_min else x.max())[None]
    out = torch.full((n_groups + 1,), ident, dtype=x.dtype, device=x.device)
    out.scatter_reduce_(0, gid.long(), x, "amin" if for_min else "amax")
    return out[:n_groups]


def segment_min(x, gid, n_groups):
    return _segment_extreme(x, gid, n_groups, True)


def segment_max(x, gid, n_groups):
    return _segment_extreme(x, gid, n_groups, False)


def segment_any(mask: torch.Tensor, gid: torch.Tensor, n: int) -> torch.Tensor:
    """True where ANY row of the segment has `mask` set; gid is a
    probe-row index, always in [0, n)."""
    out = torch.zeros((n,), dtype=torch.int32, device=mask.device)
    out.scatter_reduce_(0, gid.long(), mask.to(torch.int32), "amax")
    return out > 0


# ---------------------------------------------------------------------------
# join probe
# ---------------------------------------------------------------------------


def pack_with_layout(cols: List[Column], sel, layout) -> torch.Tensor:
    """Pack another column set with a layout from pack_keys (the join's
    probe side shares the build side's strides)."""
    if layout is None:
        return _hash_keys(cols, sel)
    key = _apply_layout(cols, layout)
    return torch.where(sel, key, key_sentinel(key))


def build_probe(build_key: torch.Tensor, probe_key: torch.Tensor):
    """Sort the build side; position every probe key among the build
    keys.  Returns (order, lb, ub): build_key[order] is sorted and the
    matches of probe row i are order[lb[i]:ub[i]].

    The reference sorts (key, side flag) together.  Build rows precede
    probe rows in the concatenation, so one stable sort on the key alone
    puts builds before probes within a run of equal keys: the same
    order."""
    nb = build_key.shape[0]
    order = sort_pair(build_key)[1]
    allk = torch.cat([build_key, probe_key])
    n = allk.shape[0]
    sk, sidx = sort_pair(allk)
    is_build = (sidx < nb).to(torch.int32)
    before = torch.cumsum(is_build, 0, dtype=torch.int32) - is_build
    # first position of each equal-key run via a running maximum
    pos = torch.arange(n, dtype=torch.int32, device=allk.device)
    newrun = torch.ones((n,), dtype=torch.bool, device=allk.device)
    if n > 1:
        newrun[1:] = sk[1:] != sk[:-1]
    run_start = torch.cummax(torch.where(newrun, pos, -1), 0).values
    # builds sort before probes within a run, so at a probe's position:
    #   lb = builds before its run (key <  probe key)
    #   ub = builds before itself  (key <= probe key)
    lb_at = before[run_start.clamp(0, max(n - 1, 0)).long()]
    lb_all, ub_all = unpermute(sidx, lb_at, before)
    lb, ub = lb_all[nb:], ub_all[nb:]
    # sentinel keys (masked build rows) must not match masked probe rows
    live = probe_key != key_sentinel(probe_key)
    return order, torch.where(live, lb, 0), torch.where(live, ub, 0)


# ---------------------------------------------------------------------------
# gathers: columns packed into one word matrix, routed flat or staged
# (exec/gather.py)
# ---------------------------------------------------------------------------

_PACKED_MIN_INDICES = 65536  # below this, one gather per word


def take_rows(arrays: List[torch.Tensor], idx: torch.Tensor,
              presorted: bool = False) -> List[torch.Tensor]:
    """Gather idx rows from every array, packing columns into one int32
    word matrix so ONE gather moves them all: 4-byte types as bit views,
    bools and narrower ints widened, 8-byte integers as two words (low,
    high), f64 and matrix-shaped arrays gathered directly.  The reference
    packs into u32 words; these are the same bits as int32.

    Large gathers route through exec/gather.py: staged gathers sort the
    indices, gather in ascending order through the block_gather kernel
    and carry the rows home in one scatter.  `presorted=True` asserts
    idx is nondecreasing: staging then skips the sort and the way home."""
    if arrays and arrays[0].shape[0] == 0 and idx.shape[0] > 0:
        # gathering from an EMPTY source: every index is dead and the
        # caller masks the result
        return [torch.zeros((idx.shape[0],) + tuple(a.shape[1:]),
                            dtype=a.dtype, device=a.device) for a in arrays]
    words: List[torch.Tensor] = []
    spec: List = [None] * len(arrays)  # how to rebuild each output
    for i, a in enumerate(arrays):
        dt = a.dtype
        if a.ndim > 1 or dt == torch.float64:
            spec[i] = ("direct", None)
        elif dt == torch.bool:
            spec[i] = ("bool", len(words))
            words.append(a.to(torch.int32))
        elif dt.itemsize == 8:
            spec[i] = ("i64", len(words))
            pair = a.contiguous().view(torch.int32).view(-1, 2)
            words.extend([pair[:, 0], pair[:, 1]])  # little-endian: lo, hi
        elif dt.itemsize == 4:
            spec[i] = ("cast", len(words))
            words.append(a.view(torch.int32))
        else:
            spec[i] = ("widen", len(words))
            words.append(a.to(torch.int32))
    n_src = arrays[0].shape[0] if arrays else 0
    device = arrays[0].device if arrays else idx.device
    route = G.gather_route(n_src, idx.shape[0], len(words), presorted,
                           device)
    if route == "staged":
        return _take_rows_staged(arrays, idx, words, spec, presorted)
    i = idx.long()
    if len(words) >= 2 and idx.shape[0] >= _PACKED_MIN_INDICES:
        packed = torch.stack(words, 1).index_select(0, i)
        col = lambda k: packed[:, k]  # noqa: E731
    else:
        taken = [w[i] for w in words]
        col = lambda k: taken[k]  # noqa: E731
    directs = {j: arrays[j][i] for j, s in enumerate(spec)
               if s[0] == "direct"}
    return _rebuild_taken(arrays, spec, col, directs)


def _take_rows_staged(arrays, idx, words, spec, presorted):
    """Ascending gather through block_gather, then (for request-order
    callers) ONE scatter keyed on the saved positions carries the word
    matrix and the direct columns home together."""
    ii = idx.to(torch.int32)
    if presorted:
        sidx, spos = ii.contiguous(), None
    else:
        sidx, spos = sort_pair(ii)
    mat = torch.stack(words, 1)
    rows = G.block_gather(mat, sidx)
    s = sidx.long()
    directs = {j: arrays[j][s] for j, sp in enumerate(spec)
               if sp[0] == "direct"}
    if spos is not None:
        home = unpermute(spos, rows, *directs.values())
        if directs:
            rows = home[0]
            directs = dict(zip(directs, home[1:]))
        else:
            rows = home
    return _rebuild_taken(arrays, spec, lambda k: rows[:, k], directs)


def _rebuild_taken(arrays, spec, col, directs) -> List[torch.Tensor]:
    out = []
    for i, a in enumerate(arrays):
        kind, k = spec[i]
        if kind == "direct":
            out.append(directs[i])
        elif kind == "bool":
            out.append(col(k) != 0)
        elif kind == "i64":
            pair = torch.stack([col(k), col(k + 1)], 1)
            out.append(pair.view(a.dtype).view(-1))
        elif kind == "cast":
            out.append(col(k).contiguous().view(a.dtype))
        else:  # widen
            out.append(col(k).to(a.dtype))
    return out


def take_columns(columns: Dict[str, Column], idx: torch.Tensor,
                 extra: Optional[List[torch.Tensor]] = None,
                 presorted: bool = False):
    """Gather idx rows of (data, valid) for every column in one packed
    take_rows pass.  Returns ({name: (data, valid)}, [extra results]);
    `extra` arrays ride the same pack."""
    arrays = list(extra or [])
    n_extra = len(arrays)
    for c in columns.values():
        arrays.append(c.data)
        if c.valid is not None:
            arrays.append(c.valid)
    taken = take_rows(arrays, idx, presorted=presorted)
    out = {}
    i = n_extra
    for name, c in columns.items():
        data = taken[i]
        i += 1
        valid = None
        if c.valid is not None:
            valid = taken[i]
            i += 1
        out[name] = (data, valid)
    return out, taken[:n_extra]


def gather_batch(batch: Batch, idx: torch.Tensor, idx_valid=None,
                 presorted: bool = False) -> Batch:
    """Gather rows of all columns at idx (clipped); optionally mask.
    presorted=True asserts idx is nondecreasing; idx_valid, if given, is
    in the same order as idx."""
    n = batch.capacity
    safe = idx.clamp(0, max(n - 1, 0))
    raw, (sel,) = take_columns(batch.columns, safe, extra=[batch.sel],
                               presorted=presorted)
    cols = {}
    for name, (data, valid) in raw.items():
        c = batch.columns[name]
        if idx_valid is not None:
            valid = idx_valid if valid is None else (valid & idx_valid)
        cols[name] = Column(data, valid, c.type, c.dictionary)
    if idx_valid is not None:
        sel = sel & idx_valid
    return Batch(cols, sel)


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------


def sort_perm(batch: Batch,
              keys: List[Tuple[Column, bool, Optional[bool]]]) -> torch.Tensor:
    """Lexicographic permutation; masked rows last; ties keep row order.
    keys: (column, ascending, nulls_first); the default null order is
    the reference's (NULLS LAST for ASC, NULLS FIRST for DESC).

    The reference co-sorts all operands in one multi-operand lax.sort;
    here each operand gets one stable sort, minor key first."""
    n = batch.capacity
    operands = [(~batch.sel).to(torch.int32)]
    for col, asc, nulls_first in keys:
        valid = _valid_arr(col)
        nf = (not asc) if nulls_first is None else nulls_first
        if col.valid is not None:
            # a null-flag operand per key instead of in-band sentinels
            operands.append(torch.where(valid, int(nf), int(not nf))
                            .to(torch.int32))
        d = _sort_operand_native(col)
        if not asc:
            d = ~d  # order-reversing bijection; negation wraps the min
        operands.append(torch.where(valid, d, 0))
    perm = torch.arange(n, device=batch.device)
    for op in reversed(operands):
        perm = perm[argsort_stable(op[perm])]
    return perm.to(torch.int32)


def _sort_operand_native(col: Column) -> torch.Tensor:
    d = col.data
    if d.dtype == torch.bool:
        return d.to(torch.int32)
    if d.is_floating_point():
        return _orderable_int(col)
    if d.dtype in (torch.int32, torch.int16, torch.int8):
        return d.to(torch.int32)
    return d.to(torch.int64)


def argsort_stable(key: torch.Tensor) -> torch.Tensor:
    """Stable argsort (equal keys keep input order)."""
    return torch.argsort(key, stable=True)


# ---------------------------------------------------------------------------
# fused_group_sums: k segmented sums sharing one group-id vector, in one
# pass over the rows.  Replaces presto_tpu/exec/kernels.py
# fused_group_sums (the Pallas kernel); the CUDA kernel keeps the
# reference interpreter path's f64 contract.
# ---------------------------------------------------------------------------


def fused_group_sums_plain(vals: torch.Tensor, gid: torch.Tensor,
                           n_groups: int) -> torch.Tensor:
    """The plain version: out[j, g] = sum of vals[j, i] over gid[i] == g,
    accumulated in f64.  vals [k, n] float (dead rows already zeroed),
    gid [n] int32 in [0, n_groups); returns [k, n_groups] f64."""
    k = vals.shape[0]
    out = torch.zeros((k, n_groups), dtype=torch.float64, device=vals.device)
    return out.index_add_(1, gid.long(), vals.to(torch.float64))


_FGS_THREADS = 256
_FGS_SMEM_BUDGET = 96 * 1024   # bytes of f64 table per block
_FGS_SCRATCH_BUDGET = 32 << 20  # bytes of per-block partial tables
_FGS_BLOCKS_PER_SM = 4


def fused_group_sums_launch_shape(n: int, k: int, n_groups: int,
                                  sm_count: int) -> Tuple[int, int]:
    """(row blocks, groups per shared-memory tile) for one launch: enough
    row blocks to fill the card, no more than the rows need or than the
    per-block partial tables' scratch budget allows, and group tiles
    small enough for the shared-memory budget."""
    gtile = max(1, min(n_groups, _FGS_SMEM_BUDGET // (8 * max(k, 1))))
    blocks = min(sm_count * _FGS_BLOCKS_PER_SM,
                 -(-n // _FGS_THREADS),
                 max(1, _FGS_SCRATCH_BUDGET // (8 * max(k * n_groups, 1))))
    return max(blocks, 0), gtile


def fused_group_sums(vals: torch.Tensor, gid: torch.Tensor,
                     n_groups: int) -> torch.Tensor:
    """ONE pass computing k segmented sums that share group ids.

    vals [k, n] float (dead rows already zeroed), gid [n] int32 in
    [0, n_groups); returns [k, n_groups] f64.  CPU tensors take the
    plain version; everything else goes to the CUDA kernel, which
    launches or raises."""
    if vals.device.type == "cpu" and gid.device.type == "cpu":
        return fused_group_sums_plain(vals, gid, n_groups)
    return fused_group_sums_cuda(vals, gid, n_groups)


def fused_group_sums_cuda(vals: torch.Tensor, gid: torch.Tensor,
                          n_groups: int) -> torch.Tensor:
    """Launch csrc/fused_group_sums.cu on the current stream: vals [k, n]
    f64 and gid [n] int32, contiguous, on one CUDA device; 1 <= k and
    1 <= n_groups.  Raises on anything else and when the launch fails;
    counts each launch in `fused_group_sums_cuda.launches`."""
    if vals.device.type != "cuda" or gid.device != vals.device:
        raise ValueError(f"fused_group_sums: vals on {vals.device}, gid on "
                         f"{gid.device}; both must be on one CUDA device")
    if vals.dtype != torch.float64 or gid.dtype != torch.int32:
        raise TypeError(f"fused_group_sums: vals {vals.dtype} (needs "
                        f"float64), gid {gid.dtype} (needs int32)")
    if vals.ndim != 2 or gid.ndim != 1 or vals.shape[1] != gid.shape[0]:
        raise ValueError(f"fused_group_sums: shapes {tuple(vals.shape)} and "
                         f"{tuple(gid.shape)} do not match [k, n] and [n]")
    if not (vals.is_contiguous() and gid.is_contiguous()):
        raise ValueError("fused_group_sums: inputs must be contiguous")
    k, n = vals.shape
    if k < 1 or n_groups < 1:
        raise ValueError(f"fused_group_sums: k={k}, n_groups={n_groups}")
    from presto_tpu_torch.exec import cuda_build

    lib = cuda_build.load("fused_group_sums")
    sm = torch.cuda.get_device_properties(vals.device).multi_processor_count
    blocks, gtile = fused_group_sums_launch_shape(n, k, n_groups, sm)
    partials = torch.empty((blocks, k, n_groups), dtype=torch.float64,
                           device=vals.device)
    out = torch.empty((k, n_groups), dtype=torch.float64, device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):  # the runtime launches on it
        rc = lib.fused_group_sums_f64(
            vals.data_ptr(), gid.data_ptr(), n, k, n_groups, blocks, gtile,
            partials.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("fused_group_sums kernel failed: "
                           + cuda_build.error_string(lib, rc))
    fused_group_sums_cuda.launches += 1
    return out


fused_group_sums_cuda.launches = 0
