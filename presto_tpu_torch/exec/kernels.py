"""Relational kernels over columnar torch tensors.

Reference: presto_tpu/exec/kernels.py.  The slice of TPC-H Q1/Q3/Q6/Q18
needs key packing, sort-based grouping, segmented reductions, the ORDER
BY permutation, the join probe, packed row gathers (whose large staged
gathers run the block_gather CUDA kernel, exec/gather.py) and the fused
multi-aggregate reduction `fused_group_sums`, whose CUDA kernel lives in
presto_tpu_torch/csrc/fused_group_sums.cu.  The static executor of
compiled mode adds layouts from statistics with their range guard
(`static_layout`, `layout_range_guard`), grouping at a fixed capacity
(`group_ids_static`) and the packed result fetch (`pack_fetch`,
`unpack_fetch`); none of these reads a tensor back to the host.
Ordering-aware execution adds sort-free grouping of presorted keys
(`group_ids_presorted`, `group_ids_presorted_static`), the check of a
presorted join build (`monotone_guard`) and `build_probe`'s
`build_order`; dynamic filtering the runtime-filter summaries
(`rf_build`, `rf_probe`, `rf_domain`), whose bloom bits are the
reference's bit for bit.  The window, Union and FULL and CROSS joins
add `compact` (the dynamic executor's, with one host read) and
`concat_batches`.

Two differences from the reference's JAX code are deliberate:
- torch has no multi-operand sort, so lexicographic sorts are built
  from stable single-key sorts, minor key to major (`sort_perm`);
- torch's CPU kernels have no `>>` on unsigned integers, so the 64-bit
  mixing in `_hash_keys` and `_rf_mix64` runs on int64 bit patterns
  with the logical shift emulated by a mask (`_lsr`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, Dictionary, upload
from presto_tpu_torch.exec import dec128 as D128
from presto_tpu_torch.exec import gather as G
from presto_tpu_torch.exec.colval import translate_codes
from presto_tpu_torch.functions.decimals import true_div

I64_MIN = np.iinfo(np.int64).min
I64_MAX = np.iinfo(np.int64).max
I32_MAX = np.iinfo(np.int32).max


def key_sentinel(key: torch.Tensor) -> int:
    """Masked-row sentinel for a packed key tensor: the dtype's max."""
    return I32_MAX if key.dtype == torch.int32 else I64_MAX


# ---------------------------------------------------------------------------
# key packing: N key columns -> one integer per row (exact, runtime ranges)
# ---------------------------------------------------------------------------


def refuse_limbs(d: torch.Tensor) -> None:
    """Long-decimal limbs are no grouping or join key and no window
    frame operand: the reference raises this there, broadcasting the
    rows' flags against the (n, 2) limbs, and so does the port."""
    if d.ndim == 2:
        n = d.shape[0]
        raise ValueError("Incompatible shapes for broadcasting: "
                         f"shapes=[({n},), ({n}, 2), ()]")


def refuse_point_keys(d: torch.Tensor) -> None:
    """A sort key of (n, k) float64 rows (a POINTS or FEATURES column,
    functions/geospatial.py and ml.py): the reference's sort operand
    applies an integer bitwise op to the float rows and raises this."""
    raise TypeError(f"xor does not accept dtype {d.dtype}".replace(
        "torch.", "") + " at position 0. Accepted dtypes at position 0 "
        "are subtypes of integer, bool.")


def pack_keys(cols: List[Column], sel: torch.Tensor,
              extra_cols: Optional[List[Column]] = None):
    """Pack key columns into a single integer key per row — int32 when
    the packed widths fit 30 bits, else int64.  Masked-out rows get the
    dtype's max as sentinel; NULL in any key column gets its own code.

    Returns (key, layout); layout is None when the packing would exceed
    62 bits and the key is a 64-bit hash instead."""
    def _minmax(col):
        d = _orderable_int(col)
        refuse_limbs(d)
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


def static_layout(cols: List[Column], stats_list) -> Optional[list]:
    """Pack layout from metadata alone, for the static executor: a
    dictionary's size for string codes, the connector's ColStats range
    for integers.  None when a column's range is unknown (callers then
    hash, which needs no range and no host read)."""
    parts = []
    for c, st in zip(cols, stats_list):
        if c.dictionary is not None:
            lo, hi = 0, max(len(c.dictionary) - 1, 0)
        elif c.data.dtype == torch.bool:
            lo, hi = 0, 1
        elif st is not None and st.min is not None and st.max is not None \
                and not c.data.is_floating_point():
            lo, hi = int(st.min), int(st.max)
        else:
            return None
        parts.append((lo, hi - lo + 2))
    total_bits = sum(int(np.ceil(np.log2(max(card, 2)))) for _, card in parts)
    if total_bits > 62:
        return None
    return _assign_strides(parts)


def layout_range_guard(cols: List[Column], sel, layout) -> torch.Tensor:
    """True (a device bool) when a live value lies outside its static
    layout range: it would spill into the next packed field, so the
    compiled query must rerun in the dynamic executor."""
    bad = torch.zeros((), dtype=torch.bool, device=sel.device)
    for c, (lo, _stride, width) in zip(cols, layout):
        d = _orderable_int(c)
        live = sel & _valid_arr(c)
        hi = lo + (1 << width) - 2  # code 0 stands for NULL
        bad = bad | (live & ((d < lo) | (d > hi))).any()
    return bad


_POW2: Dict[str, torch.Tensor] = {}  # exact power-of-two table per device


def _f64_orderable_arith(d: torch.Tensor) -> torch.Tensor:
    """Order-preserving, injective f64 -> i64 over the normal range, the
    reference's arithmetic construction: |x| = m * 2^e with e from log2
    plus comparison fixups and m recovered by an exact power-of-two table
    multiply.  Layout: normals map to (e+1023)*2^52 + mant52; negatives
    mirror; +-0 and subnormals map to 0; +-inf and NaN get sentinels
    with NaN largest (Presto sort order).  Bit for bit the keys of
    presto_tpu.exec.kernels._f64_orderable_arith."""
    pow2 = _POW2.get(str(d.device))
    if pow2 is None:
        pow2 = _POW2[str(d.device)] = upload(
            np.asarray([2.0 ** i for i in range(-1099, 1024)]), d.device)

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
    if c.valid is None:  # one flag a row, for long-decimal limbs too
        return torch.ones(c.data.shape[:1], dtype=torch.bool,
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
    `size` positions where mask is set, padded with the (clipped) fill.
    No host read: the i-th set position is where the running count of
    set rows first reaches i + 1 (one cumsum, `size` binary searches)."""
    n = mask.shape[0]
    fill = min(max(int(fill), 0), max(n - 1, 0))
    if n == 0:
        return torch.full((size,), fill, dtype=torch.int32,
                          device=mask.device)
    count = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, size + 1, dtype=torch.int32, device=mask.device)
    pos = torch.searchsorted(count, want).to(torch.int32)
    return torch.where(want <= count[-1], pos, fill)


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


def group_ids_presorted_static(key: torch.Tensor, cap: int):
    """group_ids_presorted at a fixed group capacity, without a host
    read: (gid, rep_rows[cap], exists[cap], overflow, guard) with
    group_ids_static's contract; the guard (the ordering claim lied)
    joins the static executor's guards."""
    live, newgrp, guard = _live_runs(key)
    n = key.shape[0]
    n_groups = newgrp.to(torch.int32).sum()
    if n == 0:
        gid = torch.zeros((0,), dtype=torch.int32, device=key.device)
        rep_rows = torch.zeros((cap,), dtype=torch.int32, device=key.device)
    else:
        gid = torch.cumsum(newgrp.to(torch.int32), 0, dtype=torch.int32) - 1
        gid = torch.where(live & (gid < cap), gid, cap)
        rep_rows = nonzero_i32(newgrp, cap, 0)
    exists = torch.arange(cap, device=key.device) < n_groups
    return gid, rep_rows, exists, n_groups > cap, guard


def monotone_guard(key: torch.Tensor) -> torch.Tensor:
    """True (a device bool) when `key` is not nondecreasing end to end:
    the check of a presorted join build, whose masked rows (sentinels)
    must already sit in a suffix."""
    if key.shape[0] < 2:
        return torch.zeros((), dtype=torch.bool, device=key.device)
    return (key[1:] < key[:-1]).any()


def group_ids_static(key: torch.Tensor, cap: int, sorted_pair=None):
    """group_ids at a fixed group capacity, without a host read.  Returns
    (gid, rep_rows[cap], exists[cap], overflow): live rows of groups past
    `cap` and masked rows get gid == cap; overflow is a device bool, true
    when the rows hold more than `cap` groups (the compiled query then
    reruns in the dynamic executor).  `sorted_pair` replays a memoized
    (skey, order) of this very key."""
    n = key.shape[0]
    skey, order = sorted_pair if sorted_pair is not None \
        else sort_pair(key)
    newgrp = torch.ones((n,), dtype=torch.bool, device=key.device)
    if n > 1:
        newgrp[1:] = skey[1:] != skey[:-1]
    live_sorted = skey != key_sentinel(key)
    newgrp = newgrp & live_sorted
    n_groups = newgrp.sum()
    gid_sorted = torch.cumsum(newgrp.to(torch.int32), 0,
                              dtype=torch.int32) - 1
    gid_sorted = torch.where(live_sorted & (gid_sorted < cap), gid_sorted,
                             cap)
    gid = unpermute(order, gid_sorted)
    if n == 0:
        rep_rows = torch.zeros((cap,), dtype=torch.int32, device=key.device)
    else:
        rep_rows = order[nonzero_i32(newgrp, cap, 0).long()]
    exists = torch.arange(cap, device=key.device) < n_groups
    return gid, rep_rows, exists, n_groups > cap


class GroupOrder:
    """The fixed order in which segment_sum adds each group's rows: the
    live rows (gid < n_groups; masked rows carry gid == n_groups and
    are left out) sorted stably by group, cut into chunks of at most
    _SEGMENT_CHUNK consecutive rows of one group.  Float sums add each
    chunk, then each group's chunk sums, in this order, so their bits
    depend on the input alone, on every device (no atomic adds, whose
    order the card chooses).  Built once per grouping and shared by its
    aggregates; it syncs with the host not at all."""

    def __init__(self, gid: torch.Tensor, n_groups: int):
        self.gid = gid
        self.n_groups = n_groups
        self._plan = None

    def plan(self):
        """(order, each group's first and one-past-last sorted row,
        level-1 offsets, level-2 offsets)."""
        if self._plan is None:
            g = self.gid  # int32 from group_ids: a 4-pass radix sort
            G, dev = self.n_groups, g.device
            order = torch.argsort(g, stable=True)  # masked rows last
            # group bounds by binary search in the sorted ids: a
            # bincount would add every masked row into one counter
            ids = torch.arange(G, dtype=g.dtype, device=dev)
            gs = g[order]
            starts = torch.searchsorted(gs, ids)
            ends = torch.searchsorted(gs, ids, right=True)
            cnt = ends - starts
            nchunks = (cnt + _SEGMENT_CHUNK - 1) // _SEGMENT_CHUNK
            cends = torch.cumsum(nchunks, 0)
            # at most this many chunks, whatever the data: the ones past
            # the real count are empty and sum to 0
            most = g.shape[0] // _SEGMENT_CHUNK + G + 1
            k = torch.arange(most, device=dev)
            gk = torch.searchsorted(cends, k, right=True).clamp(max=G - 1)
            j = k - (cends[gk] - nchunks[gk])
            start = torch.where(k < cends[-1],
                                starts[gk] + j * _SEGMENT_CHUNK, ends[-1])
            self._plan = (order, starts, ends,
                          torch.cat([start, ends[-1:]]),
                          torch.cat([torch.zeros(1, dtype=cends.dtype,
                                                 device=dev), cends]))
        return self._plan


_SEGMENT_CHUNK = 8192  # rows a first-level sum adds, as fused_group_sums

SUM_WINDOW = 32  # terms a level of window_sum32 adds


def window_sum32(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of a 1-D tensor in the order of presto_tpu's jnp.sum
    on the CPU (XLA's tree reduction rewrite): windows of SUM_WINDOW
    terms, level by level, each level's zero padding split low and high
    as XLA pads.  However a level adds its windows, a term passes at
    most SUM_WINDOW - 1 additions there, so the sum's error bound does
    not grow with the row count as a running sum's does."""
    while x.shape[0] > SUM_WINDOW:
        m = -(-x.shape[0] // SUM_WINDOW)
        pad = m * SUM_WINDOW - x.shape[0]
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(m, SUM_WINDOW).sum(1)
    return x.sum()


def segment_sum(x: torch.Tensor, gid: torch.Tensor, n_groups: int,
                order: Optional[GroupOrder] = None) -> torch.Tensor:
    """Per-group sums; rows with gid == n_groups (masked) are dropped.
    Integer inputs accumulate exactly in int64 (two's-complement
    wraparound, the reference's three-limb contract); the result keeps
    the input dtype (bool -> int64).  Float sums add in GroupOrder's
    fixed order, so they are bit-identical from run to run on the card
    as on the CPU; pass `order` to share one grouping's sort between
    several sums.  A global f32 sum adds in window_sum32's order."""
    if n_groups == 1:
        if x.dtype == torch.float32:
            return window_sum32(x)[None]
        return x.sum(dtype=_acc_dtype(x))[None].to(_out_dtype(x))
    if n_groups == 0:
        return torch.zeros((0,), dtype=_out_dtype(x), device=x.device)
    perm, starts, ends, level1, level2 = (
        order or GroupOrder(gid, n_groups)).plan()
    xs = x[perm].to(_acc_dtype(x))
    if not x.is_floating_point():
        # integer sums are exact in any order: differences of one
        # running sum (wrapping like the sums themselves)
        run = torch.cat([torch.zeros(1, dtype=xs.dtype, device=x.device),
                         torch.cumsum(xs, 0)])
        return (run[ends] - run[starts]).to(_out_dtype(x))
    chunks = torch.segment_reduce(xs, "sum", offsets=level1, unsafe=True,
                                  initial=0.0)
    return torch.segment_reduce(chunks, "sum", offsets=level2, unsafe=True,
                                initial=0.0).to(_out_dtype(x))


def segment_extreme_f64(x: torch.Tensor, order: "GroupOrder",
                        for_min: bool) -> torch.Tensor:
    """Per-group min or max of float64 values (integers below 2^53, such
    as row numbers and ranks, are exact in them) in GroupOrder's fixed
    order: two segment reductions and no atomics.  segment_min/max
    scatter with atomics, which contend when millions of rows fall into
    a few groups; an empty group gives +inf (min) or -inf (max)."""
    ident = float("inf") if for_min else float("-inf")
    xf = x.to(torch.float64)
    G = order.n_groups
    if G == 1:
        if xf.shape[0] == 0:
            return torch.full((1,), ident, dtype=torch.float64,
                              device=x.device)
        return (xf.min() if for_min else xf.max())[None]
    if G == 0:
        return torch.zeros((0,), dtype=torch.float64, device=x.device)
    perm, _, _, level1, level2 = order.plan()
    how = "min" if for_min else "max"
    chunks = torch.segment_reduce(xf[perm], how, offsets=level1,
                                  unsafe=True, initial=ident)
    return torch.segment_reduce(chunks, how, offsets=level2, unsafe=True,
                                initial=ident)


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


def build_probe(build_key: torch.Tensor, probe_key: torch.Tensor,
                build_order=None):
    """Sort the build side; position every probe key among the build
    keys.  Returns (order, lb, ub): build_key[order] is sorted and the
    matches of probe row i are order[lb[i]:ub[i]].

    The reference sorts (key, side flag) together.  Build rows precede
    probe rows in the concatenation, so one stable sort on the key alone
    puts builds before probes within a run of equal keys: the same
    order.  `build_order` skips the build's own sort: a memoized
    permutation of this very key, or the identity when the key is
    nondecreasing end to end (callers check with monotone_guard); the
    stable sort of such a key is the identity too."""
    nb = build_key.shape[0]
    order = build_order if build_order is not None \
        else sort_pair(build_key)[1]
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
    if idx.shape[0] == 0:
        return [a[:0] for a in arrays]
    if arrays and arrays[0].shape[0] == 0:
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


def compact(batch: Batch) -> Batch:
    """Drop masked rows (one host read: the live count).  The dynamic
    executor's window and cross join call it; the static executor never
    does."""
    n_live = int(batch.sel.sum())
    idx = nonzero_i32(batch.sel, max(n_live, 1), 0)
    if n_live == 0:
        idx = idx[:0]
    # the live positions ascend: the gather is presorted
    raw, _ = take_columns(batch.columns, idx, presorted=True)
    cols = {name: Column(data, valid, batch.columns[name].type,
                         batch.columns[name].dictionary)
            for name, (data, valid) in raw.items()}
    return Batch(cols, torch.ones((n_live,), dtype=torch.bool,
                                  device=batch.device))


def concat_batches(batches: List[Batch]) -> Batch:
    """Concatenate same-schema batches.  String columns whose branches
    hold different dictionaries are recoded into one merged on the host
    (np.unique: code order stays lexicographic order), the tuple
    dictionaries of ARRAY, MAP and ROW columns into one ordered by repr,
    as the reference merges them; a branch without a dictionary is
    typed-NULL padding (a grouping set's, say), whose dead codes become
    0.  The recode tables reach the device through `upload`, so a
    compiled query's capture reads them from its log."""
    names = list(batches[0].columns)
    cols: Dict[str, Column] = {}
    for name in names:
        parts = [b.columns[name] for b in batches]
        dicts = [p.dictionary for p in parts]
        with_dict = [d for d in dicts if d is not None]
        if with_dict and (len({id(d) for d in with_dict}) > 1
                          or len(with_dict) < len(parts)):
            if parts[0].type.name not in ("ARRAY", "MAP", "ROW"):
                merged = Dictionary(np.unique(np.concatenate(
                    [d.values for d in with_dict])))
                luts = {id(d): translate_codes(d, merged)
                        for d in with_dict}
            else:
                from presto_tpu_torch.functions.scalar import repr_order

                all_vals = [v for d in with_dict for v in d.values.tolist()]
                uniq = repr_order(list(set(all_vals)))
                cmap = {v: i for i, v in enumerate(uniq)}
                u = np.empty(len(uniq), dtype=object)
                u[:] = uniq
                merged = Dictionary(u)
                luts = {id(d): np.asarray([cmap[v] for v in d.values.tolist()],
                                          dtype=np.int32)
                        for d in with_dict}
            datas = []
            for p in parts:
                if p.dictionary is None:
                    datas.append(torch.zeros_like(p.data,
                                                  dtype=torch.int32))
                    continue
                lut = upload(luts[id(p.dictionary)], p.data.device)
                codes = p.data.clamp(0, len(p.dictionary) - 1).long()
                datas.append(lut[codes])
            data = torch.cat(datas)
            dictionary = merged
        else:
            data = torch.cat([p.data for p in parts])
            dictionary = dicts[0]
        if any(p.valid is not None for p in parts):
            valid = torch.cat([
                p.valid if p.valid is not None
                else torch.ones(p.data.shape[:1], dtype=torch.bool,
                                device=p.data.device)
                for p in parts])
        else:
            valid = None
        cols[name] = Column(data, valid, parts[0].type, dictionary)
    return Batch(cols, torch.cat([b.sel for b in batches]))


def pack_fetch(batch: Batch, guard: torch.Tensor):
    """A result batch and its guard as one int32 buffer, so the host
    pulls one array: sel, then each column's words (4-byte types as bit
    views, 8-byte integers as (low, high) word pairs, bools and narrower
    integers widened) and its validity, then the guard as the last
    word; f64 columns ride beside it.  The reference's uint32 layout,
    bit for bit.  Returns ((buffer, [f64 columns]), meta); unpack_fetch
    inverts it on the host."""
    n = batch.capacity
    parts = [batch.sel.to(torch.int32)]
    side = []
    cols_meta = []
    for name, c in batch.columns.items():
        d = c.data
        if d.dtype == torch.float64:
            side.append(d)
            words = 0
        elif d.dtype == torch.bool:
            parts.append(d.to(torch.int32))
            words = 1
        elif d.dtype.itemsize == 8:
            parts.append(d.contiguous().view(torch.int32))  # lo, hi a row
            words = 2
        elif d.dtype.itemsize == 4:
            parts.append(d.contiguous().view(torch.int32))
            words = 1
        else:
            parts.append(d.to(torch.int32))
            words = 1
        if c.valid is not None:
            parts.append(c.valid.to(torch.int32))
        cols_meta.append((name, _numpy_dtype_name(d.dtype), words,
                          c.valid is not None, c.type, c.dictionary))
    parts.append(guard.reshape(1).to(torch.int32))
    return (torch.cat(parts), side), {"n": n, "cols": cols_meta}


_NUMPY_NAMES = {torch.bool: "bool", torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.float32: "float32", torch.float64: "float64"}


def _numpy_dtype_name(dt: torch.dtype) -> str:
    return _NUMPY_NAMES[dt]


def flat_fetch(buf: torch.Tensor, side: List[torch.Tensor]) -> torch.Tensor:
    """pack_fetch's buffer with each f64 column's words behind it: what
    one copy brings to the host (split_flat_fetch divides it again)."""
    return torch.cat([buf] + [d.contiguous().view(torch.int32)
                              for d in side])


def split_flat_fetch(flat: np.ndarray, meta: dict):
    """flat_fetch's host copy back into pack_fetch's (buffer, [f64
    columns])."""
    n = meta["n"]
    n_side = sum(1 for c in meta["cols"] if c[2] == 0)
    n_buf = len(flat) - 2 * n * n_side
    side = [flat[n_buf + 2 * n * i:n_buf + 2 * n * (i + 1)].copy()
            .view(np.float64) for i in range(n_side)]
    return flat[:n_buf], side


def unpack_fetch(fetched, meta: dict):
    """The host's inverse of pack_fetch, over numpy arrays: returns
    ({name: (data, valid)}, sel, guard)."""
    buf, side = fetched
    n = meta["n"]
    buf = np.asarray(buf).view(np.uint32)
    side = [np.asarray(a) for a in side]
    si = 0
    sel = buf[:n] != 0
    off = n
    datas = {}
    for name, dtype_s, words, has_valid, _typ, _dic in meta["cols"]:
        dt = np.dtype(dtype_s)
        if words == 0:
            data = side[si]
            si += 1
        else:
            raw = buf[off:off + n * words]
            off += n * words
            if dt == np.bool_:
                data = raw != 0
            elif words == 2:
                pair = raw.reshape(n, 2).astype(np.uint64)
                data = (pair[:, 0] | (pair[:, 1] << np.uint64(32))).view(dt)
            elif dt.itemsize == 4:
                data = raw.view(dt)
            else:
                data = raw.view(np.int32).astype(dt)
        valid = None
        if has_valid:
            valid = buf[off:off + n] != 0
            off += n
        datas[name] = (data, valid)
    guard = bool(buf[off]) if off < len(buf) else False
    return datas, sel, guard


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
        if col.data.ndim == 2 and not col.type.is_decimal:
            refuse_point_keys(col.data)
        if col.data.ndim == 2:
            # long decimal (Int128 limbs): the signed hi limb, then the
            # biased lo limb; DESC by bitwise NOT, an exact
            # order-reversing bijection on int64 (negation would tie
            # I64_MIN and I64_MIN + 1)
            for d in D128.sort_operands(col.data):
                operands.append(torch.where(valid, ~d if not asc else d, 0))
            continue
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


def sort_values(x: torch.Tensor) -> torch.Tensor:
    """Ascending value sort."""
    return torch.sort(x).values


# ---------------------------------------------------------------------------
# runtime filters (dynamic filtering, plan/runtime_filters.py): a join's
# build keys summarized on the device, probed by the probe side's scans.
#   exact: the sorted live build keys, probed by binary search (build
#          capacities up to RF_EXACT_MAX)
#   bloom: a blocked bloom bitset, RF_BLOOM_K bits per key inside one
#          64-bit block (false positives possible, false negatives never)
# The reference mixes in uint64; here the same bits run in int64, with
# the constants as their two's-complement values, every shift logical
# (_lsr) and the modulo by a power of two a mask.  No function reads a
# tensor back to the host, so the static executor builds and probes
# filters inside its captured program.
# ---------------------------------------------------------------------------


RF_EXACT_MAX = 1 << 17   # build capacities up to this probe exactly
RF_BLOOM_K = 3           # bits set and tested per key
RF_BLOOM_BITS_PER_KEY = 16  # bitset density m/n: false positives ~0.5%

_RF_M1 = _u64(0xBF58476D1CE4E5B9)
_RF_M2 = _u64(0x94D049BB133111EB)


def rf_bloom_bits(n_keys: int) -> int:
    """Bloom bitset size for n keys: about RF_BLOOM_BITS_PER_KEY bits a
    key, a power of two, at least 1024."""
    n = max(int(n_keys), 1)
    return 1 << max(int(np.ceil(np.log2(n * RF_BLOOM_BITS_PER_KEY))), 10)


def _rf_mix64(v: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer over int64 key values; the uint64 result
    as int64 bits."""
    z = v.to(torch.int64) + _GOLDEN
    z = (z ^ _lsr(z, 30)) * _RF_M1
    z = (z ^ _lsr(z, 27)) * _RF_M2
    return z ^ _lsr(z, 31)


def _rf_bloom_positions(h: torch.Tensor, nbits: int) -> List[torch.Tensor]:
    """RF_BLOOM_K bit positions for each hash, all in one 64-bit block.
    nblocks is a power of two, so the unsigned `h % nblocks` is the low
    bits of h."""
    nblocks = max(nbits // 64, 1)
    block = (h & (nblocks - 1)) * 64
    return [block + (_lsr(h, 8 + 6 * j) & 63) for j in range(RF_BLOOM_K)]


def rf_build(col: Column, live: torch.Tensor, structure: str = "auto") -> dict:
    """The build side's summary over the live rows of an integer key
    column: {"kind": "exact", "keys": sorted int64, dead rows as I64_MAX}
    or {"kind": "bloom", "bits": bool[nbits]}.  "auto" chooses by the
    column's capacity, not by its live rows."""
    d = _orderable_int(col)
    live = live & _valid_arr(col)
    n = int(d.shape[0])
    kind = structure
    if kind == "auto":
        kind = "exact" if n <= RF_EXACT_MAX else "bloom"
    if kind == "exact":
        return {"kind": "exact",
                "keys": sort_values(torch.where(live, d, I64_MAX))}
    nbits = rf_bloom_bits(n)
    h = _rf_mix64(d)
    # dead rows set the overflow slot nbits, sliced off
    idx = torch.cat([torch.where(live, p, nbits)
                     for p in _rf_bloom_positions(h, nbits)])
    bits = torch.zeros((nbits + 1,), dtype=torch.bool, device=d.device)
    bits.index_fill_(0, idx, True)
    return {"kind": "bloom", "bits": bits[:nbits]}


def rf_probe(summary: dict, col: Column) -> torch.Tensor:
    """The probe side's mask: True where the row may have a build match
    (exact: iff; bloom: with false positives, never a false negative).
    NULL probe rows are False: an equi-join NULL never matches.  The
    reference's third kind, a host-made min/max "domain", comes with the
    cluster side channel, which is not ported."""
    d = _orderable_int(col)
    valid = _valid_arr(col)
    if summary["kind"] == "exact":
        keys = summary["keys"]
        nb = keys.shape[0]
        if nb == 0:
            return torch.zeros(d.shape, dtype=torch.bool, device=d.device)
        pos = torch.searchsorted(keys, d).clamp(0, nb - 1)
        # a probe value equal to the dead-row sentinel "matches" a masked
        # build slot: kept, a safe false positive
        return valid & (keys[pos] == d)
    bits = summary["bits"]
    m = valid
    for p in _rf_bloom_positions(_rf_mix64(d), int(bits.shape[0])):
        m = m & bits[p]
    return m


def rf_domain(col: Column, live: torch.Tensor):
    """(lo, hi) of the live key values as 0-d device tensors; an empty
    live set gives (I64_MAX, I64_MIN)."""
    d = _orderable_int(col)
    live = live & _valid_arr(col)
    if d.shape[0] == 0:
        return (torch.tensor(I64_MAX, device=d.device),
                torch.tensor(I64_MIN, device=d.device))
    return (torch.where(live, d, I64_MAX).min(),
            torch.where(live, d, I64_MIN).max())


# ---------------------------------------------------------------------------
# write-path layout functions (exec/writer.py): bucket assignment shares
# the splitmix64 mix of the runtime filters above; the sort permutation
# is successive stable sorts.  Host numpy in and out, the work on the
# given device; the writer lays out host pages.
# ---------------------------------------------------------------------------


def write_bucket_ids(values, bucket_count: int,
                     device: torch.device) -> np.ndarray:
    """Hash-bucket id of each row for a write's bucket column(s):
    splitmix64 of each int64 key column, XOR-combined, then the uint64
    remainder by bucket_count (reference: presto_tpu's write_bucket_ids).
    torch has no unsigned remainder: with h = hi * 2^32 + lo over the two
    32-bit halves, h mod m = ((hi mod m) * (2^32 mod m) + lo) mod m, in
    int64 without overflow for m < 2^31."""
    cols = values if isinstance(values, (list, tuple)) else [values]
    m = max(int(bucket_count), 1)
    if m >= 1 << 31:
        raise ValueError(f"bucket_count {bucket_count} exceeds 2^31 - 1")
    h = None
    for v in cols:
        t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.int64))
        mixed = _rf_mix64(t.to(device))
        h = mixed if h is None else h ^ mixed
    hi = _lsr(h, 32)
    lo = h & 0xFFFFFFFF
    b = ((hi % m) * ((1 << 32) % m) + lo) % m
    return b.to(torch.int32).cpu().numpy()


def write_sort_perm(keys: List[np.ndarray], device: torch.device,
                    ascending: Optional[List[bool]] = None) -> np.ndarray:
    """Lexicographic sort permutation of a write page: keys in priority
    order (keys[0] major), each an orderable host int or float array
    (string columns come as sorted-dictionary codes).  Successive stable
    sorts from the minor key to the major one through argsort_stable; a
    descending key sorts ~k for integers and -k for floats.  Float keys
    sort through _f64_sort_key as the reference's sort does: -0.0 and
    the subnormals equal to 0.0, every NaN last, equal to each other."""
    n = len(keys[0]) if keys else 0
    perm = np.arange(n, dtype=np.int64)
    asc = ascending if ascending is not None else [True] * len(keys)
    for key, up in reversed(list(zip(keys, asc))):
        k = np.ascontiguousarray(np.asarray(key)[perm])
        if not up:
            if k.dtype.kind in ("i", "u"):
                k = ~k  # an exact order-reversing bijection on integers
            else:
                k = -k
        t = torch.from_numpy(np.ascontiguousarray(k)).to(device)
        if t.is_floating_point():
            t = t.to(torch.float64)
            # XLA's comparisons flush subnormals: they sort equal to 0.0
            t = _f64_sort_key(torch.where(
                t.abs() < 2.2250738585072014e-308, 0.0, t))
        o = argsort_stable(t).cpu().numpy()
        perm = perm[o]
    return perm


# ---------------------------------------------------------------------------
# sketches:approx_distinct as a vectorized HyperLogLog over one register
# matrix, the value-hash sample of COUNT/SUM ... WITH ERROR, and the
# grouped percentile of approx_percentile.  The reference's uint64 values
# run as int64 bit patterns (masks and `_lsr` for the unsigned shifts),
# and nothing reads a tensor back to the host.
# ---------------------------------------------------------------------------

HLL_MAX_REGISTERS = 1 << 23  # cells of the register matrix, all groups


def dictionary_value_hashes(dic: Dictionary) -> np.ndarray:
    """XXH64 of each dictionary entry's UTF-8 bytes, as int64 bits, kept
    beside the dictionary (computed once per dictionary)."""
    from presto_tpu_torch.exec.xxh64 import xxh64_values

    return dic.derived("xxh64", lambda: xxh64_values(dic.values).view(
        np.int64))


def hll_hash64(col: Column) -> torch.Tensor:
    """The value hash of approx_distinct, as int64 bits: string columns
    hash their values (XXH64 of each dictionary entry, so dictionaries
    with other code assignments agree), numeric columns splitmix their
    orderable integers (`_rf_mix64` is the same mix)."""
    dic = col.dictionary
    if dic is not None:
        if len(dic) == 0:
            return torch.zeros(col.data.shape, dtype=torch.int64,
                               device=col.data.device)
        hv = upload(dictionary_value_hashes(dic), col.data.device)
        return hv[col.data.clamp(0, len(dic) - 1).long()]
    return _rf_mix64(_orderable_int(col))


def hll_register_count(n_groups: int, m: int = 1024) -> int:
    """The registers a group gets: m, halved (not below 64) until the
    matrix holds at most HLL_MAX_REGISTERS cells."""
    while m > 64 and n_groups * m > HLL_MAX_REGISTERS:
        m //= 2
    return m


def _bit_length32(w: torch.Tensor) -> torch.Tensor:
    """Bits needed for each w in [0, 2^32) (0 for 0), by binary search
    in integers: the reference's rho, 32 - floor(log2(w)) in f64 (33 for
    0), is 33 minus this on every device."""
    n = torch.zeros_like(w)
    for s in (16, 8, 4, 2, 1):
        hi = w >= (1 << s)
        n = n + torch.where(hi, s, 0)
        w = torch.where(hi, w >> s, w)
    return n + (w > 0).to(w.dtype)


def hll_registers_and_estimate(h: torch.Tensor, valid: torch.Tensor,
                               gid: torch.Tensor, n_groups: int,
                               m: int = 1024) -> torch.Tensor:
    """HyperLogLog per group: the low log2(m) bits of the hash pick a
    register, the next 32 bits give rho (the position of their leading
    one, 33 for none), one scatter-max fills the (n_groups, m) matrix,
    and hll_estimate reads it.  m shrinks with many groups
    (hll_register_count)."""
    m = hll_register_count(n_groups, m)
    log2m = m.bit_length() - 1
    reg = h & (m - 1)
    w = _lsr(h, log2m) & 0xFFFFFFFF
    rho = 33 - _bit_length32(w)
    dead = n_groups * m
    seg = torch.where(valid, gid.to(torch.int64) * m + reg, dead)
    M = torch.zeros((dead + 1,), dtype=torch.int64, device=h.device)
    M.scatter_reduce_(0, seg.clamp(0, dead), torch.where(valid, rho, 0),
                      "amax")
    return hll_estimate(M[:dead].reshape(n_groups, m))


def hll_m_for_error(e: float) -> int:
    """Register count for a standard error e: the power of two with
    1.04 / sqrt(m) <= e, in [64, 65536]."""
    m = 64
    while m < 65536 and 1.04 / np.sqrt(m) > e:
        m *= 2
    return m


_NEG_POW2: Dict[str, torch.Tensor] = {}  # 2^-k, k = 0..64, per device


def hll_estimate(M: torch.Tensor) -> torch.Tensor:
    """Bias-corrected HLL estimate with small-range linear counting from
    an (n_groups, m) integer register matrix; int64, rounded half to
    even.  The sum of 2^-M is exact in f64 (powers of two from a table,
    at most 49 significant bits), so its order does not matter."""
    m = M.shape[1]
    key = str(M.device)
    pow2 = _NEG_POW2.get(key)
    if pow2 is None:
        pow2 = _NEG_POW2[key] = upload(
            np.asarray([2.0 ** -k for k in range(65)]), M.device)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    E = true_div(alpha * m * m, pow2[M.clamp(0, 64)].sum(dim=1))
    zeros = (M == 0).sum(dim=1)
    linear = m * torch.log(true_div(float(m), zeros.clamp_min(1)))
    est = torch.where((E <= 2.5 * m) & (zeros > 0), linear, E)
    return torch.round(est).to(torch.int64)


def sketch_sample_mask(h: torch.Tensor) -> torch.Tensor:
    """The deterministic 1-in-8 value sample of COUNT/SUM ... WITH
    ERROR: rows whose value hash is 0 modulo 8."""
    return (h & 7) == 0


def _f64_sort_key(x: torch.Tensor) -> torch.Tensor:
    """An int64 key ordering doubles as jnp.lexsort does on every
    device: -0.0 equal to 0.0, every NaN last."""
    b = x.view(torch.int64)
    key = torch.where(b < 0, b ^ I64_MAX, b)
    key = torch.where(x == 0, 0, key)
    return torch.where(torch.isnan(x), I64_MAX, key)


def group_percentile(x: torch.Tensor, valid: torch.Tensor,
                     gid: torch.Tensor, n_groups: int, p: float,
                     order: Optional["GroupOrder"] = None):
    """Each group's p-th value by one global sort by (group, value): the
    value at rank floor(p * (count - 1)) of the group's valid rows, and
    whether the group has any.  Ties keep row order (stable sorts, minor
    key first), and the value comes back as the input held it."""
    cnt = segment_sum(valid.to(torch.int64), gid, n_groups, order)
    xf = torch.where(valid, x.to(torch.float64), float("inf"))
    g = torch.where(valid, gid.to(torch.int64), n_groups)
    perm = argsort_stable(_f64_sort_key(xf))
    perm = perm[argsort_stable(g[perm])]
    starts = torch.cumsum(cnt, 0) - cnt
    last = (cnt - 1).clamp_min(0)
    k = torch.minimum(torch.floor(p * last.to(torch.float64))
                      .to(torch.int64).clamp_min(0), last)
    pos = (starts + k).clamp(0, max(x.shape[0] - 1, 0))
    if x.shape[0] == 0:
        return torch.zeros((n_groups,), dtype=x.dtype,
                           device=x.device), cnt > 0
    return x[perm[pos]], cnt > 0


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
    gid [n] int32 in [0, n_groups); returns [k, n_groups] f64.

    It sums in two levels, as the reference's interpreter path does:
    each block of _FGS_PLAIN_BLOCK rows into its own table, then the
    tables.  One index_add_ over all n rows adds each group's rows in
    one chain: on an H100, on TPC-H Q1's input at SF1 (up to 2.9M rows a
    group), that was 2.8e-12 off the correctly rounded sums, and two
    levels 7e-15 (chip_smoke.py checks both versions against them)."""
    k, n = vals.shape
    block = torch.arange(n, device=vals.device) // _FGS_PLAIN_BLOCK
    slot = gid.long() + block * n_groups
    blocks = -(-n // _FGS_PLAIN_BLOCK)
    tables = torch.zeros((k, blocks * n_groups), dtype=torch.float64,
                         device=vals.device)
    tables.index_add_(1, slot, vals.to(torch.float64))
    return tables.view(k, blocks, n_groups).sum(1)


_FGS_PLAIN_BLOCK = 8192  # the reference kernel's BLOCK


_FGS_THREADS = 256
_FGS_REGISTER_GROUPS = 16   # G up to this takes the register path
_FGS_ACC_DOUBLES = 32       # register accumulators per thread (kc * slots)
_FGS_SLICE_ROWS = 8         # most value rows of one register-path slice
_FGS_REGISTER_BLOCKS_PER_SM = 2
_FGS_TABLE_BYTES = 64 * 1024       # shared-table path: table per block
_FGS_SMEM_PER_SM = 228 * 1024      # H100
_FGS_SMEM_PER_BLOCK = 227 * 1024   # H100, dynamic shared memory
_FGS_SMEM_RESERVED = 1024          # the runtime's share of each block
_FGS_BLOCKS_PER_SM = 2048 // _FGS_THREADS


class FgsPlan(NamedTuple):
    """One launch of csrc/fused_group_sums.cu.  path "registers": each
    thread sums into `group_slots` register accumulators per value row;
    "shared_table": one table of `smem_bytes` in each block's shared
    memory.  blockIdx.y takes `slices` slices of `rows_per_slice` value
    rows (each slice reads gid once); blockIdx.x `blocks` row blocks per
    slice; the merge sums the [blocks, k, G] partials in block order."""
    path: str
    group_slots: int
    rows_per_slice: int
    slices: int
    blocks: int
    smem_bytes: int


_FGS_PATHS = {"registers": 0, "shared_table": 1}  # the C code's path ids


def fgs_register_slice_rows(group_slots: int) -> int:
    """The most value rows a register-path slice takes at group_slots
    accumulators a row.  The C source's template bounds must hold them
    (its fused_group_sums_bounds reports them)."""
    return min(_FGS_SLICE_ROWS, _FGS_ACC_DOUBLES // group_slots)


def _slices(k: int, most: int) -> Tuple[int, int]:
    """(rows per slice, slices): at most `most` rows a slice, balanced."""
    slices = -(-k // most)
    return -(-k // slices), slices


def fgs_vectors(n: int, elem_bytes: int) -> int:
    """The 16-byte vectors of E = 16 / elem_bytes values each that the
    register path reads from every value row, whatever the row's
    alignment (the C code's `vecs`): (n - E + 1) // E, 0 below E."""
    e = 16 // elem_bytes
    return (n - e + 1) // e if n >= e else 0


def fused_group_sums_launch_shape(n: int, k: int, n_groups: int,
                                  sm_count: int,
                                  elem_bytes: int = 8) -> FgsPlan:
    """The launch plan for vals [k, n] of elem_bytes-wide values (8: f64,
    4: f32) and n_groups groups on a card of sm_count SMs.  It follows
    the shape alone: up to _FGS_REGISTER_GROUPS groups the atomic-free
    register path (bit identical from run to run on one card, for one
    16-byte alignment of vals), above it the shared-table path; either
    way each slice of value rows reads gid once and only its own rows.
    Raises ValueError when one row of the table would not fit a block's
    shared memory."""
    if n_groups <= _FGS_REGISTER_GROUPS:
        slots = 1 << (n_groups - 1).bit_length()
        kc, slices = _slices(k, fgs_register_slice_rows(slots))
        blocks = min(-(-sm_count * _FGS_REGISTER_BLOCKS_PER_SM // slices),
                     -(-fgs_vectors(n, elem_bytes) // _FGS_THREADS))
        return FgsPlan("registers", slots, kc, slices,
                       max(blocks, 1) if n else 0, 0)
    row_bytes = 8 * n_groups
    if row_bytes > _FGS_SMEM_PER_BLOCK:
        raise ValueError(f"fused_group_sums: {n_groups} groups need "
                         f"{row_bytes} bytes of shared memory a value row, "
                         f"more than a block has ({_FGS_SMEM_PER_BLOCK})")
    kc, slices = _slices(k, max(1, _FGS_TABLE_BYTES // row_bytes))
    smem = kc * row_bytes
    per_sm = max(1, min(_FGS_BLOCKS_PER_SM,
                        _FGS_SMEM_PER_SM // (smem + _FGS_SMEM_RESERVED)))
    # no more blocks than keep each block's rows above its table's size
    blocks = min(-(-sm_count * per_sm // slices),
                 -(-n // max(_FGS_THREADS, n_groups)))
    return FgsPlan("shared_table", 0, kc, slices,
                   max(blocks, 1) if n else 0, smem)


def fused_group_sums(vals: torch.Tensor, gid: torch.Tensor,
                     n_groups: int) -> torch.Tensor:
    """ONE pass computing k segmented sums that share group ids.

    vals [k, n] f64 or f32 (dead rows already zeroed), gid [n] int32 in
    [0, n_groups); returns [k, n_groups] f64: the f64 sums of the values
    as stored.  CPU tensors take the plain version; everything else goes
    to the CUDA kernel, which launches or raises."""
    if vals.device.type == "cpu" and gid.device.type == "cpu":
        return fused_group_sums_plain(vals, gid, n_groups)
    return fused_group_sums_cuda(vals, gid, n_groups)


def fused_group_sums_cuda(vals: torch.Tensor, gid: torch.Tensor,
                          n_groups: int) -> torch.Tensor:
    """Launch csrc/fused_group_sums.cu on the current stream: vals [k, n]
    f64 (entry point fused_group_sums_f64) or f32 (fused_group_sums_f32in,
    which reads the f32 values and sums them in f64) and gid [n] int32,
    contiguous, on one CUDA device; 1 <= k and 1 <= n_groups.  Raises on
    anything else and when the launch fails; counts each launch in
    `fused_group_sums_cuda.launches`, and the f32 ones also in
    `fused_group_sums_cuda.launches_f32`."""
    if vals.device.type != "cuda" or gid.device != vals.device:
        raise ValueError(f"fused_group_sums: vals on {vals.device}, gid on "
                         f"{gid.device}; both must be on one CUDA device")
    if vals.dtype not in (torch.float64, torch.float32) \
            or gid.dtype != torch.int32:
        raise TypeError(f"fused_group_sums: vals {vals.dtype} (needs "
                        f"float64 or float32), gid {gid.dtype} (needs "
                        "int32)")
    if vals.ndim != 2 or gid.ndim != 1 or vals.shape[1] != gid.shape[0]:
        raise ValueError(f"fused_group_sums: shapes {tuple(vals.shape)} and "
                         f"{tuple(gid.shape)} do not match [k, n] and [n]")
    if not (vals.is_contiguous() and gid.is_contiguous()):
        raise ValueError("fused_group_sums: inputs must be contiguous")
    k, n = vals.shape
    if k < 1 or n_groups < 1:
        raise ValueError(f"fused_group_sums: k={k}, n_groups={n_groups}")
    from presto_tpu_torch.exec import cuda_build

    sm = torch.cuda.get_device_properties(vals.device).multi_processor_count
    f32 = vals.dtype == torch.float32
    plan = fused_group_sums_launch_shape(n, k, n_groups, sm,
                                         vals.element_size())
    lib = cuda_build.load("fused_group_sums")
    entry = lib.fused_group_sums_f32in if f32 else lib.fused_group_sums_f64
    partials = torch.empty((plan.blocks, k, n_groups), dtype=torch.float64,
                           device=vals.device)
    out = torch.empty((k, n_groups), dtype=torch.float64, device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):  # the runtime launches on it
        rc = entry(
            vals.data_ptr(), gid.data_ptr(), n, k, n_groups,
            _FGS_PATHS[plan.path], plan.group_slots, plan.rows_per_slice,
            plan.slices, plan.blocks, plan.smem_bytes, partials.data_ptr(),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("fused_group_sums kernel failed: "
                           + cuda_build.error_string(lib, rc))
    fused_group_sums_cuda.launches += 1
    fused_group_sums_cuda.launches_f32 += f32
    return out


fused_group_sums_cuda.launches = 0
fused_group_sums_cuda.launches_f32 = 0
