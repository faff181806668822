"""Scalar functions, the third batch: volatile functions, inverse CDFs,
cosine_similarity, the string, color, array and map long tail, the
orderings of ARRAY and ROW values and IS [NOT] DISTINCT FROM.

Reference: presto_tpu/functions/scalar_ext2.py.  Its overloads of
array_sort (a comparator lambda) and array_join (a NULL replacement) are
functions/scalar.py's already; this module adds regexp_replace's lambda
replacement.

The volatile functions (random, rand, uuid, shuffle) draw on the host
when the query is evaluated, one value per row of the batch
(`session_ctx.batch_capacity`), and upload their draws through
`batch.upload`.  Their texts key the compiled memo per execution
(`executor._volatile_nonce`), so every run builds anew; within one
build, the eager pass and the capture of a CUDA graph see the same draws
(`batch.volatile_draw`).  The inverse CDFs solve on the device at the
reference's fixed iteration counts: 36 doublings of the bracket, 56
bisections, 40 for the discrete ones.
"""

from __future__ import annotations

import itertools
import math
import os
import uuid as _uuid

import numpy as np
import torch

from presto_tpu_torch import session_ctx
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Dictionary, upload, volatile_draw
from presto_tpu_torch.exec.colval import (ColVal, LambdaVal, all_valid,
                                          refuse_host_read)
from presto_tpu_torch.functions.scalar import (
    REGISTRY, _arr_entries, _check_lambda, _colval_from_pylist, _combo_codes,
    _const_arg, _constant, _from_tables, _fn_ret, _is_array, _is_function,
    _is_map, _is_tensor, _kept, _lambda_key, _literal_dictionary, _map_sort,
    _map_value_fn, _pair_codes, _pylist_from_colval, _result_tables,
    _tuple_dict_normalize, register)
from presto_tpu_torch.functions.scalar_ext import (
    _array_fn, _gammainc, _gammaincc, _half, _mathNd, betainc,
    betainc_iters, true_div)

# ---------------------------------------------------------------------------
# volatile functions (reference: FunctionMetadata deterministic=false)
# ---------------------------------------------------------------------------

#: the most rows a uuid() call draws for (the reference's bound)
UUID_MAX_ROWS = 200_000


def _fresh_rng() -> np.random.Generator:
    return np.random.default_rng(int.from_bytes(os.urandom(8), "little"))


def _rows() -> int:
    cap = session_ctx.batch_capacity()
    return int(cap) if cap else 1


def _resolve_random(args):
    if not args:
        return T.DOUBLE
    if len(args) == 1 and args[0].is_integer:
        return args[0]
    return None


def _per_row(vals: np.ndarray):
    """A draw per row as a column on the session's device (a single row
    as a 0-d tensor, as the reference's is a 0-d array)."""
    data = upload(vals, session_ctx.device())
    return data if len(vals) > 1 else data[0]


def _emit_random(args):
    """random() -> [0, 1) DOUBLE per row; random(n) -> [0, n) in n's
    integer type (reference: MathFunctions.random)."""
    n = _rows()
    if not args:
        return ColVal(_per_row(volatile_draw(lambda: _fresh_rng().random(n))),
                      None, T.DOUBLE)
    bound = args[0]
    if _is_tensor(bound.data) and bound.data.ndim > 0:
        raise NotImplementedError("random(n) needs a constant bound")
    b = int(_constant("random", bound))
    if b <= 0:
        raise ValueError("bound must be positive")
    vals = volatile_draw(lambda: _fresh_rng().integers(0, b, size=n))
    return ColVal(_per_row(vals.astype(bound.type.numpy_dtype())),
                  bound.valid, bound.type)


register("random", _resolve_random, _emit_random)
register("rand", _resolve_random, _emit_random)


def _emit_uuid(args):
    n = _rows()
    if n > UUID_MAX_ROWS:
        raise NotImplementedError(
            "uuid() over very large batches is not supported")
    vals = np.empty(n, dtype=object)
    vals[:] = volatile_draw(lambda: [str(_uuid.uuid4()) for _ in range(n)])
    codes = torch.arange(n, dtype=torch.int32, device=session_ctx.device()) \
        if n > 1 else 0
    return ColVal(codes, None, T.VARCHAR, Dictionary(vals))


register("uuid", lambda args: T.VARCHAR if not args else None, _emit_uuid)


def _emit_shuffle(args):
    col = args[0]
    seed = volatile_draw(lambda: int.from_bytes(os.urandom(8), "little"))
    rng = np.random.default_rng(seed)
    outs = []
    for t in _arr_entries(col):
        out = list(t)
        rng.shuffle(out)
        outs.append(tuple(out))
    return _from_tables(col, col.type, _result_tables(outs, col.type))


register("shuffle",
         lambda args: args[0] if len(args) == 1 and _is_array(args[0])
         else None, _emit_shuffle)


# ---------------------------------------------------------------------------
# inverse CDFs (reference: MathFunctions.inverse*Cdf): closed forms where
# they exist, else bracket doubling and bisection on the forward CDFs at
# fixed iteration counts
# ---------------------------------------------------------------------------

BISECT_ITERS = 56
GROW_DOUBLINGS = 36
DISCRETE_ITERS = 40


def _bisect(cdf, p, lo, hi, iters=BISECT_ITERS):
    # filled on the device: a tensor made from a host number copies it
    # there, which a capture forbids
    lo = torch.full(p.shape, float(lo), dtype=torch.float64, device=p.device)
    hi = torch.broadcast_to(hi, p.shape) if _is_tensor(hi) else \
        torch.full(p.shape, float(hi), dtype=torch.float64, device=p.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = cdf(mid) < p
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _grow_hi(cdf, p, start=1.0, doublings=GROW_DOUBLINGS):
    hi = torch.full(p.shape, start, dtype=torch.float64, device=p.device)
    for _ in range(doublings):
        hi = torch.where(cdf(hi) < p, hi * 2.0, hi)
    return hi


def _guard_p(p, v):
    return torch.where((p >= 0.0) & (p <= 1.0), v,
                       torch.full_like(v, math.nan))


def _inv_beta(a, b, p, hosts):
    it = betainc_iters(*hosts[:2])
    return _guard_p(p, _bisect(lambda v: betainc(a, b, v, it), p, 0.0, 1.0))


def _inv_chi2(df, p, hosts):
    def cdf(v):
        return _gammainc(_half(df), _half(v))

    return _guard_p(p, _bisect(cdf, p, 0.0, _grow_hi(cdf, p)))


def _inv_gamma(shape, scale, p, hosts):
    def cdf(v):
        return _gammainc(shape, true_div(v, scale))

    return _guard_p(p, _bisect(cdf, p, 0.0, _grow_hi(cdf, p)))


def _inv_f(d1, d2, p, hosts):
    it = betainc_iters(*hosts[:2])

    def cdf(v):
        return betainc(_half(d1), _half(d2),
                       torch.clamp(true_div(d1 * v, d1 * v + d2), 0.0, 1.0),
                       it)

    return _guard_p(p, _bisect(cdf, p, 0.0, _grow_hi(cdf, p)))


def _disc_inverse(cdf_at, p, hi0):
    """The smallest integer k with CDF(k) >= p (discrete inverses)."""
    lo = torch.zeros_like(p)
    hi = torch.broadcast_to(hi0, p.shape)
    for _ in range(DISCRETE_ITERS):
        mid = torch.floor(0.5 * (lo + hi))
        below = cdf_at(mid) < p
        lo = torch.where(below, mid + 1.0, lo)
        hi = torch.where(below, hi, mid)
    return lo


def _inv_poisson(lam, p, hosts):
    hi = lam + 12.0 * torch.sqrt(lam) + 64.0
    return _guard_p(p, _disc_inverse(
        lambda m: _gammaincc(m + 1.0, lam), p, hi))


def _inv_binomial(n, sp_, p, hosts):
    it = betainc_iters(hosts[0])

    def cdf(m):
        inner = 1.0 - betainc(torch.clamp_min(m + 1.0, 1e-30),
                              torch.clamp_min(n - m, 1e-30), sp_, it)
        return torch.where(m >= n, torch.ones_like(inner), inner)

    return _guard_p(p, _disc_inverse(cdf, p, n))


for _n, _k, _f in (
        ("inverse_beta_cdf", 3, _inv_beta),
        ("inverse_chi_squared_cdf", 2, _inv_chi2),
        ("inverse_gamma_cdf", 3, _inv_gamma),
        ("inverse_f_cdf", 3, _inv_f),
        ("inverse_laplace_cdf", 3,
         lambda mean, scale, p, hosts: _guard_p(p, torch.where(
             p < 0.5, mean + scale * torch.log(2.0 * p),
             mean - scale * torch.log(2.0 - 2.0 * p)))),
        ("inverse_logistic_cdf", 3,
         lambda mean, scale, p, hosts: _guard_p(
             p, mean + scale * torch.log(true_div(p, 1.0 - p)))),
        ("inverse_weibull_cdf", 3,
         lambda a, b, p, hosts: _guard_p(
             p, b * torch.pow(-torch.log1p(-p), true_div(1.0, a)))),
        ("inverse_poisson_cdf", 2, _inv_poisson),
        ("inverse_binomial_cdf", 3, _inv_binomial)):
    register(_n, *_mathNd(_k, _f))


# ---------------------------------------------------------------------------
# functions of two dictionary-coded values, once per distinct pair of codes
# ---------------------------------------------------------------------------


def _entry(entries, code):
    return entries[int(code)] if 0 <= int(code) < len(entries) else ()


def _pairwise(name, fn, rt):
    """fn over every distinct pair of codes (None where a side is NULL or
    fn raises), looked up through each row's pair (reference:
    _pairwise_dict_fn)."""
    def emit(args):
        uniq, inv, scalar = _pair_codes(args, name)
        entries = [_arr_entries(a) for a in args]
        outs = []
        for combo in uniq:
            if any(int(c) < 0 for c in combo):
                outs.append(None)
                continue
            try:
                outs.append(fn(*(_entry(e, c) for e, c in zip(entries,
                                                               combo))))
            except (ValueError, TypeError, ZeroDivisionError):
                outs.append(None)
        codes = _combo_codes(inv, scalar, args)
        return _from_tables(ColVal(codes, all_valid(*args), rt), rt,
                            _result_tables(outs, rt))

    return emit


def _cosine(m1, m2):
    d1, d2 = dict(m1), dict(m2)
    n1 = math.sqrt(sum(v * v for v in d1.values()))
    n2 = math.sqrt(sum(v * v for v in d2.values()))
    if n1 == 0.0 or n2 == 0.0:
        return None
    return sum(v * d2.get(k, 0.0) for k, v in d1.items()) / (n1 * n2)


register("cosine_similarity",
         lambda args: T.DOUBLE if len(args) == 2
         and all(_is_map(a) for a in args) else None,
         _pairwise("cosine_similarity", _cosine, T.DOUBLE))


# ---------------------------------------------------------------------------
# string long tail
# ---------------------------------------------------------------------------


def _strrpos(s, sub, instance=1):
    """1-based position of the instance'th occurrence from the end
    (reference: StringFunctions.stringReversePosition)."""
    inst = int(instance)
    if inst <= 0:
        raise ValueError("strrpos instance must be positive")
    if not sub:
        return 0
    pos, found = len(s), 0
    while found < inst:
        pos = s.rfind(sub, 0, pos)
        if pos < 0:
            return 0
        found += 1
    return pos + 1


def _str_fn(name, fn, rt, nargs):
    """A string and constant arguments, once per dictionary entry; an
    entry whose call raises is NULL (reference: scalar_ext2's _str_fn)."""

    def resolve(args):
        return rt if args and args[0].is_string and len(args) in nargs \
            else None

    def emit(args):
        col = _literal_dictionary(args[0])
        if not _is_tensor(col.data):
            # a literal's code on the device, as the reference's is
            col = ColVal(torch.zeros((), dtype=torch.int32,
                                     device=session_ctx.device()),
                         col.valid, col.type, col.dictionary)
        extra = tuple(_const_arg(name, a) for a in args[1:])

        def compute():
            outs = []
            for v in col.dictionary.values:
                try:
                    outs.append(fn(str(v), *extra))
                except (ValueError, TypeError, IndexError):
                    outs.append(None)
            return _result_tables(outs, rt)

        return _from_tables(col, rt, col.dictionary.derived(
            ("ext2", name, extra), compute))

    return resolve, emit


def _split_to_map(s, entry_d, kv_d):
    out = {}
    if s:
        for part in s.split(entry_d):
            k, sep, v = part.partition(kv_d)
            if not sep:
                raise ValueError(f"key-value delimiter missing in {part!r}")
            if k in out:
                raise ValueError(f"duplicate key {k!r} in split_to_map")
            out[k] = v
    return _map_sort(out.items())


def _split_to_multimap(s, entry_d, kv_d):
    out: dict = {}
    if s:
        for part in s.split(entry_d):
            k, sep, v = part.partition(kv_d)
            if not sep:
                raise ValueError(f"key-value delimiter missing in {part!r}")
            out.setdefault(k, []).append(v)
    return _map_sort((k, tuple(v)) for k, v in out.items())


def _fnv64(b: bytes) -> int:
    h = 0xCBF29CE484222325
    for c in b:
        h ^= c
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _key_sampling_percent(s):
    # a 64-bit FNV-1a stands in for the reference engine's xxHash64, as
    # in presto_tpu
    return (_fnv64(str(s).encode("utf-8")) % 100) / 100.0


# ---- word_stem: the Porter stemmer (reference: WordStemFunction) ----

_VOWELS = "aeiou"


def _is_cons(w, i):
    c = w[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(w):
    m, i, n = 0, 0, len(w)
    while i < n and _is_cons(w, i):
        i += 1
    while i < n:
        while i < n and not _is_cons(w, i):
            i += 1
        if i >= n:
            break
        m += 1
        while i < n and _is_cons(w, i):
            i += 1
    return m


def _has_vowel(w):
    return any(not _is_cons(w, i) for i in range(len(w)))


def _ends_cvc(w):
    if len(w) < 3:
        return False
    if not (_is_cons(w, len(w) - 3) and not _is_cons(w, len(w) - 2)
            and _is_cons(w, len(w) - 1)):
        return False
    return w[-1] not in "wxy"


_STEP2 = (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
          ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
          ("alli", "al"), ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
          ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
          ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
          ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
          ("biliti", "ble"))
_STEP3 = (("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
          ("ical", "ic"), ("ful", ""), ("ness", ""))
_STEP4 = ("al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
          "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize")


def _replace_suffix(w, rules, min_measure):
    for suf, rep in rules:
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > min_measure:
                w = w[:-len(suf)] + rep
            break
    return w


def _porter(word: str) -> str:
    w = word.lower()
    if len(w) <= 2:
        return w
    if w.endswith("sses") or w.endswith("ies"):  # step 1a
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]
    flag = False  # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w, flag = w[:-2], True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w, flag = w[:-3], True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1) \
                and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _ends_cvc(w):
            w += "e"
    if w.endswith("y") and _has_vowel(w[:-1]):  # step 1c
        w = w[:-1] + "i"
    w = _replace_suffix(w, _STEP2, 0)
    w = _replace_suffix(w, _STEP3, 0)
    for suf in _STEP4:  # step 4
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 1:
                w = w[:-len(suf)]
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" \
                and _measure(w[:-3]) > 1:
            w = w[:-3]
    if w.endswith("e"):  # step 5a
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem
    if len(w) >= 2 and w.endswith("ll") and _measure(w) > 1:  # step 5b
        w = w[:-1]
    return w


def _word_stem(s, lang="en"):
    if lang != "en":
        raise ValueError(f"unsupported stemmer language: {lang}")
    return _porter(s)


_DATA_SIZE_UNITS = {"B": 1, "kB": 1 << 10, "MB": 1 << 20, "GB": 1 << 30,
                    "TB": 1 << 40, "PB": 1 << 50, "EB": 1 << 60}


def _parse_data_size(s):
    import re

    m = re.fullmatch(r"\s*([\d.]+)\s*([A-Za-z]+)\s*", str(s))
    if not m or m.group(2) not in _DATA_SIZE_UNITS:
        raise ValueError(f"invalid data size: {s!r}")
    # the reference returns DECIMAL(38,0); BIGINT holds sizes to 8 EB
    return int(float(m.group(1)) * _DATA_SIZE_UNITS[m.group(2)])


# ---- color functions (ColorFunctions.java; a COLOR is a BIGINT code:
# negative for an ANSI system color, else packed 24-bit rgb) ----

_ANSI_COLORS = {"black": 1, "red": 2, "green": 3, "yellow": 4, "blue": 5,
                "magenta": 6, "cyan": 7, "white": 8}


def _parse_color(s):
    s = str(s).strip().lower()
    if s.startswith("#") and len(s) == 4:
        r, g, b = (int(c, 16) * 17 for c in s[1:])
        return (r << 16) | (g << 8) | b
    if s in _ANSI_COLORS:
        return -_ANSI_COLORS[s]
    raise ValueError(f"invalid color: {s!r}")


for _n, _f, _t, _k in (
        ("strrpos", _strrpos, T.BIGINT, (2, 3)),
        ("split_to_map", _split_to_map, T.map_of(T.VARCHAR, T.VARCHAR),
         (3,)),
        ("split_to_multimap", _split_to_multimap,
         T.map_of(T.VARCHAR, T.array_of(T.VARCHAR)), (3,)),
        ("key_sampling_percent", _key_sampling_percent, T.DOUBLE, (1,)),
        ("word_stem", _word_stem, T.VARCHAR, (1, 2)),
        ("parse_presto_data_size", _parse_data_size, T.BIGINT, (1,)),
        ("color", _parse_color, T.BIGINT, (1,))):
    register(_n, *_str_fn(_n, _f, _t, _k))


def _rgb(r, g, b):
    for v in (r, g, b):
        if not 0 <= v <= 255:
            raise ValueError("rgb component out of [0,255]")
    return (int(r) << 16) | (int(g) << 8) | int(b)


def _host_constants(name, args):
    vals = []
    for a in args:
        if _is_tensor(a.data) and a.data.ndim > 0:
            raise NotImplementedError(f"{name} over column values")
        vals.append(_const_arg(name, a))
    return vals


register("rgb",
         lambda args: T.BIGINT if len(args) == 3
         and all(a.is_integer for a in args) else None,
         lambda args: ColVal(_rgb(*(int(v) for v in _host_constants(
             "rgb", args))), all_valid(*args), T.BIGINT))


def _ansi_for(code: int) -> str:
    if code < 0:
        return f"\x1b[3{-code - 1}m"
    r, g, b = (code >> 16) & 255, (code >> 8) & 255, code & 255
    n = 16 + 36 * (r * 6 // 256) + 6 * (g * 6 // 256) + (b * 6 // 256)
    return f"\x1b[38;5;{n}m"


_RENDERED_BOOLS = ("\x1b[31m✘\x1b[0m", "\x1b[32m✔\x1b[0m")


def _emit_render(args):
    if len(args) == 1:  # render(boolean): a colored check mark or cross
        b = args[0]
        vals = np.empty(2, dtype=object)
        vals[:] = _RENDERED_BOOLS
        codes = b.data.to(torch.int32) if _is_tensor(b.data) \
            else int(bool(b.data))
        return ColVal(codes, b.valid, T.VARCHAR, Dictionary(vals))
    v, c = args
    if _is_tensor(c.data) and c.data.ndim > 0:
        raise NotImplementedError("render with a non-constant color")
    if not v.type.is_string:
        raise NotImplementedError("render over non-string values")
    prefix = _ansi_for(int(_const_arg("render", c)))
    col = _literal_dictionary(v)
    outs = [f"{prefix}{s}\x1b[0m" for s in col.dictionary.values]
    return _from_tables(ColVal(col.data, all_valid(v, c), T.VARCHAR),
                        T.VARCHAR, _result_tables(outs, T.VARCHAR))


def _resolve_render(args):
    if len(args) == 1 and args[0].name == "BOOLEAN":
        return T.VARCHAR
    if len(args) == 2 and args[1].is_integer:
        return T.VARCHAR
    return None


register("render", _resolve_render, _emit_render)


def _bar(x, width, low=-(_ANSI_COLORS["red"]), high=-(_ANSI_COLORS["green"])):
    x = min(max(float(x), 0.0), 1.0)
    width = int(width)
    if width < 0:
        raise ValueError("bar width must be >= 0")
    n = int(round(x * width))
    out = []
    for i in range(n):
        frac = i / max(n - 1, 1)
        if int(low) < 0 and int(high) < 0:
            code = int(low) if frac < 0.5 else int(high)
        else:
            lo = [(int(low) >> s) & 255 for s in (16, 8, 0)]
            hi = [(int(high) >> s) & 255 for s in (16, 8, 0)]
            code = _rgb(*(int(p + (q - p) * frac) for p, q in zip(lo, hi)))
        out.append(_ansi_for(code) + "█")
    return "".join(out) + "\x1b[0m" + " " * (width - n)


def _emit_bar(args):
    vals = np.empty(1, dtype=object)
    vals[0] = _bar(*_host_constants("bar", args))
    return ColVal(0, all_valid(*args), T.VARCHAR, Dictionary(vals))


register("bar",
         lambda args: T.VARCHAR if len(args) in (2, 4) and args[0].is_numeric
         else None, _emit_bar)


# ---------------------------------------------------------------------------
# array long tail
# ---------------------------------------------------------------------------


def _freq(v):
    out: dict = {}
    for e in v:
        if e is not None:
            out[e] = out.get(e, 0) + 1
    return _map_sort(out.items())


def _cum_sum(v):
    out, acc, dead = [], 0, False
    for e in v:
        if e is None or dead:
            out.append(None)
            dead = True  # the reference: elements after a NULL are NULL
        else:
            acc += e
            out.append(acc)
    return tuple(out)


def _normalize_arr(v, p):
    p = float(p)
    if p < 0:
        raise ValueError("array_normalize requires p >= 0")
    if any(e is None for e in v):
        return None
    if p == 0:
        return tuple(v)
    norm = sum(abs(e) ** p for e in v) ** (1.0 / p)
    if norm == 0:
        return tuple(v)
    return tuple(e / norm for e in v)


def _sort_desc(v):
    return tuple(sorted((e for e in v if e is not None), reverse=True)) \
        + tuple(None for e in v if e is None)


def _combinations(v, n):
    n = int(n)
    if n < 0 or n > 5:
        raise ValueError("combinations n must be in [0, 5]")
    return tuple(tuple(c) for c in itertools.combinations(v, n))


def _ngrams(v, n):
    n = int(n)
    if n <= 0:
        raise ValueError("ngrams n must be positive")
    if n >= len(v):
        return (tuple(v),)
    return tuple(tuple(v[i:i + n]) for i in range(len(v) - n + 1))


for _n, _f, _resolve in (
        ("array_frequency", _freq,
         lambda args: T.map_of(args[0].params[0], T.BIGINT)
         if len(args) == 1 and _is_array(args[0]) else None),
        ("array_cum_sum", _cum_sum,
         lambda args: args[0] if len(args) == 1 and _is_array(args[0])
         and args[0].params[0].is_numeric else None),
        ("array_normalize", _normalize_arr,
         lambda args: args[0] if len(args) == 2 and _is_array(args[0])
         and args[0].params[0].is_floating else None),
        ("array_sort_desc", _sort_desc,
         lambda args: args[0] if _is_array(args[0]) else None),
        ("combinations", _combinations,
         lambda args: T.array_of(args[0]) if len(args) == 2
         and _is_array(args[0]) else None),
        ("ngrams", _ngrams,
         lambda args: T.array_of(args[0]) if len(args) == 2
         and _is_array(args[0]) else None)):
    register(_n, _resolve, _array_fn(_n, _f, _resolve))


def _resolve_zip(args):
    if len(args) < 2 or not all(_is_array(a) for a in args):
        return None
    return T.array_of(T.row_of([(None, a.params[0]) for a in args]))


def _zip(*tups):
    width = max((len(t) for t in tups), default=0)
    # the reference pads the shorter arrays with NULL
    return tuple(tuple(t[k] if k < len(t) else None for t in tups)
                 for k in range(width))


def _emit_zip(args):
    rt = _resolve_zip([a.type for a in args])
    return _collections_of_codes("zip", args, rt, _zip)


def _collections_of_codes(name, args, rt, fn):
    """A collection result of several collection arguments, once per
    distinct combination of codes (a NULL side gives ())."""
    uniq, inv, scalar = _pair_codes(args, name)
    entries = [_arr_entries(a) for a in args]
    outs = np.empty(max(len(uniq), 1), dtype=object)
    outs[:] = [()] * len(outs)
    for i, combo in enumerate(uniq):
        if any(int(c) < 0 for c in combo):
            continue
        outs[i] = fn(*(_entry(e, c) for e, c in zip(entries, combo)))
    return _tuple_dict_normalize(
        outs, ColVal(_combo_codes(inv, scalar, args), all_valid(*args), rt),
        rt)


register("zip", _resolve_zip, _emit_zip)


# ---------------------------------------------------------------------------
# map long tail
# ---------------------------------------------------------------------------


def _remove_null_values(t):
    return tuple((k, v) for k, v in t if v is not None)


def _map_normalize(t):
    s = sum(v for _, v in t if v is not None)
    return tuple((k, (v / s if v is not None else None)) for k, v in t)


register("map_remove_null_values", *_map_value_fn(
    "map_remove_null_values", _remove_null_values, lambda a: a[0]))
register("map_normalize", *_map_value_fn(
    "map_normalize", _map_normalize,
    lambda a: a[0] if a[0].params[1].is_floating else None))


def _map_subset(t, keys):
    want = set(keys)
    return tuple((k, v) for k, v in t if k in want)


def _emit_map_subset(args):
    m, keys = args
    if _is_tensor(keys.data):
        return _collections_of_codes("map_subset", args, m.type,
                                     _map_subset)
    # constant keys: once per map entry, kept beside the dictionary (the
    # reference pairs the codes on the host, so its static pass falls
    # back here too)
    refuse_host_read("map_subset")
    want = _const_arg("map_subset", keys)
    return _from_tables(m, m.type, _kept(m, ("map_subset", want), lambda:
                                         _result_tables([_map_subset(
                                             t, want) for t in _arr_entries(
                                                 m)], m.type)))


register("map_subset",
         lambda args: args[0] if len(args) == 2 and _is_map(args[0])
         and _is_array(args[1]) else None,
         _emit_map_subset)


def _resolve_multimap_from_entries(args):
    a = args[0] if args else None
    if a is None or not _is_array(a) or a.params[0].name != "ROW":
        return None
    fields = a.params[0].params
    return T.map_of(fields[0][1], T.array_of(fields[1][1]))


def _multimap_from_entries(v):
    out: dict = {}
    for pair in v:
        if pair is None:
            raise ValueError("map entry cannot be null")
        k, val = pair
        if k is None:
            raise ValueError("map key cannot be null")
        out.setdefault(k, []).append(val)
    return _map_sort((k, tuple(vs)) for k, vs in out.items())


register("multimap_from_entries", _resolve_multimap_from_entries,
         _array_fn("multimap_from_entries", _multimap_from_entries,
                   _resolve_multimap_from_entries))


def _emit_map_zip_with(args):
    m1, m2, lam = args
    _check_lambda(lam, "map_zip_with")
    rt = T.map_of(m1.type.params[0], lam.ret_type)
    uniq, inv, scalar = _pair_codes([m1, m2], "map_zip_with")
    e1, e2 = _arr_entries(m1), _arr_entries(m2)
    # the unioned keys of every pair of maps, for one lambda application
    combo_keys, flat_k, flat_v1, flat_v2 = [], [], [], []
    for ca, cb in uniq:
        if int(ca) < 0 or int(cb) < 0:
            combo_keys.append(None)
            continue
        d1, d2 = dict(_entry(e1, ca)), dict(_entry(e2, cb))
        keys = sorted(set(d1) | set(d2), key=repr)
        combo_keys.append(keys)
        for k in keys:
            flat_k.append(k)
            flat_v1.append(d1.get(k))
            flat_v2.append(d2.get(k))
    res = []
    if flat_k:
        cols = {p: _colval_from_pylist(vals, t) for p, vals, t in zip(
            lam.params, (flat_k, flat_v1, flat_v2), lam.param_types)}
        res = _pylist_from_colval(lam.apply(cols), len(flat_k))
    outs = np.empty(max(len(uniq), 1), dtype=object)
    outs[:] = [()] * len(outs)
    off = 0
    for i, keys in enumerate(combo_keys):
        if keys is None:
            continue
        outs[i] = _map_sort(zip(keys, res[off:off + len(keys)]))
        off += len(keys)
    return _tuple_dict_normalize(
        outs, ColVal(_combo_codes(inv, scalar, [m1, m2]), all_valid(m1, m2),
                     rt), rt)


register("map_zip_with",
         lambda args: T.map_of(args[0].params[0], _fn_ret(args[2]))
         if len(args) == 3 and _is_map(args[0]) and _is_map(args[1])
         and _is_function(args[2]) else None,
         _emit_map_zip_with)


def _keys_values_match(name, which, quantifier):
    def emit(args):
        col, lam = args
        _check_lambda(lam, name)
        return _from_tables(col, T.BOOLEAN, _kept(
            col, (name, _lambda_key(lam)), lambda: compute(col, lam)))

    def compute(col, lam):
        entries = _arr_entries(col)
        lens = [len(t) for t in entries]
        flat = [(k if which == "keys" else v) for t in entries for k, v in t]
        res = []
        if flat:
            res = _pylist_from_colval(lam.apply({lam.params[0]: (
                _colval_from_pylist(flat, lam.param_types[0]))}), len(flat))
        outs = []
        off = 0
        for n in lens:
            window = [bool(r) if r is not None else None
                      for r in res[off:off + n]]
            off += n
            unknown = any(r is None for r in window)
            if quantifier == "all":
                v = False if any(r is False for r in window) else (
                    None if unknown else True)
            elif quantifier == "any":
                v = True if any(r is True for r in window) else (
                    None if unknown else False)
            else:
                v = False if any(r is True for r in window) else (
                    None if unknown else True)
            outs.append(v)
        return _result_tables(outs, T.BOOLEAN)

    return emit


for _n, _which, _q in (("all_keys_match", "keys", "all"),
                       ("any_keys_match", "keys", "any"),
                       ("no_keys_match", "keys", "none"),
                       ("any_values_match", "values", "any"),
                       ("no_values_match", "values", "none")):
    register(_n,
             lambda args: T.BOOLEAN if len(args) == 2 and _is_map(args[0])
             and _is_function(args[1]) else None,
             _keys_values_match(_n, _which, _q))


# ---------------------------------------------------------------------------
# regexp_replace(s, pattern, groups -> replacement) (reference:
# JoniRegexpReplaceLambdaFunction): every match's group array across every
# dictionary entry feeds one lambda application; a NULL result drops the
# match
# ---------------------------------------------------------------------------


def _emit_regexp_replace_lambda(args):
    import re

    col, pat, lam = args
    _check_lambda(lam, "regexp_replace")
    rx = re.compile(str(_const_arg("regexp_replace", pat)))
    col = _literal_dictionary(col)
    texts = [str(v) for v in col.dictionary.values]
    matches = [list(rx.finditer(t)) for t in texts]
    groups = [tuple(m.groups()) for ms in matches for m in ms]
    res = []
    if groups:
        res = _pylist_from_colval(lam.apply({lam.params[0]: (
            _colval_from_pylist(groups, T.array_of(T.VARCHAR)))}),
            len(groups))
    outs, off = [], 0
    for t, ms in zip(texts, matches):
        parts, last = [], 0
        for m in ms:
            parts.append(t[last:m.start()])
            if res[off] is not None:
                parts.append(str(res[off]))
            off += 1
            last = m.end()
        parts.append(t[last:])
        outs.append("".join(parts))
    return _from_tables(col, T.VARCHAR, _result_tables(outs, T.VARCHAR))


def _wrap_regexp_replace():
    old = REGISTRY["regexp_replace"]

    def resolve(args):
        if len(args) == 3 and args[0].is_string and _is_function(args[2]):
            return T.VARCHAR
        return old.resolve(args)

    def emit(args):
        if len(args) == 3 and isinstance(args[2], LambdaVal):
            return _emit_regexp_replace_lambda(args)
        return old.emit(args)

    register("regexp_replace", resolve, emit)


_wrap_regexp_replace()


# ---------------------------------------------------------------------------
# ARRAY and ROW orderings (reference: ArrayLessThanOperator and the
# RowComparisonOperator family): the values compare pairwise, elementwise
# lexicographic with prefix order; a NULL element makes the result NULL
# ---------------------------------------------------------------------------


def _orderable(t) -> bool:
    return t is not None and t.name in ("ARRAY", "ROW")


def _wrap_collection_cmp(name, pyop):
    old = REGISTRY[name]
    pair_emit = _pairwise(name, lambda x, y: pyop(tuple(x), tuple(y)),
                          T.BOOLEAN)

    def resolve(args):
        if len(args) == 2 and all(_orderable(a) for a in args):
            return T.BOOLEAN
        return old.resolve(args)

    def emit(args):
        if len(args) == 2 and all(_orderable(a.type) for a in args):
            return pair_emit(args)
        return old.emit(args)

    register(name, resolve, emit)


for _n, _op in (("lt", lambda x, y: x < y), ("le", lambda x, y: x <= y),
                ("gt", lambda x, y: x > y), ("ge", lambda x, y: x >= y)):
    _wrap_collection_cmp(_n, _op)


# ---------------------------------------------------------------------------
# IS [NOT] DISTINCT FROM: the null-safe comparison, never NULL
# ---------------------------------------------------------------------------


def _resolve_distinct_from(args):
    if len(args) != 2:
        return None
    return T.BOOLEAN if REGISTRY["eq"].resolve(args) is not None \
        or T.UNKNOWN in (args[0], args[1]) else None


def _validity(c: ColVal):
    return True if c.valid is None else c.valid


def _emit_distinct_from(args):
    a, b = args
    av, bv = _validity(a), _validity(b)
    if a.type == T.UNKNOWN or b.type == T.UNKNOWN:
        # a NULL literal: distinct when the other side is not NULL
        return ColVal(av | bv, None, T.BOOLEAN)
    eq = REGISTRY["eq"].emit([a, b]).data
    ne = ~eq if _is_tensor(eq) else not eq
    return ColVal((av ^ bv) | (av & bv & ne), None, T.BOOLEAN)


register("is_distinct_from", _resolve_distinct_from, _emit_distinct_from)

