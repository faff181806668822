"""The extended function corpus over TPC-H: the names of the port's
functions/scalar_ext.py and scalar_ext2.py, each query reaching a group
of them, run through `connect(catalog).sql(text)`.  chip_smoke.py runs
these at SF1 and the tests at SF0.01, from these strings.

- E1: math and CDFs summed per l_returnflag, l_linestatus over lineitem
  (the regularized incomplete beta at a constant count, bit_count's
  SWAR, is_nan of a 0/0 ratio), beside count(*): fused_group_sums; its
  sum of sin(l_extendedprice) mixes signs and cancels (to -0.68 over
  1.5M rows in one group at SF1), held at SF1 to the exact sums of the
  sines (exact_sin_sums: presto_tpu's SF1 scan gives some prices one
  ulp off, which moves that sum by more than the comparison's
  tolerance, ROADMAP C);
- E2: the inverse CDFs over orders, their arguments o_totalprice /
  600000, grouped by o_orderpriority (bisections at the reference's
  counts over every order);
- E3: string distances, soundex, translate, regexp_count and word_stem
  over part by p_mfgr, a dictionary x dictionary levenshtein_distance
  and jaccard_index among them;
- E4: VARBINARY codecs and hashes over customer JOIN orders by
  c_mktsegment (the join's gathers: block_gather on the card), with the
  big-endian and IEEE round trips, which read their column on the host;
- E5: the URL family, concat_ws and split_to_map over URLs built from
  nation, region and customer;
- E6: zone-less dates: date_format keys with sum(o_totalprice), hour
  and minute of a TIMESTAMP + INTERVAL, date_parse, from_iso8601_date,
  parse_duration;
- E7: the array and map long tail over split(p_name, ' ');
- E8: the volatile queries (TABLESAMPLE BERNOULLI over lineitem JOIN
  orders, random, uuid, shuffle), held to properties, not values;
- E9a: IS [NOT] DISTINCT FROM in a filter and inside a CASE; E9b: the
  DECIMAL math over CAST(l_extendedprice AS DECIMAL(12,2)) and
  CAST(l_discount AS DECIMAL(4,2)), held to Python's decimal (presto_tpu
  computes other values: ROADMAP C);
- E10: a DOUBLE column divided by 3, its round, truncate and log10, as
  VARCHAR: the strings show a division that is one ulp off (a tensor
  divided by a host scalar on the card, ROADMAP C 0).
"""

from __future__ import annotations

from decimal import Decimal
from typing import Dict, List

# the records' bookkeeping is the decimal corpus's
from presto_tpu_torch.decimal_queries import (  # noqa: F401
    compact_reference, expand_reference, memo_state)

_P = "o_totalprice / 600000"
_URL = ("'https://' || replace(lower(n_name), ' ', '-') || "
        "'.example.com:8080/' || lower(r_name) || '?seg=' || c_mktsegment "
        "|| '&k=1#top'")
_WORDS = "split(p_name, ' ')"
_LENS = f"transform({_WORDS}, w -> length(w))"

QUERIES = {
    "E1": ("SELECT l_returnflag, l_linestatus, sum(sin(l_extendedprice)), "
           "sum(cbrt(l_quantity)), sum(degrees(atan(l_discount))), "
           "sum(normal_cdf(0.05, 0.02, l_discount)), "
           "sum(beta_cdf(2, 5, l_discount * 5)), "
           "sum(poisson_cdf(25, l_quantity)), "
           "sum(wilson_interval_lower(l_quantity, 50, 1.96)), "
           "count_if(is_nan(l_discount / l_discount)), "
           "sum(bit_count(l_orderkey, 64)), count(*) FROM lineitem "
           "GROUP BY l_returnflag, l_linestatus "
           "ORDER BY l_returnflag, l_linestatus"),
    "E2": ("SELECT o_orderpriority, "
           f"sum(inverse_normal_cdf(10, 1, {_P})), "
           f"sum(inverse_beta_cdf(2, 5, {_P})), "
           f"sum(inverse_chi_squared_cdf(3, {_P})), "
           f"sum(inverse_gamma_cdf(2, 3, {_P})), "
           f"sum(inverse_poisson_cdf(10, {_P})), "
           f"sum(inverse_weibull_cdf(1.5, 2, {_P})), "
           f"sum(inverse_laplace_cdf(10, 1, {_P})), "
           f"sum(inverse_logistic_cdf(10, 1, {_P})), "
           f"sum(inverse_cauchy_cdf(1000, 1, {_P})), count(*) FROM orders "
           "GROUP BY o_orderpriority ORDER BY o_orderpriority"),
    "E3": ("SELECT p_mfgr, count(*), "
           "sum(levenshtein_distance(p_brand, 'Brand#23')), "
           "sum(levenshtein_distance(p_brand, p_container)), "
           "max(jaccard_index(p_mfgr, p_brand)), "
           "sum(hamming_distance(p_brand, 'Brand#11')), "
           "min(soundex(p_container)), max(soundex(p_type)), "
           "max(translate(p_type, 'AEIOU', 'aeiou')), "
           "sum(regexp_count(p_name, '[aeiou]')), "
           "max(regexp_position(p_type, 'BRASS')), "
           "max(word_stem(p_container)), min(word_stem(lower(p_type))) "
           "FROM part GROUP BY p_mfgr ORDER BY p_mfgr"),
    "E4": ("SELECT c_mktsegment, count(*), "
           "sum(crc32(to_utf8(c_phone))), "
           "max(to_hex(md5(to_utf8(c_name)))), "
           "min(to_base64(sha256(to_utf8(c_mktsegment)))), "
           "max(from_big_endian_64(xxhash64(to_utf8(c_phone)))), "
           "min(to_hex(sha1(to_utf8(c_address)))), "
           "max(to_hex(hmac_sha256(to_utf8(c_mktsegment), to_utf8('k')))), "
           "max(from_utf8(from_base64(to_base64(to_utf8(c_name))))), "
           "sum(from_big_endian_64(to_big_endian_64(c_nationkey))), "
           "max(from_ieee754_64(to_ieee754_64(c_acctbal))), "
           "sum(o_totalprice) FROM customer JOIN orders "
           "ON c_custkey = o_custkey "
           "GROUP BY c_mktsegment ORDER BY c_mktsegment"),
    "E5": (f"SELECT url_extract_host(u) AS host, url_extract_path(u), "
           "url_extract_parameter(u, 'seg'), url_extract_port(u), "
           "url_extract_protocol(u), url_extract_fragment(u), "
           "max(url_extract_query(u)), max(url_decode(url_encode(u))), "
           "min(concat_ws('/', r_name, n_name, c_mktsegment)), "
           "max(element_at(split_to_map(url_extract_query(u), '&', '='), "
           "'seg')), count(*) "
           f"FROM (SELECT {_URL} AS u, r_name, n_name, c_mktsegment "
           "FROM customer, nation, region WHERE c_nationkey = n_nationkey "
           "AND n_regionkey = r_regionkey) t "
           "GROUP BY 1, 2, 3, 4, 5, 6 ORDER BY 1, 2, 3"),
    "E6": ("SELECT date_format(o_orderdate, '%Y-%m') AS ym, "
           "sum(o_totalprice), count(*), "
           "max(hour(CAST(o_orderdate AS TIMESTAMP) + INTERVAL '5' HOUR)), "
           "max(minute(CAST(o_orderdate AS TIMESTAMP) "
           "+ INTERVAL '90' MINUTE)), "
           "min(day_of_month(o_orderdate)), max(year_of_week(o_orderdate)), "
           "count_if(CAST(o_orderdate AS TIMESTAMP) "
           "< date_parse('1995-01-01', '%Y-%m-%d')), "
           "count_if(o_orderdate < from_iso8601_date('1995-06-17')), "
           "max(to_milliseconds(parse_duration('1.5s'))) FROM orders "
           "GROUP BY date_format(o_orderdate, '%Y-%m') ORDER BY ym"),
    "E7": ("SELECT p_mfgr, count(*), "
           f"max(array_sum({_LENS})), sum(array_average({_LENS})), "
           f"max(cardinality(ngrams({_WORDS}, 2))), "
           f"max(array_join(array_sort_desc({_WORDS}), ',')), "
           f"count_if(array_has_duplicates({_WORDS})), "
           f"max(cardinality(array_frequency({_WORDS}))), "
           f"count_if(any_keys_match(array_frequency({_WORDS}), "
           "k -> k = 'green')), "
           f"count_if(no_values_match(array_frequency({_WORDS}), "
           "v -> v > 1)), "
           f"max(cardinality(map_subset(array_frequency({_WORDS}), "
           "ARRAY['green', 'red', 'blue']))) "
           "FROM part GROUP BY p_mfgr ORDER BY p_mfgr"),
    "E9a": ("SELECT l_returnflag, count(*), "
            "count_if(l_linestatus IS DISTINCT FROM 'F'), "
            "sum(CASE WHEN l_discount IS NOT DISTINCT FROM 0.05 "
            "THEN 1 ELSE 0 END), "
            "sum(CASE WHEN l_tax IS DISTINCT FROM 0.0 THEN l_quantity "
            "ELSE 0 END) FROM lineitem "
            "WHERE l_shipmode IS DISTINCT FROM 'AIR' "
            "GROUP BY l_returnflag ORDER BY l_returnflag"),
    "E9b": ("SELECT l_returnflag, l_linestatus, count(*), "
            "sum(floor(CAST(l_extendedprice AS DECIMAL(12,2)))), "
            "sum(ceil(CAST(l_extendedprice AS DECIMAL(12,2)))), "
            "sum(round(CAST(l_extendedprice AS DECIMAL(12,2)), -1)), "
            "sum(mod(CAST(l_extendedprice AS DECIMAL(12,2)), "
            "DECIMAL '7.5')), "
            "sum(sign(CAST(l_discount AS DECIMAL(4,2)) - DECIMAL '0.05')), "
            "sum(abs(CAST(l_discount AS DECIMAL(4,2)) - DECIMAL '0.05')), "
            "max(round(CAST(l_extendedprice AS DECIMAL(12,2)) "
            "* CAST(l_discount AS DECIMAL(4,2)), 2)) FROM lineitem "
            "GROUP BY l_returnflag, l_linestatus "
            "ORDER BY l_returnflag, l_linestatus"),
    "E10": ("SELECT n_nationkey, CAST(x / 3 AS VARCHAR), "
            "CAST(round(x / 3, 2) AS VARCHAR), "
            "CAST(truncate(x / 3, 2) AS VARCHAR), "
            "CAST(log10(x / 3) AS VARCHAR) FROM (SELECT n_nationkey, "
            "CAST(n_nationkey AS DOUBLE) + 5 AS x FROM nation) t "
            "ORDER BY n_nationkey"),
}

#: the volatile queries, held to properties
VOLATILE = {
    "E8a": ("SELECT l_returnflag, count(*) FROM lineitem "
            "TABLESAMPLE BERNOULLI (10) JOIN orders "
            "ON l_orderkey = o_orderkey "
            "GROUP BY l_returnflag ORDER BY l_returnflag"),
    "E8b": "SELECT count(*) FROM lineitem TABLESAMPLE BERNOULLI (10)",
    "E8c": ("SELECT n_nationkey, random(), random(10), uuid() FROM nation "
            "ORDER BY n_nationkey"),
    "E8d": ("SELECT r_regionkey, shuffle(ARRAY[1, 2, 3, 4, 5, 6, 7, 8]), "
            "shuffle(split(r_comment, ' ')) FROM region "
            "ORDER BY r_regionkey"),
}

#: the queries whose rows presto_tpu's values hold (E9b: Python's decimal)
REFERENCE_IDS = ("E1", "E2", "E3", "E4", "E5", "E6", "E7", "E9a", "E10")
#: the queries that must launch each kernel on the card
FUSED_IDS = ("E1",)
GATHER_IDS = ("E4",)


def value(v):
    """One result value in comparable, JSON-able form: a Decimal as
    "d:<text>", VARBINARY bytes as "x:<hex>", a collection as a list."""
    if isinstance(v, Decimal):
        return "d:" + str(v)
    if isinstance(v, bytes):
        return "x:" + v.hex()
    if isinstance(v, tuple):
        return [value(e) for e in v]
    return v


def values(rows) -> List[list]:
    return [[value(v) for v in r] for r in rows]


def record(session, sql: str, keys) -> dict:
    """One query run: its rows (or its error's type and first line), the
    column types, execution mode, seven counters (`keys`) and memo
    entry."""
    try:
        res = session.sql(sql)
    except Exception as e:  # noqa: BLE001 - an error is a result here
        return {"error": [type(e).__name__, str(e).split("\n")[0]],
                "rows": None, "types": None, "mode": None,
                "counters": None, "memo": memo_state(session, sql)}
    return {"error": None, "rows": values(res.rows),
            "types": [str(t) for _n, t in res.columns],
            "mode": res.stats.execution_mode,
            "counters": [int(getattr(res.stats, k, 0)) for k in keys],
            "memo": memo_state(session, sql)}


def _close(a, b, rtol: float) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if a != a and b != b:
            return True
        return abs(a - b) <= rtol * max(abs(a), abs(b))
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y, rtol)
                                        for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def mismatch(qid: str, mine: dict, theirs: dict, rtol: float = 1e-9,
             with_rows: bool = True) -> str:
    """'' when a query's record equals presto_tpu's: the same error (a
    StaticFallback by type alone), column types, execution mode, counters
    and memo entry, and with `with_rows` the same rows (floats within
    rtol, all else exactly); else the first difference."""
    ea, eb = mine["error"], theirs["error"]
    if ea != eb and not (ea and eb and ea[0] == eb[0] == "StaticFallback"):
        return f"{qid}: error {ea} against {eb}"
    for k in ("types", "mode", "counters", "memo"):
        if mine.get(k) != theirs.get(k):
            return f"{qid}: {k} {mine.get(k)} against {theirs.get(k)}"
    if not with_rows:
        return ""
    a, b = mine["rows"], theirs["rows"]
    if a is None or b is None:
        return "" if a is b else f"{qid}: rows {a} against {b}"
    if len(a) != len(b):
        return f"{qid}: {len(a)} rows against {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        if len(x) != len(y) or not all(_close(p, q, rtol)
                                       for p, q in zip(x, y)):
            return f"{qid} row {i}: {x} against {y}"
    return ""


# ---------------------------------------------------------------------------
# E1's sine sums and E9b against exact host values, from the generated
# columns
# ---------------------------------------------------------------------------

#: the column of E1's rows that sums sin(l_extendedprice)
E1_SIN_COLUMN = 2


def exact_sin_sums(returnflag, linestatus, extendedprice) -> List[list]:
    """[[l_returnflag, l_linestatus, sum]] in E1's order: each group's
    sum of sin(l_extendedprice) by math.fsum (exactly rounded) of
    numpy's sines (libm, within an ulp of the true sine)."""
    import math

    import numpy as np

    rf, ls = np.asarray(returnflag), np.asarray(linestatus)
    s = np.sin(np.asarray(extendedprice, dtype=np.float64))
    return [[str(a), str(b), math.fsum(s[(rf == a) & (ls == b)])]
            for a, b in sorted(set(zip(rf.tolist(), ls.tolist())))]


def decimal_math_rows(returnflag, linestatus, extendedprice, discount):
    """E9b's rows from the host columns (floats, as generated), each
    value through Python's decimal: CAST(x AS DECIMAL(12,2)) rounds half
    up at two digits."""
    import decimal as D

    ctx = D.Context(prec=60)
    cent = Decimal("0.01")

    def dec2(x):
        return ctx.create_decimal_from_float(float(x)).quantize(
            cent, rounding=D.ROUND_HALF_UP, context=ctx)

    def rnd(d, digits):
        return d.quantize(Decimal(1).scaleb(-digits),
                          rounding=D.ROUND_HALF_UP, context=ctx)

    groups: Dict[tuple, list] = {}
    five = Decimal("0.05")
    seven = Decimal("7.5")
    for rf, ls, p, d in zip(returnflag, linestatus, extendedprice, discount):
        price, disc = dec2(p), dec2(d)
        g = groups.setdefault((str(rf), str(ls)), [
            0, Decimal(0), Decimal(0), Decimal(0), Decimal(0), Decimal(0),
            Decimal(0), None])
        diff = disc - five
        rem = price.copy_abs() % seven
        g[0] += 1
        g[1] += price.to_integral_value(D.ROUND_FLOOR)
        g[2] += price.to_integral_value(D.ROUND_CEILING)
        g[3] += rnd(price, -1)
        g[4] += rem if price >= 0 else -rem
        g[5] += (diff > 0) - (diff < 0)
        g[6] += abs(diff)
        prod = rnd(price * disc, 2)
        g[7] = prod if g[7] is None or prod > g[7] else g[7]
    return [[rf, ls, g[0], *g[1:]] for (rf, ls), g in sorted(groups.items())]


def decimal_math_values(rows) -> List[list]:
    """E9b's rows (as `values` gives them: a long decimal "d:<text>", a
    short one a float) as Decimals, for comparison with
    decimal_math_rows."""
    def dec(v):
        return Decimal(v[2:]) if isinstance(v, str) and v.startswith("d:") \
            else Decimal(str(v))

    return [[r[0], r[1], r[2]] + [dec(v) for v in r[3:]] for r in rows]
