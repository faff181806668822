"""TPC-H data generator connector.

Reference parity: presto-tpch (TpchConnectorFactory.java:32, TpchRecordSet) —
the deterministic generated-data connector used as the universal test
fixture (SURVEY.md §4.5).  Like the reference's airlift-tpch generator it is
deterministic per (table, scale factor, row range); unlike it, generation is
fully vectorized numpy and *counter-based* (Philox streams keyed per
(table, column)), so any split [row0, row1) of any table can be produced
independently — the property the reference gets from per-part generator
seeking, and the one our split-parallel scans need.

Faithful to dbgen in schema, key relationships (FK validity incl. the
partsupp (partkey, supplier-slot) formula), value vocabularies, and date
logic; NOT bit-identical to dbgen output (correctness testing is
differential against sqlite on the same generated data, reference analog:
H2QueryRunner).

Money columns are DOUBLE, matching the reference connector's default
(presto-tpch TpchMetadata: useDecimal=false).
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch import types as T

EPOCH = np.datetime64("1970-01-01", "D")


def _days(date_str: str) -> int:
    return int((np.datetime64(date_str, "D") - EPOCH) / np.timedelta64(1, "D"))


START_DATE = _days("1992-01-01")  # 8035
END_DATE = _days("1998-12-01")
CURRENT_DATE = _days("1995-06-17")  # dbgen's "now"

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow"
).split()

TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
# Comment vocabulary includes the words the spec's LIKE-predicates hunt for
# (Q13 '%special%requests%', Q16 '%Customer%Complaints%').
COMMENT_WORDS = (
    "blithely bold brave busy careful carefully quick quickly regular special "
    "express final furious ironic pending silent slow sly unusual even "
    "requests deposits accounts packages foxes pinto beans theodolites "
    "instructions dependencies excuses realms courts braids frays dugouts "
    "Customer Complaints sleep wake cajole nag haggle doze run dazzle boost "
    "breach affix detect doubt sublate about above according across after "
    "against along among around at before behind beside between beyond"
).split()

SUPP_PER_PART = 4

_TABLE_ROWS = {  # rows at SF1 (scaled linearly except nation/region)
    "nation": 25,
    "region": 5,
    "part": 200_000,
    "supplier": 10_000,
    "partsupp": 800_000,
    "customer": 150_000,
    "orders": 1_500_000,
    # lineitem row count is data-dependent (1..7 lines per order, avg 4)
}

SCHEMAS = {
    "region": {"r_regionkey": T.BIGINT, "r_name": T.VARCHAR, "r_comment": T.VARCHAR},
    "nation": {"n_nationkey": T.BIGINT, "n_name": T.VARCHAR,
               "n_regionkey": T.BIGINT, "n_comment": T.VARCHAR},
    "part": {"p_partkey": T.BIGINT, "p_name": T.VARCHAR, "p_mfgr": T.VARCHAR,
             "p_brand": T.VARCHAR, "p_type": T.VARCHAR, "p_size": T.INTEGER,
             "p_container": T.VARCHAR, "p_retailprice": T.DOUBLE,
             "p_comment": T.VARCHAR},
    "supplier": {"s_suppkey": T.BIGINT, "s_name": T.VARCHAR, "s_address": T.VARCHAR,
                 "s_nationkey": T.BIGINT, "s_phone": T.VARCHAR,
                 "s_acctbal": T.DOUBLE, "s_comment": T.VARCHAR},
    "partsupp": {"ps_partkey": T.BIGINT, "ps_suppkey": T.BIGINT,
                 "ps_availqty": T.INTEGER, "ps_supplycost": T.DOUBLE,
                 "ps_comment": T.VARCHAR},
    "customer": {"c_custkey": T.BIGINT, "c_name": T.VARCHAR, "c_address": T.VARCHAR,
                 "c_nationkey": T.BIGINT, "c_phone": T.VARCHAR,
                 "c_acctbal": T.DOUBLE, "c_mktsegment": T.VARCHAR,
                 "c_comment": T.VARCHAR},
    "orders": {"o_orderkey": T.BIGINT, "o_custkey": T.BIGINT,
               "o_orderstatus": T.VARCHAR, "o_totalprice": T.DOUBLE,
               "o_orderdate": T.DATE, "o_orderpriority": T.VARCHAR,
               "o_clerk": T.VARCHAR, "o_shippriority": T.INTEGER,
               "o_comment": T.VARCHAR},
    "lineitem": {"l_orderkey": T.BIGINT, "l_partkey": T.BIGINT,
                 "l_suppkey": T.BIGINT, "l_linenumber": T.INTEGER,
                 "l_quantity": T.DOUBLE, "l_extendedprice": T.DOUBLE,
                 "l_discount": T.DOUBLE, "l_tax": T.DOUBLE,
                 "l_returnflag": T.VARCHAR, "l_linestatus": T.VARCHAR,
                 "l_shipdate": T.DATE, "l_commitdate": T.DATE,
                 "l_receiptdate": T.DATE, "l_shipinstruct": T.VARCHAR,
                 "l_shipmode": T.VARCHAR, "l_comment": T.VARCHAR},
}

_TABLE_IDS = {t: i for i, t in enumerate(SCHEMAS)}


_LINEITEM_COUNT_CACHE: dict = {}


def row_count(table: str, sf: float) -> int:
    if table in ("nation", "region"):
        return _TABLE_ROWS[table]
    if table == "lineitem":
        # exact: sum of per-order line counts, computable without
        # generation.  Cached — the CBO derives stats many times per plan
        # and this sum walks 1.5M*sf hashes (seconds at SF100).
        n_orders = int(_TABLE_ROWS["orders"] * sf)
        n = _LINEITEM_COUNT_CACHE.get(n_orders)
        if n is None:
            n = int(np.sum(_lines_per_order(
                np.arange(n_orders, dtype=np.int64))))
            _LINEITEM_COUNT_CACHE[n_orders] = n
        return n
    return int(_TABLE_ROWS[table] * sf)


SEED = 20260729


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer — the counter-based RNG core.
    Each (table, column, row, draw) maps to one u64, so any row range of
    any column is reproducible independently (split independence)."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _colkey(table: str, column: str) -> np.uint64:
    h = SEED
    for ch in (table + "/" + column).encode():
        h = ((h ^ ch) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return np.uint64(h)


def _raw(table, col, row0, n, k=1):
    """(n, k) uniform doubles in [0,1) for rows [row0, row0+n)."""
    with np.errstate(over="ignore"):
        rows = np.arange(row0, row0 + n, dtype=np.uint64)[:, None]
        draws = np.arange(k, dtype=np.uint64)[None, :]
        ctr = rows * np.uint64(k) + draws + _colkey(table, col) * np.uint64(0x632BE59BD9B4E019)
        u = _splitmix64(ctr)
    return (u >> np.uint64(11)).astype(np.float64) * (2.0**-53)


def _u(table, col, row0, n, lo, hi, dtype=np.int64):
    """Uniform integers in [lo, hi] — exactly one counter draw per row."""
    return (lo + np.floor(_raw(table, col, row0, n)[:, 0] * (hi - lo + 1))).astype(dtype)


def _uf(table, col, row0, n, lo, hi):
    return lo + _raw(table, col, row0, n)[:, 0] * (hi - lo)


def _money(table, col, row0, n, lo_cents, hi_cents):
    return _u(table, col, row0, n, lo_cents, hi_cents) / 100.0


def _pick(table, col, row0, n, choices):
    idx = _u(table, col, row0, n, 0, len(choices) - 1, np.int32)
    return np.asarray(choices, dtype=object)[idx]


def _words(table, col, row0, n, vocab, k):
    """k-word space-joined phrases, vectorized (object arrays)."""
    idx = np.floor(_raw(table, col, row0, n, k) * len(vocab)).astype(np.int64)
    v = np.asarray(vocab, dtype=object)
    out = v[idx[:, 0]]
    for j in range(1, k):
        out = out + " "
        out = out + v[idx[:, j]]
    return out


def _numbered(prefix: str, keys: np.ndarray, width: int = 9) -> np.ndarray:
    return np.char.add(prefix, np.char.zfill(keys.astype(str), width)).astype(object)


def _phone(table, col, row0, n, nationkeys):
    raw = _raw(table, col, row0, n, 3)
    a = (100 + np.floor(raw[:, 0] * 900)).astype(np.int64)
    b = (100 + np.floor(raw[:, 1] * 900)).astype(np.int64)
    c = (1000 + np.floor(raw[:, 2] * 9000)).astype(np.int64)
    cc = (nationkeys + 10).astype(str)
    return (
        np.char.add(np.char.add(np.char.add(np.char.add(np.char.add(
            np.char.add(cc, "-"), a.astype(str)), "-"), b.astype(str)), "-"),
            c.astype(str))
    ).astype(object)


def _lines_per_order(order_idx: np.ndarray) -> np.ndarray:
    """1..7 lines per order, as a pure hash of the order index so that
    lineitem offsets are computable arithmetically (split independence)."""
    with np.errstate(over="ignore"):
        h = (order_idx.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) ^ np.uint64(
            0xBF58476D1CE4E5B9
        )
        return ((h >> np.uint64(33)) % np.uint64(7) + np.uint64(1)).astype(np.int64)


def _retailprice(partkey: np.ndarray) -> np.ndarray:
    # dbgen formula: 90000 + ((partkey/10) % 20001) + 100*(partkey % 1000), in cents
    cents = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    return cents / 100.0


# ---------------------------------------------------------------------------
# per-table generators: generate(table, sf, row0, row1) -> dict[col, np.ndarray]
# ---------------------------------------------------------------------------


def _gen_region(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64)
    return {
        "r_regionkey": k,
        "r_name": np.asarray(REGIONS, dtype=object)[row0:row1],
        "r_comment": _words("region", "comment", row0, row1 - row0, COMMENT_WORDS, 6),
    }


def _gen_nation(sf, row0, row1):
    k = np.arange(row0, row1, dtype=np.int64)
    names = np.asarray([n for n, _ in NATIONS], dtype=object)[row0:row1]
    regions = np.asarray([r for _, r in NATIONS], dtype=np.int64)[row0:row1]
    return {
        "n_nationkey": k,
        "n_name": names,
        "n_regionkey": regions,
        "n_comment": _words("nation", "comment", row0, row1 - row0, COMMENT_WORDS, 8),
    }


def _gen_part(sf, row0, row1):
    n = row1 - row0
    pk = np.arange(row0 + 1, row1 + 1, dtype=np.int64)
    t = "part"
    brand_m = _u(t, "brand_m", row0, n, 1, 5)
    brand_n = _u(t, "brand_n", row0, n, 1, 5)
    mfgr = np.char.add("Manufacturer#", brand_m.astype(str)).astype(object)
    brand = np.char.add("Brand#", (brand_m * 10 + brand_n).astype(str)).astype(object)
    typ = (
        _pick(t, "type1", row0, n, TYPE_S1) + " "
        + _pick(t, "type2", row0, n, TYPE_S2) + " "
        + _pick(t, "type3", row0, n, TYPE_S3)
    )
    container = _pick(t, "cont1", row0, n, CONTAINER_S1) + " " + _pick(
        t, "cont2", row0, n, CONTAINER_S2)
    return {
        "p_partkey": pk,
        "p_name": _words(t, "name", row0, n, COLORS, 5),
        "p_mfgr": mfgr,
        "p_brand": brand,
        "p_type": typ,
        "p_size": _u(t, "size", row0, n, 1, 50, np.int32),
        "p_container": container,
        "p_retailprice": _retailprice(pk),
        "p_comment": _words(t, "comment", row0, n, COMMENT_WORDS, 5),
    }


def _gen_supplier(sf, row0, row1):
    n = row1 - row0
    sk = np.arange(row0 + 1, row1 + 1, dtype=np.int64)
    t = "supplier"
    nat = _u(t, "nation", row0, n, 0, 24)
    # dbgen: 5 suppliers per SF1 get "Customer...Complaints" comments (Q16)
    comment = _words(t, "comment", row0, n, COMMENT_WORDS, 7)
    bad = (sk % 1987) == 0
    comment = np.where(bad, "slow Customer even Complaints sleep", comment)
    return {
        "s_suppkey": sk,
        "s_name": _numbered("Supplier#", sk),
        "s_address": _words(t, "address", row0, n, COMMENT_WORDS, 3),
        "s_nationkey": nat,
        "s_phone": _phone(t, "phone", row0, n, nat),
        "s_acctbal": _money(t, "acctbal", row0, n, -99999, 999999),
        "s_comment": comment,
    }


def _gen_partsupp(sf, row0, row1):
    """Row r = (partkey = r // 4 + 1, supplier slot j = r % 4).
    Supplier formula mirrors dbgen so lineitem FK pairs stay valid:
      suppkey = (partkey + j*(S/4 + (partkey-1)//S)) % S + 1, S = 10000*sf."""
    n = row1 - row0
    r = np.arange(row0, row1, dtype=np.int64)
    pk = r // SUPP_PER_PART + 1
    j = r % SUPP_PER_PART
    t = "partsupp"
    return {
        "ps_partkey": pk,
        "ps_suppkey": _ps_suppkey(pk, j, sf),
        "ps_availqty": _u(t, "availqty", row0, n, 1, 9999, np.int32),
        "ps_supplycost": _money(t, "supplycost", row0, n, 100, 100000),
        "ps_comment": _words(t, "comment", row0, n, COMMENT_WORDS, 10),
    }


def _ps_suppkey(partkey: np.ndarray, slot: np.ndarray, sf: float) -> np.ndarray:
    s = max(int(10_000 * sf), 1)
    return (partkey + slot * (s // SUPP_PER_PART + (partkey - 1) // s)) % s + 1


def _gen_customer(sf, row0, row1):
    n = row1 - row0
    ck = np.arange(row0 + 1, row1 + 1, dtype=np.int64)
    t = "customer"
    nat = _u(t, "nation", row0, n, 0, 24)
    return {
        "c_custkey": ck,
        "c_name": _numbered("Customer#", ck),
        "c_address": _words(t, "address", row0, n, COMMENT_WORDS, 3),
        "c_nationkey": nat,
        "c_phone": _phone(t, "phone", row0, n, nat),
        "c_acctbal": _money(t, "acctbal", row0, n, -99999, 999999),
        "c_mktsegment": _pick(t, "segment", row0, n, SEGMENTS),
        "c_comment": _words(t, "comment", row0, n, COMMENT_WORDS, 8),
    }


def _order_dates(row0: int, n: int) -> np.ndarray:
    return _u("orders", "orderdate", row0, n, START_DATE, END_DATE - 151, np.int32)


def _order_custkey(row0: int, n: int, sf: float) -> np.ndarray:
    # dbgen: only 2/3 of customers have orders (custkey % 3 != 0 -> shift)
    ncust = max(int(150_000 * sf), 3)
    ck = _u("orders", "custkey", row0, n, 1, ncust)
    ck = ck - (ck % 3 == 0)  # avoid multiples of 3 => 1/3 of customers orderless
    return np.maximum(ck, 1)


def _gen_orders(sf, row0, row1):
    n = row1 - row0
    t = "orders"
    oi = np.arange(row0, row1, dtype=np.int64)
    ok = _orderkey(oi)
    odate = _order_dates(row0, n)
    # status: F if all lines shipped before current date, O if none, else P.
    # Approximate dbgen by deriving from orderdate the way ship dates do.
    status = np.where(
        odate + 121 < CURRENT_DATE, "F", np.where(odate > CURRENT_DATE, "O", "P")
    ).astype(object)
    return {
        "o_orderkey": ok,
        "o_custkey": _order_custkey(row0, n, sf),
        "o_orderstatus": status,
        "o_totalprice": _money(t, "totalprice", row0, n, 85000, 55000000),
        "o_orderdate": odate,
        "o_orderpriority": _pick(t, "priority", row0, n, PRIORITIES),
        "o_clerk": _numbered("Clerk#", _u(t, "clerk", row0, n, 1, max(int(1000 * sf), 1))),
        "o_shippriority": np.zeros(n, dtype=np.int32),
        "o_comment": _words(t, "comment", row0, n, COMMENT_WORDS, 10),
    }


def _orderkey(order_idx: np.ndarray) -> np.ndarray:
    """Sparse orderkeys like dbgen (8 per 32-key block)."""
    return (order_idx // 8) * 32 + order_idx % 8 + 1


def lineitem_offsets(order_row0: int, order_row1: int) -> tuple[int, int]:
    """Global lineitem row range produced by an order row range."""
    idx = np.arange(0, order_row1, dtype=np.int64)
    counts = _lines_per_order(idx)
    total_before = int(np.sum(counts[:order_row0]))
    total = int(np.sum(counts))
    return total_before, total


def _gen_lineitem_for_orders(sf, order_row0, order_row1):
    t = "lineitem"
    oi = np.arange(order_row0, order_row1, dtype=np.int64)
    counts = _lines_per_order(oi)
    n = int(np.sum(counts))
    row0, _ = lineitem_offsets(order_row0, order_row1)

    ok = np.repeat(_orderkey(oi), counts)
    odate = np.repeat(_order_dates(order_row0, len(oi)), counts).astype(np.int64)
    linenumber = (np.arange(n, dtype=np.int64)
                  - np.repeat(np.cumsum(counts) - counts, counts) + 1)

    npart = max(int(200_000 * sf), SUPP_PER_PART)
    pk = _u(t, "partkey", row0, n, 1, npart)
    slot = _u(t, "suppslot", row0, n, 0, SUPP_PER_PART - 1)
    sk = _ps_suppkey(pk, slot, sf)

    qty = _u(t, "quantity", row0, n, 1, 50).astype(np.float64)
    price = _retailprice(pk) * qty
    ship_delta = _u(t, "shipdelta", row0, n, 1, 121, np.int32)
    commit_delta = _u(t, "commitdelta", row0, n, 30, 90, np.int32)
    receipt_delta = _u(t, "receiptdelta", row0, n, 1, 30, np.int32)
    shipdate = (odate + ship_delta).astype(np.int32)
    receiptdate = shipdate + receipt_delta
    returnflag = np.where(
        receiptdate <= CURRENT_DATE,
        _pick(t, "returnflag", row0, n, ["R", "A"]),
        "N",
    ).astype(object)
    linestatus = np.where(shipdate > CURRENT_DATE, "O", "F").astype(object)
    return {
        "l_orderkey": ok,
        "l_partkey": pk,
        "l_suppkey": sk,
        "l_linenumber": linenumber.astype(np.int32),
        "l_quantity": qty,
        "l_extendedprice": price,
        "l_discount": _u(t, "discount", row0, n, 0, 10) / 100.0,
        "l_tax": _u(t, "tax", row0, n, 0, 8) / 100.0,
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": shipdate,
        "l_commitdate": (odate + commit_delta).astype(np.int32),
        "l_receiptdate": receiptdate,
        "l_shipinstruct": _pick(t, "instruct", row0, n, INSTRUCTIONS),
        "l_shipmode": _pick(t, "mode", row0, n, MODES),
        "l_comment": _words(t, "comment", row0, n, COMMENT_WORDS, 4),
    }


_GENERATORS = {
    "region": _gen_region,
    "nation": _gen_nation,
    "part": _gen_part,
    "supplier": _gen_supplier,
    "partsupp": _gen_partsupp,
    "customer": _gen_customer,
    "orders": _gen_orders,
}


def generate(table: str, sf: float = 1.0, row0: int = 0, row1: int | None = None):
    """Generate host columnar data for `table` rows [row0, row1).

    For lineitem, row0/row1 index ORDERS rows (the split unit, mirroring the
    reference where lineitem splits follow order-part boundaries); the
    returned arrays hold all lineitems of those orders.
    """
    if table == "lineitem":
        n_orders = int(_TABLE_ROWS["orders"] * sf)
        row1 = n_orders if row1 is None else min(row1, n_orders)
        return _gen_lineitem_for_orders(sf, row0, row1)
    total = row_count(table, sf)
    row1 = total if row1 is None else min(row1, total)
    return _GENERATORS[table](sf, row0, row1)


def like_pushdown_virtual(table: str, column: str, pattern: str):
    """Virtual-column name for a connector-evaluable LIKE predicate, or
    None.  `p_name LIKE '%word%'` is decidable from the generator's word
    DRAWS without materializing any string (reference analog: TupleDomain
    predicate pushdown into the connector, PickTableLayout): p_name is 5
    vocabulary words joined by spaces, so a single-word substring match
    (where no other vocabulary word contains it) holds iff some draw
    picked that word."""
    if table != "part" or column != "p_name":
        return None
    if len(pattern) < 3 or not (pattern.startswith("%")
                                and pattern.endswith("%")):
        return None
    word = pattern[1:-1]
    if "%" in word or "_" in word or " " in word:
        return None
    containing = [c for c in COLORS if word in c]
    if containing != [word]:
        return None  # ambiguous: substring of another vocabulary word
    return f"p_name$contains${word}"


def part_name_contains(row0: int, n: int, word: str) -> np.ndarray:
    """Host evaluation of the p_name LIKE '%word%' virtual column."""
    idx = np.floor(_raw("part", "name", row0, n, 5) * len(COLORS)).astype(
        np.int64)
    return (idx == COLORS.index(word)).any(axis=1)


def chunk_grid(sf: float, chunk_orders: int):
    """Order-row chunk grid + lineitem offsets for chunked execution:
    returns (order_edges[n+1], line_offsets[n+1]).  Buckets are
    order-row ranges, so every orderkey's lineitems live in exactly one
    chunk (the connector-bucketing property grouped execution needs)."""
    n_orders = int(_TABLE_ROWS["orders"] * sf)
    edges = list(range(0, n_orders, chunk_orders)) + [n_orders]
    if edges[-2] == edges[-1]:
        edges.pop()
    line_offsets = [0]
    for a, b in zip(edges[:-1], edges[1:]):
        counts = _lines_per_order(np.arange(a, b, dtype=np.int64))
        line_offsets.append(line_offsets[-1] + int(np.sum(counts)))
    return edges, line_offsets


def split_ranges(table: str, sf: float, n_splits: int) -> list[tuple[int, int]]:
    """Even row-range splits (order-ranges for lineitem)."""
    total = int(_TABLE_ROWS["orders"] * sf) if table == "lineitem" else row_count(table, sf)
    edges = np.linspace(0, total, n_splits + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]) if a < b]


# ---------------------------------------------------------------------------
# statistics (arithmetic, no scanning) — reference: presto-tpch
# TpchMetadata.getTableStatistics backed by precomputed stats files;
# here derivable from the generator formulas directly.
# ---------------------------------------------------------------------------

UNIQUE_KEYS = {
    "region": [("r_regionkey",)],
    "nation": [("n_nationkey",)],
    "part": [("p_partkey",)],
    "supplier": [("s_suppkey",)],
    "partsupp": [("ps_partkey", "ps_suppkey")],
    "customer": [("c_custkey",)],
    "orders": [("o_orderkey",)],
    "lineitem": [("l_orderkey", "l_linenumber")],
}

# physical row ordering the generator emits (ordering-properties SPI,
# plan/properties.py): every table comes out in primary-key order —
# dbgen writes entity files in key order and the counter-based
# generator indexes rows the same way.  (partsupp's ps_suppkey is a
# slot formula, NOT sorted within a part, so only ps_partkey is
# declared.)  Consumed behind runtime monotonicity guards.
ORDERINGS = {
    "region": [("r_regionkey", True)],
    "nation": [("n_nationkey", True)],
    "part": [("p_partkey", True)],
    "supplier": [("s_suppkey", True)],
    "partsupp": [("ps_partkey", True)],
    "customer": [("c_custkey", True)],
    "orders": [("o_orderkey", True)],
    "lineitem": [("l_orderkey", True), ("l_linenumber", True)],
}

# max rows sharing one value of the key set (join fanout upper bounds)
MAX_ROWS_PER_KEY = {
    "lineitem": {("l_orderkey",): 7, ("l_orderkey", "l_linenumber"): 1},
    "partsupp": {("ps_partkey",): SUPP_PER_PART,
                 ("ps_partkey", "ps_suppkey"): 1},
}


def column_stats(table: str, column: str, sf: float, ColStats):
    n = row_count(table, sf)
    nparts = max(int(200_000 * sf), 1)
    n_ps = max(int(800_000 * sf), 1)
    max_ps_partkey = (n_ps - 1) // SUPP_PER_PART + 1
    nsupp = max(int(10_000 * sf), 1)
    ncust = max(int(150_000 * sf), 1)
    norders = max(int(1_500_000 * sf), 1)
    max_orderkey = ((norders - 1) // 8) * 32 + (norders - 1) % 8 + 1
    R = {
        "r_regionkey": (0, 4, 5), "n_nationkey": (0, 24, 25),
        "n_regionkey": (0, 4, 5),
        "p_partkey": (1, nparts, nparts),
        "p_size": (1, 50, 50),
        "p_retailprice": (900.0, 2099.0, None),
        "s_suppkey": (1, nsupp, nsupp),
        "s_nationkey": (0, 24, 25),
        "s_acctbal": (-999.99, 9999.99, None),
        "ps_partkey": (1, max(nparts, max_ps_partkey), nparts),
        "ps_suppkey": (1, nsupp, nsupp),
        "ps_availqty": (1, 9999, 9999),
        "ps_supplycost": (1.0, 1000.0, None),
        "c_custkey": (1, ncust, ncust),
        "c_nationkey": (0, 24, 25),
        "c_acctbal": (-999.99, 9999.99, None),
        "o_orderkey": (1, max_orderkey, norders),
        "o_custkey": (1, ncust, ncust),
        "o_totalprice": (850.0, 550000.0, None),
        "o_orderdate": (START_DATE, END_DATE - 151, END_DATE - START_DATE),
        "o_shippriority": (0, 0, 1),
        "l_orderkey": (1, max_orderkey, norders),
        "l_partkey": (1, nparts, nparts),
        "l_suppkey": (1, nsupp, nsupp),
        "l_linenumber": (1, 7, 7),
        "l_quantity": (1.0, 50.0, 50),
        "l_extendedprice": (900.0, 104950.0, None),
        "l_discount": (0.0, 0.10, 11),
        "l_tax": (0.0, 0.08, 9),
        "l_shipdate": (START_DATE + 1, END_DATE - 151 + 121, None),
        "l_commitdate": (START_DATE + 30, END_DATE - 151 + 90, None),
        "l_receiptdate": (START_DATE + 2, END_DATE - 151 + 121 + 30, None),
    }
    NDV_ONLY = {
        "r_name": 5, "n_name": 25, "p_mfgr": 5, "p_brand": 25,
        "p_type": 150, "p_container": 40, "p_name": None,
        "c_mktsegment": 5, "o_orderpriority": 5, "o_orderstatus": 3,
        "l_returnflag": 3, "l_linestatus": 2, "l_shipinstruct": 4,
        "l_shipmode": 7,
    }
    if column in R:
        lo, hi, ndv = R[column]
        schema_t = SCHEMAS[table][column]
        if schema_t.name == "DOUBLE":
            return ColStats(min=lo, max=hi, ndv=ndv)
        return ColStats(min=float(lo), max=float(hi), ndv=ndv)
    if column in NDV_ONLY:
        return ColStats(ndv=NDV_ONLY[column])
    return ColStats(ndv=min(n, 4_000_000))  # names/comments/phones etc.
