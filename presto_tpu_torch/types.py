"""Logical SQL type system.

Reference parity: presto-spi/src/main/java/com/facebook/presto/spi/type/
(45+ classes) and presto-main/.../type/TypeRegistry.  We keep the same
*logical* surface (BOOLEAN..BIGINT, DOUBLE, DECIMAL, VARCHAR, DATE,
TIMESTAMP, ARRAY/MAP/ROW stubs) but map each logical type onto a
TPU-friendly *physical* representation:

  BOOLEAN              -> bool_
  TINYINT..BIGINT      -> int32 / int64
  DOUBLE / REAL        -> float64 / float32
  DECIMAL(p,s), p<=18  -> int64 scaled by 10**s (exact, MXU/ALU friendly;
                          the reference uses Slice-backed Int128 for long
                          decimals — long decimal is deferred)
  VARCHAR / CHAR       -> int32 dictionary codes (dictionary on host);
                          the reference's VariableWidthBlock/DictionaryBlock
                          (presto-spi/.../spi/block/) collapse into
                          dictionary-always, because TPUs hate ragged data
  DATE                 -> int32 days since 1970-01-01
  TIMESTAMP            -> int64 microseconds since epoch
  INTERVAL DAY/MONTH   -> int64 (micros / months) — session-side only
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Type:
    """A logical SQL type. Comparable/hashable; parametric via params."""

    name: str
    params: tuple = ()

    def __str__(self) -> str:
        if self.name == "TIMESTAMP_TZ":
            return "TIMESTAMP WITH TIME ZONE"
        if self.name == "TIME_TZ":
            return "TIME WITH TIME ZONE"
        if self.params:
            return f"{self.name}({','.join(str(p) for p in self.params)})"
        return self.name

    # ---- classification helpers -------------------------------------
    @property
    def is_integer(self) -> bool:
        return self.name in ("TINYINT", "SMALLINT", "INTEGER", "BIGINT")

    @property
    def is_floating(self) -> bool:
        return self.name in ("REAL", "DOUBLE")

    @property
    def is_decimal(self) -> bool:
        return self.name == "DECIMAL"

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_floating or self.is_decimal

    @property
    def is_string(self) -> bool:
        # JSON/VARBINARY are distinct logical types (spi/type/JsonType,
        # VarbinaryType) but share the dictionary-encoded physical form
        # and string compute paths (VARBINARY dictionary values are
        # python bytes)
        return self.name in ("VARCHAR", "CHAR", "JSON", "VARBINARY")

    @property
    def is_temporal(self) -> bool:
        return self.name in ("DATE", "TIMESTAMP", "TIMESTAMP_TZ")

    @property
    def tz(self) -> Optional[str]:
        """Zone name for TIMESTAMP_TZ / offset-minutes for TIME_TZ.

        TPU-native departure from the reference: the reference packs a
        12-bit zone key into every VALUE (spi/type/
        TimestampWithTimeZoneType + DateTimeEncoding.packDateTimeWithZone);
        here the zone rides the column TYPE and the device lane stays
        pure UTC int64 micros, so compare/join/sort/group need no unpack."""
        if self.name in ("TIMESTAMP_TZ", "TIME_TZ") and self.params:
            return self.params[0]
        return None

    @property
    def is_orderable(self) -> bool:
        return self.name not in ("UNKNOWN",)

    @property
    def decimal_scale(self) -> int:
        assert self.is_decimal
        return self.params[1] if len(self.params) > 1 else 0

    @property
    def decimal_precision(self) -> int:
        assert self.is_decimal
        return self.params[0] if self.params else 18

    @property
    def is_long_decimal(self) -> bool:
        """Precision 19..38: two-limb Int128 storage (reference:
        Decimals.MAX_SHORT_PRECISION boundary, Int128ArrayBlock)."""
        return self.is_decimal and self.decimal_precision > 18

    # ---- physical representation ------------------------------------
    def numpy_dtype(self) -> np.dtype:
        return np.dtype(_PHYSICAL[self.name])

    def integer_bounds(self):
        """LOGICAL (min, max) for integer types.  Distinct from the
        physical dtype: TINYINT/SMALLINT are stored as int32 lanes, but
        CAST overflow semantics follow the SQL type (reference raises
        out-of-range, e.g. IntegerOperators.saturatedFloorCastToSmallint)."""
        bits = {"TINYINT": 8, "SMALLINT": 16, "INTEGER": 32, "BIGINT": 64}[
            self.name]
        return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


BOOLEAN = Type("BOOLEAN")
TINYINT = Type("TINYINT")
SMALLINT = Type("SMALLINT")
INTEGER = Type("INTEGER")
BIGINT = Type("BIGINT")
REAL = Type("REAL")
DOUBLE = Type("DOUBLE")
VARCHAR = Type("VARCHAR")
DATE = Type("DATE")
TIMESTAMP = Type("TIMESTAMP")
INTERVAL_DAY_TIME = Type("INTERVAL_DAY_TIME")
INTERVAL_YEAR_MONTH = Type("INTERVAL_YEAR_MONTH")
JSON = Type("JSON")
VARBINARY = Type("VARBINARY")
UNKNOWN = Type("UNKNOWN")  # the NULL literal's type
TIME = Type("TIME")  # int64 microseconds since midnight (zone-less)


def timestamp_tz(zone: Optional[str] = None) -> Type:
    """TIMESTAMP WITH TIME ZONE in `zone` (reference:
    spi/type/TimestampWithTimeZoneType).  Lane: UTC int64 micros; the
    zone is column metadata — see Type.tz.  zone=None (e.g. a CAST
    target written without a zone) means "the session zone", resolved
    when the cast/function emits."""
    return Type("TIMESTAMP_TZ", () if zone is None else (zone,))


def time_tz(offset_minutes: Optional[int] = None) -> Type:
    """TIME WITH TIME ZONE at a fixed UTC offset (reference:
    spi/type/TimeWithTimeZoneType; named zones degenerate to their
    offset for TIME, as in the reference's packed offset encoding).
    Lane: int64 micros since midnight LOCAL to the offset.
    offset_minutes=None (a zone-less CAST target) means "the session
    zone's offset", resolved when the cast emits."""
    return Type("TIME_TZ", () if offset_minutes is None
                else (int(offset_minutes),))


def decimal(precision: int, scale: int) -> Type:
    """DECIMAL(p,s).  p <= 18 ("short"): unscaled int64.  p in 19..38
    ("long"): two int64 limbs per value, shape (n, 2) — exact Int128
    semantics through arithmetic, comparison, sort and SUM/MIN/MAX
    aggregation (reference: spi/type/DecimalType,
    UnscaledDecimal128Arithmetic, Int128ArrayBlock; device kernels in
    exec/dec128.py)."""
    if precision > 38:
        raise ValueError(f"DECIMAL precision {precision} exceeds 38")
    return Type("DECIMAL", (precision, scale))


def decimal_add_type(a: "Type", b: "Type") -> "Type":
    """Presto result type of decimal +/- (DecimalOperators.ADD)."""
    s = max(a.decimal_scale, b.decimal_scale)
    p = min(38, max(a.decimal_precision - a.decimal_scale,
                    b.decimal_precision - b.decimal_scale) + s + 1)
    return decimal(p, s)


def decimal_mul_type(a: "Type", b: "Type") -> "Type":
    """Presto result type of decimal * (DecimalOperators.MULTIPLY)."""
    s = a.decimal_scale + b.decimal_scale
    p = min(38, a.decimal_precision + b.decimal_precision)
    if s > 38:
        raise ValueError("DECIMAL multiply scale exceeds 38")
    return decimal(p, s)


def varchar(length: Optional[int] = None) -> Type:
    return VARCHAR  # length is not semantically enforced (same as reference in practice)


def array_of(elem: Type) -> Type:
    """ARRAY(elem) — physically int32 codes into a dictionary of tuples
    (the DictionaryBlock treatment extended to nested values; reference:
    spi/block/ArrayBlock, which TPUs would hate as ragged offsets)."""
    return Type("ARRAY", (elem,))


def char(length: int) -> Type:
    return Type("CHAR", (length,))


def function_type(ret: Type) -> Type:
    """FUNCTION(ret) — the type of a lambda argument (reference:
    spi/type/FunctionType.java).  Never materialized as a column."""
    return Type("FUNCTION", (ret,))


def map_of(key: Type, value: Type) -> Type:
    """MAP(K,V) — physically int32 codes into a dictionary whose entries
    are key-sorted tuples of (key, value) pairs (reference: spi/type/MapType
    + spi/block/MapBlock; same DictionaryBlock treatment as ARRAY)."""
    return Type("MAP", (key, value))


def row_of(fields) -> Type:
    """ROW(name type, ...) — dictionary of value tuples; field names ride
    the type (reference: spi/type/RowType).  `fields` is a sequence of
    (name-or-None, Type)."""
    return Type("ROW", tuple((n.lower() if n else None, t)
                             for n, t in fields))


def row_field_types(t: Type):
    return tuple(ft for _, ft in t.params)


def row_field_index(t: Type, name: str) -> Optional[int]:
    for i, (n, _) in enumerate(t.params):
        if n == name.lower():
            return i
    return None


_PHYSICAL = {
    "BOOLEAN": np.bool_,
    "TINYINT": np.int32,
    "SMALLINT": np.int32,
    "INTEGER": np.int32,
    "BIGINT": np.int64,
    "REAL": np.float32,
    "DOUBLE": np.float64,
    "DECIMAL": np.int64,
    "VARCHAR": np.int32,  # dictionary code
    "CHAR": np.int32,  # dictionary code
    "JSON": np.int32,  # dictionary code
    "VARBINARY": np.int32,  # dictionary code over bytes values
    "DATE": np.int32,
    "TIMESTAMP": np.int64,
    "TIMESTAMP_TZ": np.int64,  # UTC micros; zone in the type (Type.tz)
    "TIME": np.int64,  # micros since midnight
    "TIME_TZ": np.int64,  # micros since midnight at the type's offset
    "INTERVAL_DAY_TIME": np.int64,
    "INTERVAL_YEAR_MONTH": np.int64,
    "UNKNOWN": np.bool_,
    "ARRAY": np.int32,  # dictionary code over unique element-tuples
    "MAP": np.int32,  # dictionary code over unique pair-tuples
    "ROW": np.int32,  # dictionary code over unique field-tuples
    "HLL": np.int32,  # dictionary code over serialized sketch bytes
    "P4HLL": np.int32,  # dictionary code over serialized sketch bytes
    "QDIGEST": np.int32,  # dictionary code over serialized sketch bytes
    "TDIGEST": np.int32,  # dictionary code over serialized sketch bytes
    "HLL_STATE": np.uint8,  # device HLL registers: (n, m) matrix column
    "KLL_STATE": np.float64,  # device quantile summary: (n, 2K) matrix
}

HLL = Type("HLL")
# Dense-format HyperLogLog (reference: spi/type/P4HyperLogLogType —
# the fixed-register airlift P4 layout; this engine's HLL blobs are
# always dense, so the two types share the physical form and casts
# between them are re-tags)
P4HLL = Type("P4HLL")


def hll_state(m: int) -> Type:
    """Device-native HyperLogLog partial state: each "value" is a row of
    m uint8 registers, so the column is an (n_groups, m) matrix.  Unlike
    the reference's Slice-typed HyperLogLog blobs, the state never
    serializes on device — partials fold with elementwise max and only
    the final BIGINT estimate reaches the client.  The register count
    rides the TYPE so exchange pricing (fusion_cost._row_bytes) and
    serde know the fixed row width."""
    return Type("HLL_STATE", (int(m),))


def kll_state(width: int) -> Type:
    """Device-native quantile-summary partial state: each value is a row
    of width float64s (K summary values + K weights), an (n_groups,
    width) matrix column.  Mergeable by concat-sort-prune; width rides
    the type for pricing/serde like HLL_STATE."""
    return Type("KLL_STATE", (int(width),))


def qdigest_of(elem: Type) -> Type:
    return Type("QDIGEST", (elem,))


def tdigest_of(elem: Type) -> Type:
    """reference: TDigestParametricType (tdigest(double))."""
    return Type("TDIGEST", (elem,))


def parse_type(text: str) -> Type:
    """Parse a type name as written in SQL (CAST target etc.), including
    nested ARRAY(T) / MAP(K,V) / ROW(name T, ...) (reference:
    TypeSignature.parseTypeSignature)."""
    t = text.strip().upper()
    if "(" in t:
        base, rest = t.split("(", 1)
        base = base.strip()
        inner = rest.rstrip()
        if inner.endswith(")"):
            inner = inner[:-1]
        if base == "QDIGEST":
            return qdigest_of(parse_type(inner))
        if base == "TDIGEST":
            return tdigest_of(parse_type(inner))
        if base in ("ARRAY", "MAP", "ROW"):
            parts = _split_type_args(inner)
            if base == "ARRAY":
                return array_of(parse_type(parts[0]))
            if base == "MAP":
                return map_of(parse_type(parts[0]), parse_type(parts[1]))
            fields = []
            for p in parts:
                # `name TYPE` vs bare `TYPE`: try the named form first so
                # field names that prefix a type word (rowid, mapping...)
                # still parse; fall back to an anonymous field
                bits = p.strip().split(None, 1)
                if len(bits) == 2 and "(" not in bits[0]:
                    try:
                        fields.append((bits[0].lower(), parse_type(bits[1])))
                        continue
                    except ValueError:
                        pass
                fields.append((None, parse_type(p)))
            return row_of(fields)
        args = [int(a) for a in inner.split(",") if a.strip().isdigit()]
        if base == "HLL_STATE":
            return hll_state(args[0] if args else 1024)
        if base == "KLL_STATE":
            return kll_state(args[0] if args else 400)
        if base == "DECIMAL":
            return decimal(*args) if args else decimal(18, 0)
        if base in ("VARCHAR", "CHAR"):
            return VARCHAR if base == "VARCHAR" else char(args[0] if args else 1)
        raise ValueError(f"unknown parametric type: {text}")
    if t == "ARRAY":
        return array_of(UNKNOWN)
    aliases = {
        "INT": INTEGER,
        "INTEGER": INTEGER,
        "BIGINT": BIGINT,
        "SMALLINT": SMALLINT,
        "TINYINT": TINYINT,
        "BOOLEAN": BOOLEAN,
        "DOUBLE": DOUBLE,
        "DOUBLE PRECISION": DOUBLE,
        "REAL": REAL,
        "FLOAT": REAL,
        "VARCHAR": VARCHAR,
        "CHAR": Type("CHAR", (1,)),
        "STRING": VARCHAR,
        "DATE": DATE,
        "TIMESTAMP": TIMESTAMP,
        "TIMESTAMP WITH TIME ZONE": timestamp_tz(),
        "TIME": TIME,
        "TIME WITH TIME ZONE": time_tz(),
        "DECIMAL": decimal(18, 0),
        "JSON": JSON,
        "VARBINARY": VARBINARY,
        "HLL": HLL,
        "HYPERLOGLOG": HLL,
        "QDIGEST": qdigest_of(DOUBLE),
        "TDIGEST": tdigest_of(DOUBLE),
        "P4HYPERLOGLOG": P4HLL,
    }
    if t in aliases:
        return aliases[t]
    raise ValueError(f"unknown type: {text}")


DECIMAL_UNSCALED_LIMIT = 2.0 ** 62  # int64 headroom (~19 digits)


def check_decimal_overflow(unscaled, valid=None, what: str = "value"):
    """Shared float64-shadow guard for the int64 unscaled-decimal
    boundary; NULL lanes are excluded (they carry garbage payloads)."""
    shadow = np.abs(np.asarray(unscaled, dtype=np.float64))
    if valid is not None:
        v = np.asarray(valid)
        if v.ndim > 0:
            shadow = np.where(v, shadow, 0.0)
        elif not bool(v):
            return
    with np.errstate(invalid="ignore"):
        if shadow.size and np.nanmax(shadow) >= DECIMAL_UNSCALED_LIMIT:
            raise ValueError(
                f"DECIMAL overflow: {what} exceeds the int64 unscaled "
                "range (~19 significant digits)")


def _split_type_args(s: str):
    """Split 'K, V' at top-level commas (parens may nest)."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


# ---------------------------------------------------------------------------
# Coercion lattice — mirrors the reference's implicit-cast rules
# (presto-main/.../type/TypeRegistry + sql/analyzer/ExpressionAnalyzer).
# ---------------------------------------------------------------------------

_NUMERIC_ORDER = ["TINYINT", "SMALLINT", "INTEGER", "BIGINT", "DECIMAL", "REAL", "DOUBLE"]


def common_super_type(a: Type, b: Type) -> Optional[Type]:
    """The least common type both operands coerce to, or None."""
    if a == b:
        return a
    if a == UNKNOWN:
        return b
    if b == UNKNOWN:
        return a
    if a.is_numeric and b.is_numeric:
        ia, ib = _NUMERIC_ORDER.index(a.name), _NUMERIC_ORDER.index(b.name)
        hi = a if ia >= ib else b
        lo = b if ia >= ib else a
        if hi.is_decimal:
            if lo.is_decimal:
                scale = max(a.decimal_scale, b.decimal_scale)
                intd = max(
                    a.decimal_precision - a.decimal_scale,
                    b.decimal_precision - b.decimal_scale,
                )
                return decimal(min(intd + scale, 38), scale)
            return hi  # integer + decimal -> decimal
        if hi.is_floating and lo.is_decimal:
            return DOUBLE
        return hi
    if a.is_string and b.is_string:
        return VARCHAR
    if a.name == b.name == "ARRAY":
        et = common_super_type(a.params[0], b.params[0])
        return array_of(et) if et is not None else None
    if a.name == b.name == "MAP":
        kt = common_super_type(a.params[0], b.params[0])
        vt = common_super_type(a.params[1], b.params[1])
        return map_of(kt, vt) if kt is not None and vt is not None \
            else None
    if {a.name, b.name} == {"DATE", "TIMESTAMP"}:
        return TIMESTAMP
    if a.name == "TIMESTAMP_TZ" and b.name == "TIMESTAMP_TZ":
        # same instant lane; zones differ only as display metadata —
        # keep the left zone (the reference keeps per-value zones; a
        # documented single-zone-per-column simplification)
        return a
    if "TIMESTAMP_TZ" in (a.name, b.name) \
            and {a.name, b.name} <= {"TIMESTAMP_TZ", "TIMESTAMP", "DATE"}:
        return a if a.name == "TIMESTAMP_TZ" else b
    if a.name == "TIME_TZ" and b.name == "TIME_TZ":
        return a
    if {a.name, b.name} == {"TIME", "TIME_TZ"}:
        return a if a.name == "TIME_TZ" else b
    if a.name == "DATE" and b.name == "INTERVAL_DAY_TIME":
        return DATE
    return None


def can_coerce(frm: Type, to: Type) -> bool:
    if frm == to or frm == UNKNOWN:
        return True
    return common_super_type(frm, to) == to
