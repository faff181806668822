"""Extract per-column Domains (TupleDomain analog) from filter
conjuncts, for scan-time stats pruning inside the file readers.

Reference: presto-spi/.../spi/predicate/TupleDomain.java +
DomainTranslator (presto-main/.../sql/planner/DomainTranslator.java),
trimmed to the shapes that prune stripes/row groups: range comparisons
against literals, BETWEEN, and OR-of-equalities (how the planner lowers
IN lists).  The extraction is ADVISORY — the Filter node still runs, so
an unextractable conjunct simply contributes no pruning.
"""

from __future__ import annotations

from typing import Dict, Optional

from presto_tpu_torch.plan import ir
from presto_tpu_torch.storage.shard import Domain

_CMP = {"lt": "hi_open", "le": "hi", "gt": "lo_open", "ge": "lo",
        "eq": "eq"}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}

# types whose literal space equals the reader's stats space (DATE =
# days, TIMESTAMP = micros, strings compare lexically); DECIMAL is
# excluded (unscaled-int literals vs scaled stats)
_PRUNABLE = ("TINYINT", "SMALLINT", "INTEGER", "BIGINT", "REAL",
             "DOUBLE", "DATE", "TIMESTAMP", "VARCHAR", "CHAR")


def _lit_value(e) -> Optional[object]:
    # see through literal-widening casts the planner inserts around
    # comparison operands (CAST(2000 AS BIGINT), CAST(7 AS DOUBLE))
    while isinstance(e, ir.CastExpr) and not e.safe \
            and e.type.name in _PRUNABLE and isinstance(e.arg, ir.Lit):
        v = e.arg.value
        if v is None or not isinstance(v, (int, float, str)):
            return None
        if e.type.name in ("REAL", "DOUBLE"):
            if not isinstance(v, (int, float)):
                return None
            e = ir.Lit(float(v), e.type)
        elif e.type.name in ("TINYINT", "SMALLINT", "INTEGER", "BIGINT",
                             "DATE", "TIMESTAMP"):
            if not isinstance(v, int) or not e.arg.type.name in (
                    "TINYINT", "SMALLINT", "INTEGER", "BIGINT", "DATE",
                    "TIMESTAMP", "UNKNOWN"):
                return None  # float->int rounds; string parses — skip
            e = ir.Lit(v, e.type)
        elif e.type.name in ("VARCHAR", "CHAR") and isinstance(v, str) \
                and e.arg.type.name in ("VARCHAR", "CHAR"):
            e = ir.Lit(v, e.type)
        else:
            return None
    if isinstance(e, ir.Lit) and e.value is not None \
            and e.type.name in _PRUNABLE:
        if e.type.name == "REAL" and isinstance(e.value, float):
            # REAL stats decode from float32 storage; an un-rounded f64
            # literal (0.1 != f32(0.1)) would fail to overlap stats of
            # stripes whose rows the f32 Filter matches
            import numpy as _np

            return float(_np.float32(e.value))
        return e.value
    return None


def _ref_lit(c: ir.Call):
    """(ref, lit, op) for `ref op lit` / `lit op ref`, else None."""
    if len(c.args) != 2 or c.fn not in _CMP:
        return None
    a, b = c.args
    if isinstance(a, ir.Ref) and _lit_value(b) is not None:
        return a, _lit_value(b), c.fn
    if isinstance(b, ir.Ref) and _lit_value(a) is not None:
        return b, _lit_value(a), _FLIP[c.fn]
    return None


def _eq_chain(e) -> Optional[tuple]:
    """OR-of-equalities over one Ref (lowered IN list) ->
    (ref_name, [values]); None otherwise."""
    if not isinstance(e, ir.Call):
        return None
    if e.fn == "eq":
        rl = _ref_lit(e)
        if rl is None or rl[2] != "eq":
            return None
        return rl[0].name, [rl[1]]
    if e.fn == "or" and len(e.args) == 2:
        l, r = _eq_chain(e.args[0]), _eq_chain(e.args[1])
        if l is None or r is None or l[0] != r[0]:
            return None
        return l[0], l[1] + r[1]
    return None


def _merge(dom: Domain, add: Domain) -> Domain:
    """Conjunction of two domains on the same column."""
    if add.values is not None:
        vals = add.values if dom.values is None else \
            [v for v in dom.values if v in set(add.values)]
        vals = [v for v in vals
                if (dom.lo is None or v >= dom.lo)
                and (dom.hi is None or v <= dom.hi)]
        return Domain(values=vals)
    lo = add.lo if dom.lo is None else (
        dom.lo if add.lo is None else max(dom.lo, add.lo))
    hi = add.hi if dom.hi is None else (
        dom.hi if add.hi is None else min(dom.hi, add.hi))
    if dom.values is not None:
        return Domain(values=[v for v in dom.values
                              if (lo is None or v >= lo)
                              and (hi is None or v <= hi)])
    return Domain(lo, hi)


def domains_from_conjuncts(conjuncts, assignments: Dict[str, str]
                           ) -> Dict[str, Domain]:
    """symbol-level conjuncts -> {source column name: Domain}.

    `assignments` maps scan output symbols to connector column names
    (P.TableScan.assignments)."""
    out: Dict[str, Domain] = {}

    def add(sym: str, dom: Domain):
        col = assignments.get(sym)
        if col is None:
            return
        out[col] = _merge(out[col], dom) if col in out else dom

    for c in conjuncts:
        if not isinstance(c, ir.Call):
            continue
        chain = _eq_chain(c)
        if chain is not None:
            add(chain[0], Domain(values=sorted(set(chain[1]))))
            continue
        if c.fn == "between" and len(c.args) == 3 \
                and isinstance(c.args[0], ir.Ref):
            lo, hi = _lit_value(c.args[1]), _lit_value(c.args[2])
            if lo is not None or hi is not None:
                add(c.args[0].name, Domain(lo, hi))
            continue
        rl = _ref_lit(c) if c.fn in _CMP else None
        if rl is None:
            continue
        ref, val, op = rl
        # zone maps are closed ranges: open bounds keep the value as an
        # inclusive endpoint (an equal-to-bound stripe survives; the
        # Filter still removes its rows) — same relaxation the
        # reference applies mapping Marker.ABOVE/BELOW onto min/max
        if op in ("lt", "le"):
            add(ref.name, Domain(None, val))
        elif op in ("gt", "ge"):
            add(ref.name, Domain(val, None))
        else:  # eq
            add(ref.name, Domain(values=[val]))
    return {c: d for c, d in out.items()}


def merge_domain_maps(static: Dict[str, Domain],
                      runtime: Dict[str, Domain]) -> Dict[str, Domain]:
    """INTERSECT runtime-derived domains (dynamic filtering,
    plan/runtime_filters.py) with the statically extracted ones instead
    of replacing them: both constraints hold conjunctively, so a stripe
    must overlap BOTH to survive.  A column present in only one map
    keeps that map's domain unchanged."""
    out = dict(static or {})
    for col, dom in (runtime or {}).items():
        out[col] = _merge(out[col], dom) if col in out else dom
    return out


def domains_pickle_safe(domains: Dict[str, Domain]) -> Dict[str, Domain]:
    """numpy scalars -> python scalars so plan fragments serialize
    identically everywhere."""
    import numpy as np

    def clean(v):
        return v.item() if isinstance(v, np.generic) else v

    out = {}
    for c, d in domains.items():
        out[c] = Domain(clean(d.lo), clean(d.hi),
                        None if d.values is None
                        else [clean(v) for v in d.values])
    return out
