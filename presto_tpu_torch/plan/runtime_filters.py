"""Dynamic filtering: plan-time wiring of build-side runtime filters
into probe-side scans.

Reference parity: Presto's dynamic filtering (DynamicFilterService +
PredicatePushDown's dynamic-filter assignments): the build side of a
selective equi-join produces a runtime summary of its keys (min/max
domain + membership set) and probe-side scans consume it to skip rows,
chunks, and splits BEFORE the join ever sees them.  This pass only
WIRES producers to consumers; the summaries themselves are built and
probed by the kernel family in exec/kernels.py (rf_build / rf_probe),
applied by the executor, the chunked runner, and the cluster tasks.

Annotations (plain dicts/strings — they ride plan serde and fragment
cutting untouched, so cluster tasks agree on filter ids):

  Join.rf_produce   = [{"fid", "build_sym", "probe_sym"}]
  TableScan.rf_consume = [{"fid", "sym", "column"}]

Soundness: a filter on probe symbol `s` at join J removes only rows
whose key value is missing from J's build key set — for an INNER/SEMI
join those rows produce no J output, so removing them ANYWHERE below J
is result-identical as long as (a) the symbol's VALUE is unchanged from
the scan to J (we walk only through Filter / identity-Project /
probe-preserving Join edges) and (b) every consumer of the scan's
output lies on that walk (we refuse shared DAG subtrees).  Bloom
summaries may keep extra rows (false positives) but never drop a
matching row; results are therefore identical with filtering on or off.

Everything is best-effort and sits behind the `dynamic_filtering`
session property (default on) and the PRESTO_TPU_DYNAMIC_FILTERS env
kill switch.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from presto_tpu_torch.plan import ir
from presto_tpu_torch.plan import nodes as P

ENV_KILL = "PRESTO_TPU_DYNAMIC_FILTERS"
#: build sides estimated above this row count produce no filter (the
#: summary itself would rival the probe work it saves)
DEFAULT_MAX_BUILD_ROWS = 8_000_000
#: probe sides estimated below this produce no filter either: the
#: membership mask costs one probe-length pass + trace ops per query,
#: which a small probe can never pay back (at SF>=1 every real fact
#: probe clears this; env PRESTO_TPU_DF_MIN_PROBE overrides)
DEFAULT_MIN_PROBE_ROWS = 50_000

#: key types whose stored representation is an integer the kernels can
#: summarize exactly (strings would need cross-dictionary translation,
#: floats a lossless orderable mapping on BOTH host paths — excluded)
_FILTERABLE = ("TINYINT", "SMALLINT", "INTEGER", "BIGINT", "DATE",
               "TIMESTAMP", "BOOLEAN")


def enabled(session) -> bool:
    """The ONE gate every layer consults: env kill switch outranks the
    session property."""
    env = os.environ.get(ENV_KILL, "").lower()
    if env in ("0", "off", "false"):
        return False
    return bool(session.properties.get("dynamic_filtering", True))


def max_build_rows() -> int:
    return int(os.environ.get("PRESTO_TPU_DF_MAX_BUILD",
                              DEFAULT_MAX_BUILD_ROWS))


def min_probe_rows() -> int:
    return int(os.environ.get("PRESTO_TPU_DF_MIN_PROBE",
                              DEFAULT_MIN_PROBE_ROWS))


def annotate(plan: P.QueryPlan, session) -> None:
    """Attach producer/consumer runtime-filter annotations to every
    eligible INNER/SEMI equi-join whose build side is estimated small
    and whose probe key traces cleanly to a scan column.  Filter ids
    are unique within the plan (df0, df1, ...) and survive fragment
    serde, so every cluster task names the same filter the same way."""
    if not enabled(session):
        return
    if getattr(session, "catalog", None) is None:
        return
    counter = [0]
    seen: set = set()

    def visit(node: P.PlanNode) -> None:
        if id(node) in seen:
            return
        seen.add(id(node))
        for s in node.sources:
            visit(s)
        if not isinstance(node, P.Join) or not node.criteria \
                or node.join_type not in ("INNER", "SEMI"):
            return
        # estimates come from annotate_static_hints (which already ran
        # a memoized stats derivation over this exact plan) — this pass
        # adds NO stats work of its own; no hints, no filter
        rs_est = getattr(node, "right_est_hint", None)
        ls_est = getattr(node, "left_est_hint", None)
        if rs_est is None or ls_est is None:
            return
        # small/selective build gate: the probe must clearly outweigh
        # the build (4x) AND be worth filtering at all — a near-equal
        # build costs a probe-sized membership pass to prune little,
        # and a small probe can't repay the pass no matter what
        if rs_est > max_build_rows() or ls_est < 4 * rs_est \
                or ls_est < min_probe_rows():
            return
        ltypes = node.left.output_types()
        rtypes = node.right.output_types()
        for lk, rk in node.criteria:
            lt, rt = ltypes.get(lk), rtypes.get(rk)
            if lt is None or rt is None or lt.name not in _FILTERABLE \
                    or rt.name not in _FILTERABLE:
                continue
            hit = resolve_probe_scan(node.left, lk)
            if hit is None:
                continue
            scan, scan_sym = hit
            fid = f"df{counter[0]}"
            counter[0] += 1
            prod = list(getattr(node, "rf_produce", None) or [])
            prod.append({"fid": fid, "build_sym": rk, "probe_sym": lk})
            node.rf_produce = prod
            cons = list(getattr(scan, "rf_consume", None) or [])
            cons.append({"fid": fid, "sym": scan_sym,
                         "column": scan.assignments.get(scan_sym)})
            scan.rf_consume = cons
            break  # one filter per join: the leading resolvable key

    visit(plan.root)
    for sub in plan.subplans.values():
        visit(sub)


def resolve_probe_scan(node: P.PlanNode, sym: str
                       ) -> Optional[Tuple[P.TableScan, str]]:
    """Walk the probe subtree down to the TableScan producing `sym`,
    through row-VALUE-preserving edges only: Filter (masks), identity
    Project (renames), and join edges that keep probe rows' key values
    intact.  Returns (scan, scan_symbol) or None when the origin is not
    a clean scan column (expression, aggregate, union, exchange buffer,
    or a shared DAG subtree another consumer also reads)."""
    while True:
        if getattr(node, "shared_subtree", False):
            # plan DAG (transitive semi-join inference): pruning here
            # would starve the OTHER consumer of the shared result
            return None
        if isinstance(node, P.TableScan):
            if node.table.startswith("__exch_") \
                    or sym not in node.assignments:
                return None
            return node, sym
        if isinstance(node, P.Filter):
            node = node.source
        elif isinstance(node, P.Project):
            e = node.assignments.get(sym)
            if not isinstance(e, ir.Ref):
                return None
            sym = e.name
            node = node.source
        elif isinstance(node, P.Join):
            # removing a row below an intermediate join removes only
            # output rows carrying that row's key value — which the
            # producer join up top drops anyway (INNER/SEMI semantics)
            if node.join_type in ("INNER", "LEFT", "SEMI", "ANTI",
                                  "MARK") \
                    and sym in {s for s, _ in node.left.outputs()}:
                node = node.left
            elif node.join_type == "INNER" \
                    and sym in {s for s, _ in node.right.outputs()}:
                node = node.right
            else:
                return None
        else:
            return None  # Aggregate/Union/Window/...: values re-derived
