"""Adaptive aggregation economics (ROADMAP item 2, docs/PERF.md round 17).

Two papers point at the same gap in a static two-phase GROUP BY
pipeline.  *Partial Partial Aggregates*: partial aggregation should
disable itself per-partition when it is not reducing rows — a
high-cardinality GROUP BY (q67-class) pays a full per-chunk group-build
whose output is the size of its input.  *Global Hash Tables Strike
Back!*: a single global table beats partitioned two-phase aggregation
far more often than folklore says — a low-NDV unsorted input wants ONE
grouping pass, not a partial stage plus a merge.

This module is the one place that decides HOW a GROUP BY aggregates:

1. **Planner strategy** (``annotate``): every grouped SINGLE Aggregate
   is stamped with ``agg_strategy``:

   - ``one_pass``   — the input is presorted on a safe leading group key
     (plan/properties.py ``ordering_hint_safe``): the PR-3 run-boundary
     scan groups in one pass with no sort, so no partial stage is ever
     worth planning;
   - ``final_only`` — the NDV estimate (``capacity_hint`` from
     annotate_static_hints) is small and the input visibly reduces:
     distribution routes rows to their group's shard and aggregates
     ONCE (the global-table route) — no partial stage planned at all;
   - ``two_phase``  — high/unknown NDV keeps the partial→final split,
     with the runtime bypass below armed.

   The annotation is a plain string attribute, so it rides plan serde
   and fragment cutting to cluster workers unchanged.

2. **Runtime bypass** (``FlipState`` + the pass-through transform):
   during chunked and cluster execution the partial stage's reduction
   ratio (live rows in / groups out) is monitored; when it stays below
   ``partial_agg_min_reduction`` the partial stage flips to
   PASS-THROUGH — each input row is projected straight into the
   partial-output schema (count→0/1, sum→x, avg→(x,1), …) and streams
   to the final stage, skipping the per-chunk group-build entirely.
   The flip is per-fragment, hysteresis-guarded (``FLIP_STRIKES``
   consecutive bad windows to flip, ``REENABLE_FACTOR`` headroom to
   flip back), revisitable (a periodic probe chunk re-measures the
   ratio), and checksum-neutral — the final stage re-groups whatever
   mix of grouped partials and raw rows arrives.

Kill switches: session property ``adaptive_partial_agg`` (default on)
and env ``PRESTO_TPU_ADAPTIVE_AGG=off``.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Optional

from presto_tpu_torch import types as T
from presto_tpu_torch.plan import ir
from presto_tpu_torch.plan import nodes as P

_KILL_ENV = "PRESTO_TPU_ADAPTIVE_AGG"

# strategy names (the QueryStats.agg_strategy counter keys)
ONE_PASS = "one_pass"
FINAL_ONLY = "final_only"
TWO_PHASE = "two_phase"
SKETCH = "sketch"

# sketch aggregate family: fixed-width mergeable device states (HLL
# registers / KLL summaries / deterministic samples).  Their partials
# NEVER overflow — the state is O(1) per group regardless of input
# cardinality — so the bypass/hysteresis economics above do not apply:
# a sketch partial is ALWAYS worth keeping, and distribution never cuts
# a hash-repartition edge for a sketch-only aggregate (the merge is one
# elementwise collective over registers, see plan/distribute.py).
SKETCH_FNS = frozenset({"approx_distinct", "approx_percentile",
                        "approx_count", "approx_sum"})


def sketch_fns(node: P.Aggregate) -> frozenset:
    """The sketch-family fns this Aggregate uses (empty when none)."""
    return frozenset(a.fn for a in node.aggs.values()) & SKETCH_FNS

# hysteresis constants (module-level, not session knobs: the knob that
# matters — the reduction threshold — is partial_agg_min_reduction;
# these only shape how fast decisions move)
FLIP_STRIKES = 2        # consecutive bad windows before flipping
REENABLE_FACTOR = 2.0   # re-enable needs min_reduction * this headroom
RATIO_WINDOW = 4        # chunks per ratio observation window
RECHECK_EVERY = 16      # while bypassed, probe the grouped lane every N


def enabled(session) -> bool:
    """Master switch for BOTH the planner strategy choice and the
    runtime bypass (property default on, env kill outranks)."""
    if os.environ.get(_KILL_ENV, "").lower() in ("off", "0", "false"):
        return False
    return bool(session.properties.get("adaptive_partial_agg", True))


def min_reduction(session) -> float:
    """Rows-in / groups-out below this and the partial stage is not
    paying for itself (default measured by the tools/roofline.py `agg`
    sweep: the two-phase-vs-final-only crossover sits near 1.3x on CPU
    and well under 2x on chip — see docs/PERF.md round 17)."""
    return float(session.properties.get("partial_agg_min_reduction", 1.3))


def final_only_max_groups(session) -> int:
    """NDV-estimate ceiling for the planner's final_only (global table)
    route — above it the estimate is too coarse to bet the exchange
    volume on, and two_phase + runtime bypass adapts instead."""
    return int(session.properties.get("agg_final_only_max_groups", 4096))


# ---------------------------------------------------------------------------
# planner strategy choice
# ---------------------------------------------------------------------------

def choose(node: P.Aggregate, session) -> str:
    """Pick the aggregation strategy for one grouped Aggregate from the
    plan/properties.py ordering facts and the annotate_static_hints NDV
    estimates.  Presorted wins unconditionally; a confidently-small NDV
    with real reduction routes final-only; everything else keeps
    two-phase with the runtime bypass armed."""
    if sketch_fns(node):
        # fixed-width mergeable states: the partial stage never
        # overflows and never loses, regardless of NDV — keep it
        # unconditionally and keep the capacity check out of the way
        # (a FINAL_ONLY stamp would route the hash-repartition edge the
        # sketch exists to delete)
        return SKETCH
    if getattr(node, "ordering_hint", None) is not None \
            and getattr(node, "ordering_hint_safe", False):
        # run-boundary one-pass grouping: no sort, no partial stage
        return ONE_PASS
    cap = getattr(node, "capacity_hint", None)
    if cap and cap <= final_only_max_groups(session):
        # confidently small group table: one global grouping pass
        # (distribution adds a skew floor — see distribute.py — so a
        # near-degenerate key set still rides the tiny-partial split)
        return FINAL_ONLY
    return TWO_PHASE


def annotate(plan: P.QueryPlan, session) -> None:
    """Stamp ``agg_strategy`` on every grouped SINGLE Aggregate.  Runs
    after plan/properties.annotate (needs ordering_hint) and
    annotate_static_hints (needs capacity/input estimates)."""
    if not enabled(session):
        return
    seen: set = set()

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for s in node.sources:
            walk(s)
        if isinstance(node, P.Aggregate) and node.group_keys \
                and node.step == "SINGLE":
            node.agg_strategy = choose(node, session)

    walk(plan.root)
    for sub in plan.subplans.values():
        walk(sub)


# ---------------------------------------------------------------------------
# pass-through transform: a PARTIAL Aggregate as a per-row Project
# ---------------------------------------------------------------------------

def _row_expr(a: ir.AggCall) -> Optional[ir.RowExpr]:
    """The per-row expression whose FINAL-stage fold equals the original
    aggregate over raw rows, or None when the partial has no row form
    (the fragment is then not bypassable).  FILTER/DISTINCT partials
    are excluded — DISTINCT never reaches a PARTIAL split, and a FILTER
    needs a null-injecting conditional we do not emit today."""
    if a.distinct or a.filter is not None:
        return None
    fn = a.fn
    if fn == "count" and not a.args:
        return ir.Lit(1, a.type)  # count(*): every live row counts one
    if fn in ("count", "count_if") and a.args:
        arg = a.args[0]
        one, zero = ir.Lit(1, a.type), ir.Lit(0, a.type)
        if fn == "count_if":
            return ir.Call("if", (arg, one, zero), a.type)
        # count(x): non-null rows count one (final merge_count sums)
        return ir.Call(
            "if", (ir.Call("is_null", (arg,), T.BOOLEAN), zero, one),
            a.type)
    if fn in ("sum", "min", "max", "bool_and", "every", "bool_or",
              "arbitrary", "any_value", "min_by", "max_by"):
        arg = a.args[0]
        at = getattr(arg, "type", None)
        if at is not None and at != a.type:
            return ir.CastExpr(arg, a.type)
        return arg  # nulls stay null; the final fold skips them
    if fn == "partial_sum_double":
        return ir.CastExpr(a.args[0], T.DOUBLE)
    if fn == "partial_sum_sq_double":
        x = ir.CastExpr(a.args[0], T.DOUBLE)
        return ir.Call("mul", (x, x), T.DOUBLE)
    return None


def passthrough_project(node: P.Aggregate) -> Optional[P.Project]:
    """The pass-through lane for a PARTIAL Aggregate: a Project over the
    SAME source emitting the partial-output schema per row.  Returns
    None when any aggregate has no row form."""
    if node.step != "PARTIAL" or not node.group_keys:
        return None
    src_types = dict(node.source.outputs())
    assigns: Dict[str, ir.RowExpr] = {}
    for k in node.group_keys:
        t = src_types.get(k)
        if t is None:
            return None
        assigns[k] = ir.Ref(k, t)
    for sym, a in node.aggs.items():
        e = _row_expr(a)
        if e is None:
            return None
        assigns[sym] = e
    return P.Project(node.source, assigns)


def bypassable(node) -> bool:
    return isinstance(node, P.Aggregate) \
        and passthrough_project(node) is not None


def find_partial_agg(root) -> Optional[P.Aggregate]:
    """The PARTIAL Aggregate on a fragment's root chain (through
    Output/Project/Filter wrappers), or None.  Aggregates buried below
    joins are not monitored — their output does not feed the consumer
    exchange directly, so bypassing them would not shrink anything the
    monitor can see."""
    node = root
    while isinstance(node, (P.Output, P.Project, P.Filter)):
        node = node.source
    if isinstance(node, P.Aggregate) and node.step == "PARTIAL" \
            and node.group_keys:
        return node
    return None


def bypass_root(root):
    """A copy of the fragment root chain with the PARTIAL Aggregate
    swapped for its pass-through Project; the subtree BELOW the
    aggregate is shared (scan node identities survive, which the
    chunked runner's scan_inputs keying relies on).  None when the
    chain has no bypassable partial."""
    agg = find_partial_agg(root)
    if agg is None:
        return None
    proj = passthrough_project(agg)
    if proj is None:
        return None

    def rebuild(node):
        if node is agg:
            return proj
        clone = copy.copy(node)  # keeps optimizer hint instance-attrs
        clone.source = rebuild(node.source)
        return clone

    return rebuild(root) if root is not agg else proj


# ---------------------------------------------------------------------------
# runtime flip state (per partial-aggregate, hysteresis-guarded)
# ---------------------------------------------------------------------------

class FlipState:
    """Hysteresis-guarded bypass decision for ONE partial aggregate.

    observe() feeds one reduction-ratio measurement (rows in / groups
    out); FLIP_STRIKES consecutive measurements under the threshold
    flip the stage to pass-through, and a recovered ratio (threshold x
    REENABLE_FACTOR, measured by periodic grouped probes) flips it
    back.  Events are returned so callers count flips into QueryStats
    (partial_aggs_bypassed / partial_aggs_reenabled)."""

    __slots__ = ("bypassed", "strikes", "served", "last_ratio")

    def __init__(self):
        self.bypassed = False
        self.strikes = 0
        self.served = 0  # bypassed serves since the last grouped probe
        self.last_ratio = 0.0

    def probe_due(self) -> bool:
        """While bypassed: route this execution/chunk through the
        grouped lane to re-measure the ratio?"""
        return self.bypassed and self.served >= RECHECK_EVERY

    def note_bypassed(self) -> None:
        self.served += 1

    def observe(self, ratio: float, threshold: float) -> str:
        """Feed one grouped-lane measurement; returns "" | "flipped" |
        "reenabled"."""
        self.last_ratio = float(ratio)
        if self.bypassed:
            self.served = 0  # this was the periodic probe
            if ratio >= threshold * REENABLE_FACTOR:
                self.bypassed = False
                self.strikes = 0
                return "reenabled"
            return ""
        if ratio < threshold:
            self.strikes += 1
            if self.strikes >= FLIP_STRIKES:
                self.bypassed = True
                self.strikes = 0
                self.served = 0
                return "flipped"
        else:
            self.strikes = 0
        return ""


def node_fingerprint(node: P.Aggregate) -> str:
    """Stable identity of a partial aggregate across executors, runs and
    (decoded) cluster task fragments: group keys + aggregate signatures.
    Deliberately NOT cached on the node — a cached attribute would ride
    plan serde and perturb fragment fingerprints depending on whether
    the flip state was consulted before or after fragment cutting."""
    aggs = sorted((sym, a.fn, len(a.args),
                   str(getattr(a.args[0], "type", "")) if a.args else "")
                  for sym, a in node.aggs.items())
    return json.dumps([list(node.group_keys), aggs], sort_keys=True)


def flip_state(session, node: P.Aggregate) -> Optional[FlipState]:
    """The session-scoped FlipState for a bypassable PARTIAL aggregate
    (None when not bypassable).  Cluster workers hold their own session
    per process, so the state — and the ratio it tracks — is per-task
    by construction; the decision's counters ride task status back to
    the coordinator."""
    if not bypassable(node):
        return None
    states = getattr(session, "_agg_flip_states", None)
    if states is None:
        states = session._agg_flip_states = {}
    fp = node_fingerprint(node)
    st = states.get(fp)
    if st is None:
        st = states[fp] = FlipState()
    return st
