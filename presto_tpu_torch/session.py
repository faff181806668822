"""Session: the user-facing entry point (reference: Session.java +
SqlQueryManager orchestration, trimmed to an embeddable engine API).

`connect()` returns a Session bound to a catalog of connectors;
`Session.sql(text)` runs parse -> analyze -> plan -> optimize -> execute
and returns a host-side result table — the in-process analog of the
reference's LocalQueryRunner (presto-main/.../testing/LocalQueryRunner.java),
which is also exactly how its own planner/operator tests drive the engine.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


DEFAULT_SESSION_PROPERTIES: Dict[str, Any] = {
    # Reference: SystemSessionProperties.java:56 (81 typed properties).
    "join_distribution_type": "AUTOMATIC",  # BROADCAST | PARTITIONED | AUTOMATIC
    "hash_partition_count": 8,
    "task_concurrency": 1,
    "agg_capacity_hint": 0,  # 0 = derive from input size
    "optimizer_enabled": True,
    "execution_mode": "auto",  # auto | compiled | dynamic
    # the device bytes compiled mode's session memo may hold
    # (exec/compile_cache.GraphMemo; 0 = a quarter of the device's
    # memory); past them it evicts the least recently used query
    "compiled_cache_max_bytes": 0,
    # distributed execution over the device mesh (parallel/dist_executor.py)
    "distributed": False,
    "mesh_devices": 0,  # 0 = all local devices
    "broadcast_join_threshold_rows": 1_000_000,  # DetermineJoinDistributionType
    # below this row estimate ORDER BY gathers + sorts on one shard
    # instead of the P11 range-exchange sample sort
    "distributed_sort_threshold_rows": 100_000,
    # persist per-bucket grouped-execution results so a re-run after a
    # failure resumes from completed buckets (P8 recoverable execution).
    # In CLUSTER mode the same knob gates the durable exchange store
    # (replayable task output, parallel/cluster.py).  "auto" (default):
    # ON for multi-worker cluster queries whenever a spill/durable path
    # is configured (spill_enabled or an explicit spill_path) — the
    # fault-tolerant execution default — and OFF for the single-node
    # checkpoint path, which stays opt-in (True/"on").
    "recoverable_grouped_execution": "auto",
    # test hook: abort after N grouped buckets (0 = off)
    "fault_injection_fail_after_buckets": 0,
    # fuse sum-shaped aggregates into one Pallas pass (kernels.fused_group_sums)
    "pallas_fused_agg": True,
    # ordering-aware execution (plan/properties.py): exploit connector-
    # declared / operator-derived sort orders via presorted kernel
    # variants, the sort-permutation memo, and ORDER BY elision — all
    # behind runtime monotonicity guards.  Kill switch for A/B runs.
    "ordering_aware_execution": True,
    # execute DOUBLE expressions in float32 on device (cross-block
    # aggregate merges stay f64).  Default off: exact f64 semantics.  On
    # TPU, f64 is software-emulated (~10-20x per op), so benchmarks turn
    # this on; money-valued data (2-decimal) keeps comparisons stable
    # because literals and data round identically.
    "float32_compute": False,
    "partial_aggregation_max_groups": 8192,  # partial+gather vs repartition agg
    # adaptive aggregation economics (plan/agg_strategy.py, docs/PERF.md
    # round 17): the planner picks one_pass / final_only / two_phase per
    # grouped Aggregate from ordering facts + NDV estimates, and the
    # runtime monitors every two-phase partial stage's reduction ratio
    # (rows in / groups out), flipping it to pass-through when the
    # partial stops paying for itself — per-fragment, hysteresis-
    # guarded, revisitable, checksum-neutral.  Kill switches: this
    # property or env PRESTO_TPU_ADAPTIVE_AGG=off.
    # partial_agg_min_reduction: reduction below this flips the stage
    # (default measured by tools/roofline.py's `agg` sweep).
    # agg_final_only_max_groups: NDV-estimate ceiling for the planner's
    # single global-table route (no partial stage planned at all).
    "adaptive_partial_agg": True,
    "partial_agg_min_reduction": 1.3,
    "agg_final_only_max_groups": 4096,
    # sketch aggregates (exec/kernels.py HLL/KLL, docs/PERF.md):
    # prefer_approx_distinct opts the planner into rewriting
    # count(DISTINCT x) -> approx_distinct(x) (~3.25% std error at the
    # default 1024 registers; counted in QueryStats.approx_rewrites).
    # approx_percentile_accuracy sizes the mergeable quantile summary —
    # rank error ~accuracy, state width 2*ceil(2/accuracy) f64 per group.
    "prefer_approx_distinct": False,
    "approx_percentile_accuracy": 0.01,
    # materialized views (exec/matview.py, docs/SERVING.md): routing
    # sends contained SELECTs to the freshest MV snapshot (env kill:
    # PRESTO_TPU_MV_ROUTING=off); refresh mode auto|delta|full — auto
    # delta-folds appends and degrades LOUDLY to full recompute, delta
    # errors when a delta is impossible, full always recomputes.
    "materialized_view_routing": True,
    "mv_refresh_mode": "auto",
    # per-plan-node stats collection in dynamic mode (forced by EXPLAIN
    # ANALYZE; costs one host sync per operator — reference: OperationTimer)
    "collect_node_stats": False,
    # observability (observe/trace.py + observe/profile.py,
    # docs/OBSERVABILITY.md): span recording detail — "basic" (default)
    # records query/phase/fragment/task/attempt/compile spans and
    # merges worker spans into one trace; "full" adds per-page-pull
    # spans in cluster mode; "off" disables the recorder entirely (the
    # observability_overhead A/B lever; /v1/query/{id}/trace then
    # serves an empty trace).  profile_query: a directory path to
    # capture a jax.profiler trace of each query into (also env
    # PRESTO_TPU_PROFILE; "" = off) — jax.named_scope annotations at
    # every operator-lowering site map the profiler timeline back to
    # plan node names.
    "trace_detail": "basic",
    "profile_query": "",
    # memory management (reference: query.max-memory-per-node +
    # experimental.spill-enabled, FeaturesConfig/MemoryManagerConfig)
    "query_max_memory_bytes": 4 << 30,
    "memory_pool_bytes": 16 << 30,  # per-process pool (MemoryPool capacity)
    "spill_enabled": True,
    "spill_encryption": False,  # AES-256-CTR at rest (AesSpillCipher)
    # session time zone for the WITH TIME ZONE surface (reference:
    # Session.getTimeZoneKey / SystemSessionProperties)
    "time_zone": "UTC",
    # fragment fusion (plan/distribute.fuse_fragments, ROADMAP item 1):
    # mesh-local exchange edges of a cluster plan splice back into ONE
    # traced shard_map program whose exchanges lower to ICI collectives
    # — zero host round-trips between fused stages.  A worker is a
    # fusion target only when it DECLARES an exclusively-owned mesh
    # (PRESTO_TPU_WORKER_MESH / WorkerServer(mesh_devices=)) of at
    # least `fragment_fusion_min_devices` chips.  Modes (round 18,
    # plan/fusion_cost.py): `auto` (default) prices every mesh-local
    # exchange edge CUT vs FUSED with the calibrated exchange roofline
    # + a per-plan-shape decision memo fed by observed execute walls;
    # `force` restores round 12's fuse-every-eligible-edge policy
    # byte-identically (legacy boolean True maps here); `off` keeps the
    # per-fragment HTTP path (False maps here; env kill
    # PRESTO_TPU_FRAGMENT_FUSION=off).  Any fused-attempt failure
    # retries on the HTTP path.  `fragment_fusion_kinds` (csv)
    # restricts which edge kinds fuse, for A/B runs and partial-fusion
    # coverage; `fusion_profile` points at a calibration JSON written
    # by `tools/roofline.py --calibrate` (else PRESTO_TPU_FUSION_PROFILE
    # env, else baked per-platform defaults); `fragment_fusion_memo`
    # (default on) is the runtime-feedback kill switch — off = pure
    # model, nothing recorded.
    "fragment_fusion": "auto",
    "fragment_fusion_min_devices": 2,
    "fragment_fusion_kinds": "",
    "fragment_fusion_memo": True,
    "fusion_profile": "",
    # cross-host collective fusion (round 21): workers that joined one
    # `jax.distributed` multi-process mesh (cluster worker
    # --distributed-coordinator / PRESTO_TPU_MULTIHOST) form a GANG the
    # classifier may fuse cross-host exchange edges onto — repartition
    # lowers to all_to_all and broadcast/gather to all_gather over the
    # DCN fabric, priced by the profile's dcn_edge_ms/dcn_ms_per_mb
    # lane.  Off = mesh members are plain HTTP workers; any gang
    # failure (member death, collective fault) already degrades to the
    # HTTP exchange path on its own.
    "multihost_fusion": True,
    # cluster scheduling policy (reference: PhasedExecutionSchedule vs
    # AllAtOnceExecutionPolicy, execution-policy session property):
    # phased gates probe-side stage startup on build-side completion,
    # bounding worker buffer memory on deep join DAGs
    "phased_execution": False,
    # cluster robustness knobs (parallel/retry.py, docs/ROBUSTNESS.md):
    # one query-level deadline every RPC timeout derives from (None =
    # unbounded; env PRESTO_TPU_QUERY_DEADLINE overrides the default),
    # the straggler-hedging policy, and the health circuit breaker
    "cluster_query_deadline_s": None,
    "cluster_hedging": True,
    "cluster_hedge_quantile": 0.5,  # hedge when this wave share FINISHED
    "cluster_hedge_factor": 3.0,    # ... and a task exceeds q*factor
    "cluster_hedge_min_s": 0.25,    # ... with at least this headroom
    "cluster_health_trip_after": 3,   # consecutive failures to quarantine
    "cluster_health_probation_s": 5.0,  # re-probe a quarantined worker
    # task-granular restart (parallel/cluster.py, fault-tolerant
    # execution): when ONE task dies mid-wave the coordinator re-runs
    # just that slot on a healthy survivor inside the SAME attempt
    # (hedge-style slot repoint; completed siblings' durable pages are
    # untouched) — up to this many restarts per slot before escalating
    # to the whole-attempt retry.  0 disables (whole-attempt retry
    # only, the pre-round-20 behavior the attempt-level chaos tests
    # pin).
    "cluster_task_restarts": 2,
    # query journal (parallel/journal.py): fleet-visible resumable
    # state per in-flight distributed query, so the ring successor
    # adopts a dead coordinator's queries (docs/ROBUSTNESS.md).
    # "auto" (default) journals exactly when a fleet is attached;
    # on/off force it.  query_journal_path overrides the journal dir
    # ("" = <spill base>/journal — coordinators sharing a spill base
    # share the journal).
    "query_journal": "auto",
    "query_journal_path": "",
    # compilation economics (exec/compile_cache.py): persistent XLA
    # executable cache directory ("" = env PRESTO_TPU_COMPILE_CACHE /
    # legacy PRESTO_TPU_XLA_CACHE / the /tmp default; "0" or "off"
    # disables persistence) and the background compile-ahead that
    # AOT-compiles chunked fragments 2..N while fragment 1 executes
    # (kill switch; env PRESTO_TPU_COMPILE_AHEAD=off|on overrides
    # process-wide, and the unforced default is on only with >1 usable
    # core — on a single core a "background" compile can only steal the
    # query's cycles.  Never changes results, only when programs
    # compile).
    "compile_cache_dir": "",
    "compile_ahead": True,
    # dynamic filtering (plan/runtime_filters.py + exec/kernels.py rf_*):
    # selective-join build sides publish runtime key summaries (min/max
    # domain + exact or bloom membership) that probe-side scans consume
    # to skip rows / chunks / splits before the join.  Never changes
    # results (kill switch: env PRESTO_TPU_DYNAMIC_FILTERS=off).
    "dynamic_filtering": True,
    # cluster mode: how long a probe-side task waits for a not-yet-
    # delivered filter summary before scanning filter-free (ms).  0 =
    # never wait — a slow or crashed build worker can then never stall
    # the probe; unreceived filters degrade to today's behaviour.
    "dynamic_filtering_wait_ms": 0,
    # transitive semi-join pushdown (plan/optimizer); chunked planning
    # turns it off — the inferred probe-side semi never compacts at
    # chunk capacities
    # serving tier (server/serving.py, docs/SERVING.md): prepared
    # statements bind through the typed aval-abstracted path (one plan +
    # executable per parameter-type signature; kill switch falls every
    # EXECUTE back to text substitution), admission waits bound by the
    # queue timeout, and the protocol server's result cache serving
    # identical re-submitted SELECTs without execution (keyed by text x
    # catalog token+version x properties; any engine write invalidates)
    "prepared_typed_binding": True,
    # query coalescing (server/serving.QueryCoalescer + exec/executor.
    # run_compiled_batched): concurrent EXECUTEs of the SAME prepared
    # signature arriving within the micro-batch window stack their
    # bound parameters into a leading axis and share ONE vmap-batched
    # XLA launch.  query_coalescing: auto (default — a window opens
    # only when another same-signature query is in flight) | on | off
    # (env kill switch PRESTO_TPU_QUERY_COALESCING=off); the window is
    # coalesce_window_ms and batches cap at coalesce_max_batch (stacked
    # sizes quantize to pow2 below the cap so near-identical batch
    # sizes share executables).  Never changes results: anything that
    # cannot batch exits the group and runs solo.
    "query_coalescing": "auto",
    "coalesce_window_ms": 2.0,
    "coalesce_max_batch": 16,
    "admission_queue_timeout_s": 60.0,
    # coordinator fleet (server/fleet.py; docs/SERVING.md "Multi-
    # coordinator topology"): coordinator_count is the serving-fleet
    # size (1 = classic single coordinator; bench.py --serve
    # --coordinators N overrides per run); fleet_affinity is the front
    # door's routing mode for statements owned by a ring peer — proxy
    # (default: forward and re-home URIs, dumb clients keep one
    # endpoint) | redirect (307 to the owner; clients that follow it
    # skip the proxy hop) | off (execute wherever the statement lands;
    # coalescing batches then fragment 1/N); fleet_invalidate gates the
    # best-effort version-stamped invalidation broadcast on engine
    # writes (the catalog token+version baked into every cache key is
    # the correctness backstop — a dropped broadcast degrades to a key
    # miss, never a stale hit)
    "coordinator_count": 1,
    "fleet_affinity": "proxy",
    "fleet_invalidate": True,
    "result_cache_enabled": True,
    "result_cache_max_entries": 256,
    "result_cache_max_bytes": 64 << 20,
    "result_cache_max_rows": 10_000,
    "transitive_semijoin_inference": True,
    "iterative_optimizer_enabled": True,
    "reorder_joins": True,  # Selinger-DP ReorderJoins in the Memo
    "max_reorder_joins": 8,  # Memo/Rule fixpoint pass
    "spill_path": "",  # "" = <tmp>/presto_tpu_spill
    "localfile_root": "",  # "" = <tmp>/presto_tpu_tables (file connectors)
    # write subsystem (exec/writer.py, docs/WRITES.md): rows per
    # streamed write chunk (chunked-mode CTAS/INSERT appends one sink
    # page per chunk — the bounded-host-memory knob), and the writer
    # worker count for distributed writes (0 = auto: one thread per
    # core up to 8; each worker writes its OWN staged files, the
    # coordinator runs the single finish/commit)
    "write_page_rows": 1 << 20,
    "write_parallelism": 0,
    "spill_partition_count": 8,  # Grace hash fan-out (GenericPartitioningSpiller)
    "max_spill_bytes": 64 << 30,
    # force grouped execution above this input row count regardless of the
    # memory probe (0 = memory-driven only); the deterministic test knob,
    # like the reference's tiny operator-memory configs in spill tests
    "spill_trigger_rows": 0,
    # spill-tiered degradation (exec/spill_exec.py, docs/SPILL.md):
    # force hybrid spilling when an operator's estimated state exceeds
    # this many bytes (0 = memory-context-driven), force a specific tier
    # deterministically ("partial" | "recursive"; env
    # PRESTO_TPU_FORCE_SPILL outranks), bound the recursive
    # re-partitioning depth (past it the query fails LOUDLY with
    # SpillRecursionError), and optionally read each spill frame back
    # right after writing so write-path corruption heals by a
    # transparent re-spill instead of failing the query at unspill
    "spill_threshold_bytes": 0,
    "force_spill": "",
    "spill_max_recursion_depth": 3,
    "spill_verify_writes": False,
}


@dataclasses.dataclass
class QueryResult:
    """Host-side materialized result (reference: MaterializedResult)."""

    columns: list  # [(name, Type)]
    rows: list  # list of python tuples
    stats: Any = None  # this query's QueryStats (observe.stats)

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return len(self.rows)

    def column(self, i: int) -> list:
        return [r[i] for r in self.rows]

    def to_dict(self) -> Dict[str, list]:
        return {name: self.column(i) for i, (name, _) in enumerate(self.columns)}


class Session:
    """A catalog, session properties and the torch device every query of
    this session runs on (the reference's Session, minus the access
    control, transaction and system-table hooks this slice does not
    port)."""

    def __init__(self, catalog=None, properties: Optional[Dict[str, Any]] = None,
                 user: str = "user", source: str = "embedded", device=None):
        import collections
        import threading

        from presto_tpu_torch.catalog import Catalog

        self.catalog = catalog if catalog is not None else Catalog()
        self.device = resolve_device(device)
        self.user = user
        self.source = source
        self.properties = dict(DEFAULT_SESSION_PROPERTIES)
        if properties:
            self.properties.update(properties)
        self.history = collections.deque(maxlen=1000)
        self.history_lock = threading.Lock()

    def set(self, name: str, value) -> None:
        if name not in self.properties:
            raise KeyError(f"unknown session property: {name}")
        self.properties[name] = value

    @property
    def last_stats(self):
        """QueryStats of the most recently begun query."""
        with self.history_lock:
            return self.history[-1] if self.history else None

    def sql(self, text: str) -> QueryResult:
        from presto_tpu_torch.exec.executor import execute_query

        return execute_query(self, text)


def resolve_device(device=None):
    """The session's torch device: `cuda:0` unless the caller names
    another.  Never falls back to the CPU on its own: without a CUDA
    device the caller must pass device="cpu"."""
    import torch

    if device is None:
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "presto_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def connect(catalog=None, device=None, **properties) -> Session:
    return Session(catalog, properties or None, device=device)
