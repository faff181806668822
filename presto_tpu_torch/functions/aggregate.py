"""Aggregate function catalog: signature resolution + reduction specs.

Reference parity: the 98 aggregation files under presto-main/.../operator/
aggregation/ and AccumulatorCompiler.  Here every aggregate is described as
a (init, map, segment-combine, finalize) spec over fixed-shape arrays so
group-by lowers to jax.ops.segment_* reductions — the TPU replacement for
per-group accumulator objects.  PARTIAL/FINAL splitting (reference:
AggregationNode.Step) works on the intermediate columns declared here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List


from presto_tpu_torch import types as T


@dataclasses.dataclass
class AggSpec:
    name: str
    resolve: Callable  # (arg_types: List[Type]) -> Optional[Type]
    # intermediate state columns: list of (suffix, init_value, combine)
    # combine in {'sum', 'min', 'max', 'bitor'} — all segment-reducible
    states: Callable  # (arg_types) -> List[Tuple[str, str]]  (suffix, combine-op)
    # map inputs -> state columns (row-wise, pre-reduction)
    # finalize state columns -> result


RESOLVERS: Dict[str, Callable] = {}


def _numeric_sum_type(t: T.Type) -> T.Type:
    if t.is_integer:
        return T.BIGINT
    if t.is_decimal:
        # Presto: sum(DECIMAL(p,s)) -> DECIMAL(38,s) — the accumulator
        # is Int128 (two-limb), so whole-column sums cannot wrap
        # (reference: DecimalSumAggregation)
        return T.decimal(38, t.decimal_scale)
    return T.DOUBLE


def resolve(name: str, arg_types: List[T.Type], distinct: bool = False) -> T.Type:
    name = name.lower()
    if name in ("count", "count_if"):
        return T.BIGINT
    if name == "approx_distinct":
        return T.BIGINT
    if name == "approx_count":
        # COUNT(x) WITH ERROR (seeded-sample estimate; sql/parser.py)
        return T.BIGINT
    if name == "approx_sum":
        # SUM(x) WITH ERROR: same result type as the exact sum
        if not arg_types or not arg_types[0].is_numeric:
            raise TypeError(f"sum over {arg_types or 'no args'}")
        return _numeric_sum_type(arg_types[0])
    if name == "sum":
        if arg_types[0].name in ("INTERVAL_DAY_TIME",
                                 "INTERVAL_YEAR_MONTH"):
            # reference: IntervalDayToSecondSumAggregation
            return arg_types[0]
        if not arg_types[0].is_numeric:
            raise TypeError(f"sum over {arg_types[0]}")
        return _numeric_sum_type(arg_types[0])
    if name == "avg":
        if arg_types[0].name in ("INTERVAL_DAY_TIME",
                                 "INTERVAL_YEAR_MONTH"):
            # reference: IntervalDayToSecondAverageAggregation
            return arg_types[0]
        if not arg_types[0].is_numeric:
            raise TypeError(f"avg over {arg_types[0]}")
        return T.DOUBLE
    if name in ("min", "max", "arbitrary", "any_value"):
        return arg_types[0]
    if name in ("stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop"):
        return T.DOUBLE
    if name in ("bool_and", "bool_or", "every"):
        return T.BOOLEAN
    if name in ("corr", "covar_samp", "covar_pop", "regr_slope",
                "regr_intercept"):
        return T.DOUBLE
    if name in ("skewness", "kurtosis"):
        if not arg_types[0].is_numeric:
            raise TypeError(f"{name} over {arg_types[0]}")
        return T.DOUBLE
    if name == "entropy":
        if not arg_types[0].is_numeric:
            raise TypeError(f"entropy over {arg_types[0]}")
        return T.DOUBLE
    if name in ("bitwise_and_agg", "bitwise_or_agg"):
        if not arg_types[0].is_integer:
            raise TypeError(f"{name} over {arg_types[0]}")
        return T.BIGINT
    if name == "histogram":
        return T.map_of(arg_types[0], T.BIGINT)
    if name == "numeric_histogram":
        if len(arg_types) != 2:
            raise TypeError("numeric_histogram takes (buckets, value)")
        return T.map_of(T.DOUBLE, T.DOUBLE)
    if name == "map_union":
        if arg_types[0].name != "MAP":
            raise TypeError("map_union takes a MAP argument")
        return arg_types[0]
    if name in ("classification_miss_rate", "classification_fall_out",
                "classification_precision", "classification_recall",
                "classification_thresholds"):
        # (buckets, truth_bool, prediction_prob[, weight]) ->
        # ARRAY(DOUBLE) at thresholds i/buckets (reference:
        # Classification*Aggregation / PrecisionRecallAggregation)
        if len(arg_types) not in (3, 4) \
                or not arg_types[0].is_integer \
                or arg_types[1].name != "BOOLEAN" \
                or not arg_types[2].is_numeric:
            raise TypeError(
                f"{name} takes (buckets, truth boolean, prediction"
                "[, weight])")
        return T.array_of(T.DOUBLE)
    if name == "evaluate_classifier_predictions":
        # (truth, prediction) -> summary text (reference: presto-ml
        # EvaluateClassifierPredictionsAggregation)
        if len(arg_types) != 2:
            raise TypeError(
                "evaluate_classifier_predictions takes (truth, prediction)")
        return T.VARCHAR
    if name in ("learn_classifier", "learn_regressor"):
        if len(arg_types) != 2 or arg_types[1].name != "FEATURES":
            raise TypeError(f"{name} takes (label, features(...))")
        lt = arg_types[0]
        if name == "learn_regressor" and not lt.is_numeric:
            raise TypeError(f"learn_regressor label must be numeric, "
                            f"got {lt}")
        if name == "learn_classifier" and not (
                lt.is_numeric or lt.is_string
                or lt.name in ("BOOLEAN", "DATE")):
            raise TypeError(f"learn_classifier label type {lt} "
                            "is not supported")
        return T.VARBINARY  # serialized model (presto-ml Model role)
    if name == "approx_percentile":
        # (value, p) / (value, ARRAY[p..]) / (value, weight, p[, acc])
        # — reference: Approximate*PercentileAggregations (+Array forms)
        if not arg_types or not arg_types[0].is_numeric:
            raise TypeError(
                f"approx_percentile over {arg_types or 'no args'}")
        if len(arg_types) == 2:
            if arg_types[1].name == "ARRAY":
                return T.array_of(arg_types[0])
            return arg_types[0]
        if len(arg_types) in (3, 4):
            if arg_types[2].name == "ARRAY":
                return T.array_of(arg_types[0])
            return arg_types[0]
        raise TypeError("approx_percentile takes (value[, weight], "
                        "percentile[, accuracy])")
    if name == "checksum":
        return T.BIGINT
    if name in ("min_by", "max_by"):
        if len(arg_types) == 3:
            # n-variant: the n smallest/largest keys' values as an array
            # (reference: MinMaxByNAggregationFunction)
            if not arg_types[2].is_integer:
                raise TypeError(f"{name}(value, key, n): n must be integer")
            return T.array_of(arg_types[0])
        if len(arg_types) != 2:
            raise TypeError(f"{name} takes (value, key[, n])")
        return arg_types[0]
    if name == "geometric_mean":
        return T.DOUBLE
    if name == "array_agg":
        return T.array_of(arg_types[0])
    if name == "approx_set":
        return T.HLL
    if name == "merge":
        if arg_types[0].name not in ("HLL", "P4HLL", "QDIGEST", "TDIGEST"):
            raise TypeError(
                "merge() takes an HLL, P4HLL, QDIGEST or TDIGEST argument")
        return arg_types[0]
    if name == "qdigest_agg":
        if not arg_types[0].is_numeric:
            raise TypeError(f"qdigest_agg over {arg_types[0]}")
        return T.qdigest_of(arg_types[0])
    if name == "tdigest_agg":
        # (value[, weight[, compression]]) — reference:
        # TDigestAggregationFunction
        if not arg_types or not arg_types[0].is_numeric:
            raise TypeError(f"tdigest_agg over {arg_types or 'no args'}")
        if len(arg_types) > 3 or any(not t.is_numeric
                                     for t in arg_types[1:]):
            raise TypeError("tdigest_agg takes (value[, weight"
                            "[, compression]])")
        return T.tdigest_of(T.DOUBLE)
    if name == "map_agg":
        if len(arg_types) != 2:
            raise TypeError("map_agg takes (key, value)")
        return T.map_of(arg_types[0], arg_types[1])
    if name == "set_agg":
        # distinct values as an array (reference: SetAggregationFunction)
        return T.array_of(arg_types[0])
    if name == "set_union":
        if arg_types[0].name != "ARRAY":
            raise TypeError("set_union takes an ARRAY argument")
        return arg_types[0]
    if name == "map_union_sum":
        if arg_types[0].name != "MAP" \
                or not arg_types[0].params[1].is_numeric:
            raise TypeError("map_union_sum takes a MAP(K, numeric)")
        return arg_types[0]
    if name == "approx_most_frequent":
        if len(arg_types) != 3:
            raise TypeError(
                "approx_most_frequent takes (buckets, value, capacity)")
        return T.map_of(arg_types[1], T.BIGINT)
    if name == "reduce_agg":
        # (value, init_state, input_lambda, combine_lambda) -> state
        if len(arg_types) < 2:
            raise TypeError(
                "reduce_agg takes (value, state, input_fn, combine_fn)")
        return arg_types[1]
    if name == "multimap_agg":
        if len(arg_types) != 2:
            raise TypeError("multimap_agg takes (key, value)")
        return T.map_of(arg_types[0], T.array_of(arg_types[1]))
    raise KeyError(f"unknown aggregate function: {name}")


AGG_NAMES = {
    "count", "count_if", "sum", "avg", "min", "max", "arbitrary", "any_value",
    "stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop",
    "bool_and", "bool_or", "every", "approx_distinct", "corr", "covar_samp",
    "covar_pop", "approx_percentile", "checksum", "min_by", "max_by",
    "approx_count", "approx_sum",
    "geometric_mean", "array_agg", "map_agg", "multimap_agg",
    "approx_set", "merge", "qdigest_agg", "tdigest_agg",
    "regr_slope", "regr_intercept", "skewness", "kurtosis", "entropy",
    "bitwise_and_agg", "bitwise_or_agg", "histogram", "numeric_histogram",
    "map_union", "learn_classifier", "learn_regressor",
    "set_agg", "set_union", "map_union_sum", "approx_most_frequent",
    "reduce_agg", "evaluate_classifier_predictions",
    "classification_miss_rate", "classification_fall_out",
    "classification_precision", "classification_recall",
    "classification_thresholds",
}


def is_aggregate(name: str) -> bool:
    return name.lower() in AGG_NAMES


WINDOW_ONLY = {"row_number", "rank", "dense_rank", "ntile", "lag", "lead",
               "first_value", "last_value", "nth_value", "cume_dist", "percent_rank"}


def is_window(name: str) -> bool:
    n = name.lower()
    return n in WINDOW_ONLY or is_aggregate(n)


def resolve_window(name: str, arg_types: List[T.Type]) -> T.Type:
    """Return type of a window function call (reference: the
    WindowFunctionSupplier signatures in operator/window/)."""
    n = name.lower()
    if n in ("row_number", "rank", "dense_rank", "ntile"):
        return T.BIGINT
    if n in ("percent_rank", "cume_dist"):
        return T.DOUBLE
    if n in ("lag", "lead", "first_value", "last_value", "nth_value"):
        if not arg_types:
            raise KeyError(f"{name} requires an argument")
        return arg_types[0]
    if is_aggregate(n):
        return resolve(n, arg_types)
    raise KeyError(f"unknown window function: {name}")
