"""All 22 TPC-H queries through presto_tpu_torch's dynamic executor on
the CPU at SF0.01, held against the sqlite oracle (with the ORDERED set
and the comparison of tests/test_tpch_correctness.py) and against
presto_tpu's dynamic executor: its rows, and the seven counters of
ordering-aware execution and dynamic filtering in QueryStats
(sorts_taken, sorts_elided, sort_memo_hits, ordering_guard_trips,
df_filters_produced, df_filters_applied, df_rows_pruned), which must be
equal: the port sorts, elides and prunes what presto_tpu does.
Compiled mode, the default, has the same checks in
tests/test_torch_compiled.py.

The port reads its own generated tables (presto_tpu_torch.catalog
.tpch_catalog), which equal the reference's column for column
(tests/test_torch_slice.py::test_tpch_generator_matches_reference), so
it plans with the same statistics and key layouts.  Against presto_tpu,
keys and counts must be equal and sums and averages agree to rtol 1e-9,
the tolerance the reference holds itself to across summation orders.
The catalogs, the oracle and both sessions are built once per module,
and each package runs each query once for all its legs
(tests/torch_tpch_common.py).  This file holds Q1 to Q7,
tests/test_torch_tpch_q8.py Q8 to Q14 and tests/test_torch_tpch_q15.py
Q15 to Q22, so that `--dist loadfile` spreads them over workers.  The oracle is
a copy of the shared sqlite database with indexes on the join keys:
sqlite then runs all 22 queries in under a second, where Q21 alone took
77 s without them (CPU, SF0.01).  Indexes change no result.
"""

import pytest

from tests.torch_threads import torch_one_thread  # noqa: F401
from tests.torch_tpch_common import (  # noqa: F401 (fixtures)
    _assert_rows_match, check_counters, check_oracle, check_reference,
    counters, oracle, port_results, reference, reference_params)

QIDS = list(range(1, 8))


@pytest.mark.parametrize("qid", QIDS)
def test_query_matches_oracle(qid, port_results, oracle):
    check_oracle(qid, port_results, oracle)


@pytest.mark.parametrize("qid", reference_params(QIDS))
def test_query_matches_reference(qid, port_results, reference):
    check_reference(qid, port_results, reference)


@pytest.mark.parametrize("qid", QIDS)
def test_query_counters_match_reference(qid, port_results, reference):
    check_counters(qid, port_results, reference)
