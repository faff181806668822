"""TPC-H Q8 to Q14 through presto_tpu_torch's dynamic executor on the
CPU at SF0.01, against the sqlite oracle and presto_tpu's dynamic
executor (tests/test_torch_tpch.py says what each test holds).
"""

import pytest

from tests.torch_threads import torch_one_thread  # noqa: F401
from tests.torch_tpch_common import (  # noqa: F401 (fixtures)
    _assert_rows_match, check_counters, check_oracle, check_reference,
    counters, oracle, port_results, reference, reference_params)

QIDS = list(range(8, 15))


@pytest.mark.parametrize("qid", QIDS)
def test_query_matches_oracle(qid, port_results, oracle):
    check_oracle(qid, port_results, oracle)


@pytest.mark.parametrize("qid", reference_params(QIDS))
def test_query_matches_reference(qid, port_results, reference):
    check_reference(qid, port_results, reference)


@pytest.mark.parametrize("qid", QIDS)
def test_query_counters_match_reference(qid, port_results, reference):
    check_counters(qid, port_results, reference)
