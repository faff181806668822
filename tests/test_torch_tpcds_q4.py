"""TPC-DS queries 65 to 79 through presto_tpu_torch on the CPU at
SF0.01, in "dynamic" and "auto", against the sqlite oracle and
presto_tpu (tests/torch_tpcds_common.py says what each test holds).

FROZEN is presto_tpu's counters and memo entry of each query at SF0.01,
from `JAX_PLATFORMS=cpu python -m tests.test_torch_tpcds_q4 0.01
Q[,Q...]` (keys "ds<Q>" there).
"""

import pytest

from presto_tpu_torch.tpcds_queries import QUERIES
from tests.torch_tpcds_common import (  # noqa: F401 (fixtures)
    MODES, check_frozen, check_live, check_oracle, live_params, main,
    one_thread, oracle, oracle_params, port, reference)
from tests.torch_threads import torch_one_thread  # noqa: F401

QIDS = [q for q in sorted(QUERIES) if 65 <= q <= 79]

#: presto_tpu's counters (SORT_STATS_KEYS order) in "dynamic" and in
#: "auto" ("compiled"), and its memo entry, each query at SF0.01
FROZEN = {
    65: {"dynamic": [7, 3, 0, 0, 0, 0, 0],
         "compiled": [4, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    66: {"dynamic": [7, 0, 0, 0, 0, 0, 0],
         "compiled": [7, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    67: {"dynamic": [17, 0, 0, 0, 0, 0, 0],
         "compiled": [13, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    68: {"dynamic": [1, 2, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    69: {"dynamic": [9, 0, 0, 0, 0, 0, 0],
         "compiled": [9, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    70: {"dynamic": [23, 0, 0, 0, 0, 0, 0],
         "compiled": [13, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    71: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    72: {"dynamic": [6, 0, 0, 0, 1, 1, 0],
         "compiled": [6, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    73: {"dynamic": [4, 2, 0, 0, 0, 0, 0],
         "compiled": [6, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    74: {"dynamic": [26, 0, 0, 0, 0, 0, 0],
         "compiled": [26, 0, 0, 0, 0, 0, 0], "memo": []},
    75: {"dynamic": [31, 3, 3, 2, 0, 0, 0],
         "compiled": [31, 3, 3, 2, 0, 0, 0], "memo": []},
    76: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    77: {"dynamic": [62, 0, 0, 0, 0, 0, 0],
         "compiled": [24, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    78: {"dynamic": [28, 0, 0, 0, 2, 2, 143361],
         "compiled": [56, 0, 0, 0, 4, 4, 143361], "memo": ["DYNAMIC"]},
    79: {"dynamic": [1, 2, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("qid", oracle_params(QIDS))
def test_query_matches_oracle(qid, mode, port, oracle):
    check_oracle(qid, mode, port, oracle)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("qid", QIDS)
def test_counters_and_memo_match_presto_tpu(qid, mode, port):
    check_frozen(qid, mode, port, FROZEN)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("qid", live_params(QIDS))
def test_query_matches_presto_tpu_live(qid, mode, port, reference):
    check_live(qid, mode, port, reference, FROZEN)


if __name__ == "__main__":
    main()
