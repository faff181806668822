"""TPC-DS queries 1 to 25 through presto_tpu_torch on the CPU at
SF0.01, in "dynamic" and "auto", against the sqlite oracle and
presto_tpu (tests/torch_tpcds_common.py says what each test holds).

FROZEN is presto_tpu's counters and memo entry of each query at SF0.01,
from `JAX_PLATFORMS=cpu python -m tests.test_torch_tpcds_q1 0.01
Q[,Q...]` (keys "ds<Q>" there).
"""

import pytest

from presto_tpu_torch.tpcds_queries import QUERIES
from tests.torch_tpcds_common import (  # noqa: F401 (fixtures)
    MODES, check_frozen, check_live, check_oracle, live_params, main,
    one_thread, oracle, oracle_params, port, reference)
from tests.torch_threads import torch_one_thread  # noqa: F401

QIDS = [q for q in sorted(QUERIES) if 1 <= q <= 25]

#: presto_tpu's counters (SORT_STATS_KEYS order) in "dynamic" and in
#: "auto" ("compiled"), and its memo entry, each query at SF0.01
FROZEN = {
    1: {"dynamic": [9, 1, 0, 0, 0, 0, 0],
        "compiled": [8, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    2: {"dynamic": [17, 0, 0, 0, 0, 0, 0],
        "compiled": [17, 0, 0, 0, 0, 0, 0], "memo": []},
    3: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
        "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    4: {"dynamic": [52, 0, 0, 0, 0, 0, 0],
        "compiled": [52, 0, 0, 0, 0, 0, 0], "memo": []},
    5: {"dynamic": [2, 1, 0, 0, 0, 0, 0],
        "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    6: {"dynamic": [9, 1, 0, 0, 0, 0, 0],
        "compiled": [6, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    7: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
        "compiled": [1, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    8: {"dynamic": [13, 0, 0, 0, 0, 0, 0],
        "compiled": [7, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    9: {"dynamic": [0, 0, 0, 0, 0, 0, 0],
        "compiled": [0, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    10: {"dynamic": [12, 0, 0, 0, 0, 0, 0],
         "compiled": [12, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    11: {"dynamic": [26, 0, 0, 0, 0, 0, 0],
         "compiled": [26, 0, 0, 0, 0, 0, 0], "memo": []},
    12: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    13: {"dynamic": [0, 0, 0, 0, 0, 0, 0],
         "compiled": [0, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    14: {"dynamic": [284, 45, 15, 0, 0, 0, 0],
         "compiled": [282, 45, 15, 0, 0, 0, 0], "memo": ["executable"]},
    15: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [1, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    16: {"dynamic": [6, 2, 0, 0, 0, 0, 0],
         "compiled": [6, 2, 0, 0, 0, 0, 0], "memo": ["executable"]},
    17: {"dynamic": [9, 0, 0, 0, 0, 0, 0],
         "compiled": [9, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    18: {"dynamic": [14, 0, 0, 0, 0, 0, 0],
         "compiled": [10, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    19: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    20: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    21: {"dynamic": [3, 0, 0, 0, 1, 1, 226800],
         "compiled": [1, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    22: {"dynamic": [14, 0, 0, 0, 5, 5, 940500],
         "compiled": [12, 0, 0, 0, 5, 5, 0], "memo": ["executable"]},
    23: {"dynamic": [24, 0, 0, 0, 0, 0, 0],
         "compiled": [20, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    24: {"dynamic": [12, 1, 1, 1, 0, 0, 0],
         "compiled": [23, 3, 1, 1, 0, 0, 0], "memo": ["DYNAMIC"]},
    25: {"dynamic": [9, 0, 0, 0, 0, 0, 0],
         "compiled": [9, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
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
