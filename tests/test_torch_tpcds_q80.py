"""TPC-DS queries 80 to 99 through presto_tpu_torch on the CPU at
SF0.01, in "dynamic" and "auto", against the sqlite oracle and
presto_tpu (tests/torch_tpcds_common.py says what each test holds).

FROZEN is presto_tpu's counters and memo entry of each query at SF0.01,
from `JAX_PLATFORMS=cpu python -m tests.test_torch_tpcds_q80 0.01
Q[,Q...]` (keys "ds<Q>" there).
"""

import pytest

from presto_tpu_torch.tpcds_queries import QUERIES
from tests.torch_tpcds_common import (  # noqa: F401 (fixtures)
    MODES, check_frozen, check_live, check_oracle, live_params, main,
    one_thread, oracle, oracle_params, port, reference)
from tests.torch_threads import torch_one_thread  # noqa: F401

QIDS = [q for q in sorted(QUERIES) if 80 <= q <= 99]

#: presto_tpu's counters (SORT_STATS_KEYS order) in "dynamic" and in
#: "auto" ("compiled"), and its memo entry, each query at SF0.01
FROZEN = {
    80: {"dynamic": [47, 6, 6, 0, 0, 0, 0],
         "compiled": [39, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    81: {"dynamic": [10, 0, 0, 0, 0, 0, 0],
         "compiled": [8, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    82: {"dynamic": [6, 0, 0, 0, 1, 1, 226800],
         "compiled": [6, 0, 0, 0, 1, 1, 226800], "memo": []},
    83: {"dynamic": [31, 0, 0, 0, 3, 3, 219084],
         "compiled": [25, 0, 0, 0, 3, 3, 0], "memo": ["executable"]},
    84: {"dynamic": [4, 0, 0, 0, 0, 0, 0],
         "compiled": [4, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    85: {"dynamic": [9, 0, 0, 0, 0, 0, 0],
         "compiled": [7, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    86: {"dynamic": [8, 0, 0, 0, 0, 0, 0],
         "compiled": [4, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    87: {"dynamic": [12, 2, 0, 0, 0, 0, 0],
         "compiled": [12, 2, 0, 0, 0, 0, 0], "memo": ["executable"]},
    88: {"dynamic": [0, 0, 0, 0, 0, 0, 0],
         "compiled": [0, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    89: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    90: {"dynamic": [0, 0, 0, 0, 0, 0, 0],
         "compiled": [0, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    91: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [1, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    92: {"dynamic": [4, 1, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    93: {"dynamic": [6, 0, 0, 0, 0, 0, 0],
         "compiled": [4, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    94: {"dynamic": [6, 2, 0, 0, 0, 0, 0],
         "compiled": [6, 2, 0, 0, 0, 0, 0], "memo": ["executable"]},
    95: {"dynamic": [15, 3, 0, 0, 0, 0, 0],
         "compiled": [15, 3, 0, 0, 0, 0, 0], "memo": ["executable"]},
    96: {"dynamic": [0, 0, 0, 0, 0, 0, 0],
         "compiled": [0, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    97: {"dynamic": [10, 0, 0, 0, 0, 0, 0],
         "compiled": [10, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    98: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    99: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [1, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
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
