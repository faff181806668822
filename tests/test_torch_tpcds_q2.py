"""TPC-DS queries 26 to 50 through presto_tpu_torch on the CPU at
SF0.01, in "dynamic" and "auto", against the sqlite oracle and
presto_tpu (tests/torch_tpcds_common.py says what each test holds).

FROZEN is presto_tpu's counters and memo entry of each query at SF0.01,
from `JAX_PLATFORMS=cpu python -m tests.test_torch_tpcds_q2 0.01
Q[,Q...]` (keys "ds<Q>" there).
"""

import pytest

from presto_tpu_torch.tpcds_queries import QUERIES
from tests.torch_tpcds_common import (  # noqa: F401 (fixtures)
    MODES, check_frozen, check_live, check_oracle, live_params, main,
    one_thread, oracle, oracle_params, port, reference)
from tests.torch_threads import torch_one_thread  # noqa: F401

QIDS = [q for q in sorted(QUERIES) if 26 <= q <= 50]

#: presto_tpu's counters (SORT_STATS_KEYS order) in "dynamic" and in
#: "auto" ("compiled"), and its memo entry, each query at SF0.01
FROZEN = {
    26: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [1, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    27: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [1, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    28: {"dynamic": [4, 0, 0, 0, 0, 0, 0],
         "compiled": [4, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    29: {"dynamic": [6, 0, 0, 0, 0, 0, 0],
         "compiled": [6, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    30: {"dynamic": [10, 0, 0, 0, 0, 0, 0],
         "compiled": [8, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    31: {"dynamic": [28, 0, 0, 0, 0, 0, 0],
         "compiled": [28, 0, 0, 0, 0, 0, 0], "memo": []},
    32: {"dynamic": [4, 1, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    33: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    34: {"dynamic": [4, 2, 0, 0, 0, 0, 0],
         "compiled": [6, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    35: {"dynamic": [12, 0, 0, 0, 0, 0, 0],
         "compiled": [12, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    36: {"dynamic": [8, 0, 0, 0, 0, 0, 0],
         "compiled": [4, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    37: {"dynamic": [6, 0, 0, 0, 1, 1, 226800],
         "compiled": [6, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    38: {"dynamic": [12, 2, 0, 0, 0, 0, 0],
         "compiled": [12, 2, 0, 0, 0, 0, 0], "memo": ["executable"]},
    39: {"dynamic": [8, 0, 0, 0, 2, 2, 376200],
         "compiled": [8, 0, 0, 0, 2, 2, 376200], "memo": []},
    40: {"dynamic": [6, 0, 0, 0, 0, 0, 0],
         "compiled": [4, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    41: {"dynamic": [4, 1, 0, 0, 0, 0, 0],
         "compiled": [3, 1, 0, 0, 0, 0, 0], "memo": ["executable"]},
    42: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    43: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [1, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    44: {"dynamic": [14, 0, 0, 0, 0, 0, 0],
         "compiled": [14, 0, 0, 0, 0, 0, 0], "memo": []},
    45: {"dynamic": [7, 1, 0, 0, 0, 0, 0],
         "compiled": [6, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    46: {"dynamic": [1, 2, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    47: {"dynamic": [13, 0, 0, 0, 0, 0, 0],
         "compiled": [13, 0, 0, 0, 0, 0, 0], "memo": []},
    48: {"dynamic": [0, 0, 0, 0, 0, 0, 0],
         "compiled": [0, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    49: {"dynamic": [20, 0, 0, 0, 0, 0, 0],
         "compiled": [14, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    50: {"dynamic": [6, 0, 0, 0, 0, 0, 0],
         "compiled": [6, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
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
