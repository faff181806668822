"""TPC-DS queries 51 to 63 through presto_tpu_torch on the CPU at
SF0.01, in "dynamic" and "auto", against the sqlite oracle and
presto_tpu (tests/torch_tpcds_common.py says what each test holds).

FROZEN is presto_tpu's counters and memo entry of each query at SF0.01,
from `JAX_PLATFORMS=cpu python -m tests.test_torch_tpcds_q3 0.01
Q[,Q...]` (keys "ds<Q>" there).
"""

import pytest

from presto_tpu_torch.tpcds_queries import QUERIES
from tests.torch_tpcds_common import (  # noqa: F401 (fixtures)
    MODES, check_frozen, check_live, check_oracle, live_params, main,
    one_thread, oracle, oracle_params, port, reference)
from tests.torch_threads import torch_one_thread  # noqa: F401

QIDS = [q for q in sorted(QUERIES) if 51 <= q <= 63]

#: presto_tpu's counters (SORT_STATS_KEYS order) in "dynamic" and in
#: "auto" ("compiled"), and its memo entry, each query at SF0.01
FROZEN = {
    51: {"dynamic": [11, 0, 0, 0, 0, 0, 0],
         "compiled": [11, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    52: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    53: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    54: {"dynamic": [20, 0, 0, 0, 0, 0, 0],
         "compiled": [38, 0, 0, 0, 0, 0, 0], "memo": ["DYNAMIC"]},
    55: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    56: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [1, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    57: {"dynamic": [13, 0, 0, 0, 0, 0, 0],
         "compiled": [13, 0, 0, 0, 0, 0, 0], "memo": []},
    58: {"dynamic": [13, 0, 0, 0, 0, 0, 0],
         "compiled": [7, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    59: {"dynamic": [18, 1, 1, 0, 0, 0, 0],
         "compiled": [18, 1, 1, 0, 0, 0, 0], "memo": []},
    60: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [1, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    61: {"dynamic": [1, 0, 0, 0, 0, 0, 0],
         "compiled": [1, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    62: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
         "compiled": [1, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    63: {"dynamic": [3, 0, 0, 0, 0, 0, 0],
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
