"""A memory table with a short and a long DECIMAL column through
presto_tpu_torch and presto_tpu on the CPU, in execution_mode "dynamic"
and "auto": window frames, grouping, joins and sorts on its columns as
keys, and the long column refused as a key as presto_tpu refuses it (the
same rows, or the same error, in both packages).  The long values
themselves: tests/test_torch_decimal_values.py."""

from decimal import Decimal

import numpy as np
import pytest

from tests.test_torch_decimal import MODES, _same, _sessions
from tests.torch_threads import torch_one_thread  # noqa: F401


def _table_builder(build_cat, T):
    rng = np.random.default_rng(5)
    n = 300
    build_cat.register_memory(
        "w", {"k": T.BIGINT, "g": T.VARCHAR, "q": T.decimal(12, 2),
              "big": T.decimal(30, 2)},
        {"k": np.arange(n, dtype=np.int64),
         "g": np.asarray([("a", "b", "c")[i % 3] for i in range(n)],
                         dtype=object),
         "q": np.round(rng.integers(-500, 5000, n) / 100.0, 2),
         "big": np.asarray([str(Decimal(int(v)) / 100) for v in
                            rng.integers(-10 ** 15, 10 ** 15, n)],
                           dtype=object)})


KEY_CASES = [
    # window frames over a short decimal (the exact int64 prefix sums)
    "SELECT k, sum(q) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN 2 "
    "PRECEDING AND CURRENT ROW) FROM w ORDER BY k LIMIT 20",
    # grouping, joining and ordering on short-decimal keys
    "SELECT q, count(*) FROM w GROUP BY q ORDER BY q LIMIT 5",
    "SELECT count(*) FROM w a JOIN w b ON a.q = b.q",
    "SELECT k, q FROM w ORDER BY q DESC, k LIMIT 5",
    # long-decimal keys: presto_tpu refuses them (its pack broadcasts the
    # row flags against the limbs), and so does the port, alike
    "SELECT big, count(*) FROM w GROUP BY big",
    "SELECT count(*) FROM w a JOIN w b ON a.big = b.big",
    "SELECT DISTINCT big FROM w",
    "SELECT k, sum(big) OVER (ORDER BY k ROWS BETWEEN 1 PRECEDING AND "
    "CURRENT ROW) FROM w",
    "SELECT k, row_number() OVER (ORDER BY big) FROM w",
    "SELECT k, count(big) OVER (PARTITION BY g) FROM w ORDER BY k LIMIT 3",
]


@pytest.mark.parametrize("mode", MODES)
def test_key_cases(mode):
    ref, port = _sessions(_table_builder, mode)
    for sql in KEY_CASES:
        _same(ref, port, sql)

