"""presto_tpu's values for the collection tests of presto_tpu_torch,
frozen in tests/torch_collections_frozen.json.

presto_tpu's first dynamic run of a query compiles a JAX operation per
new shape, seconds a query on the CPU, so the tier-1 tests hold the
port to presto_tpu's frozen values: each case's column names, rows (in
order; floats within rtol 1e-9, everything else and its Python type
exactly, collection values as tuples), the seven counters of
QueryStats, the execution mode and the compiled memo's entries, in
`execution_mode` "dynamic" and "auto" (rows past ROWS_INLINE_MAX bytes
as their count and digest).  The slow tests run presto_tpu
live and hold it to the same frozen values, so the frozen table is
presto_tpu's.

`JAX_PLATFORMS=cpu python -m tests.torch_collections_common` runs every
case through presto_tpu and writes the file again (about two minutes on
the CPU).
"""

import hashlib
import importlib
import json
import os

from tests.test_torch_compiled import _memo_state
from tests.test_torch_tpch import counters
from tests.torch_functions_common import assert_rows_equal

MODES = ("dynamic", "auto")
FROZEN_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "torch_collections_frozen.json")

#: the test modules whose cases are frozen here, each with a
#: `frozen_cases()` -> {case: (reference catalog, sql)}
MODULES = ("tests.test_torch_collections", "tests.test_torch_unnest",
           "tests.test_torch_collection_aggs",
           "tests.test_torch_collections_corpus")

_frozen = None


def tuplify(v):
    """A JSON value with every list made a tuple (collection values)."""
    if isinstance(v, list):
        return tuple(tuplify(x) for x in v)
    return v


def frozen(module: str, case: str, mode: str) -> dict:
    global _frozen
    if _frozen is None:
        with open(FROZEN_FILE, encoding="utf-8") as f:
            _frozen = json.load(f)
    return _frozen[module.rsplit(".", 1)[-1]][case][mode]


def values_of(session, sql) -> dict:
    """What the tests hold of one run: column names, rows, counters,
    execution mode and memo entries, or the error's class and message."""
    try:
        result = session.sql(sql)
    except Exception as e:  # noqa: BLE001 -- the error is the value
        return {"error": type(e).__name__, "message": str(e)}
    return {"columns": [c for c, _ in result.columns],
            "rows": [list(r) for r in result.rows],
            "counters": list(counters(result.stats).values()),
            "mode": result.stats.execution_mode,
            "memo": _memo_state(session, sql)}


#: rows past this many bytes of JSON are frozen as their count and the
#: SHA-256 of their JSON, and then compare exactly
ROWS_INLINE_MAX = 16384


def rows_digest(rows: list) -> str:
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def frozen_form(values: dict) -> dict:
    """values_of's result as the frozen file keeps it."""
    rows = values.get("rows")
    if rows is not None and len(json.dumps(rows)) > ROWS_INLINE_MAX:
        values = {k: v for k, v in values.items() if k != "rows"}
        values.update({"n_rows": len(rows), "rows_sha256": rows_digest(rows)})
    return values


def assert_frozen(got: dict, want: dict, exact_columns=()):
    if "error" in want or "error" in got:
        assert got.get("error") == want.get("error"), got
        assert got["message"] == want["message"]
        return
    assert got["columns"] == want["columns"]
    if "rows_sha256" in want:
        assert len(got["rows"]) == want["n_rows"]
        assert rows_digest(got["rows"]) == want["rows_sha256"]
    else:
        assert_rows_equal(
            [tuple(tuplify(v) for v in r) for r in got["rows"]],
            [tuple(tuplify(v) for v in r) for r in want["rows"]],
            exact_columns)
    assert got["counters"] == want["counters"]
    assert got["mode"] == want["mode"]
    assert got["memo"] == want["memo"]


def check_module(module: str, port_catalog, cases, mode: str):
    """Every case of a module in one mode: the port's values (on the
    CPU) against the frozen ones."""
    import presto_tpu_torch

    session = presto_tpu_torch.connect(port_catalog, device="cpu",
                                       execution_mode=mode)
    for case, sql in cases.items():
        assert_frozen(values_of(session, sql), frozen(module, case, mode))


def check_reference(module: str):
    """presto_tpu live against the frozen values of a module's cases."""
    import presto_tpu

    for case, (catalog, sql) in importlib.import_module(
            module).frozen_cases().items():
        for mode in MODES:
            assert_frozen(values_of(presto_tpu.connect(
                catalog, execution_mode=mode), sql),
                frozen(module, case, mode))


def freeze() -> dict:
    """presto_tpu's values of every frozen case, in both modes."""
    import presto_tpu

    out = {}
    for name in MODULES:
        cases = importlib.import_module(name).frozen_cases()
        got = out[name.rsplit(".", 1)[-1]] = {}
        for case, (catalog, sql) in cases.items():
            got[case] = {mode: frozen_form(values_of(presto_tpu.connect(
                catalog, execution_mode=mode), sql)) for mode in MODES}
    return out


def write(data: dict, path: str = FROZEN_FILE) -> None:
    """The frozen table as JSON, one line a case."""
    lines = []
    for m in sorted(data):
        cases = [f"  {json.dumps(c)}: {json.dumps(data[m][c], sort_keys=True)}"
                 for c in sorted(data[m])]
        lines.append(f" {json.dumps(m)}: {{\n" + ",\n".join(cases) + "\n }")
    with open(path, "w", encoding="utf-8") as f:
        f.write("{\n" + ",\n".join(lines) + "\n}\n")


if __name__ == "__main__":
    write(freeze())
