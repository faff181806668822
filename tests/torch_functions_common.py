"""Row comparison for the function and aggregate tests of
presto_tpu_torch against presto_tpu: NaN equals NaN, floats agree within
a relative tolerance (or exactly where asked), every other value and its
Python type exactly."""

import math

import presto_tpu_torch
from presto_tpu_torch.exec import compile_cache as CC
from tests.test_torch_compiled import no_host_reads
from tests.test_torch_setops_joins import no_scalar_stores

RTOL = 1e-9


def values_equal(a, b, exact=False, rtol=RTOL) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if exact or math.isinf(a) or math.isinf(b):
            return a == b
        return math.isclose(a, b, rel_tol=rtol, abs_tol=0.0)
    return type(a) is type(b) and a == b


def assert_rows_equal(actual, expected, exact_columns=(), rtol=RTOL):
    """Rows in order, value by value."""
    assert len(actual) == len(expected), (len(actual), len(expected))
    for k, (ra, re_) in enumerate(zip(actual, expected)):
        assert len(ra) == len(re_), (k, ra, re_)
        for i, (va, ve) in enumerate(zip(ra, re_)):
            assert values_equal(va, ve, i in exact_columns, rtol), \
                (k, i, ra, re_)


def static_pass_builds(sql, catalog) -> tuple:
    """(the result, the programs built) of `sql` in a fresh compiled-mode
    session whose static pass (what compiled mode captures on a card)
    runs with every host read and every Python scalar store made to
    raise."""
    real = CC.build_graph
    built = []

    def build(fn, example, device=None):
        def program(*args):
            with no_host_reads(), no_scalar_stores():
                out = fn(*args)
            built.append(out)
            return out

        return real(program, example, device)

    CC.build_graph = build
    try:
        result = presto_tpu_torch.connect(catalog, device="cpu").sql(sql)
    finally:
        CC.build_graph = real
    return result, built
