"""No tensor of presto_tpu_torch is divided by a host scalar.

On a card, torch divides a CUDA tensor by a Python number (or a number
by a tensor) through the reciprocal, one ulp off at times, where XLA
divides; the port divides two tensors on one device instead
(functions/decimals.py::true_div).  This test runs the function corpus
(F1 to F11: the scalar functions, and the aggregates whose estimates
divide), the extended corpus (E1 to E9), the geospatial and ML corpus
(geo_ml_queries.py's G at its SMALL size and M: the ray cast's edge
intersections, segment distances, DECIMAL features) and TPC-H Q1 and Q6
under float32_compute on
the CPU at SF0.01, in "dynamic" and in "auto" (the static pass), with
Tensor.__truediv__, __rtruediv__, __itruediv__, Tensor.div, torch.div
and torch.true_divide wrapped to raise on a true division (no
rounding_mode) of a floating tensor by a Python int or float or of such
a number by a floating tensor, and on one between a 0-d tensor and
another tensor anywhere but in true_div: torch takes a 0-d CPU tensor
beside a CUDA tensor for a host scalar as well, and true_div is the one
place that puts the 0-d side on the other's device (on the CPU every
tensor is a CPU tensor, so the guard cannot tell the devices apart and
holds every such division to true_div).
"""

import contextlib
import sys

import pytest
import torch

import presto_tpu_torch
from presto_tpu_torch import function_ext_queries as FQ
from presto_tpu_torch import function_queries as FN
from presto_tpu_torch import geo_ml_queries as GQ
from presto_tpu_torch.catalog import tpch_catalog
from presto_tpu_torch.functions import decimals as DEC
from presto_tpu_torch.tpch_queries import QUERIES as TPCH
from tests import torch_geo_ml_common as C
from tests.torch_threads import torch_one_thread  # noqa: F401


class HostScalarDivision(AssertionError):
    pass


def _host_number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _floating(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _scalar_tensor_side(a, b) -> bool:
    """A 0-d tensor beside another tensor, one of them floating."""
    return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and (a.ndim == 0 or b.ndim == 0)
            and (a.is_floating_point() or b.is_floating_point()))


@contextlib.contextmanager
def no_host_scalar_division():
    saved = {n: getattr(torch.Tensor, n) for n in (
        "__truediv__", "__rtruediv__", "__itruediv__", "div")}
    saved_div, saved_true = torch.div, torch.true_divide

    def check(a, b, rounding_mode=None, in_true_div=False):
        if rounding_mode is None and (
                (_floating(a) and _host_number(b))
                or (_host_number(a) and _floating(b))
                or (not in_true_div and _scalar_tensor_side(a, b))):
            raise HostScalarDivision(f"{type(a).__name__} / "
                                     f"{type(b).__name__}")

    def wrap(fn, swap=False):
        def run(a, b, *args, **kwargs):
            inside = sys._getframe(1).f_code is DEC.true_div.__code__
            check(b, a, None, inside) if swap else check(
                a, b, kwargs.get("rounding_mode"), inside)
            return fn(a, b, *args, **kwargs)
        return run

    try:
        torch.Tensor.__truediv__ = wrap(saved["__truediv__"])
        torch.Tensor.__rtruediv__ = wrap(saved["__rtruediv__"], swap=True)
        torch.Tensor.__itruediv__ = wrap(saved["__itruediv__"])
        torch.Tensor.div = wrap(saved["div"])
        torch.div = wrap(saved_div)
        torch.true_divide = wrap(saved_true)
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)
        torch.div, torch.true_divide = saved_div, saved_true


def test_the_guard_catches_a_host_scalar_division():
    x = torch.tensor([5.0], dtype=torch.float64)
    for divide in (lambda: x / 3, lambda: 3.0 / x, lambda: torch.div(x, 3),
                   lambda: x.div(3.0), lambda: torch.true_divide(x, 3)):
        with pytest.raises(HostScalarDivision), no_host_scalar_division():
            divide()
    three = torch.full((), 3.0, dtype=torch.float64)
    for divide in (lambda: x / three, lambda: torch.div(three, x),
                   lambda: x / torch.tensor(3)):
        with pytest.raises(HostScalarDivision), no_host_scalar_division():
            divide()
    with no_host_scalar_division():
        assert DEC.true_div(x, three).item() == 5.0 / 3
        assert DEC.true_div(3, x).item() == 3 / 5.0
        torch.div(x, torch.full((1,), 3.0, dtype=torch.float64))
        torch.div(torch.tensor([7]), 2, rounding_mode="floor")
        torch.tensor([7]) / 2  # an integer tensor: not floating
    assert (x / 3).item() == 5.0 / 3  # restored


def test_true_div_moves_a_0d_cpu_tensor_to_the_others_device(monkeypatch):
    """A 0-d CPU tensor beside a tensor on another device (here "meta")
    is divided on that device, as a Python number is."""
    x = torch.ones(4, dtype=torch.float64, device="meta")
    seen = []

    def spy(a, b):  # the operands alone: meta tensors hold no values
        seen.append((a.device.type, a.dtype, b.device.type, b.dtype))
        return a

    monkeypatch.setattr(torch, "div", spy)
    for a, b in ((x, torch.tensor(3.0)), (torch.tensor(3), x), (x, 3),
                 (2.5, x)):
        DEC.true_div(a, b)
    assert seen == [("meta", torch.float64) * 2] * 4


@pytest.fixture(scope="module")
def catalog():
    return tpch_catalog(0.01)


_QUERIES = {**FN.QUERIES, **FQ.QUERIES, **FQ.VOLATILE}


@pytest.mark.parametrize("mode", ("dynamic", "auto"))
@pytest.mark.parametrize("qid", sorted(_QUERIES))
def test_corpus_divides_no_tensor_by_a_host_scalar(qid, mode, catalog):
    s = presto_tpu_torch.connect(catalog, device="cpu", execution_mode=mode)
    with no_host_scalar_division():
        s.sql(_QUERIES[qid])


@pytest.mark.parametrize("mode", ("dynamic", "auto"))
@pytest.mark.parametrize("qid", [1, 6])
def test_float32_compute_divides_no_tensor_by_a_host_scalar(qid, mode,
                                                            catalog):
    s = presto_tpu_torch.connect(catalog, device="cpu", execution_mode=mode,
                                 float32_compute=True)
    with no_host_scalar_division():
        s.sql(TPCH[qid])


@pytest.mark.parametrize("mode", ("dynamic", "auto"))
def test_geo_corpus_divides_no_tensor_by_a_host_scalar(mode):
    tables = GQ.geo_tables(GQ.SMALL)
    cat = C.register("port", C.empty_catalog("port"), tables)
    s = presto_tpu_torch.connect(cat, device="cpu", execution_mode=mode)
    with no_host_scalar_division():
        for sid, sql in GQ.geo_queries(tables, GQ.SMALL).items():
            if sid != "G4":  # raises presto_tpu's ValueError
                s.sql(sql)


@pytest.mark.parametrize("mode", ("dynamic", "auto"))
def test_ml_corpus_divides_no_tensor_by_a_host_scalar(mode):
    cat = tpch_catalog(0.01)
    s = presto_tpu_torch.connect(cat, device="cpu", execution_mode=mode)
    with no_host_scalar_division():
        blobs = s.sql(GQ.M1).rows[0]
        C.register("port", cat, {"models": GQ.models_table(blobs)})
        for sid in ("M2", "M3"):
            s.sql(GQ.ML_QUERIES[sid])
        # a DECIMAL feature divides by its scale through true_div
        s.sql("SELECT sum(regress(features(CAST(l_discount AS "
              "DECIMAL(4, 2)), l_tax, l_linenumber), m.rm)) FROM lineitem "
              "CROSS JOIN models m")
