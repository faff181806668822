"""Column values flowing through expression evaluation.

Reference: presto_tpu/exec/colval.py.  A ColVal is (data, valid, type,
dictionary):
- data: a torch tensor (codes for strings), or a python scalar for
  literals not yet broadcast;
- valid: None (all valid), a bool tensor, or a python bool;
- dictionary: the host-side Dictionary of a string value (sorted) or of
  an ARRAY, MAP or ROW value (Python tuples in the canonical order of
  functions/scalar.py's _tuple_dict_normalize).

A LambdaVal is a lambda argument of a higher-order function, evaluated
over the elements of a collection's dictionary entries.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import numpy as np

from presto_tpu_torch.batch import Dictionary
from presto_tpu_torch.types import Type


class StaticFallback(Exception):
    """Raised when a plan cannot run in the static executor (an
    unbounded join fanout, a static expansion too large, a host read of
    device values); "auto" mode then runs the dynamic executor."""


_STATIC_PASS = contextvars.ContextVar("presto_tpu_torch_static_pass",
                                      default=False)
_GUARDS = contextvars.ContextVar("presto_tpu_torch_guards", default=None)


@contextlib.contextmanager
def static_pass(guards: Optional[list] = None):
    """Mark the block as the static executor's pass (what compiled mode
    captures on a card); `guards` is the executor's guard list, which
    the expression-level checks (check_rows) append to."""
    token = _STATIC_PASS.set(True)
    gtoken = _GUARDS.set(guards)
    try:
        yield
    finally:
        _GUARDS.reset(gtoken)
        _STATIC_PASS.reset(token)


def in_static_pass() -> bool:
    return _STATIC_PASS.get()


def refuse_host_read(what: str) -> None:
    """The places where the reference's static program reads a traced
    array on the host (its jit trace raises there, and "auto" falls back
    to the dynamic executor) raise StaticFallback in the static pass, so
    that both packages pick the same execution mode: the port's static
    pass does not trace, and such a read would synchronize a capture."""
    if _STATIC_PASS.get():
        raise StaticFallback(f"{what} reads device values on the host")


def check_rows(bad, msg: str) -> None:
    """An expression-level check (a DECIMAL overflow, say) over a bool
    tensor of failing rows, or a python bool.  In the static pass the
    tensor's any() joins the executor's guards, read with the result, so
    a failing compiled query reruns in the dynamic executor; elsewhere it
    is read back once and raises ValueError(msg), as the reference's
    host checks do."""
    import torch

    if isinstance(bad, torch.Tensor):
        if _STATIC_PASS.get():
            guards = _GUARDS.get()
            if guards is not None:
                guards.append(bad.any())
            return
        bad = bool(bad.any())
    if bad:
        raise ValueError(msg)


@dataclasses.dataclass
class ColVal:
    data: object  # torch.Tensor | python scalar
    valid: object  # None | bool tensor | python bool
    type: Type
    dictionary: Optional[Dictionary] = None


@dataclasses.dataclass
class LambdaVal:
    """An unevaluated lambda argument to a higher-order function
    (reference: presto_tpu/exec/colval.py LambdaVal).  `apply` evaluates
    the body over a batch whose columns are the parameter bindings: the
    lambda runs vectorized over collection elements, once per distinct
    dictionary entry, never per row."""

    params: tuple
    param_types: tuple
    body: object  # ir.RowExpr
    ctx: object  # EvalContext
    type: Type  # FUNCTION(ret)

    @property
    def ret_type(self) -> Type:
        return self.type.params[0]

    def free_refs(self) -> set:
        return self.body.refs() - set(self.params)

    def apply(self, cols: dict) -> ColVal:
        import torch

        from presto_tpu_torch.batch import Batch
        from presto_tpu_torch.exec import compiler

        n, device = 1, torch.device("cpu")
        for v in cols.values():
            if isinstance(v.data, torch.Tensor) and v.data.ndim > 0:
                n, device = max(n, int(v.data.shape[0])), v.data.device
        batch = Batch({s: compiler.to_column(v, n, device)
                       for s, v in cols.items()},
                      torch.ones((n,), dtype=torch.bool, device=device))
        return compiler.eval_expr(self.body, batch, self.ctx)


def and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def all_valid(*vals):
    v = None
    for x in vals:
        v = and_valid(v, x.valid if isinstance(x, ColVal) else x)
    return v


def translate_codes(frm: Dictionary, to: Dictionary) -> np.ndarray:
    """Host LUT mapping codes in `frm` to codes in `to` (-1 = not
    present): joins and compares string columns whose dictionaries
    differ."""
    idx = np.searchsorted(to.values, frm.values)
    idx = np.clip(idx, 0, max(len(to) - 1, 0))
    ok = (len(to) > 0) & (to.values[idx] == frm.values)
    return np.where(ok, idx, -1).astype(np.int32)
