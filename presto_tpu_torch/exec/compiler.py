"""Expression evaluation: typed IR -> ColVal over a Batch.

Reference: presto_tpu/exec/compiler.py (`eval_expr`, `eval_predicate`,
`to_column`).  Evaluation is eager: each IR call runs its torch ops on
the batch's device as it is reached.
"""

from __future__ import annotations

from typing import Dict

import torch

from presto_tpu_torch import session_ctx
from presto_tpu_torch.batch import Batch, Column, Dictionary
from presto_tpu_torch.exec.colval import ColVal, LambdaVal
from presto_tpu_torch.functions import decimals
from presto_tpu_torch.functions import scalar as scalar_fns
from presto_tpu_torch.plan import ir


class EvalContext:
    """Carries scalar-subquery results (python scalars) into evaluation."""

    def __init__(self, scalar_results: Dict[int, tuple] | None = None):
        self.scalar_results = scalar_results or {}  # plan_id -> (value, valid)


def eval_expr(expr: ir.RowExpr, batch: Batch, ctx: EvalContext) -> ColVal:
    # the volatile functions (random()) draw a value per row, and their
    # emitters see only the arguments
    session_ctx.set_batch_capacity(batch.capacity)
    if isinstance(expr, ir.Ref):
        c = batch.columns[expr.name]
        return ColVal(c.data, c.valid, c.type, c.dictionary)
    if isinstance(expr, ir.Lit):
        if expr.value is None:
            return ColVal(False, False, expr.type)
        return ColVal(expr.value, None, expr.type)
    if isinstance(expr, ir.ScalarSub):
        v, valid = ctx.scalar_results[expr.plan_id]
        if expr.type.is_decimal and valid:
            # _single_value decodes a decimal to its SCALED host value (a
            # Decimal when long, a float when short); decimal ColVals
            # carry the unscaled integer
            v = decimals.host_unscaled(v, expr.type.decimal_scale)
        return ColVal(v, None if valid else False, expr.type)
    if isinstance(expr, ir.CastExpr):
        return scalar_fns.emit_cast(eval_expr(expr.arg, batch, ctx),
                                    expr.type, expr.safe)
    if isinstance(expr, ir.Call):
        args = [LambdaVal(a.params, a.param_types, a.body, ctx, a.type)
                if isinstance(a, ir.LambdaExpr)
                else eval_expr(a, batch, ctx) for a in expr.args]
        return scalar_fns.lookup(expr.fn).emit(args)
    raise NotImplementedError(
        f"cannot evaluate {type(expr).__name__} in presto_tpu_torch")


def eval_predicate(expr: ir.RowExpr, batch: Batch,
                   ctx: EvalContext) -> torch.Tensor:
    """Boolean expression -> row mask (SQL: NULL predicate == not selected)."""
    v = eval_expr(expr, batch, ctx)
    data = v.data
    if not isinstance(data, torch.Tensor) or data.ndim == 0:
        data = torch.full((batch.capacity,), bool(data), dtype=torch.bool,
                          device=batch.device)
    mask = data
    if v.valid is not None:
        mask = mask & _expand_valid(v.valid, batch.capacity, batch.device)
    return mask


def to_column(v: ColVal, capacity: int, device: torch.device) -> Column:
    """Materialize a ColVal as a full-capacity Column on `device`."""
    data = v.data
    if not isinstance(data, torch.Tensor) or data.ndim == 0:
        if decimals.is_long(v.type):
            limbs = decimals.lift128(v, device)
            return Column(limbs.expand(capacity, 2).contiguous(),
                          _expand_valid(v.valid, capacity, device), v.type)
        if isinstance(data, (str, bytes)):
            # string literal column: single-entry dictionary
            import numpy as np

            vals = np.empty(1, dtype=object)
            vals[0] = data
            codes = torch.zeros((capacity,), dtype=torch.int32,
                                device=device)
            return Column(codes, _expand_valid(v.valid, capacity, device),
                          v.type, Dictionary(vals))
        dt = scalar_fns.torch_dtype(v.type)
        if isinstance(data, torch.Tensor):  # a constant computed on device
            data = data.to(device=device, dtype=dt).reshape(1) \
                .repeat(capacity)
        else:
            data = torch.full((capacity,), data, dtype=dt, device=device)
    return Column(data, _expand_valid(v.valid, capacity, device), v.type,
                  v.dictionary)


def python_value(v: ColVal):
    """The python value of a scalar ColVal (None when NULL)."""
    valid = v.valid
    if isinstance(valid, torch.Tensor):
        valid = bool(valid.reshape(-1)[0])
    if valid is False:
        return None
    data = v.data
    if isinstance(data, torch.Tensor):
        data = data.reshape(-1)[0].item()
    if v.dictionary is not None:
        return v.dictionary.values[int(data)]
    return data


def _expand_valid(valid, capacity: int, device: torch.device):
    if valid is None:
        return None
    if not isinstance(valid, torch.Tensor):
        return torch.full((capacity,), bool(valid), dtype=torch.bool,
                          device=device)
    if valid.ndim == 0:
        return valid.expand(capacity)
    return valid
