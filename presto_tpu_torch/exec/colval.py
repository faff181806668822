"""Column values flowing through expression evaluation.

Reference: presto_tpu/exec/colval.py.  A ColVal is (data, valid, type,
dictionary):
- data: a torch tensor (codes for strings), or a python scalar for
  literals not yet broadcast;
- valid: None (all valid), a bool tensor, or a python bool;
- dictionary: the host-side sorted Dictionary of a string value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from presto_tpu_torch.batch import Dictionary
from presto_tpu_torch.types import Type


@dataclasses.dataclass
class ColVal:
    data: object  # torch.Tensor | python scalar
    valid: object  # None | bool tensor | python bool
    type: Type
    dictionary: Optional[Dictionary] = None


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
