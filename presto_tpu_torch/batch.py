"""Columnar batch representation on torch tensors.

Reference: presto_tpu/batch.py.  The data contracts are the reference's,
bit for bit:

- A `Batch` holds one data tensor per column, an optional per-column
  validity mask (None == no nulls) and a row-selection mask `sel`.
- Filters AND into `sel` instead of compacting; `row_count` is the
  popcount of `sel`.
- Strings are always dictionary-encoded: int32 codes on the device, the
  dictionary a SORTED host-side numpy array shared by reference, so code
  order == lexicographic order.
- BIGINT/DOUBLE are 64-bit.

Unlike the reference these are plain dataclasses (no pytree
registration): PyTorch runs eagerly, so nothing traces through them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import decimal
import hashlib
import itertools
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch.types import Type

_dict_ids = itertools.count()


class Dictionary:
    """Host-side string dictionary, identity-hashed and never changed
    after it is built, so what is computed from its values can be kept
    beside it (`derived`)."""

    __slots__ = ("values", "_id", "_derived")

    def __init__(self, values: np.ndarray):
        # values: 1-D object/str array; code i means values[i]; null is
        # carried by the validity mask
        self.values = np.asarray(values)
        self._id = next(_dict_ids)
        self._derived = {}

    def derived(self, key, compute):
        """compute() on first use for `key`, then the kept result: a
        host transform over every entry runs once per dictionary."""
        hit = self._derived.get(key)
        if hit is None:
            hit = self._derived[key] = compute()
        return hit

    def __len__(self) -> int:
        return len(self.values)

    def __hash__(self) -> int:
        return self._id

    def __eq__(self, other) -> bool:
        return self is other

    def __repr__(self) -> str:
        return f"Dictionary(#{self._id}, {len(self.values)} values)"


@dataclasses.dataclass
class Column:
    """One column: data tensor + optional validity mask (True == non-null)."""

    data: torch.Tensor
    valid: Optional[torch.Tensor]  # None => all valid
    type: Type
    dictionary: Optional[Dictionary] = None


@dataclasses.dataclass
class Batch:
    """A set of equal-capacity columns + a row-selection mask."""

    columns: Dict[str, Column]
    sel: torch.Tensor  # bool[capacity]; True == row is live

    @property
    def capacity(self) -> int:
        return self.sel.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sel.device

    def row_count(self) -> torch.Tensor:
        return self.sel.sum()

    def with_sel(self, sel: torch.Tensor) -> "Batch":
        return Batch(self.columns, sel)

    def select(self, names: Sequence[str]) -> "Batch":
        return Batch({n: self.columns[n] for n in names}, self.sel)


# ---------------------------------------------------------------------------
# Host-side ingestion
# ---------------------------------------------------------------------------

_uploads = threading.local()


def upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array as a tensor on `device`: a plain copy, except while
    a compiled query is built for a CUDA device
    (exec/compile_cache.build_graph).  Its eager pass copies from pinned
    memory without a host sync and logs the tensor under the array's
    content; its capture then takes the logged tensor, since a copy from
    pageable host memory synchronizes, which capture forbids.  The
    graph reads the logged tensors on every replay."""
    arr = np.ascontiguousarray(host)
    log = getattr(_uploads, "log", None)
    if log is None or device.type != "cuda":
        return torch.from_numpy(arr).to(device)
    key = (arr.dtype.str, arr.shape,
           hashlib.blake2b(arr.tobytes(), digest_size=16).digest())
    hit = log.tensors.get(key)
    if hit is None:
        if log.capturing:
            raise RuntimeError(
                f"an upload of {arr.dtype}{list(arr.shape)} during capture "
                "that the eager pass did not make")
        hit = log.tensors[key] = torch.from_numpy(arr).pin_memory().to(
            device, non_blocking=True)
    return hit


class UploadLog:
    """The device tensors one compiled query uploaded, by content, and
    the host draws of its volatile functions, in order."""

    def __init__(self):
        self.tensors: Dict[tuple, torch.Tensor] = {}
        self.capturing = False
        self.draws: list = []
        self.drawn = 0  # draws the capture has taken


def volatile_draw(make):
    """make() of a volatile function (its random values), logged while a
    compiled query is built for a CUDA device: the eager pass draws and
    logs, the capture takes the eager pass's draws in order, so that its
    uploads are the ones the eager pass made.  Elsewhere a fresh draw."""
    log = getattr(_uploads, "log", None)
    if log is None:
        return make()
    if log.capturing:
        value = log.draws[log.drawn]
        log.drawn += 1
        return value
    value = make()
    log.draws.append(value)
    return value


@contextlib.contextmanager
def logged_uploads(log: UploadLog):
    """Route this thread's `upload` calls through `log`."""
    prev = getattr(_uploads, "log", None)
    _uploads.log = log
    try:
        yield log
    finally:
        _uploads.log = prev



def encode_strings(values: np.ndarray) -> tuple[np.ndarray, Dictionary]:
    """Dictionary-encode a host string column -> (int32 codes, Dictionary)
    with a SORTED dictionary (the reference's np.unique branch)."""
    arr = np.asarray(values, dtype=object).astype(str)
    uniq, codes = np.unique(arr, return_inverse=True)
    return codes.astype(np.int32), Dictionary(uniq)


def column_from_numpy(data: np.ndarray, typ: Type, device: torch.device,
                      valid: Optional[np.ndarray] = None) -> Column:
    """Upload one host column to `device` (strings dictionary-encoded on
    the host first)."""
    if isinstance(data, np.ma.MaskedArray):
        mask = np.ma.getmaskarray(data)
        nv = ~mask
        valid = nv if valid is None else (np.asarray(valid) & nv)
        data = data.filled("" if typ.is_string else 0)
    dictionary = None
    if typ.is_string and data.dtype.kind in ("U", "S", "O"):
        data, dictionary = encode_strings(data)
    if typ.is_decimal and typ.is_long_decimal:
        from presto_tpu_torch.exec import dec128 as D128

        if not (data.ndim == 2 and data.dtype.kind == "i"):  # else limbs
            s = typ.decimal_scale
            with decimal.localcontext() as ctx:
                ctx.prec = 80  # the default 28 cannot hold 38 digits
                ints = [int(decimal.Decimal(str(v)).scaleb(s).quantize(
                    decimal.Decimal(1), rounding=decimal.ROUND_HALF_UP))
                    for v in data]
            data = D128.from_host_ints(ints)
        v = None if valid is None else upload(np.asarray(valid, dtype=bool),
                                              device)
        return Column(upload(np.ascontiguousarray(data, dtype=np.int64),
                             device), v, typ, None)
    if typ.is_decimal and data.dtype.kind == "f":
        # host floats (a decoded decimal column written again by CTAS or
        # INSERT) carry the scaled value: rescale, never truncate
        scaled = data * (10 ** typ.decimal_scale)
        from presto_tpu_torch.types import check_decimal_overflow

        check_decimal_overflow(scaled, valid, "ingested value")
        data = np.round(scaled)
    data = np.ascontiguousarray(data, dtype=typ.numpy_dtype())
    v = None if valid is None else upload(np.asarray(valid, dtype=bool),
                                          device)
    return Column(upload(data, device), v, typ, dictionary)


def batch_from_numpy(
    arrays: Dict[str, np.ndarray],
    types: Dict[str, Type],
    device: torch.device,
    valids: Optional[Dict[str, np.ndarray]] = None,
) -> Batch:
    cols = {}
    n = None
    for name, arr in arrays.items():
        v = (valids or {}).get(name)
        cols[name] = column_from_numpy(arr, types[name], device, v)
        n = len(arr) if n is None else n
        assert len(arr) == n, f"ragged column {name}"
    sel = torch.ones((n or 0,), dtype=torch.bool, device=device)
    return Batch(cols, sel)


_COMPACT_THRESHOLD = 262_144  # capacity above which selective fetch wins


def to_numpy(batch: Batch):
    """Materialize to host: (column arrays with strings decoded, live-row
    mask).  Large mostly-dead batches are compacted on the device first,
    so only the live rows cross to the host."""
    if batch.capacity > _COMPACT_THRESHOLD:
        sel_h = batch.sel.cpu().numpy()
        live = np.flatnonzero(sel_h)
        if len(live) < batch.capacity // 4:
            idx = torch.from_numpy(live).to(batch.device)
            pulled = {n: (c.data[idx].cpu().numpy(),
                          None if c.valid is None
                          else c.valid[idx].cpu().numpy())
                      for n, c in batch.columns.items()}
            return _decode_pulled(batch, pulled), np.ones(len(live), bool)
        return _decode_pulled(batch, _pull_all(batch)), sel_h
    return _decode_pulled(batch, _pull_all(batch)), batch.sel.cpu().numpy()


def _pull_all(batch: Batch) -> dict:
    return {n: (c.data.cpu().numpy(),
                None if c.valid is None else c.valid.cpu().numpy())
            for n, c in batch.columns.items()}


def decode_host_column(data, valid, typ, dictionary) -> np.ndarray:
    """Decode one pulled column on host: dictionary lookup, decimal
    rescale, NULL masking.  Long decimals come back as exact
    decimal.Decimal values, short ones as float64 divided by 10^scale,
    as the reference returns them."""
    data = np.asarray(data)
    if dictionary is not None:
        codes = np.clip(data, 0, len(dictionary) - 1)
        data = dictionary.values[codes]
    elif typ.is_decimal and typ.is_long_decimal and data.ndim == 2:
        from presto_tpu_torch.exec import dec128 as D128

        ints = D128.to_host_ints(data)  # signed (the hi limb is signed)
        s = typ.decimal_scale
        out = np.empty(len(ints), dtype=object)
        with decimal.localcontext() as ctx:
            ctx.prec = 80  # scaleb rounds to the context's precision
            for i, v in enumerate(ints):
                out[i] = decimal.Decimal(v).scaleb(-s)
        data = out
    elif typ.is_decimal:
        data = data.astype(np.float64) / (10 ** typ.decimal_scale)
    if valid is not None:
        data = np.ma.masked_array(data, mask=~np.asarray(valid))
    return data


def _decode_pulled(batch: Batch, datas) -> Dict[str, np.ndarray]:
    return {name: decode_host_column(datas[name][0], datas[name][1],
                                     col.type, col.dictionary)
            for name, col in batch.columns.items()}
