"""Gather-aware routing and the block-gather kernel for large row gathers.

Reference: presto_tpu/exec/gather.py.  `kernels.take_rows` packs the
columns of a gather into one (n, w) matrix of 32-bit words and routes
the gather here:

- **flat**: one gather in request order (`torch.index_select`);
- **staged**: sort the indices once (co-sorting the request positions),
  gather in ASCENDING index order through `block_gather`, and carry the
  rows home with one scatter keyed on the positions (`kernels.unpermute`).
  Presorted callers skip both the sort and the way home.

`block_gather` replaces the reference's Pallas kernel
(`_blocked_gather_call`).  The TPU kernel pulled one aligned window of a
static size per grid step, so the reference guarded the whole launch
with an all-or-nothing coverage check: one block of indices whose span
straddled its window sent every block to the plain gather.  On the GPU
each thread block decides for itself, on the device, whether its rows
fit its shared memory (csrc/block_gather.cu), so there is no coverage
check and no host sync.

Words are held as int32 bit patterns: torch's CPU kernels lack shifts
on unsigned types, and the gather only moves bytes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# routing constants (the reference's names, so tests can shrink them)
# ---------------------------------------------------------------------------

# below this index count the flat packed gather wins: the two extra
# sorts of the staged route only amortize over many indices
_STAGED_MIN_INDICES = 1 << 20

# staged request-order gathers pay the way home carrying all row words;
# two words (one i64 column) already clear the bar
_STAGED_MIN_WORDS = 2

# sorted indices per thread block (one output block)
_IB = 1024

# the reference's window sizing (the largest window, and headroom over
# the expected span of _IB sorted indices, _IB * n / m rows); here only
# to compare with the reference's coverage check (`window_rows`)
_MAX_WINDOW = 8192
_WINDOW_SLACK = 2

# shared memory one thread block of the kernel may stage rows in.  The
# launch reserves it for every block, so it sets occupancy: at 24 KB
# eight blocks of 256 threads fill an H100 SM (228 KB).  chip_smoke.py
# times 12 to 192 KB at the main path's gathers; 24 KB was fastest in
# sum on an H100 80GB HBM3 at 700 W.
_SMEM_MAX_BYTES = 24 * 1024


def _staging_enabled(device: torch.device) -> bool:
    """Stage on the accelerator only, as the reference does; the CPU
    keeps the flat gather (tests patch this to stage at test sizes)."""
    return device.type == "cuda"


def gather_route(n: int, m: int, words: int, presorted: bool = False,
                 device: torch.device = torch.device("cpu")) -> str:
    """Routing for an m-index gather from an n-row, `words`-wide word
    matrix on `device`: 'flat' (packed gather in request order) or
    'staged' (ascending-order staging through block_gather).  Decided
    from shapes alone, never from the data.

    presorted indices skip the sort AND the way home, so staging wins at
    any width; request-order gathers must clear _STAGED_MIN_WORDS."""
    if not _staging_enabled(device):
        return "flat"
    if m < _STAGED_MIN_INDICES or n <= 0 or words <= 0:
        return "flat"
    if not presorted and words < _STAGED_MIN_WORDS:
        return "flat"
    return "staged"


def window_rows(n: int, m: int) -> Optional[int]:
    """The reference's window for a blocked gather: the power of two (at
    least _IB) covering _WINDOW_SLACK times the expected span of one
    block of sorted indices, or None when the indices are too sparse for
    any window up to _MAX_WINDOW.  The kernel does not use it; it tells
    which blocks the reference's all-or-nothing check would cover."""
    if n <= 0 or m <= 0:
        return None
    span = _WINDOW_SLACK * _IB * n / m
    W = 1 << int(np.ceil(np.log2(max(span, _IB))))
    if W > _MAX_WINDOW:
        return None
    return int(W)


def smem_rows(w: int) -> int:
    """Rows of a w-word matrix one thread block may stage in shared
    memory.  A block whose sorted indices span more rows reads them
    straight from device memory."""
    return _SMEM_MAX_BYTES // (4 * max(w, 1))


# ---------------------------------------------------------------------------
# block_gather: out[i, :] = src[sidx[i], :], byte for byte
# ---------------------------------------------------------------------------


def block_gather_plain(src: torch.Tensor, sidx: torch.Tensor) -> torch.Tensor:
    """The plain version: one index_select."""
    return src.index_select(0, sidx.long())


def block_gather(src: torch.Tensor, sidx: torch.Tensor) -> torch.Tensor:
    """Rows of src (n, w) int32 at ascending int32 indices in [0, n): the
    staged route's gather.  CPU tensors take the plain version; everything else goes to the
    CUDA kernel, which launches or raises."""
    if src.device.type == "cpu" and sidx.device.type == "cpu":
        return block_gather_plain(src, sidx)
    return block_gather_cuda(src, sidx)


def block_gather_cuda(src: torch.Tensor, sidx: torch.Tensor,
                      staged_blocks: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Launch csrc/block_gather.cu on the current stream: src (n, w)
    int32 and sidx (m,) int32 ascending in [0, n), contiguous, on one
    CUDA device.  Raises on anything else and when the launch fails;
    counts each launch in `block_gather_cuda.launches`.  `staged_blocks`,
    a one-element int32 tensor on the same device, gets the number of
    thread blocks that took the shared-memory branch added to it."""
    if src.device.type != "cuda" or sidx.device != src.device:
        raise ValueError(f"block_gather: src on {src.device}, sidx on "
                         f"{sidx.device}; both must be on one CUDA device")
    if src.dtype != torch.int32 or sidx.dtype != torch.int32:
        raise TypeError(f"block_gather: src {src.dtype}, sidx {sidx.dtype}; "
                        "both must be int32")
    if src.ndim != 2 or sidx.ndim != 1:
        raise ValueError(f"block_gather: shapes {tuple(src.shape)} and "
                         f"{tuple(sidx.shape)} do not match (n, w) and (m,)")
    if not (src.is_contiguous() and sidx.is_contiguous()):
        raise ValueError("block_gather: inputs must be contiguous")
    n, w = src.shape
    m = sidx.shape[0]
    out = torch.empty((m, w), dtype=torch.int32, device=src.device)
    if m == 0 or w == 0:
        return out
    if n == 0:
        raise ValueError("block_gather: indices into an empty source")
    if staged_blocks is not None and (
            staged_blocks.dtype != torch.int32
            or staged_blocks.device != src.device
            or staged_blocks.numel() != 1):
        raise ValueError("block_gather: staged_blocks must be one int32 "
                         "element on the source's device")
    from presto_tpu_torch.exec import cuda_build

    lib = cuda_build.load("block_gather")
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):  # the runtime launches on it
        rc = lib.block_gather_u32(
            src.data_ptr(), sidx.data_ptr(), m, w, _IB, smem_rows(w),
            out.data_ptr(),
            None if staged_blocks is None else staged_blocks.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError("block_gather kernel failed: "
                           + cuda_build.error_string(lib, rc))
    block_gather_cuda.launches += 1
    return out


block_gather_cuda.launches = 0
