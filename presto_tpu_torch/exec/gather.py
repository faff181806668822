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
each tile of sorted indices decides for itself, on the device, whether
its rows fit a stage of the kernel's shared-memory ring
(csrc/block_gather.cu), so there is no coverage check and no host sync.
The kernel's launch plan is the pure function
`block_gather_launch_shape` of the shape and the card's SM count.

Words are held as int32 bit patterns: torch's CPU kernels lack shifts
on unsigned types, and the gather only moves bytes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

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

# the reference's sorted indices per output block (its window sizing)
_IB = 1024

# the reference's window sizing (the largest window, and headroom over
# the expected span of _IB sorted indices, _IB * n / m rows); here only
# to compare with the reference's coverage check (`window_rows`)
_MAX_WINDOW = 8192
_WINDOW_SLACK = 2


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


# ---------------------------------------------------------------------------
# block_gather's launch plan
# ---------------------------------------------------------------------------


# The kernel's compile-time bounds (csrc/block_gather.cu reports them in
# block_gather_bounds; chip_smoke.py checks that they agree):
_BG_THREADS = 256
_BG_TILE = 1024            # sorted indices a tile
_BG_STAGES = 2             # the TMA ring
_BG_IDX_BUFFERS = 3        # index buffers a block
_BG_BARRIER_BYTES = 16     # one 8-byte mbarrier a stage
_BG_MAX_BLOCKS_PER_SM = 4  # __launch_bounds__(256, 4): <= 64 registers
_BG_SMEM_PER_BLOCK = 227 * 1024  # H100, dynamic shared memory
_BG_SMEM_PER_SM = 228 * 1024     # H100
_BG_SMEM_RESERVED = 1024         # the runtime's share of each block
# stage rows over the expected span of a tile: the span of 1,024 sorted
# uniform indices varies by about 3%, and a few rows more cover the
# spans of tiles whose rows repeat (a tile over 2 rows may touch 3)
_BG_SPAN_SLACK = 1.25
_BG_SPAN_EXTRA_ROWS = 2
_BG_SECTOR_BYTES = 32  # the unit device memory moves


class BgPlan(NamedTuple):
    """One launch of csrc/block_gather.cu.  `blocks` persistent blocks
    of _BG_THREADS threads walk tiles of `tile` sorted indices; a tile
    whose copy window (`copy_window`) fits `stage_bytes` goes through
    the ring of `stages` stages, the others read their rows with
    `vec_words`-word loads.  Each block takes `smem_bytes` of shared
    memory, so `blocks_per_sm` blocks fit an SM."""
    tile: int
    stage_bytes: int
    stages: int
    vec_words: int
    blocks: int
    blocks_per_sm: int
    smem_bytes: int


def _bg_smem(stage_bytes: int) -> int:
    return (_BG_STAGES * stage_bytes + _BG_IDX_BUFFERS * _BG_TILE * 4
            + _BG_BARRIER_BYTES)


def bg_stage_cap(blocks_per_sm: int) -> int:
    """The largest stage (a multiple of 16 bytes) whose ring and index
    buffers let blocks_per_sm blocks share an SM."""
    per_block = min(_BG_SMEM_PER_BLOCK,
                    _BG_SMEM_PER_SM // blocks_per_sm - _BG_SMEM_RESERVED)
    room = per_block - _bg_smem(0)
    return (room // _BG_STAGES) // 16 * 16


def bg_vec_words(w: int) -> int:
    """The widest load, in words, that starts every row of a w-word
    matrix on its boundary (the source starts on a 16-byte one)."""
    return 4 if w % 4 == 0 else 2 if w % 2 == 0 else 1


def block_gather_plan_at(n: int, w: int, m: int, sm_count: int,
                         stage_bytes: int) -> BgPlan:
    """The plan at a given stage size: as many blocks as fit the card at
    the residency that stage allows, no more than there are tiles."""
    if stage_bytes < 0 or stage_bytes % 16:
        raise ValueError(f"block_gather: stage of {stage_bytes} bytes is "
                         "not a non-negative multiple of 16")
    smem = _bg_smem(stage_bytes)
    if smem > _BG_SMEM_PER_BLOCK:
        raise ValueError(f"block_gather: a stage of {stage_bytes} bytes "
                         f"needs {smem} bytes of shared memory a block, "
                         f"more than a block has ({_BG_SMEM_PER_BLOCK})")
    per_sm = min(_BG_MAX_BLOCKS_PER_SM,
                 _BG_SMEM_PER_SM // (smem + _BG_SMEM_RESERVED))
    tiles = -(-m // _BG_TILE)
    return BgPlan(_BG_TILE, stage_bytes, _BG_STAGES, bg_vec_words(w),
                  min(tiles, sm_count * per_sm), per_sm, smem)


def bg_expected_stage_bytes(n: int, w: int, m: int) -> int:
    """The bytes of a stage that holds the copy window of one tile at
    the expected span of its sorted indices (_BG_TILE * n / m rows, with
    slack), widened by 16 bytes at either end."""
    span = _BG_TILE * n / max(m, 1)
    rows = int(np.ceil(_BG_SPAN_SLACK * span)) + _BG_SPAN_EXTRA_ROWS
    return -(-(min(rows, n) * w * 4 + 32) // 16) * 16


@functools.lru_cache(maxsize=1024)
def block_gather_launch_shape(n: int, w: int, m: int,
                              sm_count: int) -> BgPlan:
    """The launch plan for src [n, w] and m sorted indices on a card of
    sm_count SMs, from the shape alone (no setting moves it).  A stage
    holds the expected span of a tile (`bg_expected_stage_bytes`), and
    the residency is what that ring leaves (at most 4 blocks an SM).
    No ring (stage 0: every tile reads its rows directly) when the
    indices fall a 32-byte sector or more apart on average, since a
    span's copy would then move more bytes than the sectors its rows
    touch, or when no stage holds the span.  Kept per shape: the
    wrapper asks for it at every launch."""
    need = bg_expected_stage_bytes(n, w, m)
    sparse = n * w * 4 >= _BG_SECTOR_BYTES * m
    stage = 0 if sparse or need > bg_stage_cap(1) else need
    return block_gather_plan_at(n, w, m, sm_count, stage)


def copy_window(lo: int, hi: int, w: int, n: int) -> Tuple[int, int, int]:
    """A tile's TMA copy, as csrc/block_gather.cu computes it: (start
    byte into src, bytes, byte offset of row lo's first word in the
    stage).  The rows [lo, hi] are widened to 16-byte boundaries (the
    source starts on one) and clamped at the last boundary inside src;
    the words of a tail cut by the clamp are read with plain loads.
    bytes 0: nothing to copy."""
    fb = lo * w * 4
    start = fb & ~15
    end = min(((hi + 1) * w * 4 + 15) & ~15, (n * w * 4) & ~15)
    return start, max(end - start, 0), fb - start


def tile_staged(window: Tuple[int, int, int], stage_bytes: int) -> bool:
    """Whether a tile with this copy window goes through the ring."""
    return 0 < window[1] <= stage_bytes


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
    """Launch csrc/block_gather.cu on the current stream with the plan
    of `block_gather_launch_shape`: src (n, w) int32 starting on a
    16-byte boundary (as every fresh allocation does) and sidx (m,)
    int32 ascending in [0, n), contiguous, on one CUDA device.  Raises
    on anything else and when the launch fails; counts each launch in
    `block_gather_cuda.launches`.  `staged_blocks`, a one-element int32
    tensor on the same device, gets the number of tiles that went
    through the TMA ring added to it."""
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
    if src.data_ptr() % 16:
        raise ValueError("block_gather: the source must start on a 16-byte "
                         f"boundary (address {src.data_ptr():#x})")
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
    plan = block_gather_launch_shape(n, w, m, _sm_count(src.device.index))
    launch_block_gather(src, sidx, plan, out, staged_blocks)
    block_gather_cuda.launches += 1
    return out


block_gather_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_block_gather(src: torch.Tensor, sidx: torch.Tensor, plan: BgPlan,
                        out: torch.Tensor,
                        staged_blocks: Optional[torch.Tensor] = None) -> None:
    """One launch of the kernel with an explicit plan into out (m, w),
    inputs as block_gather_cuda checks them (m, w, n >= 1).  The main
    path reaches it only through block_gather_cuda; chip_smoke.py calls
    it with other stage sizes to show the plan's choice.  Raises when
    the kernel refuses the plan or the launch fails."""
    from presto_tpu_torch.exec import cuda_build

    n, w = src.shape
    lib = cuda_build.load("block_gather")
    index = src.device.index
    # the raw handle of the current stream: torch.cuda.current_stream
    # builds a Stream object, a few microseconds a launch
    stream = torch._C._cuda_getCurrentRawStream(index)
    rc = lib.block_gather_u32(
        src.data_ptr(), sidx.data_ptr(), n, sidx.shape[0], w, plan.tile,
        plan.stage_bytes, plan.stages, plan.vec_words, plan.blocks,
        plan.smem_bytes, out.data_ptr(),
        None if staged_blocks is None else staged_blocks.data_ptr(), index,
        stream)
    if rc == -1:
        raise ValueError(f"block_gather: the kernel refuses {plan}: outside "
                         "its compile-time bounds, or src or out not on a "
                         "16-byte boundary")
    if rc != 0:
        raise RuntimeError("block_gather kernel failed: "
                           + cuda_build.error_string(lib, rc))
