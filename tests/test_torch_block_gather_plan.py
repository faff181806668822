"""The block_gather kernel's launch plan and copy window, on the CPU.

`exec/gather.py::block_gather_launch_shape` is the only source of the
CUDA kernel's launch numbers (csrc/block_gather.cu), and `copy_window`
is the kernel's own arithmetic for a tile's TMA copy.  The kernel runs
only on the card (chip_smoke.py holds it there against its plain
version); these tests hold the plan's invariants at every gather shape
the 22 TPC-H queries give the kernel at SF1 and at edge shapes, and
simulate a tile's gather through its window with numpy, which must give
index_select's bytes.
"""

import numpy as np
import pytest
import torch

from presto_tpu_torch.exec import gather as G
from tests.torch_threads import torch_one_thread  # noqa: F401

H100_SMS = 132

# (n, w, m) of every staged gather of the 22 TPC-H queries at SF1
QUERY_SHAPES = [
    (150_000, 4, 1_500_000), (1_500_000, 12, 6_000_601),      # Q3
    (10_000, 18, 6_000_601), (150_000, 5, 1_500_000),         # Q5
    (150_000, 10, 1_500_000), (1_500_000, 16, 6_000_601),     # Q7
    (10_000, 10, 6_000_601),
    (200_000, 4, 6_000_601), (150_000, 16, 1_500_000),        # Q8
    (1_500_000, 23, 6_000_601),
    (800_000, 5, 6_000_601), (1_500_000, 4, 6_000_601),       # Q9
    (150_000, 14, 1_500_000), (1_500_000, 26, 6_000_601),     # Q10
    (1_500_000, 6, 1_536_123), (150_000, 3, 1_536_123),       # Q13
    (200_000, 5, 6_000_601),                                  # Q17
    (6_000_601, 2, 1_500_000), (1_500_000, 11, 6_000_601),    # Q18
    (200_000, 6, 6_000_601),                                  # Q19
    (10_000, 11, 6_000_601),                                  # Q21
]
# m below a tile, a single index, odd widths, w = 1 and 64, a span no
# stage holds, a source of one row
EDGE_SHAPES = [
    (100_000, 3, 1_000), (5, 7, 1), (999_983, 9, 777_777),
    (1 << 20, 1, 1 << 21), (50_000, 64, 1 << 20), (16_000_000, 2, 4_096),
    (1, 5, 5_000), (8_000_000, 4, 2_000_000),
]


@pytest.mark.parametrize("n,w,m", QUERY_SHAPES + EDGE_SHAPES)
def test_plan_invariants(n, w, m):
    plan = G.block_gather_launch_shape(n, w, m, H100_SMS)
    assert plan == G.block_gather_launch_shape(n, w, m, H100_SMS)
    assert plan.tile == G._BG_TILE
    assert plan.tile % G._BG_THREADS == 0 and plan.tile % 4 == 0
    assert plan.stages == 2
    # the ring plus the index buffers fit one block's 227 KB, and
    # blocks_per_sm such blocks fit an SM's 228 KB
    assert plan.stage_bytes % 16 == 0 and plan.stage_bytes >= 0
    assert plan.smem_bytes == (2 * plan.stage_bytes
                               + G._BG_IDX_BUFFERS * plan.tile * 4 + 16)
    assert plan.smem_bytes <= 227 * 1024
    assert 1 <= plan.blocks_per_sm <= G._BG_MAX_BLOCKS_PER_SM
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= 228 * 1024
    # the vector width is the widest that keeps every row aligned
    assert w % plan.vec_words == 0
    assert plan.vec_words == 4 or w % (2 * plan.vec_words)
    # persistent blocks: no more than fit the card, no more than tiles
    tiles = -(-m // plan.tile)
    assert 1 <= plan.blocks <= min(tiles, H100_SMS * plan.blocks_per_sm)
    # a ring that holds the expected span of a tile, and as many blocks
    # as it leaves room for; no ring for indices a sector or more apart
    need = G.bg_expected_stage_bytes(n, w, m)
    if n * w * 4 >= 32 * m or need > G.bg_stage_cap(1):
        assert plan.stage_bytes == 0
        assert plan.blocks_per_sm == G._BG_MAX_BLOCKS_PER_SM
    else:
        assert plan.stage_bytes == need
        assert plan.blocks_per_sm == min(
            G._BG_MAX_BLOCKS_PER_SM,
            228 * 1024 // (plan.smem_bytes + 1024))


def test_plan_residency_follows_the_span():
    """Q3's orders at lineitem (256 rows of 48 bytes a tile) keep four
    blocks an SM; Q10's 26-word rows leave room for two; Q18's group
    keys (indices 4 rows, 32 bytes, apart) and a span no stage holds
    take no ring at four."""
    def plan(*shape):
        return G.block_gather_launch_shape(*shape, H100_SMS)

    assert plan(1_500_000, 12, 6_000_601).blocks_per_sm == 4
    assert plan(1_500_000, 26, 6_000_601).blocks_per_sm == 2
    for shape in ((6_000_601, 2, 1_500_000), (16_000_000, 2, 4_096)):
        assert plan(*shape).stage_bytes == 0
        assert plan(*shape).blocks_per_sm == 4
    assert [G.bg_stage_cap(r) for r in (4, 2, 1)] == [22512, 51696, 110064]


def test_plan_at_rejects_stages_that_do_not_fit():
    for bad in (-16, 24, G.bg_stage_cap(1) + 16):
        with pytest.raises(ValueError, match="stage"):
            G.block_gather_plan_at(1000, 4, 5000, H100_SMS, bad)
    zero = G.block_gather_plan_at(1000, 4, 5000, H100_SMS, 0)
    assert zero.blocks_per_sm == 4 and zero.blocks == 5


def _gather_through_windows(src, sidx, stage_bytes):
    """What the kernel writes, simulated with numpy: each tile of sorted
    indices copies its window into a stage when it fits and reads every
    word outside the copy (or every word, when it does not fit) from
    the source."""
    n, w = src.shape
    buf = src.view(np.uint8).ravel()
    words = src.ravel()
    out = np.empty((len(sidx), w), np.int32)
    staged = 0
    for i0 in range(0, len(sidx), G._BG_TILE):
        idx = sidx[i0:i0 + G._BG_TILE].astype(np.int64)
        win = G.copy_window(int(idx[0]), int(idx[-1]), w, n)
        start, nbytes, first = win
        q = idx[:, None] * w + np.arange(w)[None, :]   # source words
        if not G.tile_staged(win, stage_bytes):
            out[i0:i0 + len(idx)] = words[q]
            continue
        staged += 1
        # the copy: 16-byte aligned, a multiple of 16 bytes, inside the
        # source, and row lo's first word at `first`, within its first
        # 16 bytes
        assert start % 16 == 0 and nbytes % 16 == 0
        assert start >= 0 and start + nbytes <= n * w * 4
        assert first == int(idx[0]) * w * 4 - start and 0 <= first < 16
        stage = buf[start:start + nbytes].view(np.int32)
        o = (q - idx[0] * w) + first // 4     # stage words
        inside = o < len(stage)
        # plain loads only at the end: at most 3 words after the copy
        # (a tail the clamp cut)
        assert (idx[-1] + 1) * w - (start + nbytes) // 4 <= 3
        got = words[q]
        got[inside] = stage[o[inside]]
        out[i0:i0 + len(idx)] = got
    return out, staged


# no ring, a stage of 1 KB (only the narrowest spans fit), and the
# largest stage at 4 and at 1 blocks an SM
@pytest.mark.parametrize("stage", [0, 1024, G.bg_stage_cap(4),
                                   G.bg_stage_cap(1)])
@pytest.mark.parametrize("n,w,m", [
    (7, 3, 3000),          # 84 source bytes: the last tile's copy clamps
    (1001, 5, 5000),       # odd width, 20,020 bytes
    (4097, 2, 2048),       # spans of about 2,000 rows: some tiles fit
    (333, 4, 4096),
    (50, 1, 3000),
])
def test_copy_window_gathers_exact_rows(n, w, m, stage):
    rng = np.random.default_rng(n * 100 + w)
    src = rng.integers(-(1 << 31), 1 << 31, (n, w)).astype(np.int32)
    sidx = np.sort(rng.integers(0, n, m)).astype(np.int32)
    sidx[-1] = n - 1   # the last tile reaches the end of the source
    out, staged = _gather_through_windows(src, sidx, stage)
    want = torch.from_numpy(src).index_select(
        0, torch.from_numpy(sidx).long()).numpy()
    assert out.tobytes() == want.tobytes()
    if n * w * 4 <= stage // 2:
        assert staged == -(-m // G._BG_TILE)  # every tile went through
    if stage == 0:
        assert staged == 0


@pytest.mark.parametrize("w", [1, 3, 4, 11])
def test_tile_staged_at_the_stage_boundary(w):
    """A window of exactly the stage's bytes goes through the ring; one
    row more does not."""
    n = 10_000
    stage = G.bg_stage_cap(4)
    lo = 64                          # row lo starts on a 16-byte boundary
    rows = stage // (4 * w)
    hi = lo + rows - 1
    while G.copy_window(lo, hi, w, n)[1] > stage:
        hi -= 1
    while G.copy_window(lo, hi + 1, w, n)[1] <= stage:
        hi += 1
    win = G.copy_window(lo, hi, w, n)
    assert G.tile_staged(win, stage)
    assert not G.tile_staged(G.copy_window(lo, hi + 1, w, n), stage)
    if w % 4 == 0:   # whole 16-byte rows: the window is the rows exactly
        assert win[1] == stage == (hi - lo + 1) * w * 4


def test_copy_window_clamps_at_the_source_end():
    # 7 rows of 3 words: 84 bytes, the last 16-byte boundary at 80
    start, nbytes, first = G.copy_window(5, 6, 3, 7)
    assert (start, nbytes, first) == (48, 32, 12)
    # a source shorter than 16 bytes has nothing to copy
    assert G.copy_window(0, 0, 3, 1)[1] == 0
    assert not G.tile_staged(G.copy_window(0, 0, 3, 1), 1 << 16)
    # a row that starts 8 bytes past a boundary: the copy starts at the
    # boundary before it, and row lo's first word sits 8 bytes in
    assert G.copy_window(1, 3, 2, 100) == (0, 32, 8)
