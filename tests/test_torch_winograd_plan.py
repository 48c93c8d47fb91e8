"""The Winograd kernel's launch geometry (``ops/winograd.py``
``winograd_plan``), which the launcher hands to the kernel: checked here
on the CPU, for the chain's two shapes at 416x416, for every input size
from 320 to 608 in steps of 32 at both chain modules, and for the card
tests' edge shapes (``WINOGRAD_CASES``), each for the mode with the
least and the one with the most shared memory."""
import numpy as np
import pytest

from . import torch_threads  # noqa: F401
from .test_torch_cuda_kernels import WINOGRAD_CASES
from yolov3_tensorflow_tpu_torch.ops import winograd as wg

SIZES = range(320, 609, 32)
GROUPS = {
    # module 2's second block and module 1's blocks at batch 128
    "chain": [(128, 128, 128, 52, 52), (128, 64, 64, 104, 104)],
    "module2_sizes": [(128, 128, 128, s // 8, s // 8) for s in SIZES],
    "module1_sizes": [(128, 64, 64, s // 4, s // 4) for s in SIZES],
    "edge": list(WINOGRAD_CASES),
}


def plans(group):
    """Each shape's plan without a second input and with the most shared
    memory a mode takes (a partner, three epilogue inputs)."""
    return [wg.winograd_plan(*shape, partner=partner, epi_inputs=epi)
            for shape in GROUPS[group] for partner, epi in ((False, 0),
                                                            (True, 3))]


def blocks(plan):
    """Every block's (image, first tile row, tile rows, first tile
    column, tile columns, co-block), as arrays over the grid."""
    return plan.block(np.arange(plan.grid))


@pytest.mark.parametrize("group", list(GROUPS))
def test_plan_covers_every_output_tile_once(group):
    """Each (image, tile, co-block) is one block's, exactly once; blocks
    hold at most 64 tiles and the co-blocks span the output channels."""
    for plan in plans(group):
        n, tr0, rb, tc0, twe, cb = blocks(plan)
        assert (rb * twe <= wg.TILES_PER_BLOCK).all() and (rb >= 1).all()
        assert (twe >= 1).all()
        count = np.zeros((plan.co_blocks, plan.n, plan.th, plan.tw), int)
        dr, dc = np.meshgrid(np.arange(plan.rows), np.arange(plan.seg_tiles),
                             indexing="ij")
        dr, dc = dr.ravel()[None, :], dc.ravel()[None, :]
        keep = (dr < rb[:, None]) & (dc < twe[:, None])
        sel = np.broadcast_to
        shape = keep.shape
        np.add.at(count, (sel(cb[:, None], shape)[keep],
                          sel(n[:, None], shape)[keep],
                          (tr0[:, None] + dr)[keep],
                          (tc0[:, None] + dc)[keep]), 1)
        assert (count == 1).all(), plan
        assert (plan.co_blocks - 1) * wg.CO_BLOCK < plan.co \
            <= plan.co_blocks * wg.CO_BLOCK


@pytest.mark.parametrize("group", list(GROUPS))
def test_plan_bands_stay_inside_one_image(group):
    """A block's tiles lie in one image; its band starts on an even row
    and stages, inside the image, every input row its tiles' 4x4 patches
    read (rows 2*tr0 - 1 .. 2*(tr0 + rows) clipped to the image)."""
    for plan in plans(group):
        n, tr0, rb, tc0, twe, _ = blocks(plan)
        assert ((n >= 0) & (n < plan.n)).all()
        assert (tr0 + rb <= plan.th).all() and (tc0 + twe <= plan.tw).all()
        for band in range(plan.bands):
            row0, nrows = plan.band_rows(band)
            tr = band * plan.rows
            rows = min(plan.rows, plan.th - tr)
            need_lo = max(2 * tr - 1, 0)
            need_hi = min(2 * (tr + rows) + 1, plan.h)
            assert row0 % 2 == 0 and 0 <= row0 <= need_lo, (plan, band)
            assert need_hi <= row0 + nrows <= plan.h, (plan, band)
            assert nrows <= 2 * plan.rows + 3


@pytest.mark.parametrize("group", list(GROUPS))
def test_plan_picks_the_16_byte_variant_exactly_where_it_fits(group):
    """The aligned (16-byte copy) variant where the (n, c) plane and every
    band's first row start on 16 bytes, the narrow one elsewhere: both
    chain shapes and every size in the sweep are aligned, W = 11 is not."""
    for plan in plans(group):
        starts = [plan.band_rows(b)[0] for b in range(plan.bands)]
        fits = (plan.h * plan.w * 2) % 16 == 0 and all(
            (s * plan.w * 2) % 16 == 0 for s in starts)
        assert plan.aligned == fits, plan
        if group != "edge":
            assert plan.aligned, plan
        if plan.w == 11:
            assert not plan.aligned, plan


@pytest.mark.parametrize("group", list(GROUPS))
def test_plan_partial_rows_equal_the_block_count(group):
    """One partial-sum row per block of tiles (the co-blocks of a band
    share its row, each writing its own channels), and a grid of that
    many blocks per co-block; the block fits the card's shared memory and
    stages whole 8-channel groups."""
    for plan in plans(group):
        n, tr0, _, tc0, _, cb = blocks(plan)
        tile_blocks = len(set(zip(n.tolist(), tr0.tolist(), tc0.tolist())))
        assert plan.partial_rows == tile_blocks == plan.n * plan.bands \
            * plan.segs
        assert plan.grid == plan.partial_rows * plan.co_blocks
        assert set(cb.tolist()) == set(range(plan.co_blocks))
        assert plan.smem_bytes <= wg.MAX_SMEM_BYTES
        assert plan.cch % 8 == 0 and 8 <= plan.cch <= max(plan.c, 8)
