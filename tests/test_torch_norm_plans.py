"""The host-side plan of kernel C's backward (`fused_norm.norm_bwd_plan`)
on the CPU. It is a pure function of the shape: which kernel takes the rows
(the row kernel exactly where the forward takes its own: both read
`row_tpr`), the threads of a row, the rows a block takes at once, the
ring's bytes and the persistent grid whose blocks each own a contiguous run of rows and one partial row of
dw. It needs no card."""

import pytest

from emu_tpu_torch.ops import fused_norm as C
from emu_tpu_torch.ops._cuda import H100_SMS, SMEM_PER_BLOCK

# (rows, width): Emu1's train step (2 x 1024 tokens of LLaMA-13B), a ragged
# row count, LLaMA-33B and LLaMA-7B widths, the card tests' shapes, the
# widest row the row kernel holds and one past it, a width that is not a
# multiple of 8, a single row, no rows, more steps than SMs by one
NORM_SHAPES = [(2048, 5120), (2047, 5120), (37, 5120), (2048, 6656),
               (2048, 4096), (300, 1000), (300, 1001), (1, 16384),
               (5, 16392), (1, 8), (3, 7), (0, 5120), (640, 64),
               (2 * (H100_SMS + 1), 5120)]


@pytest.mark.parametrize("m,w", NORM_SHAPES)
def test_norm_bwd_plan_is_a_function_of_the_shape(m, w):
    """Computed afresh, the plan is the same: it reads no data."""
    first = dict(C.norm_bwd_plan(m, w))
    C.norm_bwd_plan.cache_clear()
    assert C.norm_bwd_plan(m, w) == first


@pytest.mark.parametrize("m,w", NORM_SHAPES)
def test_norm_bwd_plan_covers_every_row_once(m, w):
    """The blocks' runs of rows are consecutive, none is empty, they cover
    [0, m) exactly; the row kernel's runs are whole steps; at most one
    block an SM (the row kernel) and one partial row of dw a block."""
    plan = C.norm_bwd_plan(m, w)
    rpb, grid = plan["rows_per_block"], plan["grid"]
    runs = [(i * rpb, min(m, (i + 1) * rpb)) for i in range(grid)]
    covered = [r for lo, hi in runs for r in range(lo, hi)]
    assert covered == list(range(m))
    assert all(lo < hi for lo, hi in runs)
    assert plan["parts"] == grid
    if plan["kernel"] == "rows":
        assert rpb % plan["rows_step"] == 0
        assert grid <= H100_SMS


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("w", [8, 64, 1000, 1001, 4096, 5120, 6656, 16384,
                               16385, 16392, 12, 7])
def test_norm_bwd_plan_takes_the_row_kernel_where_the_forward_does(w,
                                                                   aligned):
    """The row kernel exactly where the forward's conditions hold (w % 8 ==
    0, w <= 8 * NORM_VMAX * NORM_THREADS, 16-byte aligned operands), with
    the threads a row the forward's wrapper passes (`row_tpr`: the fewest
    powers of two from 32 that hold the row in NORM_VMAX vectors each); the
    ring of NORM_STAGES steps fits one block's shared memory and holds the
    block's partial rows at the end; the scalar kernel's dw sums fit too."""
    plan = C.norm_bwd_plan(2048, w, aligned=aligned)
    vmax, threads = C.NORM_VMAX, C.NORM_THREADS
    vector = w % 8 == 0 and w <= 8 * vmax * threads and aligned
    assert plan["kernel"] == ("rows" if vector else "any")
    assert plan["tpr"] == C.row_tpr(w, aligned)
    if vector:
        tpr = plan["tpr"]
        assert tpr in (32, 64, 128, 256)
        assert tpr * vmax * 8 >= w and (tpr == 32 or tpr * vmax * 4 < w)
        assert plan["rows_step"] == threads // tpr
        assert plan["smem"] == \
            C.NORM_STAGES * 3 * plan["rows_step"] * w * 2 + 128
        assert plan["rows_step"] * w * 4 <= plan["smem"] <= SMEM_PER_BLOCK
    else:
        assert plan["tpr"] == 0
        assert plan["smem"] == 4 * w <= SMEM_PER_BLOCK


def test_norm_bwd_plan_at_the_train_step():
    """Emu1's train step (2048 rows of 5120): 128 threads a row, two rows a
    step, a ring of two steps (120 KiB and a line to align it), 128 blocks of 16 rows: 128 partial
    rows of dw instead of the first design's 256."""
    plan = C.norm_bwd_plan(2048, 5120)
    assert (plan["tpr"], plan["rows_step"], plan["smem"]) == \
        (128, 2, 2 * 3 * 2 * 5120 * 2 + 128)
    assert (plan["grid"], plan["rows_per_block"], plan["parts"]) == \
        (128, 16, 128)
