"""The host-side choices around two Hopper kernels, on the CPU: which GEMM
plan kernel H (`fused_dense`) takes for a shape, and the envelope the
attention backward kernels accept. Neither needs the card: the plan is a
pure function of the shape and the operands' alignment, and the envelope
is checked before any launch."""

import pytest
import torch

from emu_tpu_torch.ops import flash_attention as fa
from emu_tpu_torch.ops import fused_mlp as mlp

@pytest.mark.parametrize("m,k,n,aligned,plan", [
    (2048, 5120, 1280, True, "tma"),    # SDXL GEGLU proj_out
    (2048, 1280, 10240, True, "tma"),   # SDXL GEGLU proj_in
    (8192, 640, 5120, True, "tma"),     # the pre form's GEMM (64² level)
    (8200, 1792, 1792, True, "tma"),    # EVA-4B proj + post-LN
    (300, 96, 200, True, "tma"),        # K % 64 and N % 128 ragged
    (64, 4096, 256, True, "tma"),       # a short grid, a long K
    (16, 1024, 1024, True, "tma"),
    (2, 320, 1280, True, "mma"),        # the time embedding: 2 rows
    (3, 320, 1280, True, "tma"),
    (32, 768, 5120, True, "tma"),       # Causal Former proj, 1 image
    (257, 588, 1408, True, "mma"),      # the patch embedding: K % 8
    (5, 64, 60, True, "mma"),           # N % 8
    (2048, 5120, 1280, False, "mma"),   # an unaligned view
])
def test_fused_dense_plan(m, k, n, aligned, plan):
    assert mlp.fused_dense_plan(m, k, n, aligned) == plan


def test_fused_dense_plan_rows_edge():
    """Aligned denses of at most DENSE_MMA_ROWS rows keep the mma.sync
    plan, more rows take the TMA plan."""
    edge = mlp.DENSE_MMA_ROWS
    if edge > 0:
        assert mlp.fused_dense_plan(edge, 320, 1280, True) == "mma"
    assert mlp.fused_dense_plan(edge + 1, 320, 1280, True) == "tma"


@pytest.mark.parametrize("unmet", ["k_not_multiple_of_8",
                                   "n_not_multiple_of_8", "unaligned"])
def test_fused_dense_plan_needs_aligned_multiples_of_8(unmet):
    """The TMA plan's tensor maps need K and N multiples of 8 and 16-byte
    aligned operands: a shape that misses one takes the mma.sync plan at
    every row count."""
    k = 1284 if unmet == "k_not_multiple_of_8" else 1280
    n = 1284 if unmet == "n_not_multiple_of_8" else 1280
    for m in (1, 3, 128, 2048, 8192):
        assert mlp.fused_dense_plan(m, k, n, unmet != "unaligned") == "mma"
        assert mlp.fused_dense_plan(m, 1280, 1280, True) == (
            "mma" if m <= mlp.DENSE_MMA_ROWS else "tma")


def test_fused_dense_plan_is_a_function_of_the_shape():
    """The plan reads only the shape and the alignment: every call at one
    shape gives one answer, and the short grids of the main paths (the
    SD1.5 UNet's 8² level, the Causal Former's projection) take the TMA
    plan whole, as the long ones do."""
    for m, k, n in ((128, 1280, 1280), (128, 5120, 1280), (32, 768, 5120),
                    (512, 5120, 1280), (2048, 5120, 1280)):
        plans = {mlp.fused_dense_plan(m, k, n, True) for _ in range(3)}
        assert plans == {"tma"}


def test_fused_dense_counts_no_plan_on_cpu():
    """A CPU tensor takes the twin: no launch, no plan counted."""
    before = dict(mlp.fused_dense.plans), mlp.fused_dense.launches
    x, w = torch.randn(3, 64), torch.randn(64, 128)
    out = mlp.fused_dense(x, w, torch.randn(128))
    assert out.shape == (3, 128)
    assert (dict(mlp.fused_dense.plans), mlp.fused_dense.launches) == before


def _bwd_inputs(b=2, h=4, hkv=2, sq=70, skv=90, d=64):
    bf = torch.bfloat16
    q = torch.zeros(b, sq, h, d, dtype=bf).transpose(1, 2)
    k = torch.zeros(b, skv, hkv, d, dtype=bf).transpose(1, 2)
    v = torch.zeros_like(k)
    o, do = torch.zeros_like(q), torch.zeros_like(q)
    lse = torch.zeros(b, h, sq)
    dvec = torch.zeros(b, h, sq)
    return q, k, v, o, lse, do, dvec


def test_backward_envelope_accepts_the_train_layout():
    """Token-major [B, S, H, D] memory seen as [B, H, S, D], GQA, a mask:
    accepted, the mask handed on as bool."""
    q, k, v, o, lse, do, dvec = _bwd_inputs()
    valid = torch.ones(2, 90, dtype=torch.int32)
    got = fa._bwd_check("bwd", q, k, v, o, lse, do, dvec, valid)
    assert got.dtype == torch.bool and got.is_contiguous()
    assert fa._bwd_check("bwd", q, k, v, None, lse, do, dvec, None) is None


@pytest.mark.parametrize("fault", [
    "d_not_multiple_of_8", "d_above_128", "heads_not_grouped", "lse_shape",
    "lse_dtype", "do_shape", "o_shape", "kv_valid_shape", "broadcast_k",
    "broadcast_do", "unaligned_stride", "fp32_q"])
def test_backward_envelope_refuses(fault):
    """What the kernels cannot take raises ValueError before any launch."""
    if fault == "d_not_multiple_of_8":
        q, k, v, o, lse, do, dvec = _bwd_inputs(d=60)
    elif fault == "d_above_128":
        q, k, v, o, lse, do, dvec = _bwd_inputs(d=136)
    elif fault == "heads_not_grouped":
        q, k, v, o, lse, do, dvec = _bwd_inputs(h=3, hkv=2)
    else:
        q, k, v, o, lse, do, dvec = _bwd_inputs()
    valid = None
    if fault == "lse_shape":
        lse = lse[:, :, 1:]
    elif fault == "lse_dtype":
        lse = lse.double()
    elif fault == "do_shape":
        do = do[:, :, 1:]
    elif fault == "o_shape":
        o = o[:1]
    elif fault == "kv_valid_shape":
        valid = torch.ones(2, 89, dtype=torch.bool)
    elif fault == "broadcast_k":
        k = k[:, :1].expand(-1, 2, -1, -1)
    elif fault == "broadcast_do":
        do = do[:, :, :1].expand(-1, -1, 70, -1)
    elif fault == "unaligned_stride":
        q = torch.zeros(2, 70, 4, 68, dtype=torch.bfloat16)[..., :64] \
            .transpose(1, 2)
    elif fault == "fp32_q":
        q = q.float()
    with pytest.raises(ValueError):
        fa._bwd_check("bwd", q, k, v, o, lse, do, dvec, valid)


@pytest.mark.parametrize("view", ["broadcast", "unaligned", "aligned"])
def test_backward_cotangent_copied_only_where_unmappable(view):
    """`_bwd_do` copies a cotangent no tensor map can step (a broadcast
    dim, strides off 16 bytes) and passes a mappable view as it is."""
    base = torch.randn(2, 70, 4, 72).to(torch.bfloat16)
    do = {"broadcast": base[:, :1, :, :64].expand(-1, 70, -1, -1),
          "unaligned": torch.randn(2, 70, 4, 68).to(torch.bfloat16)[..., :64],
          "aligned": base[..., :64]}[view].transpose(1, 2)
    got = fa._bwd_do(do)
    assert torch.equal(got, do)
    assert (got is do) == (view == "aligned")
    fa._check_bhsd("bwd", ("do", got), maps=True)
