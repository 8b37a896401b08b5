"""The port's CUDA kernels against their plain twins, on the card (bf16).

These need a CUDA card and `nvcc`, and skip without a card. They import no
jax, so on a machine without it run them with the JAX test harness left
out:  python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
Edge shapes here (ragged rows and columns, D = 64/88/128, GQA, no biases,
kernel E's cluster plans) complement chip_smoke.py, which
checks the Emu1 and Emu2-Chat paths' own shapes."""

import pytest
import torch

from emu_tpu_torch.ops import decode_attention as D
from emu_tpu_torch.ops import flash_attention as A
from emu_tpu_torch.ops import fused_mlp as B
from emu_tpu_torch.ops import fused_norm as C
from emu_tpu_torch.ops import q4_matmul as Q4
from emu_tpu_torch.ops import quant as Q

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, std=1.0):
    return (torch.randn(shape, device="cuda", generator=gen) * std
            ).to(torch.bfloat16)


def assert_close(got, ref, tol=2e-2):
    """bf16 outputs: |got - ref| <= tol * (1 + max|ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * (1 + ref.float().abs().max().item()), err


def assert_close_blocks(got, ref, rel=1e-2, block=64):
    """Backward outputs, whose size falls off along the sequence under a
    causal mask: every block of `block` rows (dim -2; a vector is one row)
    has ||got - ref||_F <= rel * ||ref||_F + 1e-6 * sqrt(n), so a block whose
    reference is zero must come out zero (chip_smoke.compare_blocks)."""
    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all())
    if got.dim() == 1:
        got, ref = got[None], ref[None]
    pad = (-got.shape[-2]) % block

    def blocks(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, pad))
        return t.reshape(*t.shape[:-2], -1, block * t.shape[-1])

    err = torch.linalg.vector_norm(blocks(got - ref), dim=-1)
    size = torch.linalg.vector_norm(blocks(ref), dim=-1)
    limit = rel * size + 1e-6 * (block * got.shape[-1]) ** 0.5
    assert bool((err <= limit).all()), float((err / limit).max())


def launched(wrapper, fn):
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,bias", [
    (2, 4, 4, 70, 70, 88, False, True),
    (3, 4, 2, 33, 130, 64, True, False),
    (1, 2, 1, 1, 65, 128, True, False),
    (2, 3, 3, 200, 200, 40, True, True),
    (2, 2, 1, 150, 333, 80, True, False),
    (1, 4, 4, 257, 257, 112, False, True),
])
def test_attention_kernel(gen, b, h, hkv, sq, skv, d, causal, bias):
    q = randn(gen, b, h, sq, d)
    k, v = randn(gen, b, hkv, skv, d), randn(gen, b, hkv, skv, d)
    qb = randn(gen, h, d) if bias else None
    vb = randn(gen, hkv, d) if bias else None
    valid = torch.arange(skv, device="cuda")[None] >= (
        torch.arange(b, device="cuda")[:, None] * 7)
    kw = dict(kv_valid=valid, scale=d ** -0.5, causal=causal)
    got = launched(A.attention, lambda: A.attention(q, k, v, qb, vb, **kw))
    assert_close(got, A.attention_reference(q, k, v, qb, vb, **kw))


@pytest.mark.parametrize("m,k,f,n,ln,bias", [
    (37, 64, 160, 64, True, True), (16, 128, 128, 96, False, False),
    (257, 128, 1024, 128, True, True)])
def test_fused_mlp_kernel(gen, m, k, f, n, ln, bias):
    """Also: the same bits on a second run (no atomics, every sum in a
    fixed order)."""
    x = randn(gen, m, k)
    w1, w2 = randn(gen, k, f, std=0.1), randn(gen, f, n, std=0.1)
    b1 = randn(gen, f) if bias else None
    b2 = randn(gen, n) if bias else None
    kw = dict(ln_scale=randn(gen, k), ln_bias=randn(gen, k), ln_mode="pre"
              ) if ln else {}
    kw["residual"] = n == k
    got = launched(B.fused_mlp, lambda: B.fused_mlp(x, w1, b1, w2, b2, **kw))
    assert_close(got, B.fused_mlp_reference(x, w1, b1, w2, b2, **kw))
    assert torch.equal(got, B.fused_mlp(x, w1, b1, w2, b2, **kw))


def test_fused_mlp_refuses_unported_forms(gen):
    x = randn(gen, 4, 32)
    w = randn(gen, 32, 32)
    with pytest.raises(ValueError, match="activation"):
        B.fused_mlp(x, w, None, w, None, w, None, activation="geglu")


@pytest.mark.parametrize("m,f,ln_mode,bias", [
    (37, 90, "pre", True),       # F % 8 != 0: the wrapper pads to 96
    (257, 2730, "post", True),   # EVA02-CLIP-L's hidden width
    (300, 256, None, False),
    (16, 129, "pre", False)])    # odd F: the wrapper pads to 136
def test_fused_mlp_swiglu_kernel(gen, m, f, ln_mode, bias):
    """Kernel B's SwiGLU form x + w3(silu(w1 x + b1) * (w2 x + b2)) + b3,
    pre-, post- and no LN; the same bits on a second run."""
    k = 128
    x = randn(gen, m, k)
    w1, w2 = randn(gen, k, f, std=0.1), randn(gen, k, f, std=0.1)
    w3 = randn(gen, f, k, std=0.1)
    b1, b2, b3 = ((randn(gen, f), randn(gen, f), randn(gen, k)) if bias
                  else (None, None, None))
    kw = dict(activation="swiglu", ln_mode=ln_mode, residual=True)
    if ln_mode:
        kw.update(ln_scale=1 + randn(gen, k, std=0.1), ln_bias=randn(gen, k))
    before = B.fused_mlp.forms["swiglu"]
    got = launched(B.fused_mlp,
                   lambda: B.fused_mlp(x, w1, b1, w2, b2, w3, b3, **kw))
    assert B.fused_mlp.forms["swiglu"] == before + 1
    assert_close(got, B.fused_mlp_reference(x, w1, b1, w2, b2, w3, b3, **kw))
    assert torch.equal(got, B.fused_mlp(x, w1, b1, w2, b2, w3, b3, **kw))


@pytest.mark.parametrize("m,k,n,ln_mode,bias,res", [
    (2, 320, 1280, None, True, False),       # the time embedding
    (300, 640, 5120, "pre", True, False),    # norm3 + GEGLU proj_in
    (257, 588, 1408, None, True, False),     # the patch embedding: K % 8 != 0
    (130, 256, 200, None, False, True),      # ragged N, no bias, residual
    (129, 512, 384, "post", True, True),     # post-LN + residual
    (70, 96, 1792, "post", False, False),
    (5, 64, 60, "pre", False, True),
    (300, 640, 200, None, True, False),      # TMA plan: ragged M, N % 128 != 0
    (300, 96, 1280, None, True, True),       # TMA plan: K % 64 != 0
    (64, 4096, 256, None, True, False),      # a short grid, a long K
    (64, 4096, 256, "post", True, True),     # the same, post-LN + residual
    (16, 1024, 1024, "pre", True, False),    # the same after the LN pass
    (2048, 5120, 1280, None, True, False)])  # the SDXL GEGLU proj_out
def test_fused_dense_kernel(gen, m, k, n, ln_mode, bias, res):
    """Kernel H in every form against its twin, with ragged M, N and K, on
    the plan `fused_dense_plan` chooses (its counter says which), the same
    bits on a second run."""
    x, w = randn(gen, m, k), randn(gen, k, n, std=k ** -0.5)
    b = randn(gen, n) if bias else None
    r = randn(gen, m, n) if res else None
    dim = k if ln_mode == "pre" else n
    kw = dict(ln_mode=ln_mode)
    if ln_mode:
        kw.update(ln_scale=1 + randn(gen, dim, std=0.1),
                  ln_bias=randn(gen, dim, std=0.1))
    form = ln_mode or "plain"
    plan = B.fused_dense_plan(m, k, n, True)
    before = B.fused_dense.forms[form], B.fused_dense.plans[plan]
    got = launched(B.fused_dense,
                   lambda: B.fused_dense(x, w, b, residual=r, **kw))
    assert (B.fused_dense.forms[form], B.fused_dense.plans[plan]) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (m, n)
    assert_close(got, B.fused_dense_reference(x, w, b, residual=r, **kw),
                 tol=1e-2)
    assert torch.equal(got, B.fused_dense(x, w, b, residual=r, **kw))


@pytest.mark.parametrize("m,k,n", [(3, 320, 1280), (300, 640, 200),
                                   (64, 4096, 256)])
def test_fused_dense_plans_agree(gen, m, k, n):
    """Both GEMM plans give the twin's result at one shape: x 16-byte
    aligned takes the TMA plan, the same values at an offset of one
    element (contiguous, so not copied) the mma.sync plan."""
    x, w = randn(gen, m, k), randn(gen, k, n, std=k ** -0.5)
    b = randn(gen, n)
    ref = B.fused_dense_reference(x, w, b)
    shifted = torch.empty(m * k + 1, device=x.device, dtype=x.dtype)
    shifted[1:] = x.reshape(-1)
    for plan, xin in (("tma", x), ("mma", shifted[1:].view(m, k))):
        before = B.fused_dense.plans[plan]
        got = B.fused_dense(xin, w, b)
        torch.cuda.synchronize()
        assert B.fused_dense.plans[plan] == before + 1
        assert_close(got, ref, tol=1e-2)


@pytest.mark.parametrize("ln_mode", [None, "pre", "post"])
def test_fused_dense_kernel_fp32_vectors(gen, ln_mode):
    """Kernel H reads fp32 bias and LayerNorm vectors as well as bf16 ones
    (the same values give the same bits), and holds fp32 vectors that bf16
    cannot carry to the twin."""
    m, k, n = 67, 320, 200
    x, w = randn(gen, m, k), randn(gen, k, n, std=k ** -0.5)
    dim = k if ln_mode == "pre" else n
    vecs = dict(b=randn(gen, n))
    if ln_mode:
        vecs.update(ln_scale=1 + randn(gen, dim, std=0.1),
                    ln_bias=randn(gen, dim, std=0.1))
    got = B.fused_dense(x, w, ln_mode=ln_mode, **vecs)
    wide = {name: t.float() for name, t in vecs.items()}
    assert torch.equal(got, B.fused_dense(x, w, ln_mode=ln_mode, **wide))
    fine = {name: t + 1e-3 * torch.rand(t.shape, device="cuda",
                                        generator=gen)
            for name, t in wide.items()}
    assert_close(B.fused_dense(x, w, ln_mode=ln_mode, **fine),
                 B.fused_dense_reference(x, w, ln_mode=ln_mode, **fine),
                 tol=1e-2)


def test_dense_routes_to_fused_dense_on_the_card(gen):
    """A biased bf16 dense launches kernel H; an fp32 one and one autograd
    records do not; the UNet block's norm3 + GEGLU proj_in takes its pre
    form."""
    from emu_tpu_torch.ops import layers as L
    p = {"kernel": randn(gen, 64, 96, std=0.1), "bias": randn(gen, 96)}
    x = randn(gen, 3, 64)
    got = launched(B.fused_dense, lambda: L.dense(p, x))
    assert_close(got, B.fused_dense_reference(x, p["kernel"], p["bias"]),
                 tol=1e-2)
    before = B.fused_dense.launches
    L.dense({n: t.float() for n, t in p.items()}, x.float())
    L.dense({"kernel": p["kernel"].requires_grad_(), "bias": p["bias"]}, x)
    assert B.fused_dense.launches == before
    ln = {"scale": 1 + randn(gen, 64, std=0.1), "bias": randn(gen, 64)}
    pre = B.fused_dense.forms["pre"]
    with torch.no_grad():
        got = L.layer_norm_dense(ln, p, x, 1e-5)
    assert B.fused_dense.forms["pre"] == pre + 1
    assert_close(got, L.dense(p, L.layer_norm(ln, x, 1e-5)).detach(),
                 tol=1e-2)


# batched_mha's head widths (each padded width DP of 64, 128, 192 and 256,
# the pad zero-filled by TMA) and sequence lengths around its 128-row query
# tiles and 64/128-key K/V tiles (one token, one short of and one past a
# tile, the ViTs' 257 and 1025)
MHA_D = [40, 64, 80, 88, 112, 160, 256]
MHA_S = [1, 63, 65, 129, 257, 1025]


@pytest.mark.parametrize("b,s,h,d,pad", [
    (2, 257, 16, 88, 0), (1, 1025, 4, 112, 0), (3, 40, 4, 32, 0)] + [
    (2, s, 2, d, 8) for d in MHA_D for s in MHA_S])
def test_mha_packed_qkv_kernel(gen, b, s, h, d, pad):
    """The batched_mha kernel on the three planes of a packed [B, S, 3·H·D]
    projection (token stride 3·H·D; D = 88 and 112 pad to 128), and on one
    cut from a wider buffer (token stride 3·H·D + pad): every padded width,
    ragged S, B > 1."""
    qkv = randn(gen, b, s, 3 * h * d + pad)[..., :3 * h * d]
    before = A.batched_mha.launches
    got = launched(A.mha_packed_qkv,
                   lambda: A.mha_packed_qkv(qkv, h, d, scale=d ** -0.5))
    assert A.batched_mha.launches == before
    assert got.shape == (b, s, h * d)
    assert_close(got, A.mha_packed_qkv_reference(qkv, h, d, scale=d ** -0.5))


def test_emu2_chat_fp32_decode_step_on_the_card(gen):
    """fp32 activations on the card take the plain routes where kernels D,
    F and G take bf16 only: a full-width Emu2-Chat cut to 2 layers, built
    in fp32, answers one request (prefill and decode steps), with float
    weights and with int4."""
    from emu_tpu_torch.pipelines.chat import EmuChatGeneration
    for quantize in (None, "int4"):
        chat = EmuChatGeneration.from_config(
            instruct=True, device="cuda", dtype=torch.float32,
            quantize=quantize, seed=0, depth=2)
        ids = chat.generate_ids([["Describe the sea."]], max_new_tokens=4)
        assert ids.shape == (1, 4)
        del chat
        torch.cuda.empty_cache()


@pytest.mark.parametrize("form", ["cross_4096x64", "self_4096", "packed_qkv",
                                  "blind_block"])
def test_attention_kernel_forms(gen, form):
    """Kernel A without kv_valid at the UNets' shapes (4096 latent queries
    against 64 conditioning keys; 4096-token self-attention), on strided
    planes of one packed [B, S, 3, H, D] projection, and with a block of
    128 query rows that all see no valid key (causal + left padding)."""
    if form == "cross_4096x64":
        q = randn(gen, 2, 10, 4096, 64)
        k, v = randn(gen, 2, 10, 64, 64), randn(gen, 2, 10, 64, 64)
        kw = dict(scale=64 ** -0.5)
    elif form == "self_4096":
        q, k, v = (randn(gen, 1, 2, 4096, 64) for _ in range(3))
        kw = dict(scale=64 ** -0.5)
    elif form == "packed_qkv":
        qkv = randn(gen, 2, 300, 3, 4, 88)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        kw = dict(scale=88 ** -0.5)
    else:
        q, k, v = (randn(gen, 2, 2, 300, 128) for _ in range(3))
        valid = torch.arange(300, device="cuda")[None] >= torch.tensor(
            [[0], [200]], device="cuda")
        kw = dict(kv_valid=valid, scale=128 ** -0.5, causal=True)
    got = launched(A.attention, lambda: A.attention(q, k, v, **kw))
    assert_close(got, A.attention_reference(q, k, v, **kw))


def test_attention_kernel_refuses_broadcast_kv(gen):
    """A k/v view broadcast over batch (stride 0, as `expand` makes it)
    has no tensor map: the wrapper raises, and launches nothing, rather
    than read other memory; the same values made contiguous run."""
    q = randn(gen, 2, 4, 70, 64)
    k, v = randn(gen, 1, 4, 70, 64), randn(gen, 1, 4, 70, 64)
    kx, vx = k.expand(2, -1, -1, -1), v.expand(2, -1, -1, -1)
    before = A.attention.launches
    with pytest.raises(ValueError, match="stride 0"):
        A.attention(q, kx, vx, scale=0.125)
    assert A.attention.launches == before
    got = launched(A.attention, lambda: A.attention(
        q, kx.contiguous(), vx.contiguous(), scale=0.125))
    assert_close(got, A.attention_reference(q, kx, vx, scale=0.125))


@pytest.mark.parametrize("m,f,bias", [(37, 160, True), (300, 1024, False)])
def test_fused_mlp_post_ln_kernel(gen, m, f, bias):
    """Kernel B's post-LN form: x + LN(fc2(gelu(fc1 x))); same bits twice."""
    k = 128
    x = randn(gen, m, k)
    w1, w2 = randn(gen, k, f, std=0.1), randn(gen, f, k, std=0.1)
    b1 = randn(gen, f) if bias else None
    b2 = randn(gen, k) if bias else None
    kw = dict(ln_scale=1 + randn(gen, k, std=0.1), ln_bias=randn(gen, k),
              ln_mode="post", residual=True)
    got = launched(B.fused_mlp, lambda: B.fused_mlp(x, w1, b1, w2, b2, **kw))
    assert_close(got, B.fused_mlp_reference(x, w1, b1, w2, b2, **kw))
    assert torch.equal(got, B.fused_mlp(x, w1, b1, w2, b2, **kw))


def _w8a8(gen, k, f, n):
    q1 = Q.quantize_kernel(randn(gen, k, f, std=0.1))
    q2 = Q.quantize_kernel(randn(gen, f, n, std=0.1))
    return (q1["kernel_q8"], q1["scale"], randn(gen, f, std=0.1),
            q2["kernel_q8"], q2["scale"], randn(gen, n, std=0.1))


@pytest.mark.parametrize("m,ln_mode", [(300, "pre"), (2049, "post"),
                                       (9, None)])
def test_fused_mlp_w8a8_kernel(gen, m, ln_mode):
    """Kernel E, three hidden blocks of 256 re-quantized per row; ragged
    rows; a second run gives the same bits."""
    k, f = 128, 768
    x = randn(gen, m, k)
    ws = _w8a8(gen, k, f, k)
    kw = dict(ln_mode=ln_mode, residual=True, bf=256)
    if ln_mode:
        kw.update(ln_scale=1 + randn(gen, k, std=0.1), ln_bias=randn(gen, k))
    got = launched(B.fused_mlp_w8a8, lambda: B.fused_mlp_w8a8(x, *ws, **kw))
    assert_close(got, B.fused_mlp_w8a8_reference(x, *ws, **kw))
    assert torch.equal(got, B.fused_mlp_w8a8(x, *ws, **kw))


@pytest.mark.parametrize("m", [100, 129])
@pytest.mark.parametrize("ln_mode", ["pre", "post", None])
def test_fused_mlp_kernel_ragged_rows_no_biases(gen, m, ln_mode):
    """Kernel B's GELU forms at M below and above one 128-row tile, with
    no biases; the same bits on a second run."""
    k, f = 128, 384
    x = randn(gen, m, k)
    w1, w2 = randn(gen, k, f, std=0.1), randn(gen, f, k, std=0.1)
    kw = dict(ln_mode=ln_mode, residual=True)
    if ln_mode:
        kw.update(ln_scale=1 + randn(gen, k, std=0.1), ln_bias=randn(gen, k))
    got = launched(B.fused_mlp,
                   lambda: B.fused_mlp(x, w1, None, w2, None, **kw))
    assert_close(got, B.fused_mlp_reference(x, w1, None, w2, None, **kw))
    assert torch.equal(got, B.fused_mlp(x, w1, None, w2, None, **kw))


@pytest.mark.parametrize("activation,ln_mode", [
    ("gelu", "pre"), ("gelu", "post"), ("swiglu", "pre"), ("swiglu", None)])
def test_fused_mlp_kernel_long_grids(gen, activation, ln_mode):
    """Kernel B at 4200 ragged rows, K = N = F = 2048 (grids of 264-528
    blocks, more than one wave of them), each form; the same bits twice."""
    m, k, f = 4200, 2048, 2048
    x = randn(gen, m, k)
    w1, w2 = randn(gen, k, f, std=0.03), randn(gen, f, k, std=0.03)
    b1, b2 = randn(gen, f, std=0.1), randn(gen, k, std=0.1)
    args = (x, w1, b1, w2, b2)
    if activation == "swiglu":
        args = (x, w1, b1, randn(gen, k, f, std=0.03), randn(gen, f, std=0.1),
                randn(gen, f, k, std=0.03), None)
    kw = dict(activation=activation, ln_mode=ln_mode, residual=True)
    if ln_mode:
        kw.update(ln_scale=1 + randn(gen, k, std=0.1), ln_bias=randn(gen, k))
    got = launched(B.fused_mlp, lambda: B.fused_mlp(*args, **kw))
    assert_close(got, B.fused_mlp_reference(*args, **kw))
    assert torch.equal(got, B.fused_mlp(*args, **kw))


@pytest.mark.parametrize("m,f", [(100, 2731), (129, 90)])
def test_fused_mlp_swiglu_kernel_odd_hidden_no_biases(gen, m, f):
    """Kernel B's SwiGLU form with a hidden width the wrapper pads (odd,
    and not a multiple of 8) and no biases, pre-LN."""
    k = 128
    x = randn(gen, m, k)
    w1, w2 = randn(gen, k, f, std=0.1), randn(gen, k, f, std=0.1)
    w3 = randn(gen, f, k, std=0.1)
    kw = dict(activation="swiglu", ln_mode="pre", residual=True,
              ln_scale=1 + randn(gen, k, std=0.1), ln_bias=randn(gen, k))
    args = (x, w1, None, w2, None, w3, None)
    got = launched(B.fused_mlp, lambda: B.fused_mlp(*args, **kw))
    assert_close(got, B.fused_mlp_reference(*args, **kw))
    assert torch.equal(got, B.fused_mlp(*args, **kw))


@pytest.mark.parametrize("m,k,f,bf,ln_mode,bias", [
    (130, 1792, 15360, 768, "post", True),   # EVA-4B widths, clusters of 6
    (100, 1792, 3072, 768, "pre", False),
    (129, 128, 1024, 128, None, True),       # one block a hidden block
    (64, 128, 2304, 1152, "pre", True),      # 9 tiles: 3 ranks x 3, twice
    (40, 32, 128, 768, "post", False),       # tiny: F < bf, K < 128
])
def test_fused_mlp_w8a8_kernel_plans(gen, m, k, f, bf, ln_mode, bias):
    """Kernel E at its plan's edges: ragged M below and above a 128-row
    tile, bf 768 at K = N = 1792, a cluster of one, a hidden block of nine
    tiles (the maxima computed, then each tile again to quantize), a
    hidden width below bf and K below one 128-byte step; biases None; the
    same bits on a second run."""
    ws = list(_w8a8(gen, k, f, k))
    if not bias:
        ws[2] = ws[5] = None
    kw = dict(ln_mode=ln_mode, residual=True, bf=bf)
    if ln_mode:
        kw.update(ln_scale=1 + randn(gen, k, std=0.1), ln_bias=randn(gen, k))
    x = randn(gen, m, k)
    got = launched(B.fused_mlp_w8a8, lambda: B.fused_mlp_w8a8(x, *ws, **kw))
    # the twin on CPU copies: its integer products are exact there at any
    # width (cuBLAS's int8 product refuses some small ones on the card)
    cpu = [None if t is None else t.cpu() for t in (x, *ws)]
    ckw = {k_: v.cpu() if torch.is_tensor(v) else v for k_, v in kw.items()}
    assert_close(got.cpu(), B.fused_mlp_w8a8_reference(*cpu, **ckw))
    assert torch.equal(got, B.fused_mlp_w8a8(x, *ws, **kw))


@pytest.mark.parametrize("m,k,n,bias", [(5, 512, 200, True),
                                        (40, 1024, 256, False),
                                        (3, 768, 32274, False),
                                        (64, 1024, 384, True),
                                        (65, 1024, 384, False),
                                        (330, 768, 32274, True),
                                        (1024, 1024, 520, False)])
def test_matmul_q4_kernel(gen, m, k, n, bias):
    """Kernel F: both tile plans (one consumer warpgroup up to 64 rows,
    with K split when the grid is short; two from 65), at 330 and 1024
    rows, ragged N as the lm_head's 32274 (rows not 16-byte aligned) and
    520, groups of 128 and 384; the same bits on a second run."""
    gs = 384 if k == 768 else 128
    p = Q.quantize_kernel_int4(randn(gen, k, n, std=0.05), group_size=gs)
    x, b = randn(gen, m, k), (randn(gen, n) if bias else None)
    got = launched(Q4.matmul_q4,
                   lambda: Q4.matmul_q4(x, p["kernel_q4"], p["scale4"], b))
    assert_close(got, Q4.matmul_q4_reference(x, p["kernel_q4"], p["scale4"],
                                             b))
    # at decode rows K is split; the splits are summed in a fixed order
    assert torch.equal(got, Q4.matmul_q4(x, p["kernel_q4"], p["scale4"], b))


@pytest.mark.parametrize("m", [1, 5, 8, 17, 32])
def test_fused_swiglu_q4_kernel(gen, m):
    """Kernel G at D 256, F 1536 (hidden block 384, two per half): its
    decode plan at one, two and four n8 tiles of rows."""
    gu = Q.quantize_kernel_int4(randn(gen, 256, 3072, std=0.1))
    dn = Q.quantize_kernel_int4(randn(gen, 1536, 256, std=0.1))
    args = (gu["kernel_q4"], gu["scale4"], dn["kernel_q4"], dn["scale4"])
    x, w = randn(gen, m, 256), 1 + randn(gen, 256, std=0.1)
    got = launched(Q4.fused_swiglu_q4,
                   lambda: Q4.fused_swiglu_q4(x, w, *args))
    assert_close(got, Q4.fused_swiglu_q4_reference(x, w, *args))
    assert torch.equal(got, Q4.fused_swiglu_q4(x, w, *args))


@pytest.mark.parametrize("m,d,f,gs", [(8, 2048, 5632, 128),
                                      (5, 768, 1536, 384),
                                      (1, 6656, 17920, 128)])
def test_fused_swiglu_q4_decode_plan_kernel(gen, m, d, f, gs):
    """Kernel G's decode plan with K split over clusters of 8 (gate|up at
    D 2048: 22 hidden blocks of 256) and 4, groups of 384 rows (three
    128-row folds a group), and LLaMA-33B's widths; the same bits twice."""
    gu = Q.quantize_kernel_int4(randn(gen, d, 2 * f, std=0.05), group_size=gs)
    dn = Q.quantize_kernel_int4(randn(gen, f, d, std=0.05))
    args = (gu["kernel_q4"], gu["scale4"], dn["kernel_q4"], dn["scale4"])
    x, w = randn(gen, m, d), 1 + randn(gen, d, std=0.1)
    got = launched(Q4.fused_swiglu_q4,
                   lambda: Q4.fused_swiglu_q4(x, w, *args))
    assert_close(got, Q4.fused_swiglu_q4_reference(x, w, *args))
    assert torch.equal(got, Q4.fused_swiglu_q4(x, w, *args))


def test_quantized_kernels_refuse_unmet_constraints(gen):
    p = Q.quantize_kernel_int4(randn(gen, 256, 64))
    with pytest.raises(ValueError):        # fp32 activations
        Q4.matmul_q4(randn(gen, 2, 256).float(), p["kernel_q4"], p["scale4"])
    with pytest.raises(ValueError):        # more than 32 rows
        Q4.fused_swiglu_q4(randn(gen, 33, 256), torch.ones(256, device="cuda"),
                           p["kernel_q4"], p["scale4"], p["kernel_q4"],
                           p["scale4"])


@pytest.mark.parametrize("rows,w,add,w_fp32", [
    (3, 4096, True, False), (5, 1000, False, False), (7, 1001, True, True)] + [
    (rows, w, add, w_fp32) for w in (1000, 4096, 5120, 6656)
    for rows in (1, 5, 640) for add, w_fp32 in ((True, False), (False, True),
                                                (True, True))])
def test_rmsnorm_kernel(gen, rows, w, add, w_fp32):
    """Kernel C's forward at the paths' widths (4096, 5120, 6656), a width
    whose rows end inside a thread's last vector (1000) and one that takes
    the scalar kernel (1001), at decode and prefill rows; w bf16 or fp32
    (read in its own dtype, not rounded to bf16); y bit-equal to the plain
    add, and every output the same bits on two runs."""
    x, r = randn(gen, rows, w), (randn(gen, rows, w) if add else None)
    wt = randn(gen, w)
    if w_fp32:
        wt = 1 + torch.randn(w, device="cuda", generator=gen) * 0.1
    got = launched(C.rmsnorm_fwd, lambda: C.rmsnorm_fwd(wt, x, r))
    ref = C.rmsnorm_reference(wt, x, r)
    assert torch.equal(got[0], ref[0])
    assert_close(got[1], ref[1])
    assert_close(got[2], ref[2], tol=1e-5)
    for a, b in zip(got, C.rmsnorm_fwd(wt, x, r)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b,h,hkv,s,d,extra", [
    (3, 8, 2, 50, 128, True), (2, 4, 4, 7, 64, False)])
def test_decode_attention_kernel(gen, b, h, hkv, s, d, extra):
    q = randn(gen, b, 1, h, d)
    kc, vc = randn(gen, 2, b, hkv, s, d), randn(gen, 2, b, hkv, s, d)
    kn = randn(gen, b, hkv, 1, d) if extra else None
    vn = randn(gen, b, hkv, 1, d) if extra else None
    valid = torch.rand(b, s, device="cuda", generator=gen) > 0.3
    kw = dict(scale=d ** -0.5, layer=1, k_new=kn, v_new=vn)
    got = launched(D.decode_attention,
                   lambda: D.decode_attention(q, kc, vc, valid, **kw))
    assert_close(got, D.decode_attention_reference(q, kc, vc, valid, **kw))


def _int8_planes(gen, *shape):
    vals = torch.randint(-127, 128, shape, device="cuda", generator=gen,
                         dtype=torch.int32).to(torch.int8)
    scales = torch.rand(shape[:-1], device="cuda", generator=gen) * 0.02 + 0.005
    return vals, scales


@pytest.mark.parametrize("b,h,hkv,s,d,qn,quant", [
    (3, 8, 2, 50, 128, 1, True),      # int8 decode step, GQA
    (2, 4, 4, 130, 64, 1, True),
    (1, 4, 4, 77, 128, 5, False),     # speculative verify chunk
    (2, 2, 2, 200, 128, 32, False),   # mixed step, 32 queries, MHA
    (2, 8, 2, 70, 128, 16, True),     # GQA rep 4, int8
    (3, 4, 4, 64, 128, 32, True),
])
def test_decode_attention_new_forms(gen, b, h, hkv, s, d, qn, quant):
    """Kernel D's int8 and Sq <= 32 forms against the twin: ragged valid
    masks, the stacked cache at layer 1, the chunk's extra columns with the
    intra-chunk triangle."""
    q = randn(gen, b, qn, h, d)
    if quant:
        kc, ks = _int8_planes(gen, 2, b, hkv, s, d)
        vc, vs = _int8_planes(gen, 2, b, hkv, s, d)
    else:
        kc, vc = randn(gen, 2, b, hkv, s, d), randn(gen, 2, b, hkv, s, d)
        ks = vs = None
    # k_new/v_new as the decoder passes them: transposed projection views
    kn = randn(gen, b, qn, hkv, d).transpose(1, 2)
    vn = randn(gen, b, qn, hkv, d).transpose(1, 2)
    valid = torch.rand(b, s, device="cuda", generator=gen) > 0.3
    kw = dict(scale=d ** -0.5, layer=1, k_new=kn, v_new=vn)
    form = ("chunk_" if qn > 1 else "") + ("int8" if quant else "bf16")
    before = D.decode_attention.forms[form]
    got = launched(D.decode_attention,
                   lambda: D.decode_attention(q, kc, vc, valid, ks, vs, **kw))
    assert D.decode_attention.forms[form] == before + 1
    assert_close(got, D.decode_attention_reference(q, kc, vc, valid, ks, vs,
                                                   **kw))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_decode_packed_rows_on_the_card(gen, quant):
    """The packed mixed step (8 decode rows + one slot's 32-row chunk, a
    short final chunk of 20) against the dense `decode_mixed_rows` on the
    same state, a 2-layer decoder at head width 128: kernel D's Sq = 1 form
    over the decode rows and its chunk form over the admitting slot alone
    (the cache's slots folded into its layer axis) run once a layer; the
    hidden states and committed rows agree within bf16 rounding."""
    from emu_tpu_torch.bridge import cast_tree
    from emu_tpu_torch.config import LlamaConfig
    from emu_tpu_torch.models import llama
    from emu_tpu_torch.ops.layers import Init
    cfg = LlamaConfig(hidden_size=512, intermediate_size=1024,
                      num_hidden_layers=2, num_attention_heads=4,
                      vocab_size=97, extended_vocab_size=97,
                      max_position_embeddings=256)
    params = cast_tree(llama.init(cfg, Init(generator=torch.Generator()
                                            .manual_seed(0))),
                       "cuda", torch.bfloat16)
    b, total, q, admit, qlen = 8, 256, 32, 5, 20
    shape = (cfg.num_hidden_layers, b, cfg.kv_heads, total, cfg.head_dim)
    if quant:
        cache = dict(zip(("k", "k_scale"), _int8_planes(gen, *shape)))
        cache.update(zip(("v", "v_scale"), _int8_planes(gen, *shape)))
    else:
        cache = {n: randn(gen, *shape) for n in ("k", "v")}
    slots = torch.tensor([40, 7, 0, 130, 99, 200, 64, 250], device="cuda")
    sm = torch.arange(total, device="cuda")[None] < slots[:, None]
    pos = sm.sum(-1)
    dec, chunk = randn(gen, b, cfg.hidden_size), randn(gen, q,
                                                       cfg.hidden_size)
    chunk[qlen:] = 0
    grid = torch.zeros(b, q, cfg.hidden_size, device="cuda",
                       dtype=torch.bfloat16)
    grid[:, 0] = dec
    grid[admit] = chunk
    dense = {n: c.clone() for n, c in cache.items()}
    packed = {n: c.clone() for n, c in cache.items()}
    hd, _ = llama.decode_mixed_rows(params, cfg, dense, grid, slots, sm, pos)
    forms = dict(D.decode_attention.forms)
    hp, _ = llama.decode_packed_rows(params, cfg, packed,
                                     torch.cat([dec, chunk]), admit, slots,
                                     sm, pos)
    torch.cuda.synchronize()
    kind = "int8" if quant else "bf16"
    assert D.decode_attention.forms[kind] == forms[kind] + 2
    assert D.decode_attention.forms["chunk_" + kind] == \
        forms["chunk_" + kind] + 2
    others = [r for r in range(b) if r != admit]
    assert_close(hp[others], hd[others, 0])
    assert_close(hp[b:b + qlen], hd[admit, :qlen])
    for n in cache:
        got, want = packed[n].transpose(2, 3), dense[n].transpose(2, 3)
        cols = [(r, int(slots[r])) for r in others] + [
            (admit, int(slots[admit]) + j) for j in range(qlen)]
        for r, s in cols:
            if quant and n in ("k", "v"):
                diff = (got[:, r, s].float() - want[:, r, s].float()).abs()
                assert diff.max() <= 1, (n, r, s)
            else:
                assert_close(got[:, r, s], want[:, r, s])


@pytest.mark.parametrize("qn,quant", [(1, False), (1, True), (8, False),
                                      (8, True)])
def test_paged_decode_attention_kernel(gen, qn, quant):
    """Kernel D over a shuffled page table (pages of 16, a chunk of 64
    positions straddles four pages)."""
    n_layers, n_pages, page, p_count, b, h, hkv, d = 2, 40, 16, 9, 3, 4, 4, 128
    pool = (n_layers, n_pages, hkv, page, d)
    if quant:
        kc, _ = _int8_planes(gen, *pool)
        vc, _ = _int8_planes(gen, *pool)
        ks, vs = (torch.rand(n_layers, b, hkv, p_count * page, device="cuda",
                             generator=gen) * 0.02 + 0.005 for _ in range(2))
    else:
        kc, vc = randn(gen, *pool), randn(gen, *pool)
        ks = vs = None
    table = torch.randperm(n_pages, device="cuda", generator=gen)[
        :b * p_count].reshape(b, p_count).int()
    q = randn(gen, b, qn, h, d)
    kn, vn = randn(gen, b, hkv, qn, d), randn(gen, b, hkv, qn, d)
    valid = torch.rand(b, p_count * page, device="cuda", generator=gen) > 0.2
    kw = dict(scale=d ** -0.5, k_scale=ks, v_scale=vs, layer=1, k_new=kn,
              v_new=vn)
    got = launched(D.paged_decode_attention,
                   lambda: D.paged_decode_attention(q, kc, vc, table, valid,
                                                    **kw))
    assert_close(got, D.paged_decode_attention_reference(q, kc, vc, table,
                                                         valid, **kw))


@pytest.mark.parametrize("b,h,hkv,s,d,qn,quant,extra,mask", [
    (3, 4, 4, 1000, 128, 1, False, True, "ragged"),   # S % 32 != 0
    (3, 4, 4, 1000, 128, 1, True, True, "ragged"),
    (2, 8, 8, 1024, 128, 1, True, True, "prefix40"),  # masked splits
    (2, 8, 8, 1024, 128, 1, True, False, "prefix40"),
    (2, 8, 8, 1024, 64, 1, False, False, "row_empty"),
    (2, 8, 8, 1024, 64, 1, False, True, "row_empty"),
    (1, 52, 52, 1024, 128, 5, False, True, "ragged"),  # B 1 verify
    (1, 52, 52, 1024, 128, 5, True, True, "prefix40"),
    (2, 4, 4, 300, 128, 32, True, True, "ragged"),     # qn 32
    (2, 4, 4, 300, 64, 32, False, True, "row_empty"),
    (2, 16, 2, 500, 128, 1, False, True, "ragged"),    # rep 8 GQA
    (2, 16, 2, 500, 128, 4, True, True, "ragged"),
    (2, 32, 2, 200, 64, 1, False, False, "row_empty"),  # rep 16: mma, Sq 1
    (8, 52, 52, 1024, 128, 1, True, True, "engine"),   # 16-264 of 1024
])
def test_decode_attention_split_plans(gen, b, h, hkv, s, d, qn, quant, extra,
                                      mask):
    """Kernel D's split designs at their plans' edges: S not a multiple of
    the chunk, splits whose chunks are all masked (with k_new, and without
    it in a row that has a valid position: left unread), a row with no
    valid position and no k_new (the uniform average over all S, merged
    over splits), the B 1 verify, 32 queries, GQA rep 8 (and rep 16 at Sq 1:
    the mma kernel), int8, D 64 and 128, the engine's occupancy; against
    the twin, the same bits twice, counted under decode_plan's kernel."""
    q = randn(gen, b, qn, h, d)
    if quant:
        kc, ks = _int8_planes(gen, 2, b, hkv, s, d)
        vc, vs = _int8_planes(gen, 2, b, hkv, s, d)
    else:
        kc, vc = randn(gen, 2, b, hkv, s, d), randn(gen, 2, b, hkv, s, d)
        ks = vs = None
    kn = randn(gen, b, qn, hkv, d).transpose(1, 2) if extra else None
    vn = randn(gen, b, qn, hkv, d).transpose(1, 2) if extra else None
    pos = torch.arange(s, device="cuda")[None, :]
    if mask == "prefix40":
        valid = (pos < 40).expand(b, s).contiguous()
    elif mask == "engine":
        lens = torch.tensor([16, 40, 64, 100, 150, 200, 240, 264][:b],
                            device="cuda")
        valid = pos < lens[:, None]
    else:
        valid = torch.rand(b, s, device="cuda", generator=gen) > 0.3
        if mask == "row_empty":
            valid[0] = False
    kw = dict(scale=d ** -0.5, layer=1, k_new=kn, v_new=vn)
    plan = D.decode_plan(b, hkv, h // hkv, qn, s, d, kc.element_size())
    before = D.decode_attention.plans[plan["kernel"]]
    got = launched(D.decode_attention,
                   lambda: D.decode_attention(q, kc, vc, valid, ks, vs, **kw))
    assert plan["kernel"] in ("rows", "mma")
    assert D.decode_attention.plans[plan["kernel"]] == before + 1
    assert_close(got, D.decode_attention_reference(q, kc, vc, valid, ks, vs,
                                                   **kw))
    assert torch.equal(got, D.decode_attention(q, kc, vc, valid, ks, vs,
                                               **kw))


@pytest.mark.parametrize("qn", [1, 5, 32])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_matches_dense_bit_for_bit(gen, quant, qn):
    """The page pool takes the split kernels through the page table, the row
    kernel at Sq = 1 and the mma kernel for the chunk forms: the same cache
    laid out in shuffled pages of 16 gives the dense cache's output bit for
    bit (the paged lane's contract with the dense engine), over every plan
    split of a 144-slot cache whose last chunk runs past the table's end."""
    n_layers, b, hkv, d, page, per_row = 2, 3, 52, 128, 16, 9
    s = page * per_row
    if quant:
        kd, ks = _int8_planes(gen, n_layers, b, hkv, s, d)
        vd, vs = _int8_planes(gen, n_layers, b, hkv, s, d)
    else:
        kd = randn(gen, n_layers, b, hkv, s, d)
        vd = randn(gen, n_layers, b, hkv, s, d)
        ks = vs = None
    n_pages = b * per_row + 5
    table = torch.randperm(n_pages, device="cuda", generator=gen)[
        :b * per_row].reshape(b, per_row).int()
    pools = []
    for dense in (kd, vd):
        pool = torch.zeros(n_layers, n_pages, hkv, page, d, device="cuda",
                           dtype=dense.dtype)
        for r in range(b):
            for p in range(per_row):
                pool[:, table[r, p]] = dense[:, r, :, p * page:(p + 1) * page]
        pools.append(pool)
    q = randn(gen, b, qn, hkv, d)
    kn, vn = randn(gen, b, hkv, qn, d), randn(gen, b, hkv, qn, d)
    valid = torch.arange(s, device="cuda")[None] < torch.tensor(
        [64, 70, 143], device="cuda")[:, None]
    kw = dict(scale=d ** -0.5, layer=1, k_new=kn, v_new=vn)
    dense_out = D.decode_attention(q, kd, vd, valid, ks, vs, **kw)
    plan = "rows" if qn == 1 else "mma"
    before = D.paged_decode_attention.plans[plan]
    paged_out = launched(D.paged_decode_attention,
                         lambda: D.paged_decode_attention(
                             q, pools[0], pools[1], table, valid, k_scale=ks,
                             v_scale=vs, **kw))
    assert D.paged_decode_attention.plans[plan] == before + 1
    assert torch.equal(paged_out, dense_out)


def test_decode_attention_refuses_unmet_constraints(gen):
    q = randn(gen, 1, 33, 4, 128)
    kc = randn(gen, 1, 1, 4, 64, 128)
    kn = randn(gen, 1, 4, 33, 128)
    valid = torch.ones(1, 64, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError):        # more than 32 queries
        D.decode_attention(q, kc, kc, valid, scale=1.0, layer=0, k_new=kn,
                           v_new=kn)
    with pytest.raises(ValueError):        # Sq > 1 without k_new
        D.decode_attention(q[:, :4], kc, kc, valid, scale=1.0, layer=0)


def _blind_rows(valid, sq, skv, causal):
    """[B, Sq] rows that see no valid key."""
    first = torch.where(valid.any(1), valid.float().argmax(1),
                        torch.full_like(valid[:, 0], skv, dtype=torch.long))
    rows = torch.arange(sq, device=valid.device)[None]
    lim = rows + (skv - sq) if causal else torch.full_like(rows, skv - 1)
    return lim < first[:, None]


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal", [
    (2, 4, 4, 200, 200, 128, True),     # tile skip; blocks with blind rows
    (2, 4, 2, 70, 300, 64, True),       # Sq < Skv, GQA
    (1, 2, 2, 130, 130, 88, False),
    (2, 2, 2, 300, 300, 40, True),
    (1, 2, 1, 130, 260, 80, True),
    (2, 2, 2, 200, 200, 112, False)])
def test_attention_lse_kernel(gen, b, h, hkv, sq, skv, d, causal):
    """Kernel A with its lse output (and the causal tile skip) against the
    twin; the lse on the rows that see a key within 1e-3, and on the rows
    that see none (-1e30 + log Skv) to the bit."""
    q = randn(gen, b, h, sq, d)
    k, v = randn(gen, b, hkv, skv, d), randn(gen, b, hkv, skv, d)
    valid = torch.arange(skv, device="cuda")[None] >= (
        torch.arange(b, device="cuda")[:, None] * 90)
    args = (q, k, v, None, None, valid, d ** -0.5, causal, True)
    out, lse = launched(A.attention, lambda: A._attention_fwd(*args))
    ref, rlse = A.attention_reference(q, k, v, kv_valid=valid,
                                      scale=d ** -0.5, causal=causal,
                                      with_lse=True)
    assert_close(out, ref)
    seen = ~_blind_rows(valid, sq, skv, causal)[:, None].expand(-1, h, -1)
    assert_close(lse[seen], rlse[seen], tol=1e-3)
    assert torch.equal(lse[~seen], rlse[~seen])


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal", [
    (2, 4, 4, 200, 200, 128, True),
    (2, 4, 2, 70, 300, 64, True),
    (1, 2, 1, 130, 130, 88, False),
    (2, 2, 2, 1024, 1024, 64, True),    # the train length, a left-padded row
    (2, 2, 2, 1024, 1024, 128, True),
    (2, 2, 1, 300, 170, 40, True),      # Sq > Skv: blind rows (the diagonal)
    (1, 2, 2, 130, 333, 96, True),      # Sq != Skv, ragged on the 128-row tile
    (1, 4, 2, 257, 257, 128, False),    # GQA rep 2
    (1, 2, 2, 4096, 4096, 128, True)])  # 4096 causal keys
def test_attention_backward_kernels(gen, b, h, hkv, sq, skv, d, causal):
    """The dQ and dK/dV kernels against the twin (left-padded kv_valid, rows
    that see no key, GQA, D = 40-128, Sq != Skv both ways); dQ and dK/dV the
    same bits on a second run; the autograd Function reaches them."""
    q = randn(gen, b, h, sq, d)
    k, v = randn(gen, b, hkv, skv, d), randn(gen, b, hkv, skv, d)
    do = randn(gen, b, h, sq, d)
    valid = torch.arange(skv, device="cuda")[None] >= (
        torch.arange(b, device="cuda")[:, None] * 90)
    o, lse = A._attention_fwd(q, k, v, None, None, valid, d ** -0.5, causal,
                              True)
    kw = dict(scale=d ** -0.5, causal=causal)
    dq, d_row = launched(A.attention_bwd_dq, lambda: A.attention_bwd_dq(
        q, k, v, o, lse, do, valid, **kw))
    dk, dv = launched(A.attention_bwd_dkv, lambda: A.attention_bwd_dkv(
        q, k, v, lse, do, d_row, valid, **kw))
    ref = A.attention_bwd_reference(q, k, v, o, lse, do, valid, **kw)
    for got, r in zip((dq, dk, dv), ref):
        assert_close_blocks(got, r)
    again = A.attention_bwd_dkv(q, k, v, lse, do, d_row, valid, **kw)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
    assert torch.equal(A.attention_bwd_dq(q, k, v, o, lse, do, valid,
                                          **kw)[0], dq)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = A.attention_bwd_dkv.launches
    out = A.attention(*leaves, kv_valid=valid, **kw)
    out.backward(do)
    assert A.attention_bwd_dkv.launches == before + 1
    for leaf, r in zip(leaves, ref):
        assert_close_blocks(leaf.grad, r)


@pytest.mark.parametrize("rows,w,add,w_fp32,kernel", [
    (37, 5120, True, False, "rows"),
    (300, 1000, False, False, "rows"),    # 32 threads a row, 8 rows a step
    (2048, 5120, True, True, "rows"),     # fp32 w, read as stored
    (1001, 5120, False, True, "rows"),    # ragged: half a step, short runs
    (1001, 6656, True, False, "rows"),    # a 2-step ring
    (300, 1001, True, True, "any"),       # W % 8 != 0: the scalar kernel
    (5, 16392, False, False, "any"),      # wider than the row kernel holds
])
def test_rmsnorm_backward_kernel(gen, rows, w, add, w_fp32, kernel):
    """The norm backward against its twin, on the kernel its plan names;
    dx and dw the same bits twice."""
    assert C.norm_bwd_plan(rows, w)["kernel"] == kernel
    x, r = randn(gen, rows, w), (randn(gen, rows, w) if add else None)
    wt = 1 + randn(gen, w, std=0.1)
    if w_fp32:
        wt = 1 + torch.randn(w, device="cuda", generator=gen) * 0.1
    y, _, rsig = C.rmsnorm_fwd(wt, x, r)
    dh, dy = randn(gen, rows, w), (randn(gen, rows, w) if add else None)
    dx, dw = launched(C.rmsnorm_bwd, lambda: C.rmsnorm_bwd(y, wt, rsig, dh,
                                                           dy))
    assert dw.dtype == wt.dtype
    rdx, rdw = C.rmsnorm_bwd_reference(y, wt, rsig, dh, dy)
    assert_close_blocks(dx, rdx)
    assert_close_blocks(dw, rdw)
    again = C.rmsnorm_bwd(y, wt, rsig, dh, dy)
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])


@pytest.mark.parametrize("w", [4096, 5120])
def test_rmsnorm_unaligned_rows_take_the_scalar_kernels(gen, w):
    """Rows cut from a buffer one element in are not 16-byte aligned: the
    host's row rule (`row_tpr`) sends the forward and the backward alike to
    their scalar kernels, which match their twins."""
    rows = 5
    x = randn(gen, rows * w + 1)[1:].view(rows, w)
    dh = randn(gen, rows * w + 1)[1:].view(rows, w)
    assert x.data_ptr() % 16 and C.row_tpr(w, False) == 0
    assert C.norm_bwd_plan(rows, w, aligned=False)["kernel"] == "any"
    wt = 1 + randn(gen, w, std=0.1)
    _, h, rsig = launched(C.rmsnorm_fwd, lambda: C.rmsnorm_fwd(wt, x))
    ref = C.rmsnorm_reference(wt, x)
    assert_close(h, ref[1])
    assert_close(rsig, ref[2], tol=1e-5)
    dx, dw = launched(C.rmsnorm_bwd, lambda: C.rmsnorm_bwd(x, wt, rsig, dh))
    rdx, rdw = C.rmsnorm_bwd_reference(x, wt, rsig, dh)
    assert_close_blocks(dx, rdx)
    assert_close_blocks(dw, rdw)


def test_inference_kernels_refuse_grad_on_card(gen):
    """Kernel B has no backward: with inputs that require grad it raises
    instead of returning a tensor that cuts the graph."""
    x = randn(gen, 4, 32)
    w = randn(gen, 32, 32).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        B.fused_mlp(x, w, None, w, None)
    with torch.no_grad():
        B.fused_mlp(x, w, None, w, None)


@pytest.mark.parametrize("b,s,h,d", [
    (2, 1024, 4, 64), (2, 130, 3, 40), (1, 257, 2, 80), (2, 64, 2, 160),
    (1, 257, 2, 256), (3, 1, 2, 64)] + [
    (2, s, 2, d) for d in MHA_D for s in MHA_S])
def test_batched_mha_kernel(gen, b, s, h, d):
    """Token-major [B, S, H, D] strided views of a [B, S, 3, H, D]
    projection, ragged S, every padded width D up to 256, B > 1."""
    qkv = randn(gen, b, s, 3, h, d)
    q, k, v = qkv.unbind(2)
    got = launched(A.batched_mha, lambda: A.batched_mha(q, k, v,
                                                        scale=d ** -0.5))
    assert got.shape == (b, s, h, d)
    assert_close(got, A.batched_mha_reference(q, k, v, scale=d ** -0.5))


def test_batched_mha_refuses_unmet_constraints(gen):
    x = randn(gen, 1, 64, 2, 264)
    with pytest.raises(ValueError):
        A.batched_mha(x, x, x)
    with pytest.raises(ValueError):
        A.batched_mha(x.float()[..., :64], x.float()[..., :64],
                      x.float()[..., :64])
    y = randn(gen, 1, 64, 2, 64).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        A.batched_mha(y, y, y)
    z = randn(gen, 1, 64, 1, 64).expand(2, 64, 2, 64)   # broadcast: no map
    with pytest.raises(ValueError, match="broadcasts"):
        A.batched_mha(z, z, z)


def test_unet_attention_routes_on_the_card(gen):
    """The diffusion attention's dispatch on CUDA tensors: 1024- and
    4096-token self-attention launch batched_mha (the edge the card
    measured), longer self-attention and the 64-key cross-attention kernel
    A."""
    from emu_tpu_torch.ops import attention as att
    with torch.no_grad():
        x = randn(gen, 2, 1024, 4, 64)
        launched(A.batched_mha, lambda: att.dot_product_attention(x, x, x))
        y = randn(gen, 1, 4096, 2, 64)
        launched(A.batched_mha, lambda: att.dot_product_attention(y, y, y))
        z = randn(gen, 1, 4160, 2, 64)
        launched(A.attention, lambda: att.dot_product_attention(z, z, z))
        c = randn(gen, 1, 64, 2, 64)
        out = launched(A.attention, lambda: att.dot_product_attention(y, c, c))
        assert_close(out, att.grouped_attention(y, c, c, scale=64 ** -0.5))
