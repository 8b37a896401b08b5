"""The port's CUDA kernels against their plain twins, on the card (bf16).

These need a CUDA card and `nvcc`, and skip without a card. They import no
jax, so on a machine without it run them with the JAX test harness left
out:  python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
Edge shapes here (ragged rows and columns, D = 64/88/128, GQA, no biases,
both tile configurations of the int8 GEMM) complement chip_smoke.py, which
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
    """Also: the same bits on a second run (the hidden-dim splits are summed
    in a fixed order)."""
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
    with pytest.raises(NotImplementedError):
        B.fused_mlp(x, w, None, w, None, w, None, activation="swiglu")


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


@pytest.mark.parametrize("m,k,n,bias", [(5, 512, 200, True),
                                        (40, 1024, 256, False),
                                        (3, 768, 32274, False)])
def test_matmul_q4_kernel(gen, m, k, n, bias):
    """Kernel F: decode (16-row tiles, K split) and prefill (64-row tiles)
    shapes, ragged N as the lm_head's 32274, groups of 128 and 384; the
    same bits on a second run."""
    gs = 384 if k == 768 else 128
    p = Q.quantize_kernel_int4(randn(gen, k, n, std=0.05), group_size=gs)
    x, b = randn(gen, m, k), (randn(gen, n) if bias else None)
    got = launched(Q4.matmul_q4,
                   lambda: Q4.matmul_q4(x, p["kernel_q4"], p["scale4"], b))
    assert_close(got, Q4.matmul_q4_reference(x, p["kernel_q4"], p["scale4"],
                                             b))
    # at decode rows K is split; the splits are summed in a fixed order
    assert torch.equal(got, Q4.matmul_q4(x, p["kernel_q4"], p["scale4"], b))


@pytest.mark.parametrize("m", [1, 5, 32])
def test_fused_swiglu_q4_kernel(gen, m):
    """Kernel G at D 256, F 1536 (hidden block 384, two per half)."""
    gu = Q.quantize_kernel_int4(randn(gen, 256, 3072, std=0.1))
    dn = Q.quantize_kernel_int4(randn(gen, 1536, 256, std=0.1))
    args = (gu["kernel_q4"], gu["scale4"], dn["kernel_q4"], dn["scale4"])
    x, w = randn(gen, m, 256), 1 + randn(gen, 256, std=0.1)
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


@pytest.mark.parametrize("rows,w,add", [(3, 4096, True), (5, 1000, False)])
def test_rmsnorm_kernel(gen, rows, w, add):
    x, r = randn(gen, rows, w), (randn(gen, rows, w) if add else None)
    wt = randn(gen, w)
    got = launched(C.rmsnorm_fwd, lambda: C.rmsnorm_fwd(wt, x, r))
    ref = C.rmsnorm_reference(wt, x, r)
    assert torch.equal(got[0], ref[0])
    assert_close(got[1], ref[1])
    assert_close(got[2], ref[2], tol=1e-5)


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
