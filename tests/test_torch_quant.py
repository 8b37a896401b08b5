"""The port's quantization (emu_tpu_torch.ops.quant), quantized dense forms,
and the plain twins of kernels B (post-LN), E, F and G against the JAX
package: quantizers bit for bit, twins against the Pallas kernels run in
interpret mode at shapes where the JAX route rules pick them. Inputs come
from numpy seeds; fp32 unless a test says bf16.

Tolerances: fp32 2e-4 where the computation is the same up to summation
order. Kernels E and G re-quantize activations inside: an fp32 difference
in the last place (XLA's rsqrt or exp against torch's) can move an int8
value by one step (1/127 of its row's max) at a rounding tie, so their
outputs are compared at 2e-3 of max|ref|, a fraction of one such step."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from emu_tpu.ops import fused_mlp as jmlp
from emu_tpu.ops import layers as jlayers
from emu_tpu.ops import q4_matmul as jq4
from emu_tpu.ops import quant as jquant
from emu_tpu_torch import bridge
from emu_tpu_torch.ops import fused_mlp as mlp
from emu_tpu_torch.ops import layers as L
from emu_tpu_torch.ops import q4_matmul as q4
from emu_tpu_torch.ops import quant

TOL = 2e-4


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


def test_dense_bf16_bias_rounds_once_like_jax():
    """bf16 x @ W + b: the fp32 product plus the fp32 bias, one rounding —
    every element equal to the JAX `dense`."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rnd(rng, 64, 256), jnp.bfloat16)
    k = jnp.asarray(rnd(rng, 256, 128, scale=0.1), jnp.bfloat16)
    b = jnp.asarray(rnd(rng, 128, scale=3.0), jnp.bfloat16)
    ref = np.asarray(jlayers.dense({"kernel": k, "bias": b}, x), np.float32)

    def tb(a):
        return t(np.asarray(a, np.float32)).to(torch.bfloat16)

    out = L.dense({"kernel": tb(k), "bias": tb(b)}, tb(x))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), ref)


def test_quantizers_match_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    w = rnd(rng, 3, 512, 96)          # stacked: per-layer scales
    x = rnd(rng, 7, 512)
    # the JAX package quantizes inside jitted programs
    jq8 = jax.jit(jquant.quantize_kernel)(jnp.asarray(w))
    q8 = quant.quantize_kernel(t(w))
    np.testing.assert_array_equal(q8["kernel_q8"].numpy(), jq8["kernel_q8"])
    np.testing.assert_array_equal(q8["scale"].numpy(), jq8["scale"])
    jq4p = jax.jit(jquant.quantize_kernel_int4)(jnp.asarray(w[0]))
    q4p = quant.quantize_kernel_int4(t(w[0]))
    assert q4p["kernel_q4"].dtype == torch.int8
    np.testing.assert_array_equal(q4p["kernel_q4"].numpy(), jq4p["kernel_q4"])
    np.testing.assert_array_equal(q4p["scale4"].numpy(), jq4p["scale4"])
    np.testing.assert_array_equal(
        quant.dequantize_int4(q4p, torch.float32).numpy(),
        jquant.dequantize_int4(jq4p, jnp.float32))
    jxq, jsx = jax.jit(jquant.quantize_activations)(jnp.asarray(x))
    xq, sx = quant.quantize_activations(t(x))
    np.testing.assert_array_equal(xq.numpy(), jxq)
    np.testing.assert_array_equal(sx.numpy(), jsx)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_model_params_matches_jax(mode):
    """The serving recipe on an Emu2-shaped tree (decoder + visual): the
    same leaves, dtypes and values as the JAX package's."""
    rng = np.random.default_rng(2)
    tree = {
        "visual": {"blocks": {
            "attn": {"qkv": {"kernel": rnd(rng, 2, 64, 192)},
                     "proj": {"kernel": rnd(rng, 2, 64, 64),
                              "bias": rnd(rng, 2, 64)}},
            "mlp": {"fc1": {"kernel": rnd(rng, 2, 64, 256),
                            "bias": rnd(rng, 2, 256)},
                    "fc2": {"kernel": rnd(rng, 2, 256, 64)}},
            "norm1": {"scale": rnd(rng, 2, 64), "bias": rnd(rng, 2, 64)}},
            "patch_embed": {"kernel": rnd(rng, 588, 64)}},
        "decoder": {
            "layers": {"self_attn": {"qkv_proj": {"kernel": rnd(rng, 2, 256, 768)},
                                     "o_proj": {"kernel": rnd(rng, 2, 256, 256)}},
                       "mlp": {"gate_up": {"kernel": rnd(rng, 2, 256, 1024)},
                               "down": {"kernel": rnd(rng, 2, 512, 256)}},
                       "input_layernorm": rnd(rng, 2, 256)},
            "embed_tokens": rnd(rng, 50, 256),
            "lm_head": {"kernel": rnd(rng, 256, 50)}},
    }
    ref = bridge.flatten(jax.tree.map(np.asarray, jax.jit(
        lambda p: jquant.quantize_model_params(p, mode))(
            jax.tree.map(jnp.asarray, tree))))
    out = bridge.flatten(quant.quantize_model_params(
        bridge.unflatten({k: t(v) for k, v in bridge.flatten(tree).items()}),
        mode))
    assert sorted(out) == sorted(ref)
    for k, v in ref.items():
        assert str(out[k].dtype).split(".")[-1] == str(v.dtype), k
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("form", ["kernel_q8", "kernel_w8a8", "kernel_q4"])
def test_quantized_dense_matches_jax(form):
    """The quantized dense forms off the kernel routes (the int4 group of
    64 rows declines `q4_plan`, so both packages dequantize)."""
    rng = np.random.default_rng(3)
    x, w, b = rnd(rng, 2, 5, 128), rnd(rng, 128, 40, scale=0.1), rnd(rng, 40)
    jw = jnp.asarray(w)
    if form == "kernel_q4":
        p = jquant.quantize_kernel_int4(jw, group_size=64)
    else:
        q = jquant.quantize_kernel(jw)
        p = {form: q["kernel_q8"], "scale": q["scale"]}
    p["bias"] = jnp.asarray(b)
    ref = jlayers.dense(p, jnp.asarray(x))
    out = L.dense({k: t(v) for k, v in p.items()}, t(x))
    close(out, ref)


def test_fused_mlp_post_ln_bf16_twin_matches_pallas():
    """Kernel B's post-LN form (the bf16 EVA-4B block), bf16 in and out:
    within two bf16 steps of the output scale (0.03 * (1 + max|ref|))."""
    rng = np.random.default_rng(4)
    k, f = 64, 256
    bf = jnp.bfloat16
    x = jnp.asarray(rnd(rng, 2, 9, k), bf)
    w1, b1 = jnp.asarray(rnd(rng, k, f, scale=0.2), bf), jnp.asarray(
        rnd(rng, f, scale=0.1), bf)
    w2, b2 = jnp.asarray(rnd(rng, f, k, scale=0.2), bf), jnp.asarray(
        rnd(rng, k, scale=0.1), bf)
    lns, lnb = jnp.asarray(1 + rnd(rng, k, scale=0.1), bf), jnp.asarray(
        rnd(rng, k, scale=0.1), bf)
    kw = dict(ln_mode="post", residual=True)
    ref = np.asarray(jmlp.fused_mlp(x, w1, b1, w2, b2, None, None, lns, lnb,
                                    bm=8, bf=128, interpret=True, **kw),
                     np.float32)

    def tb(a):
        return t(np.asarray(a, np.float32)).to(torch.bfloat16)

    out = mlp.fused_mlp(tb(x), tb(w1), tb(b1), tb(w2), tb(b2), None, None,
                        tb(lns), tb(lnb), **kw)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 0.03 * (1 + np.abs(ref).max()), err


def _w8a8_weights(rng, k, f, n):
    q1 = jquant.quantize_kernel(jnp.asarray(rnd(rng, k, f, scale=0.2)))
    q2 = jquant.quantize_kernel(jnp.asarray(rnd(rng, f, n, scale=0.2)))
    return (q1["kernel_q8"], q1["scale"], jnp.asarray(rnd(rng, f, scale=0.1)),
            q2["kernel_q8"], q2["scale"], jnp.asarray(rnd(rng, n, scale=0.1)))


@pytest.mark.parametrize("ln_mode", ["pre", "post"])
def test_fused_mlp_w8a8_twin_matches_pallas(ln_mode):
    """Kernel E at the rows where the JAX package runs it (M >= 2048,
    ragged against its 256-row blocks), hidden blocks of 768 (two blocks,
    each re-quantized per row on its own); 2e-3 of max|ref|."""
    rng = np.random.default_rng(5)
    m, k, f = 2050, 64, 1536
    x = rnd(rng, m, k)
    ws = _w8a8_weights(rng, k, f, k)
    lns, lnb = 1 + rnd(rng, k, scale=0.1), rnd(rng, k, scale=0.1)
    kw = dict(ln_mode=ln_mode, residual=True)
    ref = np.asarray(jmlp.fused_mlp_w8a8(
        jnp.asarray(x), *ws, jnp.asarray(lns), jnp.asarray(lnb), bm=256,
        bf=768, interpret=True, **kw))
    out = mlp.fused_mlp_w8a8(t(x), *[t(a) for a in ws], t(lns), t(lnb),
                             bf=768, **kw)
    err = np.abs(out.numpy() - ref).max()
    assert err <= 2e-3 * np.abs(ref).max(), err
    # the per-block requant is what the unfused route does NOT do
    whole = mlp.fused_mlp_w8a8(t(x), *[t(a) for a in ws], t(lns), t(lnb),
                               bf=f, **kw)
    assert not torch.equal(whole, out)


@pytest.mark.parametrize("m,n", [(5, 200), (40, 256), (16, 200),
                                 (17, 256)])
def test_matmul_q4_twin_matches_pallas(m, n):
    """Kernel F: groups of 128, ragged N (as the lm_head's 32274), bias;
    16 and 17 rows sit at both sides of the first version's plan edge."""
    rng = np.random.default_rng(6)
    k = 512
    p = jquant.quantize_kernel_int4(jnp.asarray(rnd(rng, k, n, scale=0.1)))
    x, b = rnd(rng, m, k), rnd(rng, n, scale=0.1)
    ref = jq4.matmul_q4(jnp.asarray(x), p["kernel_q4"], p["scale4"],
                        jnp.asarray(b), interpret=True)
    out = q4.matmul_q4(t(x), t(p["kernel_q4"]), t(p["scale4"]), t(b))
    close(out, ref)


@pytest.mark.parametrize("m", [1, 5])
def test_fused_swiglu_q4_twin_matches_pallas(m):
    """Kernel G: D 256, F 1536 (hidden block 384: two blocks per half);
    2e-3 of max|ref|."""
    rng = np.random.default_rng(7)
    d, f = 256, 1536
    gu = jquant.quantize_kernel_int4(jnp.asarray(rnd(rng, d, 2 * f,
                                                     scale=0.2)))
    dn = jquant.quantize_kernel_int4(jnp.asarray(rnd(rng, f, d, scale=0.2)))
    x, w = rnd(rng, m, d), 1 + rnd(rng, d, scale=0.1)
    args = (gu["kernel_q4"], gu["scale4"], dn["kernel_q4"], dn["scale4"])
    ref = np.asarray(jq4.fused_swiglu_q4(jnp.asarray(x), jnp.asarray(w),
                                         *args, interpret=True))
    out = q4.fused_swiglu_q4(t(x), t(w), *[t(a) for a in args])
    err = np.abs(out.numpy() - ref).max()
    assert err <= 2e-3 * np.abs(ref).max(), err


def test_swiglu_hidden_block_snaps_as_jax():
    """bf 384 snaps to 256 at Emu2-33B's F = 17920 (F/2 = 8960)."""
    assert q4.snap_bf(384, 17920, 128) == 256
    assert q4.snap_bf(384, 1536, 128) == 384


def test_route_plans_match_jax_rules():
    """The port's plans are the JAX package's rules minus its backend
    test: decided by rows, groups and layouts."""
    p = {"kernel_q4": torch.zeros(128, 64, dtype=torch.int8),
         "scale4": torch.zeros(2, 64)}
    assert q4.q4_plan(p, torch.zeros(4, 256, 256))
    assert not q4.q4_plan(p, torch.zeros(1025, 256))
    p64 = {"kernel_q4": torch.zeros(128, 64, dtype=torch.int8),
           "scale4": torch.zeros(4, 64)}          # 64-row groups
    assert not q4.q4_plan(p64, torch.zeros(4, 256))
    mlp_p = {"gate_up": {"kernel_q4": torch.zeros(128, 512, dtype=torch.int8),
                         "scale4": torch.zeros(2, 512)},
             "down": {"kernel_q4": torch.zeros(128, 256, dtype=torch.int8),
                      "scale4": torch.zeros(2, 256)}}
    w = torch.ones(256)
    assert q4.swiglu_q4_plan(w, mlp_p, torch.zeros(5, 1, 256))
    assert not q4.swiglu_q4_plan(w, mlp_p, torch.zeros(33, 256))
    wq = {"fc1": {"kernel_w8a8": torch.zeros(64, 256, dtype=torch.int8)},
          "fc2": {"kernel_w8a8": torch.zeros(256, 64, dtype=torch.int8)}}
    assert L.w8a8_mlp_plan(wq, torch.zeros(2, 1025, 64,
                                           dtype=torch.bfloat16)) == 768
    assert L.w8a8_mlp_plan(wq, torch.zeros(1, 1025, 64,
                                           dtype=torch.bfloat16)) is None
    assert L.w8a8_mlp_plan(wq, torch.zeros(2, 1025, 64)) is None   # fp32


NEW_WRAPPERS = [mlp.fused_mlp_w8a8, q4.matmul_q4, q4.fused_swiglu_q4]


def test_new_wrappers_do_not_launch_on_cpu_and_refuse_meta():
    for w in NEW_WRAPPERS:
        w.launches = 0
    rng = np.random.default_rng(8)
    gu = quant.quantize_kernel_int4(t(rnd(rng, 256, 512)))
    dn = quant.quantize_kernel_int4(t(rnd(rng, 256, 256)))
    x = t(rnd(rng, 3, 256))
    q4.matmul_q4(x, gu["kernel_q4"], gu["scale4"])
    q4.fused_swiglu_q4(x, torch.ones(256), gu["kernel_q4"], gu["scale4"],
                       dn["kernel_q4"], dn["scale4"])
    w1, w2 = quant.quantize_kernel(t(rnd(rng, 256, 256))), \
        quant.quantize_kernel(t(rnd(rng, 256, 256)))
    mlp.fused_mlp_w8a8(x, w1["kernel_q8"], w1["scale"], None,
                       w2["kernel_q8"], w2["scale"], None, bf=128)
    assert [w.launches for w in NEW_WRAPPERS] == [0, 0, 0]
    meta = torch.zeros(3, 256, device="meta")
    with pytest.raises(ValueError):
        q4.matmul_q4(meta, gu["kernel_q4"], gu["scale4"])
