"""The port's kernel wrappers on CPU tensors (their plain twins) against the
JAX Pallas kernels run in interpret mode, fp32, tolerance 2e-4."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from emu_tpu.ops import attention as jatt
from emu_tpu.ops import decode_attention as jdec
from emu_tpu.ops import flash_attention as jfa
from emu_tpu.ops import fused_mlp as jmlp
from emu_tpu.ops import fused_norm as jnorm
from emu_tpu_torch.ops import attention as att
from emu_tpu_torch.ops import decode_attention as dec
from emu_tpu_torch.ops import flash_attention as fa
from emu_tpu_torch.ops import fused_mlp as mlp
from emu_tpu_torch.ops import fused_norm as norm

TOL = 2e-4
WRAPPERS = [fa.attention, mlp.fused_mlp, norm.rmsnorm_fwd,
            dec.decode_attention]


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("s,h,d", [(13, 2, 16), (37, 3, 8)])
def test_mha_bhsd_twin_matches_pallas(s, h, d):
    rng = np.random.default_rng(0)
    q, k, v = (rnd(rng, 2, h, s, d) for _ in range(3))
    qb, vb = rnd(rng, h, d, scale=0.5), rnd(rng, h, d, scale=0.5)
    s_pad = jfa.bhsd_plan(h, d, s, 4)[2]
    pad = lambda a: jnp.asarray(np.pad(a, ((0, 0), (0, 0), (0, s_pad - s),
                                           (0, 0))))
    ref = jfa.mha_bhsd(pad(q), pad(k), pad(v), jnp.asarray(qb),
                       jnp.asarray(vb), scale=d ** -0.5, s_real=s,
                       interpret=True)[:, :, :s]
    out = fa.mha_bhsd(t(q), t(k), t(v), t(qb), t(vb), scale=d ** -0.5)
    close(out, ref)


@pytest.mark.parametrize("sq,skv,hkv,causal", [
    pytest.param(16, 16, 2, True, id="16-16-2"),
    pytest.param(8, 24, 2, True, id="8-24-2"),
    pytest.param(16, 16, 1, True, id="16-16-1"),
    pytest.param(40, 8, 2, False, id="40-8-2-noncausal")])
def test_flash_attention_twin_matches_pallas(sq, skv, hkv, causal):
    """Causal (end-aligned) + left-padded kv_valid; GQA (hkv < h) against
    the JAX grouped path, MHA also against the Pallas kernel; and the
    UNets' form, non-causal with Sq >> Skv (latent queries against a few
    conditioning keys)."""
    rng = np.random.default_rng(1)
    b, h, d = 2, 2, 32
    q = rnd(rng, b, sq, h, d)
    k, v = rnd(rng, b, skv, hkv, d), rnd(rng, b, skv, hkv, d)
    valid = np.ones((b, skv), np.int32)
    valid[1, :5] = 0
    out = fa.flash_attention(t(q), t(k), t(v), kv_valid=t(valid),
                             scale=d ** -0.5, causal=causal)
    # the plain XLA path of the JAX package, every row (fully masked too)
    xla = (jatt._xla_attention if hkv == h else jatt._xla_attention_gqa)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None,
        jnp.asarray(valid), d ** -0.5, causal)
    close(out, xla)
    if hkv == h:
        ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), kv_valid=jnp.asarray(valid),
                                  scale=d ** -0.5, causal=causal,
                                  interpret=True)
        # rows with at least one visible key (the Pallas kernel's fully
        # masked rows are not defined to match)
        rows = (np.arange(sq) + (skv - sq) >= 5 if causal
                else np.ones(sq, bool))
        close(out[1][rows], np.asarray(ref)[1][rows])
        close(out[0], np.asarray(ref)[0])


@pytest.mark.parametrize("form", ["bias_broadcast", "mask_per_head",
                                  "mask_gqa", "mask_causal_kv_valid"])
def test_dense_bias_mask_attention_matches_jax(form):
    """The plain route of dot_product_attention (dense bias/mask forms, MHA
    and GQA) against the JAX package's XLA attention."""
    rng = np.random.default_rng(6)
    b, s, h, d = 2, 9, 4, 16
    hkv = 2 if form == "mask_gqa" else h
    q = rnd(rng, b, s, h, d)
    k, v = rnd(rng, b, s, hkv, d), rnd(rng, b, s, hkv, d)
    kw = {}
    if form == "bias_broadcast":
        kw["bias"] = rnd(rng, 1, h, s, s)
    elif form == "mask_per_head":
        kw["mask"] = rng.random((b, h, s, s)) > 0.3
    else:
        kw["mask"] = rng.random((b, 1, s, s)) > 0.3
    if form == "mask_causal_kv_valid":
        valid = np.ones((b, s), np.int32)
        valid[1, :3] = 0
        kw.update(kv_valid=valid, causal=True)
    ref = jatt.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()})
    out = att.dot_product_attention(
        t(q), t(k), t(v),
        **{n: t(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()})
    close(out, ref)


@pytest.mark.parametrize("activation,ln_mode,residual", [
    ("gelu", "pre", True), ("gelu", None, False), ("gelu", "post", True),
    ("swiglu", "pre", True)])
def test_fused_mlp_twin_matches_pallas(activation, ln_mode, residual):
    rng = np.random.default_rng(2)
    k, f = 32, 64
    x = rnd(rng, 2, 5, k)
    ws = [rnd(rng, k, f, scale=0.2), rnd(rng, f, scale=0.1)]
    if activation == "swiglu":
        ws += [rnd(rng, k, f, scale=0.2), rnd(rng, f, scale=0.1)]
    ws += [rnd(rng, f, k, scale=0.2), rnd(rng, k, scale=0.1)]
    if activation == "gelu":
        ws += [None, None]
    lns, lnb = 1 + rnd(rng, k, scale=0.1), rnd(rng, k, scale=0.1)
    kw = dict(activation=activation, ln_mode=ln_mode, residual=residual)
    ln = (lns, lnb) if ln_mode else (None, None)
    ref = jmlp.fused_mlp(
        jnp.asarray(x), *[None if a is None else jnp.asarray(a) for a in ws],
        *[None if a is None else jnp.asarray(a) for a in ln], bm=8, bf=32,
        interpret=True, **kw)
    out = mlp.fused_mlp(t(x), *[None if a is None else t(a) for a in ws],
                        *[None if a is None else t(a) for a in ln], **kw)
    close(out, ref)


def test_rmsnorm_twin_matches_pallas():
    rng = np.random.default_rng(3)
    x, r = rnd(rng, 3, 7, 256), rnd(rng, 3, 7, 256)
    w = 1 + rnd(rng, 256, scale=0.1)
    jy, jh = jnorm.add_rmsnorm(jnp.asarray(w), jnp.asarray(x), jnp.asarray(r),
                               1e-6, interpret=True)
    y, h = norm.add_rmsnorm(t(w), t(x), t(r), 1e-6)
    close(y, jy)
    close(h, jh)
    close(norm.rms_norm_fused(t(w), t(x), 1e-6),
          jnorm.rms_norm_fused(jnp.asarray(w), jnp.asarray(x), 1e-6,
                               interpret=True))
    _, _, rsig, _, _ = jnorm._norm_call(
        jnp.asarray(x.reshape(-1, 256)), jnp.asarray(r.reshape(-1, 256)),
        jnp.asarray(w), 1e-6, True, True)
    close(norm.rmsnorm_fwd(t(w), t(x), t(r), 1e-6)[2],
          np.asarray(rsig)[:21, 0])


def test_rmsnorm_twin_fp32_weight_matches_pallas():
    """bf16 activations with an fp32 weight, the LLaMA layers' case when a
    tree keeps its norms in fp32: the kernel reads w in its stored dtype and
    widens it, as the Pallas kernel does (`w_ref[...].astype(float32)`),
    never rounding it to bf16. The port's entry points (their twins here)
    against the Pallas kernels in interpret mode: y bit-equal, h within one
    bf16 rounding of each element, rsigma at 2e-4."""
    rng = np.random.default_rng(13)
    bf = jnp.bfloat16
    x, r = rnd(rng, 3, 7, 256), rnd(rng, 3, 7, 256)
    w = 1 + rnd(rng, 256, scale=0.1)
    jx, jr = jnp.asarray(x, bf), jnp.asarray(r, bf)
    tx, tr = t(x).bfloat16(), t(r).bfloat16()
    jy, jh = jnorm.add_rmsnorm(jnp.asarray(w), jx, jr, 1e-6, interpret=True)
    y, h = norm.add_rmsnorm(t(w), tx, tr, 1e-6)
    assert torch.equal(y.float(), t(np.asarray(jy, np.float32)))
    np.testing.assert_allclose(h.float().numpy(), np.asarray(jh, np.float32),
                               rtol=2 ** -7, atol=1e-6)
    jh2 = jnorm.rms_norm_fused(jnp.asarray(w), jx, 1e-6, interpret=True)
    np.testing.assert_allclose(
        norm.rms_norm_fused(t(w), tx, 1e-6).float().numpy(),
        np.asarray(jh2, np.float32), rtol=2 ** -7, atol=1e-6)
    _, _, rsig, _, _ = jnorm._norm_call(
        jx.reshape(-1, 256), jr.reshape(-1, 256), jnp.asarray(w), 1e-6,
        True, True)
    close(norm.rmsnorm_fwd(t(w), tx, tr, 1e-6)[2], np.asarray(rsig)[:21, 0])


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_decode_attention_twin_matches_pallas(h, hkv):
    """Stacked cache + layer index, ragged kv_valid, k_new/v_new column."""
    rng = np.random.default_rng(4)
    n_layers, b, s, d = 3, 2, 24, 32
    q = rnd(rng, b, 1, h, d)
    kc, vc = rnd(rng, n_layers, b, hkv, s, d), rnd(rng, n_layers, b, hkv, s, d)
    kn, vn = rnd(rng, b, hkv, 1, d), rnd(rng, b, hkv, 1, d)
    valid = np.arange(s)[None, :] < np.array([[9], [17]])
    ref = jdec.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(valid),
        scale=d ** -0.5, layer=jnp.int32(1), k_new=jnp.asarray(kn),
        v_new=jnp.asarray(vn), interpret=True)
    out = dec.decode_attention(t(q), t(kc), t(vc), t(valid), scale=d ** -0.5,
                               layer=1, k_new=t(kn), v_new=t(vn))
    close(out, ref)


def test_wrappers_do_not_launch_on_cpu():
    """CPU tensors take the plain twin: no launch is counted."""
    for w in WRAPPERS:
        w.launches = 0
    rng = np.random.default_rng(5)
    x = t(rnd(rng, 2, 3, 16, 8))
    fa.attention(x, x, x, scale=0.5, causal=True)
    mlp.fused_mlp(x, t(rnd(rng, 8, 16)), None, t(rnd(rng, 16, 8)), None)
    norm.rmsnorm_fwd(t(np.ones(8, np.float32)), x, x)
    dec.decode_attention(t(rnd(rng, 2, 1, 3, 8)), x, x,
                         torch.ones(2, 16, dtype=torch.bool), scale=0.5)
    assert [w.launches for w in WRAPPERS] == [0, 0, 0, 0]


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 1, 8, 8, device="meta")
    with pytest.raises(ValueError):
        fa.attention(x, x, x, scale=1.0)
