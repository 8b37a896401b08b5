"""The port's training path (emu_tpu_torch: the backward twins and autograd
Functions of kernels A and C, remat, the chunked CE loss, forward_loss,
fused_adafactor, Trainer) against the JAX package on the CPU: the same
params and inputs (numpy, from a seed), fp32, the Pallas kernels in
interpret mode. Tolerance 2e-4 of max|ref| unless stated."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from emu_tpu import config as jconfig
from emu_tpu.models import emu1 as jemu1
from emu_tpu.models import llama as jllama
from emu_tpu.ops import flash_attention as jfa
from emu_tpu.ops import fused_norm as jnorm
from emu_tpu.optim import fused_adafactor as jfused_adafactor
from emu_tpu.training import Trainer as JTrainer
from emu_tpu_torch import bridge, optim, training
from emu_tpu_torch import config as pconfig
from emu_tpu_torch.models import emu1, llama, vit
from emu_tpu_torch.ops import _cuda
from emu_tpu_torch.ops import attention as att
from emu_tpu_torch.ops import flash_attention as fa
from emu_tpu_torch.ops import fused_mlp as mlp
from emu_tpu_torch.ops import fused_norm as norm
from emu_tpu_torch.ops import layers as L

TOL = 2e-4
CFG = jconfig.Emu1Config.tiny()
TCFG = pconfig.Emu1Config.tiny()
SPECIAL = (CFG.llama.vocab_size, CFG.llama.vocab_size + 1,
           CFG.llama.vocab_size + 2, CFG.llama.vocab_size + 3)


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a, dtype=None, grad=False):
    out = torch.from_numpy(np.array(a, dtype=np.float32))
    if dtype is not None:
        out = out.to(dtype)
    return out.requires_grad_(grad)


def close(port, ref, tol=TOL, what=""):
    """max |port - ref| <= tol * max|ref| (both as fp32 numpy)."""
    port = (port.detach().float().numpy() if isinstance(port, torch.Tensor)
            else np.asarray(port, np.float32))
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol * max(float(np.abs(ref).max()), 1e-6), (what, err)


def to_torch(tree, dtype=None):
    return bridge.unflatten(bridge.to_state_dict(tree, dtype=dtype))


def perturb(tree, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


# --- kernel C's backward ----------------------------------------------------


@pytest.mark.parametrize("add", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
def test_norm_backward_matches_jax_vjp(add, dtype):
    """rmsnorm_bwd (the plain twin) and the autograd Functions against the
    JAX custom VJP of the Pallas kernels (interpret mode): dw, dx and, in
    the add form, the residual's cotangent, and their dtypes; bf16 at 1e-2.
    "mixed" is bf16 rows and cotangents with an fp32 w, which both read as
    stored and which gives an fp32 dw."""
    rng = np.random.default_rng(10)
    rows, wd, eps = 21, 256, 1e-6
    x, r = rnd(rng, rows, wd), rnd(rng, rows, wd)
    w = 1 + rnd(rng, wd, scale=0.1)
    dh, dy = rnd(rng, rows, wd), rnd(rng, rows, wd)
    act = "bfloat16" if dtype == "mixed" else dtype
    wdt = "float32" if dtype == "mixed" else dtype
    jdt, jwdt = jnp.dtype(act), jnp.dtype(wdt)
    tdt, twdt = getattr(torch, act), getattr(torch, wdt)
    tol = TOL if dtype == "float32" else 1e-2
    J = lambda a: jnp.asarray(a, jdt)
    if add:
        _, vjp = jax.vjp(lambda w_, x_, r_: jnorm.add_rmsnorm(
            w_, x_, r_, eps, interpret=True), jnp.asarray(w, jwdt), J(x),
            J(r))
        jdw, jdx, jdr = vjp((J(dy), J(dh)))
    else:
        _, vjp = jax.vjp(lambda w_, x_: jnorm.rms_norm_fused(
            w_, x_, eps, interpret=True), jnp.asarray(w, jwdt), J(x))
        jdw, jdx = vjp(J(dh))
    assert (jdw.dtype, jdx.dtype) == (jwdt, jdt)
    # the twin, from the forward's saved (y, rsigma)
    tw, tx, tr = t(w, twdt), t(x, tdt), t(r, tdt)
    y, _, rsig = norm.rmsnorm_fwd(tw, tx, tr if add else None, eps)
    dx, dw = norm.rmsnorm_bwd(y, tw, rsig, t(dh, tdt),
                              t(dy, tdt) if add else None)
    assert (dw.dtype, dx.dtype) == (twdt, tdt)
    close(dx, jdx, tol, "twin dx")
    close(dw, jdw, tol, "twin dw")
    # the Functions (the public entry points take them for bf16; fp32
    # activations take the plain composition, so call them directly)
    tw, tx, tr = t(w, twdt, True), t(x, tdt, True), t(r, tdt, True)
    if add:
        yy, hh = norm._AddRMSNorm.apply(tw, tx, tr, eps)
        torch.autograd.backward((yy, hh), (t(dy, tdt), t(dh, tdt)))
        close(tr.grad, jdr, tol, "Function dr")
    else:
        norm._RMSNorm.apply(tw, tx, eps).backward(t(dh, tdt))
    assert (tw.grad.dtype, tx.grad.dtype) == (twdt, tdt)
    close(tx.grad, jdx, tol, "Function dx")
    close(tw.grad, jdw, tol, "Function dw")


@pytest.mark.parametrize("add", [True, False])
def test_norm_takes_the_function_only_where_autograd_records(add,
                                                             monkeypatch):
    """bf16 activations: under no_grad, and with grad enabled but no input
    requiring grad, add_rmsnorm / rms_norm_fused call the forward wrapper
    alone (no autograd Function, no per-call Function overhead on the
    serving and generation paths); with inputs requiring grad they take the
    Function. Every route gives the same bits, and the recorded one's
    gradients match the JAX package's VJP (Pallas in interpret mode, bf16
    at 1e-2)."""
    rng = np.random.default_rng(11)
    rows, wd, eps = 9, 128, 1e-6
    x, r = rnd(rng, rows, wd), rnd(rng, rows, wd)
    w = 1 + rnd(rng, wd, scale=0.1)
    dh, dy = rnd(rng, rows, wd), rnd(rng, rows, wd)
    bf = torch.bfloat16

    def call(grad):
        tw, tx, tr = t(w, bf, grad), t(x, bf, grad), t(r, bf, grad)
        out = (norm.add_rmsnorm(tw, tx, tr, eps) if add
               else (norm.rms_norm_fused(tw, tx, eps),))
        return out, (tw, tx, tr)

    fn = norm._AddRMSNorm if add else norm._RMSNorm
    real = fn.apply

    def refuse(*a):
        raise AssertionError("the autograd Function was taken")
    monkeypatch.setattr(fn, "apply", refuse)
    with torch.no_grad():
        plain, _ = call(True)
    plain2, _ = call(False)
    monkeypatch.setattr(fn, "apply", real)
    recorded, (tw, tx, tr) = call(True)
    assert all(o.grad_fn is not None for o in recorded)
    for a, b, c in zip(plain, plain2, recorded):
        assert torch.equal(a, b) and torch.equal(a, c.detach())
    J = lambda a: jnp.asarray(a, jnp.bfloat16)
    if add:
        torch.autograd.backward(recorded, (t(dy, bf), t(dh, bf)))
        _, vjp = jax.vjp(lambda w_, x_, r_: jnorm.add_rmsnorm(
            w_, x_, r_, eps, interpret=True), J(w), J(x), J(r))
        jdw, jdx, jdr = vjp((J(dy), J(dh)))
        close(tr.grad, jdr, 1e-2, "dr")
    else:
        recorded[0].backward(t(dh, bf))
        _, vjp = jax.vjp(lambda w_, x_: jnorm.rms_norm_fused(
            w_, x_, eps, interpret=True), J(w), J(x))
        jdw, jdx = vjp(J(dh))
    close(tx.grad, jdx, 1e-2, "dx")
    close(tw.grad, jdw, 1e-2, "dw")


def test_norm_routes_by_dtype(monkeypatch):
    """fp32 activations take layers.rms_norm (the JAX package's XLA route),
    bf16 ones the kernel's Function."""
    def refuse(*a, **k):
        raise AssertionError("kernel route taken")
    monkeypatch.setattr(norm, "rmsnorm_fwd", refuse)
    x, w = torch.randn(3, 64), torch.rand(64) + 0.5
    y, h = norm.add_rmsnorm(w, x, x)
    close(h, L.rms_norm(w, 2 * x).numpy(), 0.0)
    norm.rms_norm_fused(w, x)
    with pytest.raises(AssertionError):
        norm.rms_norm_fused(w.bfloat16(), x.bfloat16())


# --- kernel A's lse and backward --------------------------------------------


def _jax_attention_grads(q, k, v, valid, do, causal, scale):
    def f(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(
            q_, k_, v_, kv_valid=None if valid is None else jnp.asarray(valid),
            scale=scale, causal=causal, interpret=True) * jnp.asarray(do))
    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))


@pytest.mark.parametrize("sq,skv,causal,pad", [
    (16, 16, True, True), (16, 16, False, True), (16, 16, True, False),
    (8, 24, True, True), (24, 24, False, False)])
def test_attention_backward_matches_jax(sq, skv, causal, pad):
    """flash_attention's backward (the Function over the twins) against
    jax.grad of the Pallas kernels: causal and not, left-pad kv_valid or
    none, Sq != Skv (end-aligned), and rows that see no key (pad 11 of a
    16-row causal block); those rows' gradients are zero in both."""
    rng = np.random.default_rng(11)
    b, h, d = 2, 2, 32
    q, k, v = rnd(rng, b, sq, h, d), rnd(rng, b, skv, h, d), rnd(rng, b, skv, h, d)
    do = rnd(rng, b, sq, h, d)
    valid = None
    if pad:
        valid = np.ones((b, skv), np.int32)
        valid[1, :11] = 0
    scale = d ** -0.5
    jdq, jdk, jdv = _jax_attention_grads(q, k, v, valid, do, causal, scale)
    tq, tk, tv = t(q, grad=True), t(k, grad=True), t(v, grad=True)
    out = fa.flash_attention(tq, tk, tv,
                             kv_valid=None if valid is None else t(valid),
                             scale=scale, causal=causal)
    out.backward(t(do))
    close(tq.grad, jdq, what="dq")
    close(tk.grad, jdk, what="dk")
    close(tv.grad, jdv, what="dv")
    if pad and causal:                     # rows that see no valid key
        blind = np.arange(sq) + (skv - sq) < 11
        assert blind.any() == (sq == skv)
        assert not tq.grad[1, torch.from_numpy(blind)].abs().sum()


def test_backward_wrappers_run_their_twins_on_cpu():
    """On CPU tensors the dQ and dK/dV wrappers and the norm backward run
    their plain twins (the pieces of attention_bwd_reference) and count no
    launch."""
    rng = np.random.default_rng(19)
    q, o, do = (t(rnd(rng, 2, 4, 9, 16)) for _ in range(3))
    k, v = t(rnd(rng, 2, 2, 12, 16)), t(rnd(rng, 2, 2, 12, 16))
    lse = t(rnd(rng, 2, 4, 9)) + 3.0
    valid = torch.arange(12)[None] >= torch.tensor([[0], [4]])
    kw = dict(scale=0.25, causal=True)
    counters = (fa.attention, fa.attention_bwd_dq, fa.attention_bwd_dkv,
                norm.rmsnorm_bwd)
    before = [c.launches for c in counters]
    dq, d_row = fa.attention_bwd_dq(q, k, v, o, lse, do, valid, **kw)
    dk, dv = fa.attention_bwd_dkv(q, k, v, lse, do, d_row, valid, **kw)
    ref = fa.attention_bwd_reference(q, k, v, o, lse, do, valid, **kw)
    for got, r in zip((dq, dk, dv), ref):
        assert torch.equal(got, r)
    close(d_row, (do * o).sum(-1).numpy())
    y, w = t(rnd(rng, 5, 32)), t(rnd(rng, 32))
    norm.rmsnorm_bwd(y, w, norm.rmsnorm_fwd(w, y)[2], y)
    assert [c.launches for c in counters] == before


def test_attention_lse_matches_pallas():
    """Kernel A's lse twin against _flash_short(with_lse=True), on the rows
    with at least one visible key."""
    rng = np.random.default_rng(12)
    b, h, s, d = 2, 2, 16, 32
    q, k, v = (rnd(rng, b, s, h, d) for _ in range(3))
    valid = np.ones((b, s), np.int32)
    valid[1, :5] = 0
    _, res = jfa._flash_short(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(valid, jnp.float32), d ** -0.5,
                              True, True, with_lse=True)
    ref = np.asarray(res[4])[:, :, :s, 0]
    _, lse = fa.attention_reference(
        t(q).transpose(1, 2), t(k).transpose(1, 2), t(v).transpose(1, 2),
        kv_valid=t(valid), scale=d ** -0.5, causal=True, with_lse=True)
    seen = np.ones((b, s), bool)
    seen[1, :5] = False
    close(lse.permute(0, 2, 1)[torch.from_numpy(seen)],
          ref.transpose(0, 2, 1)[seen])


def test_attention_backward_gqa_matches_jax_repeated():
    """GQA rep 2: dK/dV sum the rep query heads of each kv head; against
    JAX with K/V repeated and dK/dV summed per group."""
    rng = np.random.default_rng(13)
    b, s, h, hkv, d = 2, 16, 4, 2, 32
    q, do = rnd(rng, b, s, h, d), rnd(rng, b, s, h, d)
    k, v = rnd(rng, b, s, hkv, d), rnd(rng, b, s, hkv, d)
    valid = np.ones((b, s), np.int32)
    valid[0, :3] = 0
    rep = lambda a: np.repeat(a, h // hkv, axis=2)
    jdq, jdk, jdv = _jax_attention_grads(q, rep(k), rep(v), valid, do, True,
                                         d ** -0.5)
    group = lambda g: np.asarray(g).reshape(b, s, hkv, h // hkv, d).sum(3)
    tq, tk, tv = t(q, grad=True), t(k, grad=True), t(v, grad=True)
    fa.flash_attention(tq, tk, tv, kv_valid=t(valid), scale=d ** -0.5,
                       causal=True).backward(t(do))
    close(tq.grad, jdq, what="dq")
    close(tk.grad, group(jdk), what="dk")
    close(tv.grad, group(jdv), what="dv")


def test_attention_bias_grads():
    """The ViT's q/v-bias form: the Function's bias grads equal autograd of
    the plain attention on q + q_bias, v + v_bias."""
    rng = np.random.default_rng(14)
    b, h, s, d = 2, 3, 9, 16
    q, k, v = (rnd(rng, b, h, s, d) for _ in range(3))
    qb, vb, do = rnd(rng, h, d), rnd(rng, h, d), rnd(rng, b, h, s, d)
    got = [t(a, grad=True) for a in (q, k, v, qb, vb)]
    fa.mha_bhsd(*got, scale=0.25).backward(t(do))
    ref = [t(a, grad=True) for a in (q, k, v, qb, vb)]
    out = att.grouped_attention(
        (ref[0] + ref[3][None, :, None]).transpose(1, 2), ref[1],
        ref[2] + ref[4][None, :, None], scale=0.25, kv_layout="bgkd")
    out.transpose(1, 2).backward(t(do))
    for name, a, r in zip(("q", "k", "v", "q_bias", "v_bias"), got, ref):
        close(a.grad, r.grad.numpy(), what=name)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_twin_matches_streaming_pallas(causal):
    """Kernel A's twin at Skv past the TPU's streaming threshold's shape
    class: against _flash_streaming with several kv blocks (bk 128)."""
    rng = np.random.default_rng(15)
    b, h, d, sq, skv = 2, 2, 64, 67, 300
    q, k, v = rnd(rng, b, sq, h, d), rnd(rng, b, skv, h, d), rnd(rng, b, skv, h, d)
    ref = jfa._flash_streaming(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None, d ** -0.5, causal, True, bk=128)
    out = fa.flash_attention(t(q), t(k), t(v), scale=d ** -0.5, causal=causal)
    close(out, ref)


def test_dot_product_attention_routes_by_dtype(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernel route taken")
    monkeypatch.setattr(att.fa, "flash_attention", refuse)
    x = torch.randn(1, 4, 2, 8)
    att.dot_product_attention(x, x, x, causal=True)
    with pytest.raises(AssertionError):
        att.dot_product_attention(x.bfloat16(), x.bfloat16(), x.bfloat16())


# --- the repairs --------------------------------------------------------------


def test_vit_fp32_images_take_the_plain_route(monkeypatch):
    """fp32 images: no kernel A branch and no kernel B (vit.py:155,
    layers.py:195 of the JAX package); bf16 images take both."""
    calls = []
    monkeypatch.setattr(vit, "_fused_attn_branch",
                        lambda *a: calls.append("A") or a[2])
    params = vit.init(TCFG.vision, L.Init())
    img = torch.randn(1, 28, 28, 3)
    vit.forward_features(params, TCFG.vision, img)
    assert calls == []
    blk = bridge.layer(params["blocks"], 0)
    x = torch.randn(1, 5, TCFG.vision.width)
    assert L.fused_block_mlp(blk["norm2"], blk["mlp"], x, 1e-6, False) is None
    vit.forward_features(bridge.cast_tree(params, dtype=torch.bfloat16),
                         TCFG.vision, img.bfloat16())
    assert calls == ["A", "A"]


def test_inference_kernels_refuse_grad():
    """Kernels B, D, E, F and G have no backward in either package: their
    wrappers refuse inputs that require grad where autograd is on (the
    check that runs before every CUDA launch), and allow them under
    no_grad."""
    x = torch.randn(2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _cuda.refuse_grad("fused_mlp", x, None)
    with torch.no_grad():
        _cuda.refuse_grad("fused_mlp", x, None)
    _cuda.refuse_grad("fused_mlp", x.detach(), None)
    assert _cuda.kernel_dtype(x.bfloat16()) and not _cuda.kernel_dtype(x)
    # on a CPU tensor the wrapper runs its plain twin, which autograd
    # differentiates
    mlp.fused_mlp(x, torch.randn(8, 16), None, torch.randn(16, 8), None
                  ).sum().backward()
    assert x.grad is not None


# --- the stacked-leaf layout --------------------------------------------------


def test_trainable_tree_accumulates_layer_grads_in_place():
    """bridge.trainable: each layer's views are autograd leaves whose grads
    land in one stacked buffer, equal to the grads of the stacked tensor."""
    rng = np.random.default_rng(16)
    w = t(rnd(rng, 3, 4, 5))
    tree = bridge.trainable({"layers": {"w": w.clone()}, "head": w[0].clone()})
    x = t(rnd(rng, 2, 4))
    loss = sum((x @ bridge.layer(tree["layers"], i)["w"]).square().sum()
               for i in range(3)) + (x @ tree["head"][:, :4]).sum()
    loss.backward()
    ref = w.clone().requires_grad_()
    (sum((x @ ref[i]).square().sum() for i in range(3))).backward()
    stacked = tree["layers"]["w"]
    close(stacked.grad, ref.grad.numpy(), 0.0)
    assert not stacked.requires_grad
    grads = dict((id(p), g) for p, g in bridge.grad_leaves(tree))
    assert len(grads) == 2 and id(stacked) in grads
    bridge.zero_grads(tree)
    assert not stacked.grad.abs().max() and not tree["head"].grad.abs().max()


# --- remat, masked CE, forward_loss ---------------------------------------------


def _llama_setup(seed=0):
    cfg = jconfig.LlamaConfig(hidden_size=64, intermediate_size=128,
                              num_hidden_layers=3, num_attention_heads=4,
                              vocab_size=97, extended_vocab_size=101,
                              max_position_embeddings=32)
    tcfg = pconfig.LlamaConfig(**{f: getattr(cfg, f) for f in
                                  cfg.__dataclass_fields__})
    jp = perturb(jllama.init(jax.random.PRNGKey(seed), cfg))
    emb = rnd(np.random.default_rng(seed), 2, 16, 64)
    mask = np.ones((2, 16), np.int32)
    mask[1, :5] = 0
    return cfg, tcfg, jp, emb, mask


def _port_hidden_grads(tcfg, jp, emb, mask, remat, dtype=torch.float32):
    params = bridge.trainable(to_torch(jp, dtype))
    out = llama.forward_hidden(params, tcfg, t(emb, dtype), t(mask), remat)
    (0.5 * out.float().square().sum()).backward()
    return {name: v.grad.float()
            for name, v in bridge.flatten(params).items()}


@pytest.mark.parametrize("remat", [False, True, "dots", "named", "dots+attn"])
def test_forward_hidden_remat_grads_match_jax(remat):
    """Every remat setting gives the no-remat grads, and those equal the
    JAX package's (fp32: the plain route)."""
    cfg, tcfg, jp, emb, mask = _llama_setup()

    def loss(p):
        out = jllama.forward_hidden(p, cfg, jnp.asarray(emb), jnp.asarray(mask))
        return 0.5 * jnp.sum(out.astype(jnp.float32) ** 2)

    ref = bridge.flatten(jax.grad(loss)(jax.tree.map(jnp.asarray, jp)))
    got = _port_hidden_grads(tcfg, jp, emb, mask, remat)
    base = _port_hidden_grads(tcfg, jp, emb, mask, False)
    assert set(got) == set(ref)
    for name in ref:
        close(got[name], ref[name], what=name)
        close(got[name], base[name].numpy(), 1e-6, name)


@pytest.mark.parametrize("remat", [True, "dots", "named"])
def test_forward_hidden_bf16_kernel_route_under_remat(remat, monkeypatch):
    """bf16 runs the kernel route (kernel A's custom op and Function, kernel
    C's Functions; their CPU twins here) under checkpointing: the grads
    equal the no-remat ones, and "named" keeps kernel A's output, so the
    backward does not run the attention forward again."""
    _, tcfg, jp, emb, mask = _llama_setup(1)
    calls = []
    twin = fa.attention_reference
    monkeypatch.setattr(fa, "attention_reference",
                        lambda *a, **k: calls.append(1) or twin(*a, **k))
    base = _port_hidden_grads(tcfg, jp, emb, mask, False, torch.bfloat16)
    n_plain = len(calls)
    got = _port_hidden_grads(tcfg, jp, emb, mask, remat, torch.bfloat16)
    n_layers = tcfg.num_hidden_layers
    assert n_plain == n_layers
    assert len(calls) - n_plain == (n_layers if remat == "named"
                                    else 2 * n_layers)
    for name in base:
        close(got[name], base[name].numpy(), 1e-2, name)


@pytest.mark.parametrize("chunk", [5, 1024])
def test_masked_ce_loss_matches_jax(chunk):
    """Value and grads (hidden, lm_head) against jax.value_and_grad; chunk
    5 does not divide the 14 rows."""
    rng = np.random.default_rng(17)
    hid = rnd(rng, 2, 7, 64)
    w = rnd(rng, 64, 101, scale=0.1)
    labels = rng.integers(0, 101, (2, 7))
    valid = rng.random((2, 7)) > 0.3

    def jloss(h, w_):
        return jllama.masked_ce_loss({"lm_head": {"kernel": w_}}, h,
                                     jnp.asarray(labels), jnp.asarray(valid),
                                     chunk=chunk)

    jv, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hid), jnp.asarray(w))
    th, tw = t(hid, grad=True), t(w, grad=True)
    v = llama.masked_ce_loss({"lm_head": {"kernel": tw}}, th,
                             torch.from_numpy(labels), torch.from_numpy(valid),
                             chunk=chunk)
    v.backward()
    close(v, np.asarray(jv))
    close(th.grad, jdh)
    close(tw.grad, jdw)


def _emu1_batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    n = CFG.n_causal
    pad, img, img_end, image = SPECIAL
    ids = np.full((b, 6 + n), 7, np.int64)
    ids[:, 0] = 1
    ids[:, 1] = img
    ids[:, 2:2 + n] = image
    ids[:, 2 + n] = img_end
    ids[:, 3 + n:] = rng.integers(3, 200, (b, 3))
    mask = np.ones_like(ids)
    mask[1, 0] = 0
    ids[1, 0] = pad
    images = rnd(rng, b, 28, 28, 3, scale=0.1)
    return images, ids, mask


def test_forward_loss_value_and_grads_match_jax():
    jp = perturb(jemu1.init(jax.random.PRNGKey(3), CFG), 1)
    images, ids, mask = _emu1_batch()
    emb = rnd(np.random.default_rng(4), 2 * CFG.n_causal, 64)

    def jloss(p):
        return jemu1.forward_loss(p, CFG, jnp.asarray(ids), jnp.asarray(mask),
                                  jnp.asarray(emb), SPECIAL)

    jv, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jp))
    params = bridge.trainable(to_torch(jp))
    v = emu1.forward_loss(params, TCFG, torch.from_numpy(ids),
                          torch.from_numpy(mask), t(emb), SPECIAL,
                          remat="named")
    v.backward()
    close(v, np.asarray(jv))
    ref = bridge.flatten(jg)
    got = {k: x.grad for k, x in bridge.flatten(params).items()}
    assert set(got) == set(ref)
    for name in ref:
        close(got[name], ref[name], what=name)


# --- fused_adafactor and the Trainer ---------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_adafactor_matches_jax(dtype):
    """Three updates on a tree with a stacked [L, m, n] leaf (the sliced
    path), a factored matrix, a vector and a small unfactored matrix; bf16
    at bf16 resolution (1e-2)."""
    import optax
    rng = np.random.default_rng(18)
    shapes = {"stacked": (3, 160, 192), "big": (192, 160), "vec": (192,),
              "small": (4, 8)}
    p0 = {k: rnd(rng, *s, scale=0.02 if len(s) > 1 else 1.0)
          for k, s in shapes.items()}
    grads = [{k: rnd(rng, *s) for k, s in shapes.items()} for _ in range(3)]
    jdt = jnp.dtype(dtype)
    tx = jfused_adafactor(1e-2)
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v, jdt) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
    tdt = getattr(torch, dtype)
    tp = {k: t(v, tdt) for k, v in p0.items()}
    opt = optim.fused_adafactor(1e-2)(list(tp.values()))
    for g in grads:
        for k, p in tp.items():
            p.grad = t(g[k], tdt)
        opt.step()
        for k, p in tp.items():            # the grads are read, not changed
            close(p.grad, np.asarray(t(g[k], tdt).float()), 0.0, k)
    tol = TOL if dtype == "float32" else 1e-2
    for k in shapes:
        close(tp[k], np.asarray(jp[k], np.float32), tol, k)


def test_trainer_matches_jax_trainer_and_learns():
    """The first 3 losses equal the JAX Trainer's (mesh None, the same
    bridged params, fused_adafactor on both sides); over 6 steps on one
    batch the loss falls by >= 10% (as tests/test_training.py asks)."""
    jp = jemu1.init(jax.random.PRNGKey(0), CFG)
    tree = to_torch(jax.tree.map(np.asarray, jp))
    images, ids, mask = _emu1_batch(5, b=4)
    jt = JTrainer(CFG, jp, jfused_adafactor(3e-2), SPECIAL)
    # fused_adafactor's init shares one zeros buffer between the unused
    # row/col moments of unfactored leaves; the donating step needs them
    # distinct
    jt.opt_state = jax.tree.map(jnp.copy, jt.opt_state)
    jl = [jt.step(jnp.asarray(images), jnp.asarray(ids, jnp.int32),
                  jnp.asarray(mask, jnp.int32)) for _ in range(3)]
    tr = training.Trainer(TCFG, tree, optim.fused_adafactor(3e-2), SPECIAL,
                          remat="named", device="cpu")
    tl = [tr.step(images, ids, mask) for _ in range(6)]
    close(np.asarray(tl[:3]), np.asarray(jl))
    assert all(np.isfinite(tl)) and tl[-1] < 0.9 * tl[0], tl


def test_trainer_refuses_unported_options():
    with pytest.raises(NotImplementedError, match="item 16"):
        training.Trainer(TCFG, {}, optim.fused_adafactor(1e-2), SPECIAL,
                         mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        training.Trainer(TCFG, {}, optim.fused_adafactor(1e-2), SPECIAL,
                         checkpoint_dir="x", device="cpu")
