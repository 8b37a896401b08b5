"""Kernel H (`fused_dense`), kernel B's SwiGLU form and `mha_packed_qkv`
on the CPU: their plain twins against the JAX package's Pallas kernels in
interpret mode, the routes that reach them (`layers.dense_plan`, the UNet
block's pre-LN dense, the SwiGLU ViT), the ViT-parts bench at a tiny size,
and the port's repairs of faults it had copied from the JAX package or
added itself (fp32 inputs at bf16-only kernels, partial burst admission,
dead decode steps, the page size of a 4-D page pool). Tolerances: fp32
2e-4 of max|ref|; bf16 one bf16 step (2^-7) of max|ref|."""

import threading
import types
from concurrent.futures import Future

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from emu_tpu import config as jconfig
from emu_tpu.models import vit as jvit
from emu_tpu.ops import flash_attention as jfa
from emu_tpu.ops import fused_mlp as jmlp
from emu_tpu_torch import bridge
from emu_tpu_torch import config as pconfig
from emu_tpu_torch.diffusion import unet
from emu_tpu_torch.generation import continuous
from emu_tpu_torch.models import llama, vit
from emu_tpu_torch.ops import attention as att
from emu_tpu_torch.ops import decode_attention as dec
from emu_tpu_torch.ops import flash_attention as fa
from emu_tpu_torch.ops import fused_mlp as mlp
from emu_tpu_torch.ops import layers as L
from emu_tpu_torch.ops import q4_matmul as q4
from emu_tpu_torch.ops import quant
from emu_tpu_torch.serving.continuous_helper import ContinuousChatHelper
from emu_tpu_torch.tools import bench_vit_parts

TOL = 2e-4
BF16_STEP = 2.0 ** -7


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close_to(out, ref, rel):
    """max |out - ref| <= rel * max|ref| (both as fp32 numpy)."""
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(out - ref).max())
    assert err <= rel * float(np.abs(ref).max()), (err, np.abs(ref).max())


# --- kernel H: fused_dense --------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("form", ["plain", "pre", "post_residual"])
def test_fused_dense_twin_matches_pallas(form, bias, dtype):
    """70 rows (a ragged 64-row block), K 96, N 128: the twin against the
    TPU kernel in interpret mode, in fp32 and in bf16."""
    rng = np.random.default_rng(20)
    m, k, n = 70, 96, 128
    ln_mode = {"plain": None, "pre": "pre", "post_residual": "post"}[form]
    dim = k if ln_mode == "pre" else n
    arrays = {"x": rnd(rng, m, k), "w": rnd(rng, k, n, scale=0.1),
              "b": rnd(rng, n, scale=0.3) if bias else None,
              "ln_scale": 1 + rnd(rng, dim, scale=0.1) if ln_mode else None,
              "ln_bias": rnd(rng, dim, scale=0.1) if ln_mode else None,
              "residual": rnd(rng, m, n) if form == "post_residual" else None}
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)

    def jx(a):
        return None if a is None else jnp.asarray(a, jd)

    def tx(a):
        return None if a is None else torch.from_numpy(a).to(td)

    ref = jmlp.fused_dense(jx(arrays["x"]), jx(arrays["w"]), jx(arrays["b"]),
                           jx(arrays["ln_scale"]), jx(arrays["ln_bias"]),
                           jx(arrays["residual"]), ln_mode=ln_mode, bm=64,
                           bn=128, interpret=True)
    out = mlp.fused_dense(tx(arrays["x"]), tx(arrays["w"]), tx(arrays["b"]),
                          tx(arrays["ln_scale"]), tx(arrays["ln_bias"]),
                          tx(arrays["residual"]), ln_mode=ln_mode)
    assert out.dtype == td and out.shape == (m, n)
    close_to(out, np.asarray(ref, np.float32),
             TOL if dtype == "float32" else BF16_STEP)


def _count_fused_dense(monkeypatch):
    calls = []
    real = L.fused_dense

    def counted(*a, **kw):
        calls.append(kw.get("ln_mode"))
        return real(*a, **kw)
    monkeypatch.setattr(L, "fused_dense", counted)
    return calls


def test_dense_plan_routes(monkeypatch):
    """A biased bf16 dense (float weights or dequantized int4) takes kernel
    H; fp32 activations, a dense autograd records, weight-only int8 and a
    dense without bias keep their plain routes. The bf16 result is the
    plain composition's, bit for bit, on the CPU."""
    calls = _count_fused_dense(monkeypatch)
    torch.manual_seed(0)
    w, b = torch.randn(256, 64) * 0.1, torch.randn(64)
    x = torch.randn(3, 256)
    p = {"kernel": w.bfloat16(), "bias": b.bfloat16()}
    xb = x.bfloat16()
    assert L.dense_plan(p, xb)
    out = L.dense(p, xb)
    assert calls == [None]
    want = (xb.float() @ p["kernel"].float() + p["bias"].float()).bfloat16()
    assert torch.equal(out, want)
    # int4 groups of 64 rows: kernel F declines, the dequantized dense
    q = dict(quant.quantize_kernel_int4(w, group_size=64), bias=b.bfloat16())
    assert not L.q4_plan(q, xb) and L.dense_plan(q, xb)
    L.dense(q, xb)
    assert calls == [None, None]
    assert not L.dense_plan({"kernel": w, "bias": b}, x)            # fp32
    assert not L.dense_plan({"kernel": p["kernel"]}, xb)            # no bias
    q8 = dict(quant.quantize_kernel(w), bias=b.bfloat16())
    assert not L.dense_plan(q8, xb)                                 # int8
    grad = {"kernel": p["kernel"].clone().requires_grad_(), "bias": p["bias"]}
    assert not L.dense_plan(grad, xb)
    with torch.no_grad():
        assert L.dense_plan(grad, xb)
    L.dense({"kernel": w, "bias": b}, x)
    L.dense(q8, xb)
    L.dense(grad, xb)
    assert calls == [None, None]


def test_unet_block_norm3_takes_the_pre_form(monkeypatch):
    """The UNet transformer block's norm3 + GEGLU proj_in is kernel H's pre
    form in bf16, and equals the JAX composition layer_norm -> dense to
    the bit; fp32 keeps the two calls."""
    calls = _count_fused_dense(monkeypatch)
    cfg = pconfig.UNetConfig.tiny()
    init = L.Init(generator=torch.Generator().manual_seed(1))
    blk = unet._tf_block_init(init, 32, cfg.cross_attention_dim)
    for leaf in bridge.flatten(blk).values():
        leaf.add_(torch.randn(leaf.shape) * 0.05)
    x = torch.randn(2, 16, 32)
    ctx = torch.randn(2, 5, cfg.cross_attention_dim)
    unet._tf_block(blk, x, ctx, 2)
    assert "pre" not in calls
    xb = x.bfloat16()
    pb = bridge.cast_tree(blk, dtype=torch.bfloat16)
    got = L.layer_norm_dense(pb["norm3"], pb["ff"]["proj_in"], xb, 1e-5)
    assert calls[-1] == "pre"
    want = L.dense(pb["ff"]["proj_in"], L.layer_norm(pb["norm3"], xb, 1e-5))
    assert torch.equal(got, want)
    calls.clear()
    unet._tf_block(pb, xb, ctx.bfloat16(), 2)
    assert calls.count("pre") == 1 and calls.count(None) >= 3


# --- kernel B: the SwiGLU form ----------------------------------------------

@pytest.mark.parametrize("ln_mode", ["pre", "post", None])
def test_fused_mlp_swiglu_twin_matches_pallas_untiled_hidden(ln_mode):
    """Hidden width 90 (the TPU wrapper zero-pads it to its block of 32)."""
    rng = np.random.default_rng(21)
    k, f = 32, 90
    x = rnd(rng, 2, 7, k)
    ws = [rnd(rng, k, f, scale=0.2), rnd(rng, f, scale=0.1),
          rnd(rng, k, f, scale=0.2), rnd(rng, f, scale=0.1),
          rnd(rng, f, k, scale=0.2), rnd(rng, k, scale=0.1)]
    ln = ([1 + rnd(rng, k, scale=0.1), rnd(rng, k, scale=0.1)] if ln_mode
          else [None, None])
    kw = dict(activation="swiglu", ln_mode=ln_mode, residual=True)
    ref = jmlp.fused_mlp(jnp.asarray(x), *map(jnp.asarray, ws),
                         *[None if a is None else jnp.asarray(a) for a in ln],
                         bm=8, bf=32, interpret=True, **kw)
    out = mlp.fused_mlp(torch.from_numpy(x), *map(torch.from_numpy, ws),
                        *[None if a is None else torch.from_numpy(a)
                          for a in ln], **kw)
    close_to(out, ref, TOL)


def eva02_l(**kw):
    """The published EVA02-CLIP-L-14 vision widths (EVA-CLIP's
    EVA02-CLIP-L-14.json: 24 x 1024, heads of 64, mlp_ratio 2.6667, patch
    14 at 224 px, 2-D RoPE with pt_hw_seq_len 16 and intp_freq), with one
    cut: sub-LN off, so that the MLP can take the fused kernel."""
    base = dict(image_size=224, patch_size=14, width=1024, layers=24,
                head_width=64, mlp_ratio=2.6667, naiveswiglu=True, rope=True,
                pt_hw_seq_len=16, intp_freq=True, subln=False)
    base.update(kw)
    return base


TINY_SWIGLU = eva02_l(image_size=28, width=64, layers=2, head_width=16,
                      num_classes=0)


def test_eva02_l_config_widths():
    cfg = pconfig.VisionConfig(**eva02_l())
    assert (cfg.mlp_hidden, cfg.num_heads, cfg.seq_len) == (2730, 16, 257)


def test_swiglu_vit_matches_jax_and_bf16_takes_kernel_b(monkeypatch):
    """A 2-layer tiny SwiGLU ViT with RoPE (sub-LN off): fp32 against the
    JAX forward_features; bf16 images send every block's MLP branch to the
    fused SwiGLU form and every biased dense to kernel H; the bridge
    carries the w1/w2/w3 tree by name and shape."""
    jcfg = jconfig.VisionConfig(**TINY_SWIGLU)
    tcfg = pconfig.VisionConfig(**TINY_SWIGLU)
    rng = np.random.default_rng(22)
    jp = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), jvit.init(jax.random.PRNGKey(3), jcfg))
    flat = bridge.to_state_dict(jp)
    meta = bridge.flatten(vit.init(tcfg, L.Init(device="meta")))
    assert sorted(flat) == sorted(meta)
    assert {"blocks.mlp.w1.kernel", "blocks.mlp.w2.kernel",
            "blocks.mlp.w3.kernel", "blocks.mlp.w3.bias"} <= set(flat)
    assert all(tuple(flat[n].shape) == tuple(meta[n].shape) for n in flat)
    tp = bridge.unflatten(flat)
    x = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    ref = jvit.forward_features(jax.tree.map(jnp.asarray, jp), jcfg,
                                jnp.asarray(x))
    close_to(vit.forward_features(tp, tcfg, torch.from_numpy(x)), ref, TOL)

    forms, dense_calls = [], _count_fused_dense(monkeypatch)
    real = L.fused_mlp

    def counted(*a, **kw):
        forms.append(kw.get("activation", "gelu"))
        return real(*a, **kw)
    monkeypatch.setattr(L, "fused_mlp", counted)
    tb = bridge.cast_tree(tp, dtype=torch.bfloat16)
    vit.forward_features(tb, tcfg, torch.from_numpy(x).bfloat16())
    # per block: the qkv and proj denses; once: the patch embedding
    assert forms == ["swiglu"] * 2 and len(dense_calls) == 2 * 2 + 1


# --- mha_packed_qkv ---------------------------------------------------------

def test_mha_packed_qkv_twin_matches_pallas():
    rng = np.random.default_rng(23)
    b, s, h, d = 2, 40, 4, 32
    qkv = rnd(rng, b, s, 3 * h * d)
    ref = jfa.mha_packed_qkv(jnp.asarray(qkv), h, d, scale=d ** -0.5,
                             interpret=True)
    fa.mha_packed_qkv.launches = 0
    out = fa.mha_packed_qkv(torch.from_numpy(qkv), h, d, scale=d ** -0.5)
    assert out.shape == (b, s, h * d) and fa.mha_packed_qkv.launches == 0
    close_to(out, ref, TOL)


# --- the ViT-parts bench ----------------------------------------------------

def test_bench_vit_parts_runs_every_part_on_the_cpu():
    lines = []
    res = bench_vit_parts.run("tiny", "cpu", out=lines.append)
    shape = bench_vit_parts.SHAPES["tiny"]
    b, s, w, h, d = (shape[k] for k in ("b", "s", "w", "h", "d"))
    assert len(res) == 8 and all(r["us"] is None for r in res.values())
    assert res["mha_packed_qkv"]["shape"] == (b, s, h * d)
    assert res["fused LN + QKV (H pre)"]["shape"] == (b, s, 3 * h * d)
    assert res["fused LN + MLP + residual (B)"]["shape"] == (b, s, w)
    assert all(r["bound_us"] > 0 for r in res.values())
    assert set(bench_vit_parts.LAYER_PARTS) <= set(res)
    assert not any("us/layer" in ln for ln in lines)


def test_bench_vit_parts_int8_part_on_the_cpu():
    """--int8 adds the W8A8 parts after the bf16 ones: kernel E's twin at
    the route's hidden block, the W8A8 qkv product and the quantization
    alone, each run once with a bound and no time."""
    lines = []
    res = bench_vit_parts.run("tiny", "cpu", out=lines.append, int8=True)
    shape = bench_vit_parts.SHAPES["tiny"]
    b, s, w, h, d = (shape[k] for k in ("b", "s", "w", "h", "d"))
    assert len(res) == 11 and all(r["us"] is None for r in res.values())
    assert res[bench_vit_parts.W8A8_MLP]["shape"] == (b, s, w)
    assert res["W8A8 qkv (matmul_w8a8, dynamic quant)"]["shape"] == (
        b, s, 3 * h * d)
    assert res["quantize_activations alone"]["shape"] == (b, s, w)
    assert all(r["bound_us"] > 0 for r in res.values())
    assert "W8A8 parts" in lines and not any("us/layer" in ln for ln in lines)


# --- repairs: fp32 and out-of-envelope inputs at bf16-only kernels ----------

def test_decode_kernel_fits_its_envelope():
    bf = torch.bfloat16
    q = torch.zeros(2, 1, 8, 128, dtype=bf)
    cache = torch.zeros(2, 2, 4, 64, 128, dtype=bf)
    assert dec.kernel_fits(q, cache)
    assert not dec.kernel_fits(q.float(), cache.float())          # fp32
    assert dec.kernel_fits(q, cache.to(torch.int8), quant=True)
    assert not dec.kernel_fits(q, cache, quant=True)              # bf16 + scales
    wide = torch.zeros(2, 1, 8, 160, dtype=bf)
    assert not dec.kernel_fits(wide, torch.zeros(2, 4, 64, 160, dtype=bf))
    chunk = torch.zeros(2, 16, 8, 128, dtype=bf)
    kn = torch.zeros(2, 4, 16, 128, dtype=bf)
    assert dec.kernel_fits(chunk, cache, kn)                      # rep 2 x 16
    assert not dec.kernel_fits(chunk, cache)                      # no k_new
    many = torch.zeros(2, 16, 32, 128, dtype=bf)                  # rep 8 x 16
    assert not dec.kernel_fits(many, cache, kn)
    odd = torch.zeros(2, 1, 16, 80, dtype=bf)        # D 80 decodes at rep 4,
    assert dec.kernel_fits(odd, torch.zeros(2, 4, 64, 80, dtype=bf))
    assert not dec.kernel_fits(odd, torch.zeros(2, 1, 64, 80, dtype=bf))  # 16


def test_cache_attention_routes_fp32_to_the_plain_chain(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernel D route taken")
    monkeypatch.setattr(att, "decode_attention", refuse)
    rng = np.random.default_rng(24)
    q = torch.from_numpy(rnd(rng, 2, 1, 4, 16))
    k, v = (torch.from_numpy(rnd(rng, 2, 4, 12, 16)) for _ in range(2))
    valid = torch.ones(2, 12, dtype=torch.bool)
    out = att.cache_attention(q, {"k": k, "v": v}, kv_valid=valid)
    ref = att.grouped_attention(q, k, v, scale=16 ** -0.5, kv_valid=valid,
                                kv_layout="bgkd")
    assert torch.equal(out, ref)
    with pytest.raises(AssertionError, match="kernel D"):
        att.cache_attention(q.bfloat16(), {"k": k.bfloat16(),
                                           "v": v.bfloat16()}, kv_valid=valid)


def test_q4_plans_take_bf16_activations_on_the_card():
    """Kernels F and G take bf16 only: fp32 activations on a device tensor
    (meta here, the card in tests/test_torch_cuda.py) dequantize; on the
    CPU the twins keep the JAX package's rule at any dtype."""
    torch.manual_seed(2)
    p = quant.quantize_kernel_int4(torch.randn(256, 128))
    mlp_p = {"gate_up": quant.quantize_kernel_int4(torch.randn(256, 512)),
             "down": quant.quantize_kernel_int4(torch.randn(256, 256))}
    w = torch.ones(256)
    for dev, fp32 in (("cpu", True), ("meta", False)):
        bf = torch.zeros(4, 256, dtype=torch.bfloat16, device=dev)
        f32 = torch.zeros(4, 256, device=dev)
        assert q4.q4_plan(p, bf) and q4.q4_plan(p, f32) == fp32
        assert q4.swiglu_q4_plan(w, mlp_p, bf[:1])
        assert q4.swiglu_q4_plan(w, mlp_p, f32[:1]) == fp32


def test_cache_attention_reads_the_page_of_a_pool_without_layer_dim():
    """A 4-D pool [n_pages, Hkv, page, D]: the page size is shape[-2]
    (page 4, D 8 here), the same answer as the 5-D pool at layer 0. Two
    queries without k_new: the plain chain, which gathers the pages."""
    rng = np.random.default_rng(25)
    kp, vp = (torch.from_numpy(rnd(rng, 6, 2, 4, 8)) for _ in range(2))
    table = torch.tensor([[3, 0, 5], [1, 4, 2]], dtype=torch.int32)
    q = torch.from_numpy(rnd(rng, 2, 2, 2, 8))
    valid = torch.from_numpy(rng.random((2, 12)) > 0.3)
    valid[:, 0] = True
    got = att.cache_attention(q, {"k": kp, "v": vp, "page_table": table},
                              kv_valid=valid)
    want = att.cache_attention(q, {"k": kp[None], "v": vp[None], "layer": 0,
                                   "page_table": table}, kv_valid=valid)
    assert torch.equal(got, want)


# --- repairs: burst admission and dead decode steps -------------------------

TCFG = pconfig.Emu2Config.tiny().llama


@pytest.fixture(scope="module")
def decoder():
    return llama.init(TCFG, L.Init(generator=torch.Generator().manual_seed(7)))


def _emb(params, ids):
    ids = torch.tensor([ids])
    return llama.embed(params, ids), torch.ones_like(ids)


def test_burst_admission_checks_every_row_first(decoder):
    """A burst whose later bucket group exceeds max_len raises before any
    row is admitted: no slot is taken, no request recorded."""
    eng = continuous.ContinuousEngine(decoder, TCFG, max_slots=3, max_len=24,
                                      prefill_buckets=(8, 16),
                                      eos_token_id=None)
    ok = (*_emb(decoder, [3, 5, 7]), 8)              # bucket 8 + 8 <= 24
    bad = (*_emb(decoder, list(range(3, 15))), 10)   # bucket 16 + 10 > 24
    with pytest.raises(ValueError, match="max_len"):
        eng.submit_many([ok, bad])
    assert eng.free_slots() == 3 and not eng.requests
    ids = eng.submit_many([ok])
    assert len(eng.run_until_drained()[ids[0]]) == 8


class _Pipeline:
    """What ContinuousChatHelper reads of a chat pipeline: the decoder, its
    config, a tokenizer, and embed_inputs over lists of token ids."""

    def __init__(self, params):
        self.params = {"decoder": params}
        self.cfg = types.SimpleNamespace(llama=TCFG)
        self.tokenizer = types.SimpleNamespace(
            eos_token_id=None,
            decode=lambda toks, skip_special_tokens=True: list(toks))

    def embed_inputs(self, inputs, is_grounding=False):
        emb, mask = _emb(self.params["decoder"], inputs)
        return emb, mask, torch.tensor([inputs])


def test_helper_burst_fails_only_the_bad_request(decoder):
    """One prompt of a burst whose bucket + max_new exceeds max_len fails
    its own future; the others are admitted. Each row is checked once."""
    helper = ContinuousChatHelper(_Pipeline(decoder), max_slots=3,
                                  max_len=40, block_steps=4)
    helper.shutdown()                          # drive _admit by hand
    checks, check = [], helper.engine.check_request
    helper.engine.check_request = lambda *a: checks.append(a) or check(*a)
    good, bad = Future(), Future()             # bucket 32 + 8, + 9 > 40
    helper._admit([(good, [3, 5, 7], {"max_new_tokens": 8}),
                   (bad, [3, 5, 7], {"max_new_tokens": 9})])
    assert len(checks) == 2
    assert isinstance(bad.exception(timeout=0), ValueError)
    assert not good.done() and list(helper.waiting.values()) == [good]
    helper.close()


def test_no_dead_steps_after_every_budget_is_dispatched(decoder):
    """One request of 5 tokens through the block dispatcher (blocks of 8,
    floor 4): the prefill gives the first token and exactly 4 decode steps
    run; the engine suggests no block once every budget is dispatched."""
    helper = ContinuousChatHelper(_Pipeline(decoder), max_slots=2,
                                  max_len=64, block_steps=8)
    eng = helper.engine
    steps, lock = [0], threading.Lock()
    body = eng._step_body

    def counted():
        with lock:
            steps[0] += 1
        return body()
    eng._step_body = counted
    try:
        toks = helper.get()([3, 5, 7, 9], max_new_tokens=5)
    finally:
        helper.close()
    assert len(toks) == 5 and steps[0] == 4
    eng2 = continuous.ContinuousEngine(decoder, TCFG, max_slots=1, max_len=32,
                                       prefill_buckets=(8,),
                                       eos_token_id=None)
    eng2.submit_many([(*_emb(decoder, [3, 5]), 5)])
    blk = eng2.step_block(eng2.suggested_block(8))
    assert eng2.suggested_block(8) == 0
    eng2.record_block(blk)
    assert eng2.slot_req == [None]
