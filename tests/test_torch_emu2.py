"""The port's Emu2 chat path (emu_tpu_torch.models.emu2,
emu_tpu_torch.pipelines.chat) against the JAX package on the CPU: the same
params (the JAX tree, perturbed so no leaf is a trivial zero/one, bridged
into the port) and the same inputs (numpy seeds, PIL images), fp32.

Tiny widths make the JAX kernel routes decline (int4 groups below 128
rows, fewer than 2048 tower rows), so both packages take the same routes
and the tiny chat's tokens must be equal. The int4 decode step at hidden
256 / F 512 is held against the JAX package with its kernel routes forced
(backend patched to "tpu", every Pallas entry it reaches in interpret
mode); its tolerance is 2e-3 of max|ref| for the activation requantization
(see test_torch_quant.py); fp32 comparisons elsewhere are 2e-4."""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from emu_tpu import tokenization as T
from emu_tpu.config import Emu2Config, LlamaConfig
from emu_tpu.models import emu2 as jemu2
from emu_tpu.models import llama as jllama
from emu_tpu.models import vit as jvit
from emu_tpu.ops import layers as jlayers
from emu_tpu.ops import quant as jquant
from emu_tpu.pipelines.chat import EmuChatGeneration as JChat
from emu_tpu_torch import bridge
from emu_tpu_torch.models import emu2, llama, vit
from emu_tpu_torch.ops import layers as L
from emu_tpu_torch.ops.layers import Init
from emu_tpu_torch.pipelines.chat import EmuChatGeneration

TOL = 2e-4
CFG = Emu2Config.tiny()


def perturb(tree, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


def to_torch(tree, dtype=None):
    return bridge.unflatten(bridge.to_state_dict(tree, dtype=dtype))


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


def tiny_tokenizer(cfg=CFG):
    return T.EmuTokenizer(T.SimpleTokenizer(cfg.llama.vocab_size),
                          T.emu2_special_tokens(),
                          base_vocab=cfg.llama.vocab_size)


def pil(seed, size=64):
    return Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (size, size, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def jparams():
    return perturb(jemu2.init(jax.random.PRNGKey(0), CFG, jnp.float32))


def test_bridge_round_trips_quantized_emu2_tree(jparams):
    """A bf16 Emu2 tree quantized int4 by the JAX package: int leaves keep
    int8, the quantized denses' scales stay fp32, float leaves become
    bf16 — every leaf bit for bit — and the port's init(quantize="int4")
    on the meta device builds exactly these names, shapes and dtypes."""
    jbf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
    jq = jax.jit(lambda p: jquant.quantize_model_params(
        dict(p, decoder=jllama.fuse_projections(p["decoder"])), "int4"))(jbf)
    flat = bridge.flatten(jax.tree.map(np.asarray, jq))
    sd = bridge.to_state_dict(jq, dtype=torch.bfloat16)
    assert sorted(sd) == sorted(flat)
    dtypes = set()
    for k, v in flat.items():
        got = sd[k]
        dtypes.add((k.rsplit(".", 1)[-1], str(got.dtype)))
        assert str(got.dtype).split(".")[-1] == str(v.dtype), k
        as_np = (got.view(torch.int16).numpy() if got.dtype == torch.bfloat16
                 else got.numpy())
        ref = v.view(np.int16) if str(v.dtype) == "bfloat16" else v
        np.testing.assert_array_equal(as_np, ref, err_msg=k)
    assert ("kernel_q4", "torch.int8") in dtypes
    assert ("kernel_w8a8", "torch.int8") in dtypes
    assert ("scale4", "torch.float32") in dtypes
    model = emu2.Emu2(CFG, emu2.init(CFG, Init(device="meta",
                                                dtype=torch.bfloat16),
                                     quantize="int4"))
    meta = model.state_dict()
    assert sorted(meta) == sorted(sd)
    for k, v in sd.items():
        assert meta[k].shape == v.shape and meta[k].dtype == v.dtype, k
    bridge.load_jax_params(model, jq, dtype=torch.bfloat16)
    assert torch.equal(model.decoder.lm_head.kernel_q4, sd[
        "decoder.lm_head.kernel_q4"])


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_encode_image_lm_matches_jax(jparams, quantize):
    """EVA tower (post-norm; W8A8 when quantized) → pool → project_up."""
    jp = jax.tree.map(jnp.asarray, jparams)
    tp = to_torch(jparams)
    if quantize:
        jp = jax.jit(lambda p: jquant.quantize_model_params(p, quantize))(jp)
        tp = bridge.unflatten(bridge.to_state_dict(jp))
    x = np.random.default_rng(1).standard_normal((3, 56, 56, 3)
                                                 ).astype(np.float32)
    ref = jemu2.encode_image_lm(jp, CFG, jnp.asarray(x))
    out = emu2.encode_image_lm(tp, CFG, torch.from_numpy(x))
    close(out, ref)


def test_avg_pool_tokens_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 64, 5)).astype(np.float32)
    close(L.avg_pool_tokens(torch.from_numpy(x), 16),
          jlayers.avg_pool_tokens(jnp.asarray(x), 16))


REQUESTS = [
    [pil(0), "describe this image"],                        # plain format
    [[pil(1), "what is this?"], ["a cat"], [pil(2), "and this?"]],  # chat
    ["[VIDEO]", pil(3), pil(4), "[/VIDEO]", "what happens?"],  # video span
    [["hello there"]],                                      # text only
]


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_tiny_chat_tokens_match_jax(jparams, quantize):
    """EmuChatGeneration on the tiny Emu2: plain, two-image chat, video and
    text-only requests, beam 3 and greedy; the same prompt texts and the
    same new tokens as the JAX pipeline."""
    tok = tiny_tokenizer()
    jchat = JChat(jax.tree.map(jnp.asarray, jparams), CFG, tok,
                  quantize=quantize)
    chat = EmuChatGeneration(to_torch(jparams), CFG, tok, quantize=quantize)
    assert (chat._assemble_batch(REQUESTS, False)[0]
            == jchat._assemble_batch(REQUESTS, False)[0])
    kw = dict(max_new_tokens=6, skip_special_tokens=False)
    assert (chat.generate_batch(REQUESTS[:2], num_beams=3, **kw)
            == jchat.generate_batch(REQUESTS[:2], num_beams=3, **kw))
    assert (chat.generate_batch(REQUESTS[2:], num_beams=1, **kw)
            == jchat.generate_batch(REQUESTS[2:], num_beams=1, **kw))
    assert chat.last_stats["decode_steps"] >= 1


def test_chat_grounding_and_errors(jparams):
    tok = tiny_tokenizer()
    chat = EmuChatGeneration(to_torch(jparams), CFG, tok)
    jchat = JChat(jax.tree.map(jnp.asarray, jparams), CFG, tok)
    req = [[pil(5), "where is the cat?"]]
    assert (chat._assemble_batch([req], True)[0]
            == jchat._assemble_batch([req], True)[0])
    with pytest.raises(ValueError, match="user input"):
        chat.generate_batch([[["a"], ["b"]]])
    with pytest.raises(NotImplementedError):
        EmuChatGeneration(to_torch(jparams), CFG, tok,
                          preprocess_mode="device")
    with pytest.raises(NotImplementedError):
        chat(["hi"], do_sample=True, num_beams=1, max_new_tokens=2)


def test_int4_decode_step_matches_jax_kernel_route():
    """Hidden 256, F 512, 5 rows: the JAX package with its TPU routes
    forced (matmul_q4 for the projections and the lm_head,
    fused_swiglu_q4 for the MLP, the fused norms and decode attention, all
    in interpret mode) against the port's plain twins on the same routes."""
    cfg = LlamaConfig(hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      vocab_size=300, extended_vocab_size=300)
    jp = perturb(jllama.init(jax.random.PRNGKey(3), cfg), seed=3)
    jq = jax.jit(lambda p: jquant.quantize_model_params(
        {"decoder": jllama.fuse_projections(p)}, "int4"))(
            jax.tree.map(jnp.asarray, jp))["decoder"]
    tq = bridge.unflatten(bridge.to_state_dict(jq))
    rng = np.random.default_rng(4)
    b, s, slot = 5, 24, 17
    shape = (2, b, cfg.kv_heads, s, cfg.head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    emb = rng.standard_normal((b, 1, 256)).astype(np.float32)
    mask = np.arange(s)[None] <= np.array([[17], [17], [12], [9], [17]])
    mask[:, slot + 1:] = False
    pos = mask.sum(-1).astype(np.int32) - 1

    from emu_tpu.ops import decode_attention as jda
    from emu_tpu.ops import fused_norm as jfn
    from emu_tpu.ops import q4_matmul as jq4

    calls = {}

    def interpret(name, fn):
        def run(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            kw["interpret"] = True
            return fn(*a, **kw)
        return run

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(jax, "default_backend",
                                              lambda: "tpu"))
        for mod, name in [(jq4, "matmul_q4"), (jq4, "fused_swiglu_q4"),
                          (jfn, "add_rmsnorm"), (jfn, "rms_norm_fused"),
                          (jda, "decode_attention")]:
            stack.enter_context(mock.patch.object(
                mod, name, interpret(name, getattr(mod, name))))
        jh, _ = jllama.decode_step(
            jq, cfg, {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
            jnp.asarray(emb), jnp.int32(slot), jnp.asarray(mask),
            jnp.asarray(pos))
        jlog = jllama.logits(jq, jh[:, 0])
    # traced once for the layer scan: qkv, o_proj, swiglu; plus the lm_head
    assert calls["matmul_q4"] == 3 and calls["fused_swiglu_q4"] == 1

    th, _ = llama.decode_step(
        tq, cfg, {"k": torch.from_numpy(kc), "v": torch.from_numpy(vc)},
        torch.from_numpy(emb), slot, torch.from_numpy(mask),
        torch.from_numpy(pos).long())
    tlog = llama.logits(tq, th[:, 0])
    for got, ref in ((th, jh), (tlog, jlog)):
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max()
        assert err <= 2e-3 * np.abs(ref).max(), err


def test_port_vit_w8a8_init_builds_quantized_blocks():
    """vit.init(quant="w8a8") on the CPU: int8 kernels and fp32 scales in
    the JAX package's VIT_PATTERNS places; the forward runs."""
    vcfg = dataclasses.replace(CFG.vision, layers=1)
    p = vit.init(vcfg, Init(generator=torch.Generator().manual_seed(0)),
                 quant="w8a8")
    blk = p["blocks"]
    for path in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"),
                 ("mlp", "fc2")):
        d = blk[path[0]][path[1]]
        assert d["kernel_w8a8"].dtype == torch.int8
        assert d["scale"].dtype == torch.float32
    out = vit.forward_features(p, vcfg, torch.zeros(1, 56, 56, 3))
    assert out.shape == (1, 17, 32) and bool(torch.isfinite(out).all())
