"""The port's diffusion modules (`emu_tpu_torch.diffusion`, the UNet
quantization, the bridge's list and conv support, `batched_mha`'s twin and
the attention routing) against the JAX package's, at tiny sizes in fp32 on
the CPU, with the same numpy inputs: 2e-4 of max|ref|; the scheduler tables
and the quantized UNet tree bit for bit."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from emu_tpu.config import SchedulerConfig, UNetConfig, VAEConfig
from emu_tpu.diffusion import layers as jD
from emu_tpu.diffusion import schedulers as jS
from emu_tpu.diffusion import unet as junet
from emu_tpu.diffusion import vae as jvae
from emu_tpu.ops import flash_attention as jfa
from emu_tpu.ops import quant as jquant
from emu_tpu_torch import bridge
from emu_tpu_torch import config as pconfig
from emu_tpu_torch.diffusion import layers as D
from emu_tpu_torch.diffusion import schedulers as S
from emu_tpu_torch.diffusion import unet, vae
from emu_tpu_torch.ops import attention as att
from emu_tpu_torch.ops import flash_attention as fa
from emu_tpu_torch.ops import quant as Q

REL = 2e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(port, ref, rel=REL):
    """|port - ref| <= rel * max|ref| everywhere."""
    ref = np.asarray(ref, np.float32)
    got = port.detach().float().numpy() if torch.is_tensor(port) else port
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def perturb(tree, seed=0):
    """Every leaf moved off its init (biases off zero, scales off one)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


def to_torch(tree):
    return bridge.unflatten(bridge.to_state_dict(tree))


def t(a):
    return torch.from_numpy(np.asarray(a))


UNET_CFGS = {
    "sdxl": UNetConfig.tiny(cross_attention_dim=16, sdxl=True),
    "sd": UNetConfig.tiny(cross_attention_dim=16, sdxl=False),
    "sd_conv_proj": dataclasses.replace(
        UNetConfig.tiny(cross_attention_dim=16, sdxl=False),
        use_linear_projection=False),
}


def port_cfg(cfg):
    """The port's copy of a JAX config dataclass, field by field."""
    return getattr(pconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def unets():
    return {name: perturb(junet.init(jax.random.PRNGKey(i), cfg), i)
            for i, (name, cfg) in enumerate(UNET_CFGS.items())}


@pytest.fixture(scope="module")
def vae_params():
    return perturb(jvae.init(jax.random.PRNGKey(5), VAEConfig.tiny()), 5)


def unet_inputs(cfg, seed=0, b=2):
    x = rand(seed, b, 8, 8, cfg.in_channels)
    ts = np.array([999.0, 421.0][:b], np.float32)
    ctx = rand(seed + 1, b, 5, cfg.cross_attention_dim)
    kw = {}
    if cfg.addition_embed_type == "text_time":
        kw = {"added_text_embeds": ctx.mean(1),
              "added_time_ids": np.tile(np.array(
                  [[1024, 1024, 0, 0, 1024, 1024]], np.float32), (b, 1))}
    return x, ts, ctx, kw


# --- layers -----------------------------------------------------------------


@pytest.mark.parametrize("stride,padding,k", [(1, 1, 3), (2, 1, 3),
                                              (1, 0, 1)])
def test_conv2d_matches_jax(stride, padding, k):
    """NHWC activations and the HWIO kernel as the JAX tree holds it (the
    port permutes to an OIHW view inside the call)."""
    p = {"kernel": rand(0, k, k, 6, 10, scale=0.3), "bias": rand(1, 10)}
    x = rand(2, 2, 9, 7, 6)
    ref = jD.conv2d(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride,
                    padding)
    got = D.conv2d({n: t(v) for n, v in p.items()}, t(x), stride, padding)
    assert got.shape == ref.shape
    close(got, ref)


def test_group_norm_matches_jax():
    p = {"scale": rand(0, 16) + 1, "bias": rand(1, 16)}
    x = rand(2, 2, 5, 6, 16, scale=3.0) + 1.5
    ref = jD.group_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), 4, 1e-5)
    close(D.group_norm({n: t(v) for n, v in p.items()}, t(x), 4, 1e-5), ref)


@pytest.mark.parametrize("flip,shift", [(True, 0.0), (False, 1.0)])
def test_timestep_embedding_matches_jax(flip, shift):
    ts = np.array([0.0, 1.0, 421.0, 999.0], np.float32)
    ref = jD.timestep_embedding(jnp.asarray(ts), 32, flip, shift)
    close(D.timestep_embedding(t(ts), 32, flip, shift), ref)


@pytest.mark.parametrize("cross", [False, True])
def test_attention_matches_jax(cross):
    p = perturb(jD.attention_init(jax.random.PRNGKey(0), 32,
                                  24 if cross else None))
    x = rand(1, 2, 70, 32)
    ctx = rand(2, 2, 5, 24) if cross else None
    ref = jD.attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                       None if ctx is None else jnp.asarray(ctx), 4)
    got = D.attention(to_torch(p), t(x), None if ctx is None else t(ctx), 4)
    close(got, ref)


@pytest.mark.parametrize("shortcut,temb", [(True, True), (False, False)])
def test_resnet_block_matches_jax(shortcut, temb):
    cin, cout = 16, (32 if shortcut else 16)
    p = perturb(jD.resnet_block_init(jax.random.PRNGKey(1), cin, cout,
                                     24 if temb else None))
    x = rand(0, 2, 6, 5, cin)
    tv = rand(1, 2, 24) if temb else None
    ref = jD.resnet_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                          None if tv is None else jnp.asarray(tv), 8, 1e-5)
    got = D.resnet_block(to_torch(p), t(x), None if tv is None else t(tv), 8,
                         1e-5)
    close(got, ref)


def test_upsample_matches_jax_nearest_resize():
    x = rand(0, 2, 3, 5, 4)
    ref = jax.image.resize(jnp.asarray(x), (2, 6, 10, 4), "nearest")
    np.testing.assert_array_equal(D.upsample_nearest2x(t(x)).numpy(),
                                  np.asarray(ref))


# --- schedulers ---------------------------------------------------------------


@pytest.mark.parametrize("spacing", ["leading", "linspace"])
def test_scheduler_tables_equal_to_the_bit(spacing):
    cfg = dataclasses.replace(SchedulerConfig(), timestep_spacing=spacing)
    pcfg = port_cfg(cfg)
    je, pe = jS.EulerDiscreteScheduler(cfg, 50), S.EulerDiscreteScheduler(
        pcfg, 50)
    np.testing.assert_array_equal(pe.timesteps.numpy(), np.asarray(je.timesteps))
    np.testing.assert_array_equal(pe.sigmas.numpy(), np.asarray(je.sigmas))
    assert pe.init_noise_sigma == je.init_noise_sigma
    jp, pp = jS.PNDMScheduler(cfg, 50), S.PNDMScheduler(pcfg, 50)
    np.testing.assert_array_equal(pp.timesteps.numpy(), np.asarray(jp.timesteps))
    np.testing.assert_array_equal(pp.alphas_cumprod.numpy(),
                                  np.asarray(jp.alphas_cumprod))
    assert float(pp.final_alpha_cumprod) == float(jp.final_alpha_cumprod)
    assert pp.num_steps == jp.num_steps == 51


def test_euler_steps_match_jax_over_a_whole_schedule():
    cfg = SchedulerConfig()
    js, ps = jS.EulerDiscreteScheduler(cfg, 50), S.EulerDiscreteScheduler(
        port_cfg(cfg), 50)
    x = rand(0, 1, 4, 4, 4) * js.init_noise_sigma
    jx, px = jnp.asarray(x), t(x)
    for i in range(50):
        close(ps.scale_model_input(px, i), js.scale_model_input(jx, i))
        eps = rand(100 + i, 1, 4, 4, 4)
        jx = js.step(jnp.asarray(eps), i, jx)
        px = ps.step(t(eps), i, px)
        close(px, jx)


def test_plms_steps_match_jax_over_a_whole_schedule():
    cfg = SchedulerConfig()
    js, ps = jS.PNDMScheduler(cfg, 50), S.PNDMScheduler(port_cfg(cfg), 50)
    x = rand(0, 1, 4, 4, 4)
    jx, px = jnp.asarray(x), t(x)
    jstate, pstate = js.init_state(x.shape), ps.init_state()
    for i in range(js.num_steps):
        eps = rand(200 + i, 1, 4, 4, 4)
        jx, jstate = js.step(jnp.asarray(eps), i, jx, jstate)
        px, pstate = ps.step(t(eps), i, px, pstate)
        close(px, jx)
    assert pstate["counter"] == int(jstate["counter"]) == 51


# --- UNet -----------------------------------------------------------------------


@pytest.mark.parametrize("name", list(UNET_CFGS))
def test_unet_forward_matches_jax(unets, name):
    cfg, params = UNET_CFGS[name], unets[name]
    x, ts, ctx, kw = unet_inputs(cfg)
    ref = junet.forward(params, cfg, jnp.asarray(x), jnp.asarray(ts),
                        jnp.asarray(ctx),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = unet.forward(to_torch(params), port_cfg(cfg), t(x), t(ts), t(ctx),
                       **{k: t(v) for k, v in kw.items()})
    assert got.shape == ref.shape == x.shape
    close(got, ref)


@pytest.mark.parametrize("name", ["sdxl", "sd"])
def test_unet_deep_cache_contract(unets, name):
    """return_cache gives the JAX package's cache feature, and a cached pass
    with the cache of the same (x, t) equals the full pass."""
    cfg, params = UNET_CFGS[name], unets[name]
    x, ts, ctx, kw = unet_inputs(cfg, seed=3)
    pp, pc = to_torch(params), port_cfg(cfg)
    tkw = {k: t(v) for k, v in kw.items()}
    jout, jcache = junet.forward(params, cfg, jnp.asarray(x), jnp.asarray(ts),
                                 jnp.asarray(ctx), return_cache=True,
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    out, cache = unet.forward(pp, pc, t(x), t(ts), t(ctx), return_cache=True,
                              **tkw)
    close(out, jout)
    close(cache, jcache)
    again, same = unet.forward(pp, pc, t(x), t(ts), t(ctx), deep_cache=cache,
                               **tkw)
    assert same is cache
    close(again, out.numpy(), 1e-6)


# --- VAE --------------------------------------------------------------------


def test_vae_decode_and_encode_match_jax(vae_params):
    cfg = VAEConfig.tiny()
    pp, pc = to_torch(vae_params), port_cfg(cfg)
    z = rand(0, 1, 8, 8, 4)
    close(vae.decode(pp, pc, t(z)), jvae.decode(vae_params, cfg,
                                                jnp.asarray(z)))
    img = np.tanh(rand(1, 2, 16, 16, 3))
    jmean, jlogvar = jvae.encode(vae_params, cfg, jnp.asarray(img))
    mean, logvar = vae.encode(pp, pc, t(img))
    assert mean.shape == (2, 8, 8, 4)
    close(mean, jmean)
    close(logvar, jlogvar)


@pytest.mark.parametrize("n,chunk", [(48, 16), (50, 16)])
def test_vae_chunked_attention_matches_jax(vae_params, n, chunk):
    """The query-chunked single-head attention, ragged last chunk too."""
    p = vae_params["decoder"]["mid_block"]["attention"]
    x = rand(0, 1, n, 32)
    ref = jvae._vae_attention(p, jnp.asarray(x), chunk=chunk)
    got = vae._vae_attention(to_torch(p), t(x), chunk=chunk)
    close(got, ref)
    close(got, vae._vae_attention(to_torch(p), t(x), chunk=4096).numpy())


# --- quantization -------------------------------------------------------------


def test_quantize_unet_params_tree_equal_to_the_bit(unets):
    """W8A8 for the Transformer2D interior: the same leaves quantized, the
    same bits (against the JAX recipe inside jit, as every quantizer of the
    port); SD1.5's 4-D conv projections stay float."""
    for name in ("sdxl", "sd_conv_proj"):
        jq = jax.jit(jquant.quantize_unet_params)(unets[name])
        flat = bridge.flatten(jax.tree.map(np.asarray, jq))
        got = bridge.flatten(Q.quantize_unet_params(to_torch(unets[name])))
        assert sorted(got) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        n_q = sum(k.endswith("kernel_w8a8") for k in flat)
        assert n_q > 0
        if name == "sd_conv_proj":
            assert all(k + ".kernel" in flat for k in (
                "down_blocks.1.attentions.0.proj_in",
                "mid_block.attentions.0.proj_out"))


def test_quantized_unet_forward_matches_jax(unets):
    """The W8A8 UNet forward; 2e-3 of max|ref|, since activations are
    re-quantized per token inside every product and a one-step rounding
    flip of an activation moves its whole row (tests/test_torch_quant.py's
    limit)."""
    cfg = UNET_CFGS["sdxl"]
    jq = jax.jit(jquant.quantize_unet_params)(unets["sdxl"])
    x, ts, ctx, kw = unet_inputs(cfg, seed=7)
    ref = junet.forward(jq, cfg, jnp.asarray(x), jnp.asarray(ts),
                        jnp.asarray(ctx),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = unet.forward(Q.quantize_unet_params(to_torch(unets["sdxl"])),
                       port_cfg(cfg), t(x), t(ts), t(ctx),
                       **{k: t(v) for k, v in kw.items()})
    close(got, ref, 2e-3)


# --- bridge -----------------------------------------------------------------


def _structure(tree):
    """Nesting and leaf shapes; an empty list (a block without attentions)
    holds no leaf, so no flat state dict carries it, and is left out."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()
                if not (isinstance(v, list) and not v)}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    return tuple(np.shape(tree))


@pytest.mark.parametrize("which", ["unet_sdxl", "unet_conv_proj", "vae"])
def test_bridge_round_trips_diffusion_trees(unets, vae_params, which):
    """JAX tree → port (ParamTree, lists by index keys, HWIO conv kernels
    as they are) → back: the same structure, lists as lists, every leaf the
    same bits, and load_state_dict(strict) takes the flat names."""
    jtree = {"unet_sdxl": unets["sdxl"], "unet_conv_proj":
             unets["sd_conv_proj"], "vae": vae_params}[which]
    sd = bridge.to_state_dict(jtree)
    assert any(".0." in k for k in sd)
    module = bridge.ParamTree(bridge.unflatten(sd))
    back = module.tree()
    assert _structure(back) == _structure(jtree)
    flat = bridge.flatten(jax.tree.map(np.asarray, jtree))
    for k, v in bridge.flatten(back).items():
        np.testing.assert_array_equal(v.numpy(), flat[k], err_msg=k)
    assert sorted(module.state_dict()) == sorted(flat)
    fresh = bridge.ParamTree(bridge.cast_tree(back, dtype=torch.float64))
    fresh.load_state_dict(sd, strict=True)
    cast = bridge.cast_tree(back, dtype=torch.bfloat16)
    assert isinstance(cast["down_blocks" if "unet" in which else "decoder"],
                      (list, dict))


def test_trainable_stacks_only_the_stacked_subtrees(unets):
    """A Transformer2D's list of `blocks` stays a list of per-layer leaves;
    a ViT's stacked `blocks` dict still becomes Stacked."""
    tree = {"unet": to_torch(unets["sd"]),
            "visual": {"blocks": {"w": torch.zeros(3, 4, 5)}}}
    tr = bridge.trainable(tree)
    assert isinstance(tr["visual"]["blocks"], bridge.Stacked)
    blocks = tr["unet"]["down_blocks"][1]["attentions"][0]["blocks"]
    assert isinstance(blocks, list) and not isinstance(blocks[0],
                                                       bridge.Stacked)
    leaf = blocks[0]["attn1"]["to_q"]["kernel"]
    assert leaf.requires_grad and leaf.grad is not None
    n = sum(1 for _ in bridge.grad_leaves(tr))
    assert n == len(bridge.flatten(tree))


# --- batched_mha and the routing -----------------------------------------------


@pytest.mark.parametrize("s,d", [(67, 16), (64, 40), (70, 80), (33, 160)])
def test_batched_mha_reference_matches_jax_kernel(s, d):
    """The plain twin against the TPU kernel in interpret mode, ragged S
    (the kernel pads S to 8 and masks the padded columns)."""
    q, k, v = (rand(i, 2, s, 3, d) for i in range(3))
    ref = jfa.batched_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale=d ** -0.5, interpret=True)
    got = fa.batched_mha(t(q), t(k), t(v), scale=d ** -0.5)
    assert fa.batched_mha.launches == 0        # CPU tensors: no launch
    close(got, ref)


@pytest.mark.parametrize("case,route", [
    (dict(sq=1024, skv=1024, d=64), "batched_mha"),       # SDXL 32² level
    (dict(sq=64, skv=64, d=160), "batched_mha"),          # SD1.5 mid
    (dict(sq=256, skv=256, d=256), "batched_mha"),
    (dict(sq=4096, skv=4096, d=64), "batched_mha"),       # SDXL 64² level
    (dict(sq=4096, skv=4096, d=160), "batched_mha"),      # past A's D
    (dict(sq=32, skv=32, d=64), "flash"),                 # below 64 tokens
    (dict(sq=1024, skv=1024, d=64, causal=True), "flash"),
    (dict(sq=1024, skv=1024, d=64, kv_valid=True), "flash"),
    (dict(sq=1024, skv=1024, d=512), "plain"),            # the VAE's head
    (dict(sq=4096, skv=64, d=64), "flash"),               # cross-attention
    (dict(sq=1024, skv=32, d=160), "plain"),              # cross, D > 128
    (dict(sq=1024, skv=1024, d=64, dtype=torch.float32), "plain"),
    (dict(sq=1024, skv=1024, d=64, grad=True), "flash"),  # no MHA backward
    (dict(sq=256, skv=256, d=60), "plain"),               # D % 8
    (dict(sq=4096, skv=4096, d=40), "batched_mha"),       # SD1.5 64² level
    (dict(sq=4097, skv=4097, d=64), "flash"),             # past the edge
    (dict(sq=8192, skv=8192, d=160), "plain"),            # past A and MHA
])
def test_attention_route(case, route):
    """The dispatch contract (no tensor is computed on). The self-attention
    edge, 64 to 4096 tokens to batched_mha, is the one the card measured
    (chip_smoke.py phase 3, ROUTE_SHAPES: batched_mha faster than kernel A
    at 257, 1024 and 4096 tokens)."""
    dt = case.get("dtype", torch.bfloat16)
    b, h = 2, 4
    q = torch.empty(b, case["sq"], h, case["d"], dtype=dt, device="meta")
    k = torch.empty(b, case["skv"], h, case["d"], dtype=dt, device="meta")
    if case.get("grad"):
        q.requires_grad_()
    valid = torch.ones(b, case["skv"]) if case.get("kv_valid") else None
    assert att.attention_route(q, k, k, kv_valid=valid,
                               causal=case.get("causal", False)) == route


def test_dot_product_attention_reaches_batched_mha(monkeypatch):
    """A bf16 unmasked self-attention of 64..4096 tokens calls batched_mha
    (its CPU twin here) and agrees with the plain chain."""
    calls = []
    real = fa.batched_mha
    monkeypatch.setattr(att.fa, "batched_mha",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = t(rand(0, 1, 96, 2, 40)).bfloat16()
    out = att.dot_product_attention(x, x, x)
    assert calls == [1]
    ref = att.grouped_attention(x.float(), x.float(), x.float(),
                                scale=40 ** -0.5)
    close(out.float(), ref.numpy(), 2e-2)


def test_diffusion_modules_are_scanned_for_jax_imports():
    """The import scan (tests/test_torch_generation.py) walks every file of
    the port, the new diffusion and pipeline modules among them."""
    names = {os.path.relpath(os.path.join(d, n), ROOT)
             for d, _, ns in os.walk(os.path.join(ROOT, "emu_tpu_torch"))
             for n in ns}
    for f in ("diffusion/layers.py", "diffusion/unet.py", "diffusion/vae.py",
              "diffusion/schedulers.py", "pipelines/visual_generation.py",
              "pipelines/emu1_pipeline.py", "csrc/batched_mha.cu"):
        assert os.path.join("emu_tpu_torch", f) in names
