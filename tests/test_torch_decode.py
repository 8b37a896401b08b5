"""Kernel D's twins in every form (int8 cache, Sq <= 32 chunks with the
intra-chunk triangle, page pools) against the JAX package's Pallas kernels
in interpret mode, and the port's LLaMA decode forms (int8 cache, per-row
slots, mixed chunks, verify chunks) against their JAX twins. Inputs are
made with numpy from a seed; fp32 on the CPU; tolerance 2e-4 unless a test
says otherwise."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from emu_tpu.config import LlamaConfig
from emu_tpu.models import llama as jllama
from emu_tpu.ops import decode_attention as jdec
from emu_tpu_torch import bridge
from emu_tpu_torch import config as pconfig
from emu_tpu_torch.models import llama
from emu_tpu_torch.ops import attention as att
from emu_tpu_torch.ops import decode_attention as dec

TOL = 2e-4


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


def int8_cache(rng, *shape):
    """int8 values over the full range and positive fp32 scales."""
    vals = rng.integers(-127, 128, shape).astype(np.int8)
    scales = rng.uniform(0.005, 0.03, shape[:-1]).astype(np.float32)
    return vals, scales


def jargs(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def targs(*arrays):
    return [None if a is None else t(a) for a in arrays]


# -- kernel twins against the Pallas kernel (interpret mode) ----------------


@pytest.mark.parametrize("extra", [True, False], ids=["k_new", "no_extra"])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_decode_int8_twin_matches_pallas(h, hkv, extra):
    """Sq = 1 over an int8 stacked cache, layer 2 of 3: scales folded into
    the score and the probabilities."""
    rng = np.random.default_rng(10)
    n_layers, b, s, d = 3, 2, 32, 32
    q = rnd(rng, b, 1, h, d)
    kc, ks = int8_cache(rng, n_layers, b, hkv, s, d)
    vc, vs = int8_cache(rng, n_layers, b, hkv, s, d)
    kn = rnd(rng, b, hkv, 1, d) if extra else None
    vn = rnd(rng, b, hkv, 1, d) if extra else None
    valid = np.arange(s)[None, :] < np.array([[11], [29]])
    ref = jdec.decode_attention(*jargs(q, kc, vc, valid, ks, vs),
                                scale=d ** -0.5, layer=jnp.int32(2),
                                k_new=None if kn is None else jnp.asarray(kn),
                                v_new=None if vn is None else jnp.asarray(vn),
                                interpret=True)
    out = dec.decode_attention(*targs(q, kc, vc, valid, ks, vs),
                               scale=d ** -0.5, layer=2,
                               k_new=None if kn is None else t(kn),
                               v_new=None if vn is None else t(vn))
    close(out, ref)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("qn,h,hkv", [(4, 4, 4), (32, 2, 2), (4, 8, 2),
                                      (32, 4, 1)],
                         ids=["qn4_mha", "qn32_mha", "qn4_gqa4", "qn32_gqa4"])
def test_decode_chunk_twin_matches_pallas(qn, h, hkv, quant):
    """Sq = qn queries with their chunk as extra columns: the cache for
    every query, chunk column j for query i iff j <= i."""
    rng = np.random.default_rng(11)
    n_layers, b, s, d = 2, 2, 40, 16
    q = rnd(rng, b, qn, h, d)
    if quant:
        kc, ks = int8_cache(rng, n_layers, b, hkv, s, d)
        vc, vs = int8_cache(rng, n_layers, b, hkv, s, d)
    else:
        kc, vc = rnd(rng, n_layers, b, hkv, s, d), rnd(rng, n_layers, b, hkv,
                                                        s, d)
        ks = vs = None
    kn, vn = rnd(rng, b, hkv, qn, d), rnd(rng, b, hkv, qn, d)
    valid = np.arange(s)[None, :] < np.array([[7], [33]])
    ref = jdec.decode_attention(*jargs(q, kc, vc, valid, ks, vs),
                                scale=d ** -0.5, layer=jnp.int32(1),
                                k_new=jnp.asarray(kn), v_new=jnp.asarray(vn),
                                interpret=True)
    out = dec.decode_attention(*targs(q, kc, vc, valid, ks, vs),
                               scale=d ** -0.5, layer=1, k_new=t(kn),
                               v_new=t(vn))
    close(out, ref)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("qn", [1, 5])
def test_paged_decode_twin_matches_pallas(qn, quant):
    """A shuffled page table over a [L, n_pages, Hkv, page, D] pool; int8
    scales as the logical-view planes."""
    rng = np.random.default_rng(12)
    n_layers, n_pages, page, p_count, b, h, hkv, d = 2, 9, 8, 4, 2, 4, 2, 16
    q = rnd(rng, b, qn, h, d)
    pool = (n_layers, n_pages, hkv, page, d)
    if quant:
        kc, _ = int8_cache(rng, *pool)
        vc, _ = int8_cache(rng, *pool)
        lshape = (n_layers, b, hkv, p_count * page)
        ks = rng.uniform(0.005, 0.03, lshape).astype(np.float32)
        vs = rng.uniform(0.005, 0.03, lshape).astype(np.float32)
    else:
        kc, vc = rnd(rng, *pool), rnd(rng, *pool)
        ks = vs = None
    table = rng.permutation(n_pages)[:b * p_count].reshape(b, p_count)
    table = table.astype(np.int32)
    valid = np.arange(p_count * page)[None, :] < np.array([[13], [30]])
    kn = rnd(rng, b, hkv, qn, d)
    vn = rnd(rng, b, hkv, qn, d)
    ref = jdec.paged_decode_attention(
        *jargs(q, kc, vc, table, valid), scale=d ** -0.5,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), layer=jnp.int32(1),
        k_new=jnp.asarray(kn), v_new=jnp.asarray(vn), interpret=True)
    out = dec.paged_decode_attention(
        *targs(q, kc, vc, table, valid), scale=d ** -0.5,
        k_scale=None if ks is None else t(ks),
        v_scale=None if vs is None else t(vs), layer=1, k_new=t(kn),
        v_new=t(vn))
    close(out, ref)


def test_cache_attention_routes():
    """The dispatcher's rule: Sq = 1, or k_new with Sq <= 32, takes kernel
    D's wrapper (dense or paged); a longer chunk takes the plain chain over
    the dequantized cache, and agrees with the twin."""
    rng = np.random.default_rng(13)
    b, h, s, d, qn = 2, 4, 24, 16, 40
    kc, ks = int8_cache(rng, 2, b, h, s, d)
    vc, vs = int8_cache(rng, 2, b, h, s, d)
    q = t(rnd(rng, b, qn, h, d))
    kn, vn = t(rnd(rng, b, h, qn, d)), t(rnd(rng, b, h, qn, d))
    valid = t(np.arange(s)[None, :] < np.array([[9], [20]]))
    kv = {"k": t(kc), "v": t(vc), "k_scale": t(ks), "v_scale": t(vs),
          "layer": 1, "k_new": kn, "v_new": vn}
    plain = att.cache_attention(q, kv, kv_valid=valid, scale=d ** -0.5)
    twin = dec.decode_attention(q, t(kc), t(vc), valid, t(ks), t(vs),
                                scale=d ** -0.5, layer=1, k_new=kn, v_new=vn)
    close(plain, twin.numpy())


# -- the LLaMA decode forms against the JAX package ------------------------

WIDTHS = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, vocab_size=97, extended_vocab_size=97,
              max_position_embeddings=128)


def perturb(tree, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


@pytest.fixture(scope="module", params=[None, 2], ids=["mha", "gqa"])
def lm(request):
    cfg = LlamaConfig(**WIDTHS, num_key_value_heads=request.param)
    tcfg = pconfig.LlamaConfig(**WIDTHS, num_key_value_heads=request.param)
    jp = perturb(jllama.init(jax.random.PRNGKey(4), cfg))
    return (cfg, jax.tree.map(jnp.asarray, jp), tcfg,
            bridge.unflatten(bridge.to_state_dict(jp)))


def test_kv_quantize_bit_for_bit():
    x = np.random.default_rng(14).standard_normal((3, 5, 4, 32)
                                                  ).astype(np.float32)
    x[0, 0, 0] = 0.0                                # the 1e-8 floor
    jq, js = jax.jit(jllama.kv_quantize)(jnp.asarray(x))
    q, s = llama.kv_quantize(t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_init_cache_quant_layout(lm):
    cfg, _, tcfg, _ = lm
    ref = jllama.init_cache(cfg, 3, 16, quant=True)
    got = llama.init_cache(tcfg, 3, 16, device="cpu", quant=True)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(ref[k].dtype)


def close_cache(got, ref, keys=None):
    """Float planes to 2e-4; int8 planes within one quantization step of
    the JAX package's (k/v differ in the last fp32 bits, which can move a
    value across a rounding boundary) and equal in >= 99% of entries."""
    for key in keys or ref:
        g, r = got[key].float().numpy(), np.asarray(ref[key], np.float32)
        if got[key].dtype == torch.int8:
            diff = np.abs(g - r)
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, key
        else:
            np.testing.assert_allclose(g, r, atol=TOL, rtol=TOL, err_msg=key)


def prefilled(lm, quant, b=3, s=6, total=24, seed=5):
    """The same left-padded prompt prefilled by both packages."""
    cfg, jp, tcfg, tp = lm
    rng = np.random.default_rng(seed)
    emb = rnd(rng, b, s, cfg.hidden_size)
    mask = np.ones((b, s), np.int32)
    mask[min(1, b - 1), :2] = 0 if b > 1 else 1
    jc = jllama.init_cache(cfg, b, total, dtype=jnp.float32, quant=quant)
    jh, jc = jllama.prefill(jp, cfg, jnp.asarray(emb), jnp.asarray(mask), jc)
    tc = llama.init_cache(tcfg, b, total, device="cpu", dtype=torch.float32,
                          quant=quant)
    th, tc = llama.prefill(tp, tcfg, t(emb), t(mask), tc)
    return jh, jc, th, tc, mask, rng


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_prefill_into_cache_matches_jax(lm, quant):
    jh, jc, th, tc, mask, _ = prefilled(lm, quant)
    valid = mask.astype(bool)
    close(th[torch.from_numpy(valid)], np.asarray(jh)[valid])
    close_cache({k: v[:, 0] for k, v in tc.items()},
                {k: np.asarray(v)[:, 0] for k, v in jc.items()})


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_decode_step_rows_matches_jax(lm, quant):
    """Per-row slots: rows at different lengths write different slots."""
    cfg, jp, tcfg, tp = lm
    jh, jc, th, tc, mask, rng = prefilled(lm, quant)
    b, total = 3, 24
    slots = np.array([6, 9, 7], np.int32)
    sm = np.zeros((b, total), bool)
    sm[:, :6] = mask.astype(bool)
    sm[1, 6:9] = True                       # row 1 has decoded 3 more
    sm[2, 6:7] = True
    sm[np.arange(b), slots] = True
    pos = sm.sum(-1).astype(np.int32) - 1
    tok = rnd(rng, b, 1, cfg.hidden_size)
    jh2, jc2 = jllama.decode_step_rows(jp, cfg, jc, jnp.asarray(tok),
                                       jnp.asarray(slots), jnp.asarray(sm),
                                       jnp.asarray(pos))
    th2, tc2 = llama.decode_step_rows(tp, tcfg, tc, t(tok), t(slots).long(),
                                      t(sm), t(pos).long())
    close(th2, jh2)
    close_cache(tc2, jc2)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_decode_mixed_rows_matches_jax(lm, quant):
    """A mixed step: decode rows carry one token at column 0, an admitting
    row a chunk of 5; every row's q positions are committed (row 2's tail
    runs past the cache's end, where the JAX package drops it)."""
    cfg, jp, tcfg, tp = lm
    jh, jc, th, tc, mask, rng = prefilled(lm, quant)
    b, total, q = 3, 24, 5
    slots = np.array([6, 6, 21], np.int32)
    sm = np.zeros((b, total), bool)
    sm[:, :6] = mask.astype(bool)
    sm[2, :21] = True
    pos = sm.sum(-1).astype(np.int32)
    emb = rnd(rng, b, q, cfg.hidden_size)
    jh2, jc2 = jllama.decode_mixed_rows(jp, cfg, jc, jnp.asarray(emb),
                                        jnp.asarray(slots), jnp.asarray(sm),
                                        jnp.asarray(pos))
    th2, tc2 = llama.decode_mixed_rows(tp, tcfg, tc, t(emb), t(slots).long(),
                                       t(sm), t(pos).long())
    close(th2, jh2)
    close_cache(tc2, jc2)


def packed_state(tcfg, kind, b=4, total=24, seed=9):
    """A cache of `kind` ("float": fp32, "bf16", "int8": int8 values and
    scales under bf16 activations) holding random committed rows, and each
    row's write index, committed mask and next position. Row 2 is an
    empty slot riding along; row 3 writes at 20, so a chunk there runs past
    the cache's end."""
    rng = np.random.default_rng(seed)
    shape = (tcfg.num_hidden_layers, b, tcfg.kv_heads, total, tcfg.head_dim)
    if kind == "int8":
        cache = {}
        for n in ("k", "v"):
            vals, scales = int8_cache(rng, *shape)
            cache[n], cache[n + "_scale"] = t(vals), t(scales)
    else:
        dt = torch.float32 if kind == "float" else torch.bfloat16
        cache = {n: t(rnd(rng, *shape)).to(dt) for n in ("k", "v")}
    slots = torch.tensor([6, 9, 0, 20])
    sm = torch.arange(total)[None] < slots[:, None]
    sm[0, :2] = False                       # a left-padded bucket row
    return cache, slots, sm, sm.sum(-1), rng


@pytest.mark.parametrize("admit,qlen", [(0, 5), (0, 3), (1, 5), (1, 2),
                                        (3, 5), (3, 3)],
                         ids=["first-full", "first-short", "middle-full",
                              "middle-short", "last-full", "last-short"])
@pytest.mark.parametrize("kind", ["float", "bf16", "int8"])
def test_decode_packed_rows_matches_mixed_rows(lm, kind, admit, qlen):
    """The packed mixed step (B decode rows + one slot's chunk of q) gives
    `decode_mixed_rows`' hidden states and committed cache rows on the same
    state: column 0 of every decode row, the admitting row's qlen real
    columns (a short final chunk is zero-padded to q, as the engine pads
    it). It writes nothing but its rows' slots."""
    _, _, tcfg, tp = lm
    q, b = 5, 4
    cache, slots, sm, pos, rng = packed_state(tcfg, kind)
    dt = torch.float32 if kind == "float" else torch.bfloat16
    tp = bridge.cast_tree(tp, "cpu", dt)
    dec = t(rnd(rng, b, tcfg.hidden_size)).to(dt)
    chunk = torch.zeros(q, tcfg.hidden_size, dtype=dt)
    chunk[:qlen] = t(rnd(rng, qlen, tcfg.hidden_size)).to(dt)
    grid = torch.zeros(b, q, tcfg.hidden_size, dtype=dt)
    grid[:, 0] = dec
    grid[admit] = chunk
    dense = {n: c.clone() for n, c in cache.items()}
    packed = {n: c.clone() for n, c in cache.items()}
    hd, _ = llama.decode_mixed_rows(tp, tcfg, dense, grid, slots, sm, pos)
    hp, _ = llama.decode_packed_rows(tp, tcfg, packed, torch.cat([dec, chunk]),
                                     admit, slots, sm, pos)
    assert hp.shape == (b + q, tcfg.hidden_size)
    tol = TOL if kind == "float" else 2e-2
    others = [r for r in range(b) if r != admit]
    close(hp[others], hd[others, 0].float(), tol)
    close(hp[b:b + qlen], hd[admit, :qlen].float(), tol)
    written = torch.zeros(b, cache["k"].shape[3], dtype=torch.bool)
    written[others, slots[others]] = True
    written[admit, slots[admit]:slots[admit] + qlen] = True
    wrote = written.clone()
    wrote[admit, slots[admit]:slots[admit] + q] = True
    for n in cache:
        # [L, B, S, Hkv(, D)]: the masks index (row, slot)
        got, want, was = (c[n].float().transpose(2, 3)
                          for c in (packed, dense, cache))
        assert torch.equal(got[:, ~wrote], was[:, ~wrote]), n
        diff = (got - want)[:, written].abs()
        if packed[n].dtype == torch.int8:
            assert diff.max() <= 1 and (diff > 0).float().mean() < 0.01, n
        else:
            bound = tol * (1 + want[:, written].abs().max())
            assert diff.max() <= bound, (n, float(diff.max()))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_decode_chunk_matches_jax(lm, quant):
    """The speculative verify chunk at one shared slot."""
    cfg, jp, tcfg, tp = lm
    jh, jc, th, tc, mask, rng = prefilled(lm, quant, b=1)
    q = 4
    emb = rnd(rng, 1, q, cfg.hidden_size)
    pos = (6 + np.arange(q))[None].astype(np.int32)
    jh2, jc2 = jllama.decode_chunk(jp, cfg, jc, jnp.asarray(emb),
                                   jnp.int32(6), jnp.asarray([6]),
                                   jnp.asarray(pos))
    th2, tc2 = llama.decode_chunk(tp, tcfg, tc, t(emb), 6,
                                  torch.tensor([6]), t(pos).long())
    close(th2, jh2)
    close_cache(tc2, jc2)


def test_reorder_cache_gathers_scale_planes(lm):
    _, _, tcfg, _ = lm
    c = llama.init_cache(tcfg, 3, 8, device="cpu", quant=True)
    for i, v in enumerate(c.values()):
        v.copy_(torch.arange(v.numel()).reshape(v.shape) % 100 + i)
    idx = torch.tensor([2, 2, 0])
    out = llama.reorder_cache(c, idx)
    assert sorted(out) == sorted(c)
    for k in c:
        assert torch.equal(out[k], c[k][:, idx])


def test_llama_config_copy_is_a_dataclass_twin():
    a = pconfig.LlamaConfig(**WIDTHS)
    assert dataclasses.asdict(a) == dataclasses.asdict(LlamaConfig(**WIDTHS))
