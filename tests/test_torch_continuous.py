"""The port's continuous-batching engine, speculative decoding, paged KV
lane and int8-KV beam search against the JAX package, on the tiny Emu2
decoder (`Emu2Config.tiny().llama`) with the same params bridged into the
port, fp32 on the CPU: token streams must be EXACTLY equal. Sampled rows
are held to their contract only (the RNG streams differ, PARITY divergence
2): greedy rows in a sampled pool stay exactly greedy, and sampled rows
move off the greedy stream."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from emu_tpu.config import Emu2Config
from emu_tpu.generation import continuous as jcont
from emu_tpu.generation import paged_kv as jpaged
from emu_tpu.generation import speculative as jspec
from emu_tpu.generation.engine import GenerationConfig as JGenerationConfig
from emu_tpu.generation.engine import llama_generate as jllama_generate
from emu_tpu.models import llama as jllama
from emu_tpu_torch import bridge
from emu_tpu_torch import config as pconfig
from emu_tpu_torch.generation import continuous, paged_kv, speculative
from emu_tpu_torch.generation.engine import GenerationConfig, llama_generate
from emu_tpu_torch.models import llama

JCFG = Emu2Config.tiny().llama
TCFG = pconfig.Emu2Config.tiny().llama
VOCAB = JCFG.extended_vocab_size


def perturb(tree, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


class Side:
    """One package's engine class, params and prompt embedding."""

    def __init__(self, engine_cls, params, embed, ones):
        self.Engine, self.params = engine_cls, params
        self.embed, self.ones = embed, ones

    def emb(self, ids):
        return self.embed(ids), self.ones(len(ids))


@pytest.fixture(scope="module")
def sides():
    jp = perturb(jllama.init(jax.random.PRNGKey(0), JCFG))
    jpj = jax.tree.map(jnp.asarray, jp)
    tp = bridge.unflatten(bridge.to_state_dict(jp))
    jside = Side(jcont.ContinuousEngine, jpj,
                 lambda ids: jllama.embed(jpj, jnp.asarray(ids)[None]),
                 lambda n: jnp.ones((1, n), jnp.int32))
    tside = Side(continuous.ContinuousEngine, tp,
                 lambda ids: llama.embed(tp, torch.tensor(ids)[None]),
                 lambda n: torch.ones(1, n, dtype=torch.int32))
    return jside, tside


def prompts(seed, *lengths):
    rng = np.random.RandomState(seed)
    return [[int(x) for x in rng.randint(1, VOCAB - 10, n)] for n in lengths]


def engine(side, cfg, **kw):
    return side.Engine(side.params, cfg, **kw)


# Each scenario drives one engine through the public API the same way the
# JAX package's tests do (tests/test_continuous.py) and returns its token
# streams; the port's must equal the JAX package's.

def sc_staggered(side, cfg):
    """Three staggered requests of different lengths (bucketed
    left-padding), greedy, admitted between steps."""
    ps = prompts(0, 5, 11, 23)
    eng = engine(side, cfg, max_slots=4, max_len=64,
                 prefill_buckets=(8, 16, 32), eos_token_id=96)
    ids = [eng.submit(*side.emb(ps[0]), 12)]
    eng.step()
    eng.step()
    ids.append(eng.submit(*side.emb(ps[1]), 12))
    eng.step()
    ids.append(eng.submit(*side.emb(ps[2]), 12))
    res = eng.run_until_drained()
    return [res[i] for i in ids]


def sc_step_block(side, cfg):
    """step_block with double-buffered records, mid-block retirement and
    admission into a freed slot."""
    ps = prompts(2, 5, 11, 23)
    eng = engine(side, cfg, max_slots=2, max_len=64,
                 prefill_buckets=(8, 16, 32), eos_token_id=96)
    ids = [eng.submit(*side.emb(ps[i]), 9) for i in (0, 1)]
    pending = eng.step_block(4)
    pending2 = eng.step_block(4)
    eng.record_block(pending)
    eng.record_block(pending2)
    if eng.free_slots():
        ids.append(eng.submit(*side.emb(ps[2]), 9))
    for _ in range(6):
        eng.record_block(eng.step_block(4))
        if all(r is None for r in eng.slot_req):
            break
    res = eng.finished()
    return [res[i] for i in ids]


def sc_slot_reuse(side, cfg):
    eng = engine(side, cfg, max_slots=1, max_len=48, prefill_buckets=(8,),
                 eos_token_id=None)
    r1 = eng.submit(*side.emb([3, 5, 7]), 4)
    out1 = eng.run_until_drained()
    r2 = eng.submit(*side.emb([11, 13]), 4)
    out2 = eng.run_until_drained()
    return [out1[r1], out2[r2]]


def sc_int8_kv(side, cfg):
    ps = prompts(1, 7, 19)
    eng = engine(side, cfg, max_slots=2, max_len=64, prefill_buckets=(8, 32),
                 eos_token_id=96, kv_cache_quant=True)
    ids = [eng.submit(*side.emb(p), 10) for p in ps]
    res = eng.run_until_drained()
    return [res[i] for i in ids]


def sc_chunked(side, cfg, quant=False):
    """A prompt longer than every bucket streams in 8-token chunks while
    another slot keeps decoding; then drain_admissions on a second
    admission, one of max_new 1."""
    short, long_a, long_b = prompts(7, 5, 37, 20)
    eng = engine(side, cfg, max_slots=3, max_len=64, prefill_buckets=(8, 16),
                 eos_token_id=96, chunk_size=8, kv_cache_quant=quant)
    rid_s = eng.submit(*side.emb(short), 12)
    rid_a = eng.submit(*side.emb(long_a), 8)
    assert eng._admissions
    before = len(eng.requests[rid_s].tokens)
    n_mixed = 0
    while eng._admissions:
        eng.step()
        n_mixed += 1
    assert n_mixed == 5 and len(eng.requests[rid_s].tokens) > before
    rid_b = eng.submit(*side.emb(long_b), 1)
    assert eng.drain_admissions() == 3
    res = eng.run_until_drained()
    assert len(res[rid_b]) == 1
    return [res[r] for r in (rid_s, rid_a, rid_b)]


def sc_chunked_int8(side, cfg):
    return sc_chunked(side, cfg, quant=True)


def sc_chunked_pool(side, cfg, quant=False):
    """One burst mixes a chunked and a bucket admission (`submit_many`):
    the chunked prompt streams into a middle slot while the bucket rows
    decode, and a bucket row of max_new 2 retires and rides along
    inactive; then a chunked prompt streams into the last slot."""
    a, c, long_b, e, long_d = prompts(41, 6, 12, 29, 5, 19)
    eng = engine(side, cfg, max_slots=4, max_len=64, prefill_buckets=(8, 16),
                 eos_token_id=None, chunk_size=8, kv_cache_quant=quant)
    ids = [eng.submit(*side.emb(p), 14) for p in (a, c)]
    ids += eng.submit_many([(*side.emb(long_b), 6), (*side.emb(e), 2)])
    assert None not in eng.slot_req
    for _ in range(4):                      # long_b's 29 tokens: 4 chunks
        eng.step()
    assert not eng._admissions and eng.slot_req.index(None) == 3
    ids.append(eng.submit(*side.emb(long_d), 5))
    res = eng.run_until_drained()
    return [res[i] for i in ids]


def sc_chunked_pool_int8(side, cfg):
    return sc_chunked_pool(side, cfg, quant=True)


def sc_chunked_first_eos(side, cfg):
    """A chunked admission whose first token is EOS completes at its final
    chunk and frees its slot (eos chosen as that prompt's first greedy
    token)."""
    (long,) = prompts(9, 20)
    first = sc_first_token(side, cfg, long)
    eng = engine(side, cfg, max_slots=1, max_len=64, prefill_buckets=(8, 16),
                 eos_token_id=first, chunk_size=8)
    rid = eng.submit(*side.emb(long), 6)
    res = eng.run_until_drained()
    assert eng.slot_req == [None] and res[rid] == [first]
    return [res[rid]]


def sc_first_token(side, cfg, ids):
    eng = engine(side, cfg, max_slots=1, max_len=64, prefill_buckets=(32,),
                 eos_token_id=None)
    rid = eng.submit(*side.emb(ids), 1)
    return eng.run_until_drained()[rid][0]


def sc_submit_many(side, cfg):
    """One prefill per bucket (a group of 3, padded to 4 by duplicating
    row 0) and max_prefill_rows=2 splitting a group of 3; then the block
    path with refills, as a serving dispatcher drives it."""
    ps = prompts(21, 5, 7, 19)
    eng = engine(side, cfg, max_slots=4, max_len=64, prefill_buckets=(8, 32),
                 eos_token_id=96)
    ids = eng.submit_many([(*side.emb(p), 10) for p in ps])
    res = eng.run_until_drained()
    out = [res[i] for i in ids]
    ps = prompts(31, 5, 6, 7)
    eng = engine(side, cfg, max_slots=4, max_len=64, prefill_buckets=(8,),
                 eos_token_id=96, max_prefill_rows=2)
    ids = eng.submit_many([(*side.emb(p), 8) for p in ps])
    res = eng.run_until_drained()
    out += [res[i] for i in ids]
    ps = prompts(23, 5, 6, 7, 21)
    budgets = [4, 12, 12, 9]
    eng = engine(side, cfg, max_slots=2, max_len=64, prefill_buckets=(8, 32),
                 eos_token_id=96)
    queue = list(zip(ps, budgets))
    ids, pending = [], None
    for _ in range(100):
        while queue and eng.free_slots():
            p, b = queue.pop(0)
            ids += eng.submit_many([(*side.emb(p), b)])
        busy = any(r is not None for r in eng.slot_req)
        if busy:
            blk = eng.step_block(eng.suggested_block(6, floor=2))
            if pending is not None:
                eng.record_block(pending)
            pending = blk
        elif pending is not None:
            eng.record_block(pending)
            pending = None
        if not queue and not busy and pending is None:
            break
    res = eng.finished()
    return out + [res[i] for i in ids]


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_staggered, sc_step_block, sc_slot_reuse, sc_int8_kv, sc_chunked,
    sc_chunked_int8, sc_chunked_pool, sc_chunked_pool_int8,
    sc_chunked_first_eos, sc_submit_many)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_jax(sides, name):
    jside, tside = sides
    want = SCENARIOS[name](jside, JCFG)
    got = SCENARIOS[name](tside, TCFG)
    want = [[int(x) for x in row] for row in want]
    assert got == want, (got, want)
    assert all(len(row) >= 1 for row in got)


def test_suggested_block_and_greedy_only_refusal(sides):
    _, tside = sides
    ps = prompts(29, 5, 9)
    eng = engine(tside, TCFG, max_slots=2, max_len=64,
                 prefill_buckets=(8, 16), eos_token_id=96)
    eng.submit_many([(*tside.emb(p), b) for p, b in zip(ps, (5, 11))])
    assert eng.suggested_block(16) == 4
    assert eng.suggested_block(16, floor=8) == 8
    with pytest.raises(ValueError, match="free slots"):
        eng.submit_many([(*tside.emb([1]), 8)])
    fresh = engine(tside, TCFG, max_slots=1, max_len=32,
                   prefill_buckets=(8,), eos_token_id=None)
    with pytest.raises(ValueError, match="greedy-only"):
        fresh.submit(*tside.emb(ps[0]), 4, temperature=0.7)


def greedy_oracle(side_params, ids, max_new, eos):
    g = GenerationConfig(max_new_tokens=max_new, eos_token_id=eos)
    out = llama_generate(side_params, TCFG,
                         llama.embed(side_params, torch.tensor(ids)[None]),
                         torch.ones(1, len(ids), dtype=torch.int32), g)
    toks = out[0].tolist()
    return toks[:toks.index(eos) + 1] if eos in toks else toks


@pytest.mark.parametrize("chunked", [False, True], ids=["bucket", "chunked"])
def test_per_request_sampling_contract(sides, chunked):
    """A temperature-0 row in a sampling pool decodes the exact greedy
    stream while a temperature-1.5 row shares its steps and leaves the
    greedy stream."""
    _, tside = sides
    g_prompt, s_prompt = prompts(13, 21 if chunked else 7, 9)
    eng = engine(tside, TCFG, max_slots=2, max_len=64,
                 prefill_buckets=(8, 16), eos_token_id=None,
                 chunk_size=8 if chunked else None,
                 per_request_sampling=True, seed=3)
    rid_g = eng.submit(*tside.emb(g_prompt), 10, temperature=0.0)
    rid_s = eng.submit(*tside.emb(s_prompt), 10, temperature=1.5)
    res = eng.run_until_drained()
    assert res[rid_g] == greedy_oracle(tside.params, g_prompt, 10, -1)
    assert len(res[rid_s]) == 10
    assert res[rid_s] != greedy_oracle(tside.params, s_prompt, 10, -1)


def test_engine_close_releases_state(sides):
    _, tside = sides
    eng = engine(tside, TCFG, max_slots=2, max_len=32, prefill_buckets=(8,),
                 eos_token_id=None)
    eng.submit(*tside.emb([3, 5]), 3)
    eng.run_until_drained()
    eng.close()
    assert eng.state is None


# -- speculative decoding ---------------------------------------------------

@pytest.fixture(scope="module")
def drafts(sides):
    """A weak draft (a different random 1-layer model) in both packages."""
    jside, _ = sides
    dcfg = dataclasses.replace(JCFG, num_hidden_layers=1)
    tdcfg = dataclasses.replace(TCFG, num_hidden_layers=1)
    jd = perturb(jllama.init(jax.random.PRNGKey(99), dcfg), seed=9)
    return (jax.tree.map(jnp.asarray, jd), dcfg,
            bridge.unflatten(bridge.to_state_dict(jd)), tdcfg)


@pytest.mark.parametrize("draft", ["weak", "perfect"])
def test_speculative_matches_jax_and_greedy(sides, drafts, draft):
    jside, tside = sides
    jd, dcfg, td, tdcfg = drafts
    if draft == "perfect":
        jd, dcfg, td, tdcfg = jside.params, JCFG, tside.params, TCFG
    (prompt,) = prompts(5, 6)
    for max_new, k in ((13, 4), (7, 2)):
        want = jspec.speculative_generate(jside.params, JCFG, jd, dcfg,
                                          prompt, max_new=max_new, k=k,
                                          eos=96)
        got, rounds = speculative.speculative_generate(
            tside.params, TCFG, td, tdcfg, prompt, max_new=max_new, k=k,
            eos=96, return_rounds=True)
        assert got == [int(x) for x in want]
        assert got == greedy_oracle(tside.params, prompt, max_new, 96)
        if draft == "perfect":       # every proposal accepted
            assert rounds == -(-(len(got) - 1) // k)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
def test_speculative_batch_matches_jax(sides, drafts, kv_quant):
    """Three left-padded rows accept independently; each equals its own
    greedy stream and the JAX package's batch."""
    jside, tside = sides
    jd, dcfg, td, tdcfg = drafts
    ps = prompts(5, 3, 7, 5)
    s = max(len(p) for p in ps)
    ids = np.zeros((3, s), np.int32)
    mask = np.zeros((3, s), np.int32)
    for i, p in enumerate(ps):
        ids[i, s - len(p):] = p
        mask[i, s - len(p):] = 1
    want = jspec.speculative_generate_batch(jside.params, JCFG, jd, dcfg, ids,
                                            mask, max_new=11, k=4, eos=96,
                                            kv_quant=kv_quant)
    got = speculative.speculative_generate_batch(
        tside.params, TCFG, td, tdcfg, ids, mask, max_new=11, k=4, eos=96,
        kv_quant=kv_quant)
    assert got == [[int(x) for x in row] for row in want]
    if not kv_quant:
        assert got == [greedy_oracle(tside.params, p, 11, 96) for p in ps]


# -- the paged KV lane ------------------------------------------------------

PAGE = 4


def paged_tokens(mod, params, cfg, ps, n_steps, quant, to_dev):
    """paged_prefill_insert every prompt, then batched paged_decode_steps;
    the same loop for both packages (to_dev builds their arrays)."""
    alloc = mod.PageAllocator(n_pages=16)
    kw = {"device": "cpu"} if mod is paged_kv else {}
    cache = mod.init_paged_cache(cfg, 16, PAGE, max_slots=len(ps),
                                 pages_per_slot=6, dtype=to_dev.f32,
                                 quant=quant, **kw)
    lm = llama if mod is paged_kv else jllama
    lasts, lengths = [], []
    for slot, p in enumerate(ps):
        pages = alloc.alloc(-(-(len(p) + n_steps) // PAGE))
        hid, cache = mod.paged_prefill_insert(
            params, cfg, cache, lm.embed(params, to_dev.ids([p])),
            to_dev.ids([[1] * len(p)]), to_dev.ids(pages), slot)
        lasts.append(int(to_dev.np(lm.logits(params, hid[0])).argmax()))
        lengths.append(len(p))
    got = [[t] for t in lasts]
    for _ in range(n_steps - 1):
        slots = to_dev.ids(lengths)
        sm = to_dev.ids(np.arange(6 * PAGE)[None] <= np.array(lengths)[:, None])
        hid, cache = mod.paged_decode_step(
            params, cfg, cache, lm.embed(params, to_dev.ids(lasts)[:, None]),
            slots, sm, slots)
        nxt = to_dev.np(lm.logits(params, hid[:, 0])).argmax(-1)
        for i in range(len(ps)):
            lasts[i] = int(nxt[i])
            got[i].append(lasts[i])
            lengths[i] += 1
    return got


class _Jax:
    f32 = jnp.float32
    ids = staticmethod(lambda a: jnp.asarray(np.asarray(a)))
    np = staticmethod(np.asarray)


class _Torch:
    f32 = torch.float32
    ids = staticmethod(lambda a: torch.as_tensor(np.asarray(a)).long()
                       if np.asarray(a).dtype != bool
                       else torch.as_tensor(np.asarray(a)))
    np = staticmethod(lambda t: t.numpy())


def dense_tokens(params, p, n_steps, quant):
    """The port's dense-cache greedy stream through the engine."""
    eng = continuous.ContinuousEngine(params, TCFG, max_slots=1, max_len=32,
                                      prefill_buckets=(len(p),),
                                      eos_token_id=None,
                                      kv_cache_quant=quant)
    rid = eng.submit(llama.embed(params, torch.tensor([p])),
                     torch.ones(1, len(p), dtype=torch.int32), n_steps)
    return eng.run_until_drained()[rid]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_lane_matches_dense_and_jax(sides, quant):
    jside, tside = sides
    ps = [[5, 17, 3, 42, 8], [9, 2, 71, 4, 33, 12, 60, 7, 25]]
    got = paged_tokens(paged_kv, tside.params, TCFG, ps, 6, quant, _Torch)
    want = paged_tokens(jpaged, jside.params, JCFG, ps, 6, quant, _Jax)
    assert got == want
    assert got == [dense_tokens(tside.params, p, 6, quant) for p in ps]


def test_page_allocator():
    alloc = paged_kv.PageAllocator(2)
    pages = alloc.alloc(2)
    with pytest.raises(MemoryError):
        alloc.alloc(1)
    alloc.release(pages + [-1])
    assert sorted(alloc.alloc(2)) == [0, 1]


# -- beam search over the int8 KV cache -------------------------------------

def test_beam_search_int8_kv_matches_jax(sides):
    """kv_cache_quant=True: the scale planes are reordered with the value
    planes at every beam step; tokens equal the JAX llama_generate."""
    jside, tside = sides
    ps = prompts(41, 7, 7)
    ids = np.asarray(ps)
    mask = np.ones_like(ids)
    mask[1, :2] = 0
    common = dict(max_new_tokens=8, num_beams=3, length_penalty=1.0,
                  eos_token_id=96, pad_token_id=0, kv_cache_quant=True)
    ref = jllama_generate(jside.params, JCFG,
                          jllama.embed(jside.params, jnp.asarray(ids)),
                          jnp.asarray(mask), JGenerationConfig(**common))
    out = llama_generate(tside.params, TCFG,
                         llama.embed(tside.params, torch.tensor(ids)),
                         torch.tensor(mask), GenerationConfig(**common))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
