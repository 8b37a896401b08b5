"""Autoregressive generation: greedy, sampling, beam search, beam sampling
and contrastive search, as `emu_tpu/generation/engine.py` (HF `generate`
from `inputs_embeds`: left-padded batches, generated ids only, HF
BeamSearchScorer semantics), plus trie-constrained decoding.

The JAX package runs the whole loop as one `lax.while_loop`; here it is a
Python loop over eager steps with the same state and the same order of
operations. Ties in top-k go to the lower index, as `jax.lax.top_k` does,
so greedy, beam, contrastive and trie-constrained tokens match the JAX
package exactly. Random draws come from an explicit `torch.Generator` on
the logits' device (None: one seeded 0, as the JAX default `PRNGKey(0)`,
so a request without one is deterministic); the streams differ from
JAX's, so sampled tokens agree with it in distribution, not token for
token.

On a tree sharded by `parallel.shard_params` every rank of the "model"
group runs the same loop: the cache holds its kv heads (`llama.
init_cache(params=)`), the logits are gathered before any processor, beam
or trie sees them, and every rank draws from a generator seeded alike, so
the ranks keep the same tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from emu_tpu_torch.generation import logits_process as lp
from emu_tpu_torch.utils.profiling import RECORDER, Stats, mark


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 50
    min_length: int = 1                 # min generated tokens before EOS
    num_beams: int = 1
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0                      # 0 = off
    top_p: float = 1.0                  # 1.0 = off
    repetition_penalty: float = 1.0
    length_penalty: float = 0.0
    no_repeat_ngram_size: int = 0
    num_return_sequences: int = 1
    penalty_alpha: float = 0.0          # >0 + top_k>1 → contrastive search
    eos_token_id: int = 2
    pad_token_id: int = 32000
    kv_cache_quant: bool = False        # int8 KV cache (values + scales)


def _apply_common_processors(scores, seqs, t: int, gcfg: GenerationConfig):
    if gcfg.repetition_penalty != 1.0:
        valid = torch.arange(seqs.shape[1], device=seqs.device)[None, :] < t
        scores = lp.repetition_penalty(scores, seqs, valid.expand_as(seqs),
                                       gcfg.repetition_penalty)
    if gcfg.no_repeat_ngram_size > 0:
        scores = lp.no_repeat_ngram(scores, seqs, t, gcfg.no_repeat_ngram_size)
    return lp.min_length_eos_mask(scores, t, gcfg.min_length,
                                  gcfg.eos_token_id)


def _top_k(x, k: int):
    """top-k along the last dim, lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _warp(scores, gcfg: GenerationConfig):
    """The sampling warpers in HF's order: temperature, top-k, top-p."""
    if gcfg.temperature != 1.0:
        scores = lp.temperature(scores, gcfg.temperature)
    if gcfg.top_k > 0:
        scores = lp.top_k_filter(scores, gcfg.top_k)
    if gcfg.top_p < 1.0:
        scores = lp.top_p_filter(scores, gcfg.top_p)
    return scores


def _trie_tables(trie: dict, vocab: int, device):
    """The trie's (allowed [S, V] bool, next [S, V] long) on `device`."""
    allowed = torch.as_tensor(trie["allowed"], device=device)
    nxt = torch.as_tensor(trie["next"], device=device).long()
    if allowed.shape[1] != vocab:
        raise ValueError(f"trie vocab {allowed.shape[1]} != logits' {vocab}")
    return allowed, nxt


def _greedy_or_sample(step_fn, last_logits, cache, slot_mask, positions,
                      prompt_len: int, gcfg: GenerationConfig, generator,
                      trie: Optional[dict]):
    """Greedy (argmax) or sampled (softmax of the warped scores through
    torch.multinomial) decoding; a trie masks each step's scores to
    `allowed[state]` before the warpers, and `next[state, token]` advances
    the state."""
    b, v = last_logits.shape
    dev = last_logits.device
    seqs = torch.full((b, gcfg.max_new_tokens), gcfg.pad_token_id,
                      dtype=torch.long, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    if trie is not None:
        allowed, nxt = _trie_tables(trie, v, dev)
        state = torch.zeros(b, dtype=torch.long, device=dev)
    logits = last_logits
    for t in range(gcfg.max_new_tokens):
        scores = _apply_common_processors(logits.float(), seqs, t, gcfg)
        if trie is not None:
            scores = lp.allowed_tokens_mask(scores, allowed[state])
        if gcfg.do_sample:
            probs = torch.softmax(_warp(scores, gcfg), dim=-1)
            token = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            token = scores.argmax(-1)
        token = torch.where(finished, gcfg.pad_token_id, token)
        seqs[:, t] = token
        finished = finished | (token == gcfg.eos_token_id)
        if trie is not None:
            # an index past the table (a pad id) clamps, as XLA's gather
            state = nxt[state, token.clamp(max=v - 1)]
        slot = prompt_len + t
        # the new slot is always attended (HF extends the attention mask
        # with ones, also for the pad continuations of finished rows)
        slot_mask[:, slot] = True
        # skip the model call whose logits could never be consumed
        if t + 1 >= gcfg.max_new_tokens or bool(finished.all()):
            break
        logits, cache = step_fn(cache, token, slot, slot_mask, positions)
        positions = positions + 1
    return seqs


def _beam_search(step_fn, last_logits, cache, slot_mask, positions,
                 prompt_len: int, gcfg: GenerationConfig, generator):
    """HF `_beam_search` (vectorized v4.5x form): 2K candidates per batch
    row, only the top-K ranks may finish, finished hypotheses normalized by
    generated_len ** length_penalty, non-finishing candidates suppressed
    with an additive -1e9, early_stopping=False done-rule.

    do_sample draws the 2K candidates without replacement over the
    accumulated scores (Gumbel top-2K, a fresh draw each step) and keeps
    each candidate's own score; as in the JAX package, temperature, top-k
    and top-p do not apply in this mode."""
    b, v = last_logits.shape
    k = gcfg.num_beams
    t_max = gcfg.max_new_tokens
    dev = last_logits.device
    lp_pow = gcfg.length_penalty

    cache = {n: c.repeat_interleave(k, dim=1) for n, c in cache.items()}
    slot_mask = slot_mask.repeat_interleave(k, dim=0)
    positions = positions.repeat_interleave(k, dim=0)
    logits = last_logits.repeat_interleave(k, dim=0)

    run_scores = torch.tensor([0.0] + [-1e9] * (k - 1), device=dev
                              ).repeat(b, 1)
    run_seqs = torch.full((b, k, t_max), gcfg.pad_token_id, dtype=torch.long,
                          device=dev)
    fin_seqs = run_seqs.clone()
    fin_scores = torch.full((b, k), -1e9, device=dev)
    fin_mask = torch.zeros(b, k, dtype=torch.bool, device=dev)
    unsat = torch.ones(b, dtype=torch.bool, device=dev)
    batch_offset = (torch.arange(b, device=dev) * k)[:, None]
    rank = torch.arange(2 * k, device=dev)[None, :]

    for t in range(t_max):
        flat_seqs = run_seqs.reshape(b * k, t_max)
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        # HF applies the processors on log-softmaxed scores in beam mode
        logprobs = _apply_common_processors(logprobs, flat_seqs, t, gcfg)
        cand = (logprobs + run_scores.reshape(b * k, 1)).reshape(b, k * v)
        if gcfg.do_sample:
            u = torch.rand(cand.shape, generator=generator, device=dev)
            _, top_idx = _top_k(cand - torch.log(-torch.log(u)), 2 * k)
            top_scores = cand.gather(1, top_idx)
        else:
            top_scores, top_idx = _top_k(cand, 2 * k)
        top_tokens = top_idx % v
        top_beams = top_idx // v

        gather_rows = (batch_offset + top_beams).reshape(-1)
        cand_seqs = flat_seqs[gather_rows].reshape(b, 2 * k, t_max)
        cand_seqs[:, :, t] = top_tokens

        # a continuation hits the stopping criteria on EOS or max length
        hits = (top_tokens == gcfg.eos_token_id) | (t + 1 >= t_max)

        # finished set (HF _update_finished_beams)
        gen_len = float(t + 1)
        norm = top_scores / gen_len ** lp_pow
        qual = hits & (rank < k)
        neg = torch.tensor(-1e9, device=dev)
        zero = torch.tensor(0.0, device=dev)
        fin_cand = (norm + torch.where(qual, zero, neg)
                    + torch.where(unsat[:, None], zero, neg))
        all_scores = torch.cat([fin_scores, fin_cand], dim=1)
        all_seqs = torch.cat([fin_seqs, cand_seqs], dim=1)
        all_mask = torch.cat([fin_mask, qual & unsat[:, None]], dim=1)
        fin_scores, keep_idx = _top_k(all_scores, k)
        fin_seqs = all_seqs.gather(
            1, keep_idx[:, :, None].expand(-1, -1, t_max))
        fin_mask = all_mask.gather(1, keep_idx)

        # running beams (HF _get_running_beams_for_next_iteration)
        run_scores, sel = _top_k(top_scores + hits.float() * -1e9, k)
        sel_tokens = top_tokens.gather(1, sel)
        sel_beams = top_beams.gather(1, sel)
        run_seqs = cand_seqs.gather(1, sel[:, :, None].expand(-1, -1, t_max))

        # early-stop heuristic at cur_len = t + 1
        best_possible = run_scores[:, 0] / gen_len ** lp_pow
        worst = torch.where(fin_mask, fin_scores.min(dim=1, keepdim=True).values,
                            neg)
        unsat = unsat & (best_possible[:, None] > worst).any(dim=1)
        cont = not bool(hits.all())

        sel_rows = (batch_offset + sel_beams).reshape(-1)
        positions = positions[sel_rows]
        slot = prompt_len + t
        slot_mask = slot_mask[sel_rows]
        slot_mask[:, slot] = True
        # skip the final model call whose logits the loop can never use
        if not (t + 1 < t_max and bool(unsat.any()) and cont):
            break
        # every plane, the int8 scale planes too (llama.reorder_cache)
        with RECORDER.span("generation.reorder", dev):
            cache = {n: c.index_select(1, sel_rows) for n, c in cache.items()}
        with RECORDER.span("generation.step", dev):
            logits, cache = step_fn(cache, sel_tokens.reshape(-1), slot,
                                    slot_mask, positions)
        positions = positions + 1

    r = gcfg.num_return_sequences
    return fin_seqs[:, :r], fin_scores[:, :r]


def generate(prefill_fn, step_fn: Callable, inputs_embeds, attention_mask,
             gcfg: GenerationConfig, stats: Optional[dict] = None,
             generator: Optional[torch.Generator] = None,
             trie: Optional[dict] = None):
    """Prefill, then the configured decode loop.

    prefill_fn(embeds, mask, total_len) → (last_logits [B, V], cache,
    slot_mask [B, total_len] bool, positions [B]); step_fn(cache, tokens
    [N], slot, slot_mask, positions) → (logits [N, V], cache). Returns
    generated ids [B, max_new] (beams: the best sequence per row, or
    [B * num_return_sequences, max_new]). generator: the draws of sampling
    and beam sampling (None: seeded 0 on the embeds' device). trie:
    {"allowed": [S, V] bool, "next": [S, V] int} (numpy or torch) for
    prefix-constrained greedy or sampled decoding; beam search ignores it,
    as the JAX engine does. `stats` (a `profiling.Stats`), when given,
    receives prefill_s, decode_s (the card's time between CUDA events, read
    once the call's results are) and decode_steps (the model calls after
    prefill). The call is the recorder's "generation.generate" span, the
    parent of the beam search's "generation.reorder" and
    "generation.step" event pairs."""
    if gcfg.num_return_sequences > max(gcfg.num_beams, 1):
        raise ValueError("num_return_sequences must be <= num_beams")
    b, s, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with RECORDER.span("generation.generate"):
        m0 = mark(dev)
        last_logits, cache, slot_mask, positions = prefill_fn(
            inputs_embeds, attention_mask, s + gcfg.max_new_tokens)
        m1 = mark(dev)
        steps = [0]

        def counted_step(*args):
            steps[0] += 1
            return step_fn(*args)

        if gcfg.num_beams <= 1:
            out = _greedy_or_sample(counted_step, last_logits, cache,
                                    slot_mask, positions, s, gcfg, generator,
                                    trie)
        else:
            seqs, _ = _beam_search(counted_step, last_logits, cache,
                                   slot_mask, positions, s, gcfg, generator)
            out = (seqs[:, 0] if gcfg.num_return_sequences == 1
                   else seqs.reshape(b * gcfg.num_return_sequences, -1))
        _timings(stats, m0, m1, mark(dev), steps[0])
    return out


def _timings(stats, m0, m1, m2, steps: int) -> None:
    """stats' prefill_s (m0 → m1), decode_s (m1 → m2) and decode_steps;
    what the decode loop's reads have already waited for is resolved."""
    if stats is None:
        return
    Stats.interval(stats, "prefill_s", m0, m1)
    Stats.interval(stats, "decode_s", m1, m2)
    stats["decode_steps"] = steps
    if isinstance(stats, Stats):
        stats.settle()


def _contrastive_search(params, cfg, inputs_embeds, attention_mask,
                        gcfg: GenerationConfig, stats: Optional[dict] = None):
    """HF contrastive search (penalty_alpha > 0, top_k > 1), as the JAX
    engine's: each step runs the top-k continuations as one [B * k] decode
    over the cache repeated k times, scores them by (1 - α)·p(token) −
    α·max cosine(candidate hidden, context hiddens) and keeps the best
    candidate's cache rows and hidden state."""
    from emu_tpu_torch.models import llama
    b, s, d = inputs_embeds.shape
    k, alpha, t_max = gcfg.top_k, gcfg.penalty_alpha, gcfg.max_new_tokens
    total = s + t_max
    dev = inputs_embeds.device
    m0 = mark(dev)
    cache = llama.init_cache(cfg, b, total, device=dev,
                             dtype=inputs_embeds.dtype,
                             quant=gcfg.kv_cache_quant, params=params)
    hidden, cache = llama.prefill(params, cfg, inputs_embeds, attention_mask,
                                  cache)
    logits = llama.logits(params, hidden[:, -1])
    # the context's hidden history; pad slots stay out of the cosine max
    hist = hidden.new_zeros(b, total, d)
    hist[:, :s] = hidden
    hist_mask = torch.zeros(b, total, dtype=torch.bool, device=dev)
    hist_mask[:, :s] = attention_mask.bool()
    slot_mask = hist_mask.clone()
    positions = attention_mask.long().sum(-1)
    seqs = torch.full((b, t_max), gcfg.pad_token_id, dtype=torch.long,
                      device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    m1 = mark(dev)
    steps = 0
    for t in range(t_max):
        scores = _apply_common_processors(logits.float(), seqs, t, gcfg)
        top_p, top_tok = _top_k(torch.softmax(scores, dim=-1), k)
        slot = s + t
        slot_mask[:, slot] = True
        cache_k = {n: c.repeat_interleave(k, dim=1) for n, c in cache.items()}
        emb = llama.embed(params, top_tok.reshape(-1))[:, None, :]
        h, cache_k = llama.decode_step(
            params, cfg, cache_k, emb, slot,
            slot_mask.repeat_interleave(k, dim=0),
            positions.repeat_interleave(k, dim=0))
        steps += 1
        h = h[:, 0].reshape(b, k, d)
        # degeneration penalty: the max cosine against the context
        hf = h.float()
        hn = hf / hf.norm(dim=-1, keepdim=True)
        ctx = hist.float()
        ctxn = ctx / ctx.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        cos = torch.einsum("bkd,btd->bkt", hn, ctxn)
        penalty = cos.masked_fill(~hist_mask[:, None, :], -1.0).amax(-1)
        sel = ((1.0 - alpha) * top_p - alpha * penalty).argmax(-1)
        token = torch.where(finished, gcfg.pad_token_id, top_tok[rows, sel])
        seqs[:, t] = token
        finished = finished | (token == gcfg.eos_token_id)
        # keep the selected candidate's cache rows and hidden state
        cache = {n: c.index_select(1, rows * k + sel)
                 for n, c in cache_k.items()}
        h_sel = h[rows, sel]
        hist[:, slot] = h_sel
        hist_mask[:, slot] = True
        positions = positions + 1
        if t + 1 >= t_max or bool(finished.all()):
            break
        logits = llama.logits(params, h_sel)
    _timings(stats, m0, m1, mark(dev), steps)
    return seqs


def _llama_prefill_fn(params, cfg, quant: bool = False):
    from emu_tpu_torch.models import llama

    def prefill(embeds, mask, total_len):
        bsz, s = embeds.shape[:2]
        cache = llama.init_cache(cfg, bsz, total_len, device=embeds.device,
                                 dtype=embeds.dtype, quant=quant,
                                 params=params)
        hidden, cache = llama.prefill(params, cfg, embeds, mask, cache)
        last_logits = llama.logits(params, hidden[:, -1])
        slot_mask = torch.zeros(bsz, total_len, dtype=torch.bool,
                                device=embeds.device)
        slot_mask[:, :s] = mask.bool()
        return last_logits, cache, slot_mask, mask.long().sum(-1)

    return prefill


def _llama_step_fn(params, cfg):
    from emu_tpu_torch.models import llama

    def step(cache, tokens, slot, slot_mask, positions):
        embeds = llama.embed(params, tokens[:, None])
        hidden, cache = llama.decode_step(params, cfg, cache, embeds, slot,
                                          slot_mask, positions)
        return llama.logits(params, hidden[:, 0]), cache

    return step


@torch.inference_mode()
def llama_generate(params, cfg, inputs_embeds, attention_mask,
                   gcfg: GenerationConfig, stats: Optional[dict] = None,
                   generator: Optional[torch.Generator] = None,
                   trie: Optional[dict] = None):
    """HF-`generate` equivalent over the port's LLaMA: inputs_embeds
    [B, S, D] (multimodal prompt, left-padded), attention_mask [B, S].
    Returns the new token ids only; generator and trie as `generate`.
    penalty_alpha > 0 with top_k > 1, one beam and no sampling is
    contrastive search (the JAX engine's routing)."""
    if (gcfg.penalty_alpha > 0 and gcfg.top_k > 1 and gcfg.num_beams <= 1
            and not gcfg.do_sample):
        return _contrastive_search(params, cfg, inputs_embeds,
                                   attention_mask, gcfg, stats)
    return generate(_llama_prefill_fn(params, cfg, gcfg.kv_cache_quant),
                    _llama_step_fn(params, cfg), inputs_embeds,
                    attention_mask, gcfg, stats, generator, trie)
