"""Beam search as Hugging Face transformers defines it (the vectorized
`_beam_search` of v4.5x: 2K candidates a row, only the top K ranks may
finish, finished hypotheses scored by sum / generated_len ** length_penalty,
the early-stopping=False done rule), run again over the logits the program
produced at each of its steps: which candidates the program had to keep,
and each kept token's log-probability.

It judges the program's selection, not its logits (the reference judges
those): given the logits of the rows the program ran, every choice follows.
Equal scores are common (bf16 logits repeat) and are decided by the lower
index, as the program's stable sort decides them. A choice between two
candidates that differ by less than `TIE` is one that rounding may decide
either way; a batch row whose search met one is left unjudged (`tied`).
"""

from __future__ import annotations

from typing import List

import torch

NEG = -1e9
TIE = 1e-4


def _ties(sorted_vals: torch.Tensor, n: int) -> torch.Tensor:
    """[b] bool: two of the first n + 1 values (sorted, descending) apart
    but within TIE of each other, among the real ones (above NEG / 2)."""
    v = sorted_vals[:, :n + 1]
    gap = v[:, :-1] - v[:, 1:]
    real = v[:, 1:] > NEG / 2
    return ((gap > 0) & (gap < TIE) & real).any(dim=1)


def replay(last_logits: torch.Tensor, steps: List[torch.Tensor], beams: int,
           max_new: int, eos: int, pad: int, length_penalty: float = 0.0,
           min_new: int = 0) -> dict:
    """The search over the program's logits: `last_logits` [b, V] (the
    prompt's), then `steps[t]` [b * beams, V] (the logits of its running
    rows after step t, in the order it keeps them). Returns {"seqs" [b, T],
    "scores" [b], "token_logprobs" [b, T] (each kept token's
    log-probability, 0 past the end), "tied" [b] bool, "steps" (model steps
    the search needs), "fits" (whether the program's steps are the rows
    and the count this search runs)}."""
    b, v = last_logits.shape
    k, t_max = beams, max_new
    dev = last_logits.device
    run_scores = torch.tensor([0.0] + [NEG] * (k - 1), device=dev
                              ).repeat(b, 1)
    run_seqs = torch.full((b, k, t_max), pad, dtype=torch.long, device=dev)
    run_lps = torch.zeros(b, k, t_max, device=dev)
    fin_seqs, fin_lps = run_seqs.clone(), run_lps.clone()
    fin_scores = torch.full((b, k), NEG, device=dev)
    fin_mask = torch.zeros(b, k, dtype=torch.bool, device=dev)
    unsat = torch.ones(b, dtype=torch.bool, device=dev)
    tied = torch.zeros(b, dtype=torch.bool, device=dev)
    rank = torch.arange(2 * k, device=dev)[None, :]
    rows = torch.arange(b, device=dev)[:, None]
    logits = last_logits.repeat_interleave(k, dim=0)
    fits, used = True, 0
    for t in range(t_max):
        if logits.shape != (b * k, v):
            fits = False
            break
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        if t < min_new:
            logprobs = logprobs.clone()
            logprobs[:, eos] = float("-inf")
        cand = (logprobs + run_scores.reshape(b * k, 1)).reshape(b, k * v)
        vals, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
        top_scores, top_idx = vals[:, :2 * k], idx[:, :2 * k]
        tokens, parents = top_idx % v, top_idx // v
        tok_lp = logprobs.reshape(b, k, v)[rows, parents, tokens]
        cand_seqs = run_seqs[rows, parents].clone()
        cand_lps = run_lps[rows, parents].clone()
        cand_seqs[:, :, t] = tokens
        cand_lps[:, :, t] = tok_lp
        hits = (tokens == eos) | (t + 1 >= t_max)

        norm = top_scores / float(t + 1) ** length_penalty
        qual = hits & (rank < k)
        fin_cand = (norm + torch.where(qual, 0.0, NEG)
                    + torch.where(unsat[:, None], 0.0, NEG))
        all_scores = torch.cat([fin_scores, fin_cand], dim=1)
        s_all, keep = torch.sort(all_scores, dim=-1, descending=True,
                                 stable=True)
        fin_scores, keep = s_all[:, :k], keep[:, :k]
        fin_seqs = torch.cat([fin_seqs, cand_seqs], dim=1)[rows, keep]
        fin_lps = torch.cat([fin_lps, cand_lps], dim=1)[rows, keep]
        fin_mask = torch.cat([fin_mask, qual & unsat[:, None]],
                             dim=1)[rows, keep]

        live = top_scores + hits.float() * NEG
        s_run, sel = torch.sort(live, dim=-1, descending=True, stable=True)
        run_scores, sel = s_run[:, :k], sel[:, :k]
        run_seqs, run_lps = cand_seqs[rows, sel], cand_lps[rows, sel]
        # the choices that decide the rows the next step runs, and the
        # finished set's order, made by a margin rounding cannot flip
        tied |= unsat & (_ties(s_run, k) | _ties(s_all, k))

        gen_len = float(t + 1)
        best_possible = run_scores[:, 0] / gen_len ** length_penalty
        worst = torch.where(fin_mask, fin_scores.min(dim=1,
                                                     keepdim=True).values,
                            torch.tensor(NEG, device=dev))
        unsat = unsat & (best_possible[:, None] > worst).any(dim=1)
        if not (t + 1 < t_max and bool(unsat.any())
                and not bool(hits.all())):
            break
        if used >= len(steps):
            fits = False
            break
        logits = steps[used]
        used += 1
    fits = fits and used == len(steps)
    return {"seqs": fin_seqs[:, 0], "scores": fin_scores[:, 0],
            "token_logprobs": fin_lps[:, 0], "tied": tied, "steps": used,
            "fits": fits}
