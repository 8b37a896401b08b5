"""Faults planted underneath a run, each of which `correct` has to see:
the timed path broken where it is produced, the harness above it left as
it is. `benchmark/tests/test_bench_correct.py` plants them at a tiny size
on the CPU, `benchmark/control.py --fault <name>` on the chip at a cell's
own size.

Each takes `patch(obj, name, value)`, which sets an attribute
(`setattr`, or pytest's `monkeypatch.setattr`, which undoes it).
"""

from __future__ import annotations

import dataclasses


def no_commit(patch) -> None:
    """A decode step that leaves its state (the KV cache) unchanged."""
    from emu_tpu_torch.models import llama
    patch(llama, "_cache_write_all", lambda cache, new_rows, idx: cache)


def chat_token_altered(patch) -> None:
    """The served token altered where the engine samples it."""
    from emu_tpu_torch.generation.continuous import ContinuousEngine
    sample = ContinuousEngine._sample
    patch(ContinuousEngine, "_sample",
          lambda self, logits, temps: (sample(self, logits, temps) + 7)
          % 32000)


def chat_half_batch(patch) -> None:
    """The decode step's second half of its rows left out."""
    from emu_tpu_torch.models import llama
    step = llama.decode_step_rows

    def half(*a, **kw):
        h, cache = step(*a, **kw)
        h = h.clone()
        h[h.shape[0] // 2:] = 0
        return h, cache
    patch(llama, "decode_step_rows", half)


def caption_token_altered(patch) -> None:
    """The second token of every finished sequence altered after the
    search scored it."""
    from emu_tpu_torch.generation import engine
    search = engine._beam_search

    def altered(*a, **kw):
        seqs, scores = search(*a, **kw)
        seqs = seqs.clone()
        seqs[:, :, 1] = (seqs[:, :, 1] + 7) % 32000
        return seqs, scores
    patch(engine, "_beam_search", altered)


def caption_half_batch(patch) -> None:
    """Half of the batch's images left out of the encode."""
    from emu_tpu_torch.models import emu1
    encode = emu1.encode_image

    def half(params, cfg, images):
        e = encode(params, cfg, images).clone()
        e[e.shape[0] // 2:] = 0
        return e
    patch(emu1, "encode_image", half)


def caption_one_beam(patch) -> None:
    """The search run with one beam where the request asks for more: a
    greedy caption, scored consistently with its own tokens."""
    from emu_tpu_torch.generation import engine
    search = engine._beam_search

    def one(step_fn, last_logits, cache, slot_mask, positions, prompt_len,
            gcfg, generator):
        return search(step_fn, last_logits, cache, slot_mask, positions,
                      prompt_len, dataclasses.replace(
                          gcfg, num_beams=1, num_return_sequences=1),
                      generator)
    patch(engine, "_beam_search", one)


def caption_best_beam_dropped(patch) -> None:
    """Each step keeps the running candidates ranked 2 .. K + 1 in place of
    1 .. K (the best continuation dropped), its scores its own."""
    from emu_tpu_torch.generation import engine
    top_k = engine._top_k
    search = engine._beam_search

    def dropped(step_fn, last_logits, cache, slot_mask, positions,
                prompt_len, gcfg, generator):
        k = gcfg.num_beams

        def shifted(x, n):
            # the running beams' pick: K of the 2K candidates
            if n == k and x.shape[-1] == 2 * k:
                vals, idx = top_k(x, n + 1)
                return vals[..., 1:], idx[..., 1:]
            return top_k(x, n)
        patch(engine, "_top_k", shifted)
        try:
            return search(step_fn, last_logits, cache, slot_mask, positions,
                          prompt_len, gcfg, generator)
        finally:
            patch(engine, "_top_k", top_k)
    patch(engine, "_beam_search", dropped)


CHAT = (no_commit, chat_token_altered, chat_half_batch)
CAPTION = (no_commit, caption_token_altered, caption_half_batch,
           caption_one_beam, caption_best_beam_dropped)
BY_NAME = {f.__name__: f for f in CHAT + CAPTION}
