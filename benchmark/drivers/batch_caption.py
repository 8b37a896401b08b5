"""Cells that caption batches of images offline through the port's Emu1
runner (`Emu1Runner.generate_batch`, as `cli/inference.py` drives it):
batches of `batch` seeded images with the mix's prompt, beam search, back
to back.

The run: the weights are built from the seed, a pool of seeded images is
made, one batch warms every shape (every batch has the same shapes), then
batches run until the one that crosses `--seconds` completes; the window
is their whole time. A traced run profiles the batches that start in
`trace.offset_s` .. `trace.offset_s + trace.seconds`. Then the peak memory
is read, the runner freed, and the window's captions are judged: every
caption is the text of its beam search's best sequence; in a few batches
drawn from the seed, each row's best sequence is the one beam search keeps
over the logits the program produced (`beams.replay`); and over a seeded
sample of their images (the longest caption in it), each caption token's
log-probability as the program computed it is held against the
reference's.
"""

from __future__ import annotations

import gc
import importlib
import time

import numpy as np
import torch

from benchmark import harness, spans, traffic


def _prompt(config: dict, mix: dict):
    """(the caption prompt as the runner's template makes it: the system
    message, " [USER]: ", the image placeholder, the prompt,
    " [ASSISTANT]:"; the tokenizer's special strings and their ids)."""
    sp = config["special_ids"]
    placeholder = "[IMG]" + "<image>" * config["n_causal"] + "[/IMG]"
    text = (f"{mix['system']} [USER]: {placeholder}{mix['prompt']} "
            "[ASSISTANT]:").strip()
    specials = {"[IMG]": sp["img"], "[/IMG]": sp["img_end"],
                "<image>": sp["image"], "[PAD]": sp["pad"]}
    return text, specials


def prompt_words(config: dict, mix: dict) -> dict:
    """id -> word of the words the runner's tokenizer has seen: the
    prompt's pieces (a served token that is one of them decodes as the
    word, any other as its id)."""
    text, specials = _prompt(config, mix)
    base = config["llama"]["vocab_size"]
    return {traffic.word_id(w, base): w
            for w in traffic.pieces(text, specials) if w not in specials}


def prompt_ids(config: dict, mix: dict) -> list:
    """The caption prompt's ids (BOS first), by the hash-bucket rule."""
    text, specials = _prompt(config, mix)
    return [config["special_ids"]["bos"]] + traffic.hash_tokens(
        text, specials, config["llama"]["vocab_size"])


class BeamCapture:
    """The beam search's finished sequences and scores of every call (the
    port's `generation.engine._beam_search`, wrapped where `generate` looks
    it up), the runner's returned ids, and, for the calls made while `keep`
    is set, the logits the search was given: the prompt's, then those of
    its running rows after each model step."""

    def __init__(self, runner):
        from emu_tpu_torch.generation import engine
        self.engine, self.beams, self.ids = engine, [], []
        self.keep, self.logits = False, {}
        self._orig = engine._beam_search
        gen_ids = runner.generate_ids

        def beam_search(step_fn, last_logits, *a, **kw):
            kept = None
            if self.keep:
                kept = [last_logits.clone()]

                def step(*sa, **skw):
                    out = step_fn(*sa, **skw)
                    kept.append(out[0].clone())
                    return out
            seqs, scores = self._orig(step if kept else step_fn,
                                      last_logits, *a, **kw)
            if kept:
                self.logits[len(self.beams)] = kept
            self.beams.append((seqs[:, 0].clone(), scores[:, 0].clone()))
            return seqs, scores

        def generate_ids(*a, **kw):
            out = gen_ids(*a, **kw)
            self.ids.append(out.clone())
            return out

        engine._beam_search = beam_search
        runner.generate_ids = generate_ids

    def close(self):
        self.engine._beam_search = self._orig


def checked_batches(seed: int, mix: dict) -> list:
    """The batches of the window whose beam search is judged (the mix's
    `check.batches` of its first `check.among`), drawn from the seed."""
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 0xB3A])
    c = mix["check"]
    return sorted(int(j) for j in rng.permutation(c["among"])[:c["batches"]])


def run(cell: dict, config: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device, t0: float, control: bool = False) -> dict:
    family = importlib.import_module(f"benchmark.families.{config['family']}")
    from PIL import Image
    t_build = time.monotonic()
    runner = family.build_runner(config, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_built = time.monotonic()
    w, h = mix["image_size"]
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 0xCA9])
    pool_seeds = [int(s) for s in rng.integers(0, 2 ** 62, mix["pool"])]
    pool = [Image.fromarray(traffic.image(s, w, h)) for s in pool_seeds]
    n = mix["batch"]
    kw = dict(system=mix["system"], max_new_tokens=mix["new_tokens"],
              beam_size=mix["beams"],
              length_penalty=mix.get("length_penalty", 0.0))
    text = "[IMG]" + "<image>" * config["n_causal"] + "[/IMG]" + mix["prompt"]
    capture = BeamCapture(runner)
    host = spans.HostLog()
    ops = spans.OpCounter() if trace else None
    if trace:
        _host_spans(runner, host)
    try:
        runner.generate_batch(pool[:n], [text] * n, **kw)     # warm-up
        capture.beams.clear()
        capture.ids.clear()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_warm = time.monotonic()
        batches, prof, reading, t_stop = [], None, None, None
        checked = checked_batches(seed, mix)
        t_open = time.monotonic()
        while True:
            pick = rng.permutation(len(pool))[:n]
            capture.keep = len(batches) in checked
            t_b = time.monotonic()
            if trace and prof is None and \
                    t_b >= t_open + mix["trace"]["offset_s"]:
                prof, t_mark, t_p0 = _start(device, ops, host)
            captions = runner.generate_batch([pool[i] for i in pick],
                                             [text] * n, **kw)
            t_e = time.monotonic()
            batches.append({"t": (t_b, t_e), "images": [int(i) for i in
                                                        pick],
                            "captions": captions,
                            "stats": dict(runner.last_stats)})
            if prof is not None and t_stop is None and \
                    t_e >= t_p0 + mix["trace"]["seconds"]:
                t_stop = _stop(prof, device, ops, host)
            if t_e - t_open >= seconds:
                break
        t_close = time.monotonic()
        if prof is not None and t_stop is None:
            t_stop = _stop(prof, device, ops, host)
        if prof is not None:       # read once the window has closed
            reading = harness.read_trace(prof, t_p0, t_stop, t_mark,
                                         host.spans)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    finally:
        capture.close()
    record = {"setup_s": t_open - t0, "window": (t_open, t_close),
              "seconds": t_close - t_open, "memory_peak_bytes": int(peak),
              "config": config, "mix": mix, "cell": cell,
              "images_done": n * len(batches), "batches": batches}
    beams = [(s.cpu(), sc.cpu()) for s, sc in capture.beams]
    ids = [i.cpu() for i in capture.ids]
    kept = capture.logits
    del runner, capture
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    record.update(_judge(config, mix, seed, device, family, pool_seeds,
                         batches, beams, ids, kept, control))
    if trace:
        record["trace"] = reading
        record["encode_ms"] = [b["stats"]["encode_s"] * 1e3
                               for b in batches]
        record["decode_ms_per_step"] = [
            b["stats"]["decode_s"] * 1e3 / max(b["stats"]["decode_steps"], 1)
            for b in batches]
        if reading is not None:
            bnd, dev, by_label = ops.totals(reading)
            record["op_bound_s"], record["op_device_s"] = bnd, dev
            record["op_by_label"] = by_label
    st = batches[0]["stats"]
    record["notes"] = [
        f"judged: {record['rows_judged']} beam rows replayed "
        f"({record['rows_tied']} left out on a near tie), "
        f"{record['images_compared']} images against the reference; gaps "
        + ", ".join(f"{k} {v:.5f}" for k, v in record["gaps"].items()),
        f"set-up: imports {t_build - t0:.1f} s, weights "
        f"{t_built - t_build:.1f} s, warm-up batch {t_warm - t_built:.1f} s;"
        f" reference {time.monotonic() - t_ref:.1f} s",
        f"window {t_close - t_open:.1f} s: {len(batches)} batches of {n}; "
        f"prompt {st['prompt_len']} tokens, encode "
        f"{st['encode_s'] * 1e3:.1f} ms, prefill {st['prefill_s'] * 1e3:.1f}"
        f" ms, {st['decode_steps']} decode steps "
        f"{st['decode_s'] * 1e3:.1f} ms; peak {peak / 2 ** 30:.2f} GiB"]
    if record.get("op_by_label"):
        record["notes"].append(spans.op_note(record["op_by_label"]))
    return record


def _start(device, ops, host):
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        return None, None, time.monotonic()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        t_mark = time.monotonic()
        torch.cuda._sleep(1000)
    ops.start(side)
    host.on = True
    return prof, t_mark, time.monotonic()


def _stop(prof, device, ops, host) -> float:
    ops.on = host.on = False
    t_stop = time.monotonic()
    if prof is not None:
        torch.cuda.synchronize(device)
        prof.stop()
    return t_stop


def _host_spans(runner, host) -> None:
    """Host spans that label the traced window's idle gaps: the runner's
    input assembly and encode, the decoder's prefill and decode steps, and
    the beam search around them."""
    from emu_tpu_torch.generation import engine
    from emu_tpu_torch.models import llama
    runner._inputs = spans.span("runner.inputs_and_encode", runner._inputs,
                                host)
    for mod, attr, name in ((llama, "prefill", "llama.prefill"),
                            (llama, "decode_step", "llama.decode_step"),
                            (engine, "_beam_search", "beam_search")):
        setattr(mod, attr, spans.span(name, getattr(mod, attr), host))


def _judge(config, mix, seed, device, family, pool_seeds, batches, beams,
           ids, kept, control) -> dict:
    """Every batch's returned ids are its beam search's best sequences and
    its captions their text; in the checked batches (`checked_batches`),
    every row's best sequence and score are those that beam search
    (`beams.replay`) keeps over the logits the program produced; over a
    seeded sample of their images (the longest caption in it), the
    widest and the mean gap between the log-probability of each caption
    token as the program computed it and as the reference does (with
    control, the control's gap on the same tokens in the program's
    place: one number for each precision in `mix["check"]["controls"]`)."""
    from benchmark import beams as beam_ref
    from benchmark.drivers.http_chat import render_pattern, _reference_image
    sp = config["special_ids"]
    base = config["llama"]["vocab_size"]
    words = prompt_words(config, mix)
    mismatched = 0
    for b, (seqs, scores), out in zip(batches, beams, ids):
        if not torch.equal(seqs, out):
            mismatched += len(b["captions"])
            continue
        for r, cap in enumerate(b["captions"]):
            toks = _caption_tokens(seqs[r].tolist(), sp)
            pat = render_pattern(toks, words, base, (sp["bos"], sp["eos"]))
            if not pat.fullmatch(cap):
                mismatched += 1
    # the selection: every row of the checked batches, replayed
    wrong, judged, tied, rows = 0, 0, 0, []
    for j, logits in sorted(kept.items()):
        seqs, scores = beams[j]
        rep = beam_ref.replay(
            logits[0], logits[1:], mix["beams"], mix["new_tokens"],
            sp["eos"], sp["pad"], mix.get("length_penalty", 0.0),
            mix.get("min_new_tokens", 0))
        for r in range(len(batches[j]["captions"])):
            if bool(rep["tied"][r]):
                tied += 1
                continue
            judged += 1
            same = rep["fits"] and torch.equal(rep["seqs"][r].cpu(), seqs[r])\
                and abs(float(rep["scores"][r]) - float(scores[r])) <= 1e-3
            if not same:
                wrong += 1
                continue
            toks = _caption_tokens(seqs[r].tolist(), sp)
            rows.append((batches[j]["images"][r], toks,
                         rep["token_logprobs"][r, :len(toks)].double().cpu()))
    del kept
    sample = _sample(rows, seed, mix["check"]["images"])
    prompt = prompt_ids(config, mix)
    gaps, ctl = {}, {}
    if sample:
        seqs = [prompt + toks[:-1] for _, toks, _ in sample]
        pos = [list(range(len(prompt) - 1, len(prompt) - 1 + len(toks)))
               for _, toks, _ in sample]
        images = [_reference_image(config, mix, {"image": pool_seeds[i]})
                  for i, _, _ in sample]
        with torch.no_grad():
            ref = _token_logprobs(family.reference_logits(
                config, seed, device, seqs, pos, images), sample)
            diff = torch.cat([(p - q).abs() for (_, _, p), q in
                              zip(sample, ref)])
            gaps = {"token_logprob_gap": float(diff.max()),
                    "token_logprob_gap_mean": float(diff.mean())}
            for bits in (mix["check"].get("controls", []) if control
                         else []):
                low = _token_logprobs(family.reference_logits(
                    config, seed, device, seqs, pos, images, control=bits),
                    sample)
                d = torch.cat([(p - q).abs() for p, q in zip(low, ref)])
                ctl[str(bits)] = {"token_logprob_gap": float(d.max()),
                                  "token_logprob_gap_mean": float(d.mean())}
    lim = config["limits"]
    checks = {
        "captions_not_beam_output": {"value": mismatched, "limit": 0},
        "beam_choice_mismatch": {"value": wrong, "limit": 0},
    }
    for name, value in gaps.items():
        if name in lim:
            checks[name] = {"value": value, "limit": lim[name]}
    correct = (mismatched == 0 and wrong == 0 and judged > 0
               and all(name in gaps for name in lim)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    n_img = sum(len(b["captions"]) for b in batches)
    return {"correct": bool(correct), "attempted": n_img, "failed": 0,
            "checks": checks, "control_gap": ctl if control else None,
            "gaps": gaps, "rows_judged": judged, "rows_tied": tied,
            "images_compared": len(sample)}


def _token_logprobs(logits, sample) -> list:
    """Each sampled caption's token log-probabilities under `logits` (one
    [len, V] block a caption), fp64 on the host."""
    out = []
    for lg, (_, toks, _) in zip(logits, sample):
        t = torch.tensor(toks, device=lg.device)
        lp = torch.log_softmax(lg.double(), -1).gather(1, t[:, None])[:, 0]
        out.append(lp.cpu())
    return out


def _caption_tokens(seq, sp) -> list:
    """A finished beam's tokens: up to and with EOS, else all of them."""
    out = []
    for t in seq:
        out.append(int(t))
        if t == sp["eos"]:
            break
    return out


def _sample(rows, seed, n):
    if not rows:
        return []
    order = sorted(range(len(rows)), key=lambda k: -len(rows[k][1]))
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 0x5A4])
    rest = [int(k) for k in rng.permutation(order[1:])][:n - 1]
    return [rows[k] for k in [order[0]] + rest]
