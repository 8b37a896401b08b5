"""Cells that serve a chat model over HTTP `/v1/mmc`: the port's server
objects as `python -m emu_tpu_torch.serving --continuous` wires them, the
load generator in a process of its own, and the check of what was served
against the plain reference.

The run: the load generator starts first (it encodes its images while the
weights are made), the model is built from the seed, the server binds
127.0.0.1 on a free port, the mix's warm-up bursts go through the served
path, then the load generator ramps the mix up and the window opens (after
`ramp_s`, or when request `open_at` is sent) and closes (after `--seconds`,
or with `close_on_block` at the first block boundary sent after them). A
traced run profiles `trace.seconds` of the window from `trace.offset_s` on.
When the window closes the load generator stops, the peak memory is read,
the server and the engine are stopped and their cache freed; then a sample
of the requests answered in the window, drawn from the seed and holding the
longest and one of each prefill form, is judged against the reference.
"""

from __future__ import annotations

import gc
import importlib
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import harness, spans, traffic

ROOT = Path(__file__).resolve().parents[1]
GO_TIMEOUT_S = 600.0


class LoadGen:
    """The load generator's process and the lines it reports. At the
    window's open and close the reader thread calls `mark` (set by the
    run), which reads the engine's count of generated tokens on the spot."""

    def __init__(self, mix: dict, seed: int, seconds: float):
        rate = ["--rate", str(mix["rate"])] if "rate" in mix else []
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "loadgen.py"), "--mix", mix["name"],
             "--seed", str(seed), "--seconds", str(seconds), *rate],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.replies, self.window, self.exhausted = [], None, False
        self.t_open, self.mark, self.marks = None, None, []
        self.ready = threading.Event()
        self.opened = threading.Event()
        self.windowed = threading.Event()
        self.closed = threading.Event()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            msg = json.loads(line)
            if "ready" in msg:
                self.ready.set()
            elif "open" in msg:
                if self.mark is not None:
                    self.marks.append(self.mark())
                self.t_open = msg["open"]
                self.opened.set()
            elif "window" in msg:
                if self.mark is not None:
                    self.marks.append(self.mark())
                self.window = tuple(msg["window"])
                self.windowed.set()
            elif "closed" in msg:
                self.closed.set()
            elif "exhausted" in msg:
                self.exhausted = True
            else:
                self.replies.append(msg)
        self.ready.set()
        self.opened.set()
        self.windowed.set()
        self.closed.set()

    def go(self, port: int):
        if not self.ready.wait(GO_TIMEOUT_S) or self.proc.poll() is not None:
            raise RuntimeError("the load generator did not start")
        self.proc.stdin.write(f"go {port}\n")
        self.proc.stdin.flush()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._reader.join(timeout=10)


def warm(helper, mix: dict) -> int:
    """The mix's warm-up bursts through the served path (the pipeline's
    embedding and the engine's admission), each burst of `p` requests at
    once: every prefill shape the window's traffic reaches. Returns the
    requests sent."""
    from PIL import Image
    vocab = traffic.vocabulary()
    rng = np.random.default_rng(0)
    sent = 0
    for w in mix.get("warm", []):
        for p in w["bursts"]:
            errors = []

            def one(k):
                inputs = []
                if w.get("images"):
                    size = mix["image_size"]
                    inputs.append(Image.fromarray(traffic.image(
                        10_000 + k, *size)))
                inputs.append(" ".join(vocab[j] for j in rng.integers(
                    0, len(vocab), w["words"])))
                try:
                    helper.get()(inputs, max_new_tokens=w.get("new", 2))
                except Exception as ex:  # noqa: BLE001 — reported below
                    errors.append(ex)

            threads = [threading.Thread(target=one, args=(sent + k,))
                       for k in range(p)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=GO_TIMEOUT_S)
            if errors or any(t.is_alive() for t in threads):
                raise RuntimeError(f"warm-up burst of {p} failed: {errors}")
            sent += p
    return sent


def render_pattern(tokens, words_by_id: dict, base_vocab: int,
                   specials=(1, 2)):
    """The reply text the served tokens decode to, as a regex: each base
    token is its word when the tokenizer has seen that word, else
    `⟨id⟩`; special tokens are dropped and break the run of words."""
    import re
    chunks, cur = [], []
    for t in tokens:
        if t >= base_vocab or t in specials:
            if cur:
                chunks.append(" ".join(cur))
                cur = []
            continue
        alts = [re.escape(f"⟨{t}⟩")]
        if t in words_by_id:
            alts.append(re.escape(words_by_id[t]))
        cur.append("(?:" + "|".join(alts) + ")")
    if cur:
        chunks.append(" ".join(cur))
    return re.compile("".join(chunks))


def run(cell: dict, config: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device, t0: float, control: bool = False) -> dict:
    """One run of a served cell → its record (see the module docstring);
    control=True also reads the cell's control over the same sample."""
    gen = LoadGen(mix, seed, seconds)
    try:
        return _run(cell, config, mix, seed, seconds, trace, device, t0, gen,
                    control)
    finally:
        gen.stop()


def _run(cell, config, mix, seed, seconds, trace, device, t0, gen,
         control) -> dict:
    from emu_tpu_torch.serving.backend import EmuHTTPServer, make_server
    from emu_tpu_torch.serving.continuous_helper import ContinuousChatHelper
    family = importlib.import_module(f"benchmark.families.{config['family']}")
    serving = config["serving"]
    t_build = time.monotonic()
    chat = family.build_chat(config, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_built = time.monotonic()
    helper = ContinuousChatHelper(
        chat, max_slots=serving["max_slots"], max_len=serving["max_len"],
        draft=None, kv_cache_quant=serving["kv_quant"],
        chunk_size=serving["chunked_prefill"],
        block_steps=serving["block_steps"],
        per_request_sampling=serving["sampling"])
    engine = helper.engine
    capture = spans.Capture(chat, engine)
    steps = ops = None
    host = spans.HostLog()
    if trace:
        steps = spans.Steps(engine, host)
        ops = spans.OpCounter()
        chat.embed_inputs = spans.span("pipeline.embed_inputs",
                                       chat.embed_inputs, host)
    encode_ms = []
    if trace and mix.get("images"):
        embed = chat.embed_inputs

        def timed_embed(*a, **kw):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t = time.monotonic()
            out = embed(*a, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            encode_ms.append((t, (time.monotonic() - t) * 1e3))
            return out
        chat.embed_inputs = timed_embed

    server = EmuHTTPServer(helper, None)
    server.handle = spans.span("http.handle", server.handle, host)
    httpd = make_server(server, "127.0.0.1", 0)
    handle_error = httpd.handle_error

    def quiet_hangups(request, client_address):
        # the load generator hangs up on what is in flight at the close
        if not isinstance(sys.exc_info()[1], ConnectionError):
            handle_error(request, client_address)
    httpd.handle_error = quiet_hangups
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        n_warm = warm(helper, mix)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_warm = time.monotonic()
        gen.mark = lambda: (time.monotonic(), capture.generated(engine))
        gen.go(httpd.server_address[1])
        if not gen.opened.wait(GO_TIMEOUT_S) or gen.t_open is None:
            raise RuntimeError("the load generator never opened the window")
        reading = None
        if trace:
            reading = _profile(mix, ops, host, gen.t_open, device)
        if not gen.windowed.wait(GO_TIMEOUT_S) or gen.window is None \
                or len(gen.marks) != 2:
            raise RuntimeError("the load generator never closed the window")
        t_open, t_close = gen.window
        (m_open, g_open), (m_close, g_close) = gen.marks
        generated = g_close - g_open
        drain = 0.0 if mix["loop"] == "closed" else 60.0
        if not gen.closed.wait(drain + 60.0):
            raise RuntimeError("the load generator never ended")
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    finally:
        gen.stop()
        httpd.shutdown()
        httpd.server_close()
        helper.close()
        _release(helper)
    if gen.exhausted:
        raise RuntimeError("the mix ran out of requests inside the window")
    record = {"setup_s": t_open - t0, "window": (t_open, t_close),
              "seconds": m_close - m_open, "memory_peak_bytes": int(peak),
              "generated": generated,
              "config": config, "mix": mix, "cell": cell}
    reqs = traffic.requests(mix, seed)
    by_prompt = capture.by_prompt()
    tokens = dict(capture.tokens)
    n_slots = engine.max_slots
    # prompts beyond the largest prefill bucket take chunked admission
    chunk_over = engine.buckets[-1] if engine.chunk_size else None
    del chat, helper, engine, capture
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    record.update(_judge(config, mix, seed, device, family, reqs,
                         gen.replies, by_prompt, tokens, t_open, t_close,
                         chunk_over, control))
    judged = [a for a in record["answers"] if a["judged"] and a["ok"]]
    ended = sum(a["n_tokens"] < reqs[a["i"]]["new"] for a in record["answers"]
                if a["ok"])
    lat = sorted((a["done"] - a["due"]) * 1e3 for a in judged)
    late = [(a["sent"] - a["due"]) * 1e3 for a in judged]
    record["notes"] = [
        f"set-up: imports {t_build - t0:.1f} s, weights {t_built - t_build:.1f}"
        f" s, warm-up ({n_warm} requests) {t_warm - t_built:.1f} s, ramp "
        f"{t_open - t_warm:.1f} s; reference {time.monotonic() - t_ref:.1f} s",
        f"window {t_close - t_open:.1f} s: {generated} tokens generated; "
        f"{len(judged)} requests answered, "
        f"{sum(a['n_tokens'] for a in judged)} tokens; latency p50 "
        f"{lat[len(lat) // 2] if lat else float('nan'):.1f} ms; generator "
        f"late by at most {max(late, default=0.0):.1f} ms; {ended} answers "
        f"ended before their budget (EOS); peak {peak / 2 ** 30:.2f} GiB"]
    if trace:
        record["steps"] = steps.in_window(t_open, t_close)
        record["max_slots"] = n_slots
        record["trace"] = reading
        record["encode_ms"] = [ms for t, ms in encode_ms
                               if t_open <= t < t_close]
        if reading is not None:
            b, d, by_label = ops.totals(reading)
            record["op_bound_s"], record["op_device_s"] = b, d
            record["op_by_label"] = by_label
            record["notes"].append(spans.op_note(by_label))
    return record


def _release(helper) -> None:
    """Fail what is still queued or in flight at the close, so that no
    server thread keeps waiting on the stopped engine (and holding the
    model)."""
    import logging
    import queue
    closed = RuntimeError("the window closed")
    # failing them is the point: the server's error log would only repeat it
    logging.getLogger("emu_tpu_torch.serving").setLevel(logging.CRITICAL)
    helper._fail_all(closed)
    while True:
        try:
            fut = helper.pending.get_nowait()[0]
        except queue.Empty:
            break
        if not fut.done():
            fut.set_exception(closed)


def _profile(mix, ops, host, t_open, device):
    """Profile the mix's traced sub-window of the window."""
    from torch.profiler import ProfilerActivity, profile
    tr = mix["trace"]
    time.sleep(max(0.0, t_open + tr["offset_s"] - time.monotonic()))
    if device.type != "cuda":
        return None
    # the device's activity only: recording the host's operators as well
    # would slow the dispatcher it measures
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        t_mark = time.monotonic()
        torch.cuda._sleep(1000)
    ops.start(side)
    host.on = True
    t_start = time.monotonic()
    time.sleep(tr["seconds"])
    ops.on = host.on = False
    t_stop = time.monotonic()
    torch.cuda.synchronize(device)
    prof.stop()
    return harness.read_trace(prof, t_start, t_stop, t_mark, host.spans)


def _judge(config, mix, seed, device, family, reqs, replies, by_prompt,
           tokens, t_open, t_close, chunk_over, control=False) -> dict:
    """Every reply with its served tokens, and the check of those judged
    (answered in the window for a closed loop, due in it for an open one):
    attempted, failed, the replies that are not the text of the tokens
    served for their prompt, and the reference's widest gap below its best
    logit over a seeded sample of the served tokens (the longest request
    in it)."""
    special = config["special_ids"]
    image_ids = [special["img"]] + [special["image"]] * config["n_query"] \
        + [special["img_end"]]
    base_vocab = config["llama"]["vocab_size"]
    words_by_id = {traffic.word_id(w, base_vocab): w
                   for w in traffic.vocabulary()}
    answers, served, mismatched = [], [], 0
    key = "due" if mix["loop"] == "open" else "done"
    for r in replies:
        req = reqs[r["i"]]
        ids = traffic.prompt_ids(req, image_ids, special["bos"])
        rids = by_prompt.get(tuple(ids), [])
        toks = tokens.get(rids[0]) if len(rids) == 1 else None
        judged = t_open <= r[key] < t_close
        ok = r["code"] == 0
        if ok and (toks is None or not 0 < len(toks) <= req["new"]
                   or not render_pattern(
                       toks, words_by_id, base_vocab,
                       (special["bos"], special["eos"])).fullmatch(
                           r["text"])):
            mismatched += judged
            toks = None
        elif ok and judged:
            served.append((req, ids, toks))
        answers.append(dict(r, judged=judged, ok=ok,
                            n_tokens=len(toks) if toks else 0,
                            prompt_len=len(ids),
                            images=int(req["image"] is not None)))
    judged = [a for a in answers if a["judged"]]
    failed = [a for a in judged if not a["ok"]]
    gap, control_gap, forms = _gap(
        config, seed, device, family, mix, served, chunk_over,
        control) if served else (None, None, set())
    # the prefill forms the mix's prompts reach, each judged in the sample
    unjudged = len(set(mix["check"].get("forms", ["bucket"])) - forms)
    limit = config["limits"]["token_logit_gap"]
    checks = {
        "failed_requests": {"value": len(failed), "limit": 0},
        "replies_not_served_tokens": {"value": mismatched, "limit": 0},
        "prefill_forms_unjudged": {"value": unjudged, "limit": 0},
        "token_logit_gap": {"value": gap, "limit": limit},
    }
    correct = (not failed and mismatched == 0 and unjudged == 0
               and gap is not None and limit is not None and gap <= limit)
    return {"correct": bool(correct), "attempted": len(judged),
            "failed": len(failed), "checks": checks, "answers": answers,
            "control_gap": control_gap}


def prefill_form(ids, chunk_over) -> str:
    """How the engine admits a prompt of these ids: "chunked" (beyond its
    largest prefill bucket, with chunked prefill on) or "bucket"."""
    return "chunked" if chunk_over is not None and len(ids) > chunk_over \
        else "bucket"


def sample(served, seed: int, min_tokens: int, max_requests: int,
           chunk_over=None):
    """A seeded sample of (request, prompt ids, tokens) holding the request
    with the most served tokens and one request of each prefill form
    (`prefill_form`) that was served, then others until `min_tokens`
    tokens or `max_requests` requests."""
    order = sorted(range(len(served)), key=lambda k: -len(served[k][2]))
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 0x5A3])
    rest = [int(k) for k in rng.permutation(order[1:])]
    picked = [order[0]]
    for form in ("bucket", "chunked"):
        have = {prefill_form(served[k][1], chunk_over) for k in picked}
        k = next((k for k in rest
                  if prefill_form(served[k][1], chunk_over) == form), None)
        if form not in have and k is not None:
            rest.remove(k)
            picked.append(k)
    total = sum(len(served[k][2]) for k in picked)
    while rest and total < min_tokens and len(picked) < max_requests:
        k = rest.pop(0)
        picked.append(k)
        total += len(served[k][2])
    return [served[k] for k in picked]


def _gap(config, seed, device, family, mix, served, chunk_over,
         control=False):
    """(the widest gap by which a served token's reference logit lies below
    the reference's best at its position, over the sample; with control,
    the widest gap of the token the control (the reference one step lower
    in precision) puts first at each of those positions; the prefill forms
    the sample holds)."""
    chosen = sample(served, seed, mix["check"]["min_tokens"],
                    mix["check"]["max_requests"], chunk_over)
    seqs, rows, images = [], [], []
    for req, ids, toks in chosen:
        seqs.append(ids + toks[:-1])
        rows.append(list(range(len(ids) - 1, len(ids) - 1 + len(toks))))
        images.append(_reference_image(config, mix, req))
    with torch.no_grad():
        out = family.reference_logits(config, seed, device, seqs, rows,
                                      images)
    low = None
    if control:
        with torch.no_grad():
            low = family.reference_logits(config, seed, device, seqs, rows,
                                          images, control=True)
    gap, control_gap = 0.0, 0.0
    for k, (logits, (_, _, toks)) in enumerate(zip(out, chosen)):
        best = logits.max(-1).values
        t = torch.tensor(toks, device=logits.device)
        gap = max(gap, float((best - logits.gather(1, t[:, None])[:, 0])
                             .max()))
        if low is not None:
            c = low[k].argmax(-1)
            control_gap = max(control_gap, float(
                (best - logits.gather(1, c[:, None])[:, 0]).max()))
    forms = {prefill_form(ids, chunk_over) for _, ids, _ in chosen}
    return gap, (control_gap if control else None), forms


def _reference_image(config, mix, req):
    """The request's image as the reference takes it: the PNG's pixels,
    bicubic to the tower's size, scaled to [0, 1] and normalised by CLIP's
    mean and deviation (fp32 [S, S, 3]); None for a text request."""
    if req["image"] is None:
        return None
    from PIL import Image
    size = config["vision"]["image_size"]
    arr = traffic.image(req["image"], *mix["image_size"])
    im = Image.fromarray(arr).resize((size, size), Image.BICUBIC)
    x = np.asarray(im, np.float32) / 255.0
    mean = np.asarray((0.48145466, 0.4578275, 0.40821073), np.float32)
    std = np.asarray((0.26862954, 0.26130258, 0.27577711), np.float32)
    return torch.from_numpy((x - mean) / std)
