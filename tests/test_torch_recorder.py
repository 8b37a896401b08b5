"""The port's own spans and counters (`emu_tpu_torch.utils.profiling`:
`RECORDER`, `Stats`, `trace`) on the CPU: the recorder's bounds, its off
switch and its nesting; device times through the anchor and the timings of
a call, with stand-in CUDA events; the continuous engine's rows and a
request's times on a scripted run; the runner's `last_stats` and the beam
search's records; the records in an exported trace; `GET /v1/stats` over
real HTTP."""

import json
import threading
import time
import urllib.request

import pytest
import torch

from emu_tpu_torch import tokenization as T
from emu_tpu_torch.cli.inference import build_runner
from emu_tpu_torch.config import Emu2Config
from emu_tpu_torch.generation.continuous import ContinuousEngine
from emu_tpu_torch.models import emu2, llama
from emu_tpu_torch.ops.layers import Init
from emu_tpu_torch.pipelines.chat import EmuChatGeneration
from emu_tpu_torch.serving.backend import EmuHTTPServer, make_server
from emu_tpu_torch.serving.continuous_helper import ContinuousChatHelper
from emu_tpu_torch.utils import profiling
from emu_tpu_torch.utils.profiling import RECORDER, Recorder, Stats

CFG = Emu2Config.tiny()


@pytest.fixture
def recorder():
    """The process-wide recorder, emptied and on."""
    RECORDER.clear()
    RECORDER.enabled = True
    yield RECORDER
    RECORDER.enabled = True
    RECORDER.clear()


class FakeEvent:
    """A CUDA event's reading side: its time (s) and whether it is done."""

    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


# --- the recorder ------------------------------------------------------------


def test_recorder_keeps_the_newest_and_counts_all():
    rec = Recorder(maxlen=4)
    for _ in range(10):
        rec.close(rec.open("step"), rows=3)
    rec.count("rows", 5)
    assert len(rec.records) == 4
    assert [r.id for r in rec.records] == [7, 8, 9, 10]
    assert rec.counters == {"step": 10, "rows": 5}
    assert all(r.counts == {"rows": 3} and r.end >= r.start
               for r in rec.records)


def test_recorder_off_records_nothing():
    rec = Recorder()
    rec.enabled = False
    assert rec.open("a") is None
    with rec.span("b") as r:
        assert r is None
    rec.close(None, rows=1)
    rec.count("c")
    assert not rec.records and not rec.counters and rec.snapshot() == []


def test_span_parents_nest_per_thread():
    rec = Recorder()
    seen = {}

    def worker():
        with rec.span("other") as r:
            seen["other"] = r
    with rec.span("outer") as outer:
        with rec.span("inner") as inner:
            with rec.span("leaf") as leaf:
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=10)
        with rec.span("sibling") as sib:
            pass
    assert not t.is_alive()
    assert outer.parent is None and seen["other"].parent is None
    assert inner.parent == outer.id and leaf.parent == inner.id
    assert sib.parent == outer.id
    assert outer.start <= inner.start <= leaf.start <= leaf.end \
        <= inner.end <= sib.start <= sib.end <= outer.end
    # an open record is not a span: no child of it
    top = rec.open("request")
    with rec.span("later") as later:
        assert later.parent is None and top.parent is None


def test_device_times_through_the_anchor():
    """An event's time is the anchor's host time plus the card's time from
    the anchor event; nothing is read before the event has completed."""
    rec = Recorder()
    rec._anchors[0] = (FakeEvent(50.0), 1000.0)
    step = rec.open("engine.decode")
    rec.close(step)
    step.card, step.events = 0, [FakeEvent(50.25), FakeEvent(50.5)]
    pending = rec.open("engine.decode")
    pending.card, pending.events = 0, [FakeEvent(51.0),
                                       FakeEvent(51.5, done=False)]
    req = rec.open("request")
    req.marks.update(admitted=999.0, first=step, last=pending)
    snap = {r["id"]: r for r in rec.snapshot()}
    assert snap[step.id]["device"] == (1000.25, 1000.5)
    assert snap[pending.id]["device"] is None
    assert snap[req.id]["marks"] == {"admitted": 999.0, "first": 1000.5,
                                     "last": None}
    pending.events[1].done = True
    assert rec.point(req.marks["last"]) == 1001.5
    # a record without events is timed by its host end
    host = rec.open("pipeline.preprocess")
    rec.close(host)
    assert rec.point(host) == host.end and rec.device_span(host) is None


def test_request_times_and_summary():
    rec = Recorder()
    for i, (queued, admitted, first, last, n) in enumerate((
            (0.0, 0.5, 1.0, 3.0, 5), (1.0, 1.1, 2.1, 2.1, 1),
            (2.0, 4.0, 4.3, 5.3, 3))):
        r = rec.open("request")
        r.start = queued
        r.marks.update(admitted=admitted, first=first, last=last)
        rec.close(r, tokens=n)
    rec.open("request")                   # queued, never admitted
    waits, firsts, gaps = profiling.request_times(rec.snapshot())
    assert waits == pytest.approx([0.5, 0.1, 2.0])
    assert firsts == pytest.approx([0.5, 1.0, 0.3])
    assert gaps == pytest.approx([0.5, 0.5])
    s = rec.summary()
    assert s["requests"] == 3 and s["counters"] == {"request": 4}
    assert s["queue_wait_ms"] == pytest.approx(500.0)
    assert s["first_token_ms"] == pytest.approx(500.0)
    assert s["token_gap_ms"] == pytest.approx(500.0)


def test_stats_resolve_when_read_or_settled():
    st = Stats(rows=2)
    st.interval("host_s", (1.0, None), (1.25, None))
    st.interval("done_s", (0.0, FakeEvent(10.0)), (0.0, FakeEvent(10.5)))
    late = FakeEvent(11.0, done=False)
    st.interval("late_s", (0.0, FakeEvent(10.0)), (0.0, late))
    assert st["host_s"] == 0.25
    st.settle()
    assert dict.__getitem__(st, "done_s") == 0.5
    assert not isinstance(dict.__getitem__(st, "late_s"), float)
    assert set(st) == {"rows", "host_s", "done_s", "late_s"}
    # a read waits for the late event, then holds the number
    assert dict(st) == {"rows": 2, "host_s": 0.25, "done_s": 0.5,
                        "late_s": 1.0}
    assert late.done and dict.__getitem__(st, "late_s") == 1.0


# --- the continuous engine -------------------------------------------------


def test_engine_rows_and_request_times(recorder):
    """One bucket admission (5 tokens into the 8 bucket), one chunked
    admission (18 tokens in chunks of 4 over 5 mixed steps while the first
    request decodes its last 5 tokens) and a decode block of 4: rows
    computed 8 + 5 x (4 + 4) + 4 x 4 = 64 (a mixed step computes one row a
    slot and the chunk's 4), rows that carried a token 5 + (5 x 1 + 18) + 4
    = 32; every request queued <= admitted <= first <= last."""
    cfg = CFG.llama
    params = llama.init(cfg, Init(
        generator=torch.Generator().manual_seed(3)))
    eng = ContinuousEngine(params, cfg, max_slots=4, max_len=64,
                           prefill_buckets=(8, 16), eos_token_id=None,
                           chunk_size=4)
    rng = torch.Generator().manual_seed(0)

    def row(n, max_new):
        ids = torch.randint(1, cfg.vocab_size, (1, n), generator=rng)
        return (llama.embed(params, ids), torch.ones(1, n, dtype=torch.int32),
                max_new)
    (a,) = eng.submit_many([row(5, 6)])
    (b,) = eng.submit_many([row(18, 5)])
    assert eng.drain_admissions() == 5
    eng.record_block(eng.step_block(4))
    done = eng.finished()
    assert sorted(done) == [a, b]
    assert len(done[a]) == 6 and len(done[b]) == 5
    steps = [r for r in recorder.records if r.name.startswith("engine.")]
    assert [r.name for r in steps] == (["engine.prefill"]
                                       + ["engine.mixed"] * 5
                                       + ["engine.decode"] * 4)
    assert [r.counts["rows"] for r in steps] == [8] + [8] * 5 + [4] * 4
    assert [r.counts["useful"] for r in steps] == [5, 5, 5, 5, 5, 3] \
        + [1] * 4
    assert recorder.counters["engine.rows"] == 64
    assert recorder.counters["engine.useful_rows"] == 32
    reqs = [r for r in recorder.snapshot() if r["name"] == "request"]
    assert [r["counts"]["tokens"] for r in reqs] == [6, 5]
    for r in reqs:
        m = r["marks"]
        assert r["start"] <= m["admitted"] <= m["first"] <= m["last"] \
            <= r["end"]
    req_a, req_b = [r for r in recorder.records if r.name == "request"]
    assert req_a.marks["first"] is steps[0]             # the prefill
    assert req_a.marks["last"] is steps[5]              # its 6th token
    assert req_b.marks["first"] is steps[5]             # the final chunk
    assert req_b.marks["last"] is steps[-1]


# --- the runner and the beam search -----------------------------------------


def test_runner_last_stats_and_beam_records(recorder):
    runner = build_runner(device="cpu", seed=0)
    img = (torch.arange(32 * 40 * 3) % 251).reshape(32, 40, 3).to(
        torch.uint8).numpy()
    from PIL import Image
    images = [Image.fromarray(img)] * 2
    text = runner.caption_prompt()
    out = runner.generate_batch(images, [text] * 2, max_new_tokens=4,
                                beam_size=3)
    assert len(out) == 2
    st = runner.last_stats
    assert isinstance(st, Stats)
    assert set(st) == {"encode_s", "images", "rows", "prompt_len", "beams",
                       "prefill_s", "decode_s", "decode_steps"}
    assert st["images"] == 2 and st["rows"] == 2 and st["beams"] == 3
    for key in ("encode_s", "prefill_s", "decode_s"):
        assert isinstance(dict.__getitem__(st, key), float) and st[key] > 0
    names = [r.name for r in recorder.records]
    assert names.count("pipeline.preprocess") == 1
    assert names.count("pipeline.encode") == 1
    (gen,) = [r for r in recorder.records if r.name == "generation.generate"]
    kids = [r for r in recorder.records if r.parent == gen.id]
    reorders = [r for r in kids if r.name == "generation.reorder"]
    steps = [r for r in kids if r.name == "generation.step"]
    assert len(reorders) == len(steps) == st["decode_steps"] >= 1
    assert all(r.end is not None and r.events is None for r in kids)


# --- the operator's tools --------------------------------------------------


def test_trace_exports_the_recorder_spans(recorder, tmp_path):
    with recorder.span("before"):
        pass
    with profiling.trace(str(tmp_path)):
        with recorder.span("generation.generate") as outer:
            with recorder.span("generation.step"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    (path,) = tmp_path.iterdir()
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    ours = {e["name"]: e for e in events if e.get("cat") == "recorder"}
    assert set(ours) == {"generation.generate", "generation.step"}
    step, gen = ours["generation.step"], ours["generation.generate"]
    assert step["args"]["parent"] == outer.id == gen["args"]["id"]
    assert gen["ts"] <= step["ts"] and \
        step["ts"] + step["dur"] <= gen["ts"] + gen["dur"] + 1e-3
    # on the profiler's clock: the span holds the matmul it ran
    (mm,) = [e for e in events if e.get("name") == "aten::matmul"]
    assert step["ts"] - 50 <= mm["ts"] <= step["ts"] + step["dur"]


def test_v1_stats_over_http(recorder):
    """Three requests through the continuous helper, then GET /v1/stats:
    the counters, and the medians of the requests' times."""
    tok = T.EmuTokenizer(T.SimpleTokenizer(CFG.llama.vocab_size),
                         T.emu2_special_tokens(),
                         base_vocab=CFG.llama.vocab_size)
    init = Init(generator=torch.Generator().manual_seed(1))
    chat = EmuChatGeneration(emu2.init(CFG, init), CFG, tok)
    helper = ContinuousChatHelper(chat, max_slots=2, max_len=128)
    httpd = make_server(EmuHTTPServer(helper, None), "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        answers = []

        def ask(text):
            answers.append(helper.get()([text], max_new_tokens=4))
        asks = [threading.Thread(target=ask, args=(t,))
                for t in ("hello there", "a cat", "what is this?")]
        for t in asks:
            t.start()
        for t in asks:
            t.join(timeout=120)
        assert len(answers) == 3
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/stats", timeout=30) as r:
            body = json.loads(r.read())
            assert r.headers["Content-Type"] == "application/json"
    finally:
        httpd.shutdown()
        httpd.server_close()
        helper.close()
    c = body["counters"]
    assert c["request"] == 3 and c["engine.prefill"] >= 1
    assert c["engine.rows"] >= c["engine.useful_rows"] > 0
    assert 1 <= c["helper.admit"] <= 3
    assert body["requests"] == 3
    for key in ("queue_wait_ms", "first_token_ms", "token_gap_ms"):
        assert body[key] is not None and body[key] >= 0
    bursts = [r for r in recorder.records if r.name == "helper.admit"]
    assert sum(r.counts["burst"] for r in bursts) == 3
    assert time.monotonic() >= max(r.end for r in bursts)
