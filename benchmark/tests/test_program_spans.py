"""The readers of the program's own records (`program_spans.py`, found by
name as `run.py` finds them) on a synthetic recorder with known answers,
and each returning nothing from a program that keeps no records.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run  # noqa: E402
from emu_tpu_torch.utils import profiling  # noqa: E402

WINDOW = (100.0, 110.0)
NEW = ("scheduler.queue_wait_ms.chat", "engine.first_token_ms.chat",
       "engine.token_gap_ms.chat", "engine.useful_rows.chat",
       "engine.idle_between_steps.chat", "pipeline.preprocess_ms.caption",
       "generation.reorder_ms_per_step.caption")


class Synthetic:
    """A recorder that holds the given plain records."""

    def __init__(self, records):
        self.records = records

    def snapshot(self):
        return self.records


def rec(name, rid=0, parent=None, start=0.0, end=None, device=None,
        marks=None, counts=None):
    return {"name": name, "id": rid, "parent": parent, "start": start,
            "end": end, "device": device, "marks": marks or {},
            "counts": counts or {}}


def request(queued, admitted, first, last, tokens):
    return rec("request", start=queued, marks={
        "admitted": admitted, "first": first, "last": last},
        counts={"tokens": tokens} if tokens else {})


@pytest.fixture
def recorder(monkeypatch):
    def use(records):
        monkeypatch.setattr(profiling, "RECORDER", Synthetic(records))
    return use


def read(name, window=WINDOW):
    return bench_run.reader(name)({"window": window})


REQUESTS = [
    request(90.0, 99.0, 99.5, 101.0, 4),      # admitted before the window
    request(95.0, 100.5, 101.0, 103.0, 5),    # wait 5.5, first 0.5, gap 0.5
    request(100.0, 102.0, 103.0, 109.0, 7),   # wait 2, first 1, gap 1
    request(104.0, 105.0, 106.5, None, 0),    # wait 1, first 1.5, running
    request(109.0, 111.0, 112.0, 115.0, 4),   # admitted after the window
    rec("request", start=108.0),              # still queued
]


def test_queue_wait(recorder):
    recorder(REQUESTS)
    assert read("scheduler.queue_wait_ms.chat") == pytest.approx(2000.0)


def test_first_token(recorder):
    recorder(REQUESTS)
    assert read("engine.first_token_ms.chat") == pytest.approx(1000.0)


def test_token_gap(recorder):
    """Finished in the window: the requests with last tokens at 101, 103 and
    109 (gaps 0.5, 0.5, 1.0 s)."""
    recorder(REQUESTS)
    assert read("engine.token_gap_ms.chat") == pytest.approx(500.0)


def test_useful_rows(recorder):
    recorder([
        rec("engine.prefill", start=99.0, counts={"rows": 256,
                                                  "useful": 100}),
        rec("engine.prefill", start=100.0, counts={"rows": 512,
                                                   "useful": 300}),
        rec("engine.mixed", start=101.0, counts={"rows": 1024, "prompt": 32,
                                                 "useful": 63}),
        rec("engine.decode", start=102.0, counts={"rows": 32,
                                                  "useful": 31}),
        rec("engine.decode", start=109.5, counts={"rows": 32}),  # unread
        rec("request", start=103.0, counts={"rows": 99, "useful": 0}),
    ])
    assert read("engine.useful_rows.chat") == pytest.approx(
        100.0 * (300 + 63 + 31) / (512 + 1024 + 32))


def test_idle_between_steps(recorder):
    """Steps on the device at [99, 100.5], [101, 103], [102.5, 104]
    (overlapping the one before), [105, 108], [109.5, 111]: waits 0.5,
    1.0, 1.5 s of the 10 s window."""
    recorder([rec("engine.decode", device=d) for d in (
        (101.0, 103.0), (99.0, 100.5), (102.5, 104.0), (105.0, 108.0),
        (109.5, 111.0))] + [rec("engine.mixed", device=None),
                            rec("generation.step", device=(104.0, 105.0))])
    assert read("engine.idle_between_steps.chat") == pytest.approx(30.0)


def test_preprocess(recorder):
    recorder([rec("pipeline.preprocess", start=s, end=e) for s, e in (
        (99.9, 100.1), (101.0, 101.2), (103.0, 103.25), (105.0, 105.3),
        (110.0, 110.1))] + [rec("pipeline.preprocess", start=108.0)])
    assert read("pipeline.preprocess_ms.caption") == pytest.approx(250.0)


def test_reorder_per_step(recorder):
    """Three beam searches in the window: reorders of 20, 30 (mean 25), of
    10, 20, 30 (20) and of 40 ms; one before the window, one whose
    reorders are not resolved."""
    recs = [rec("generation.generate", rid=i, start=s)
            for i, s in ((1, 99.0), (2, 100.0), (3, 102.0), (4, 104.0),
                         (5, 106.0))]
    for parent, ms in ((1, [90]), (2, [20, 30]), (3, [10, 20, 30]),
                       (4, [40])):
        t = 100.0 + parent
        recs += [rec("generation.reorder", parent=parent,
                     device=(t, t + m * 1e-3)) for m in ms]
    recs += [rec("generation.reorder", parent=5, device=None),
             rec("generation.step", parent=2, device=(0.0, 1.0))]
    recorder(recs)
    assert read("generation.reorder_ms_per_step.caption") == \
        pytest.approx(25.0)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_records_reads_nothing(monkeypatch, name):
    """A version of the program without the recorder (or with an empty one)
    gives no number and raises nothing."""
    monkeypatch.delattr(profiling, "RECORDER")
    assert read(name) is None
    monkeypatch.setattr(profiling, "RECORDER", Synthetic([]), raising=False)
    assert read(name) is None
