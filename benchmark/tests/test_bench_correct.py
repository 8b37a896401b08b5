"""`correct` on the CPU at a size a test run holds: a sound run of each
kind of cell (the served chat, the open-loop image questions, the batch
captions) comes out correct; its control (the reference one step lower in
precision, in the program's place) and each fault the cell can have, the
timed path broken underneath the harness, come out not correct. The tiny
configurations' limits are set from these CPU readings, as the cells'
limits are from the chip's (PERF.md). The cells run on one chip, so the
fault of an exchange between chips left out has no place here.

    python -m pytest benchmark/tests -q
"""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from benchmark import faults, traffic  # noqa: E402
from benchmark.drivers import batch_caption, http_chat  # noqa: E402

SEED = 2 ** 31 + 5
CPU = torch.device("cpu")


def chat_run(mix="tiny-chat.json", control=False):
    cfg = json.loads((HERE / "tiny-emu2.json").read_text())
    m = traffic.load_mix(str(HERE / mix))
    return http_chat.run({"name": "tiny"}, cfg, m, SEED, 2.0, False, CPU,
                         time.monotonic(), control=control)


def caption_run(control=False):
    cfg = json.loads((HERE / "tiny-emu1.json").read_text())
    m = traffic.load_mix(str(HERE / "tiny-caption.json"))
    return batch_caption.run({"name": "tiny"}, cfg, m, SEED, 1.0, False, CPU,
                             time.monotonic(), control=control)


def test_sound_chat_run_is_correct_and_its_control_is_not():
    rec = chat_run(control=True)
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert rec["correct"], rec["checks"]
    # both prefill forms judged: a chunked admission is in the sample
    assert rec["checks"]["prefill_forms_unjudged"]["value"] == 0
    assert rec["control_gap"] > rec["checks"]["token_logit_gap"]["limit"]


def test_sound_image_question_run_is_correct():
    rec = chat_run("tiny-vqa.json")
    assert rec["attempted"] > 0 and rec["correct"], rec["checks"]


def test_sound_caption_run_is_correct_and_its_control_is_not():
    rec = caption_run(control=True)
    assert rec["attempted"] > 0 and rec["correct"], rec["checks"]
    assert rec["rows_judged"] > 0 and rec["images_compared"] > 0
    # the control fails every compared number
    for name in ("token_logprob_gap", "token_logprob_gap_mean"):
        limit = rec["checks"][name]["limit"]
        assert all(c[name] > limit for c in rec["control_gap"].values())


@pytest.mark.parametrize("fault", faults.CHAT)
def test_chat_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch.setattr)
    rec = chat_run()
    assert not rec["correct"], rec["checks"]


@pytest.mark.parametrize("fault", faults.CAPTION)
def test_caption_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch.setattr)
    rec = caption_run()
    assert not rec["correct"], rec["checks"]
