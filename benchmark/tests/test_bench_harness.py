"""The harness's own pieces on the CPU: every cell, mix, configuration and
metric found by its name, the mixes drawn alike from one seed, the frozen
cost functions against hand counts, the tokenizer copy against the port's,
the result line's keys, and the guard against the JAX package.

    python -m pytest benchmark/tests -q
"""

import importlib
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import costs, harness, traffic  # noqa: E402
from benchmark import run as bench_run  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
MIXES = sorted(p.stem for p in (ROOT / "benchmark" / "traffic").glob(
    "*.json") if traffic.load_mix(p.stem)["driver"] == "http_chat")


def test_every_cell_finds_its_files():
    names = {c["name"] for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        assert cell["config"] in names
        entry = next(c for c in BENCH["configs"]
                     if c["name"] == cell["config"])
        config = json.loads((ROOT / entry["file"]).read_text())
        importlib.import_module(f"benchmark.families.{config['family']}")
        mix = traffic.load_mix(cell["traffic"])
        importlib.import_module(f"benchmark.drivers.{mix['driver']}")
        e2e, per = bench_run.cell_metrics(BENCH, cell["name"])
        assert any(m["name"] == "setup_s" for m in e2e)
        assert len(e2e) >= 2 and per


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(bench_run.reader(m["name"]))


@pytest.mark.parametrize("mix", MIXES)
def test_mix_is_drawn_alike_from_one_seed(mix):
    m = traffic.load_mix(mix)
    m = dict(m, rate=m.get("rate") or 1.0)
    a, b = traffic.requests(m, 2 ** 31 + 11), traffic.requests(m,
                                                               2 ** 31 + 11)
    assert a == b
    c = traffic.requests(m, 7)
    assert a != c
    # every block of every seed holds the same sizes and arrival gaps;
    # the seed draws their order, and the words
    blk = m["block"]

    def block(reqs, j):
        part = reqs[j * blk:(j + 1) * blk]
        start = reqs[j * blk - 1]["due"] if j and part[0]["due"] else 0.0
        dues = [start] + [r["due"] for r in part]
        gaps = sorted(round(y - x, 9) for x, y in zip(dues, dues[1:])) \
            if part[0]["due"] is not None else None
        return (sorted(len(r["words"]) for r in part),
                sorted(r["new"] for r in part), gaps)
    assert block(a, 0) == block(a, 1) == block(c, 0) == block(c, 3)
    assert [len(r["words"]) for r in a[:blk]] != \
        [len(r["words"]) for r in c[:blk]]
    lo, hi = m["prompt_words"]["min"], m["prompt_words"]["max"]
    assert all(lo <= len(r["words"]) <= hi for r in a)


def test_images_are_drawn_alike():
    assert (traffic.image(5, 64, 48) == traffic.image(5, 64, 48)).all()
    assert (traffic.image(5, 64, 48) != traffic.image(6, 64, 48)).any()


def test_vocabulary_ids_are_distinct():
    words = traffic.vocabulary()
    assert len({traffic.word_id(w) for w in words}) == len(words)


def test_hash_tokens_match_the_ports_tokenizer():
    from emu_tpu_torch import tokenization as T
    tok = T.EmuTokenizer.emu2(instruct=True)
    text = ("[IMG]" + "<image>" * 3 + "[/IMG]w1 w2. [IMG]x y"
            " ImageContent[/IMG] z")
    specials = {"[IMG]": tok.img_token_id, "[/IMG]": tok.img_end_token_id,
                "<image>": tok.image_token_id}
    assert [1] + traffic.hash_tokens(text, specials) == tok.encode(text)


def test_caption_reply_pattern_knows_the_prompt_words():
    """A caption holding the prompt's own pieces ("ImageContent", ".",
    "[USER]:") decodes to those words, and the check reads them so."""
    from benchmark.drivers import batch_caption, http_chat
    from emu_tpu_torch.cli.inference import tokenizer_for
    from emu_tpu_torch.config import Emu1Config
    here = ROOT / "benchmark" / "tests"
    config = json.loads((here / "tiny-emu1.json").read_text())
    mix = traffic.load_mix(str(here / "tiny-caption.json"))
    tok = tokenizer_for(Emu1Config())
    text, _ = batch_caption._prompt(config, mix)
    assert [1] + tok.encode(text, add_bos=False) == \
        batch_caption.prompt_ids(config, mix)
    ids = [traffic.word_id(w) for w in ("ImageContent", ".", "[USER]:")]
    toks = [ids[0], 4711, 32003, ids[1], ids[2], 2]
    words = batch_caption.prompt_words(config, mix)
    assert http_chat.render_pattern(toks, words, 32000).fullmatch(
        tok.decode(toks).strip())


def test_costs_against_hand_counts():
    # 2 x 3 @ 3 x 4 bf16 with bias: 12 + 24 + 16 + 8 bytes, 48 ops
    assert costs.dense_cost(2, 3, 4) == (60, 48)
    # W4A8 2 x 256 @ 256 x 8, two groups: x 1024, nibbles 1024, scales 64,
    # out 32 bytes
    assert costs.q4_cost(2, 256, 8, 2) == (2144, 8192)
    # causal attention of one head, 4 tokens, D 2: q, k, v, out bf16, 10
    # pairs
    assert costs.attn_cost(1, 1, 4, 4, 2, pairs=10) == (64, 80)
    # one query over 5 valid bf16 rows of one head (D 2), the new row as
    # an extra column, a 8-slot mask
    nb, ops = costs.decode_cost(1, 1, 1, 2, 5, 8)
    assert (nb, ops) == (8 + 40 + 8 + 8, 8 * 6)
    assert costs.norm_cost(3, 4, True) == (2 * 12 * 4 + 8 + 12, 48)
    t, by = costs.bound(3.35e12, 1.0)
    assert by == "bytes" and abs(t - 1.0) < 1e-12
    t, by = costs.bound(1.0, 989e12)
    assert by == "operations" and abs(t - 1.0) < 1e-12
    # 2 layers of d 4, f 8, 2 heads: per layer 4 * 12 + 16 + 96 = 160
    # weights; 3 tokens over a context of 2, logits at one row of vocab 10
    cfg = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2,
           "num_attention_heads": 2, "extended_vocab_size": 10}
    assert costs.llama_flops(cfg, 3, 2, 1) == 2 * 3 * 2 * 160 + \
        4 * 3 * 2 * 4 * 2 + 2 * 4 * 10


def test_result_line_has_the_five_keys(capsys):
    result = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
              "device": {"platform": "gpu", "kind": "x", "count": 1,
                         "memory_peak_bytes": 1}}
    harness.emit_result(result, {"gap": {"value": 0.1, "limit": 0.5}})
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1] == "check gap: 0.1 (limit 0.5)"


@pytest.mark.parametrize("name,banned", [
    ("emu_tpu_torch", False), ("emu_tpu_torch.ops", False),
    ("emu_tpu", True), ("emu_tpu.models", True), ("jax", True),
    ("jaxlib", True), ("jax_helpers", False), ("flax", True)])
def test_import_guard_compares_whole_top_level_names(monkeypatch, name,
                                                     banned):
    for m in list(sys.modules):
        if m.split(".")[0] in harness.BANNED:
            monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in harness.banned_modules()) == banned


@pytest.mark.cuda
def test_each_cell_runs_on_the_card(tmp_path):
    """One short run of every cell (the card decides, inside the test)."""
    import subprocess
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in BENCH["workloads"]:
        out = subprocess.run(
            [sys.executable, str(ROOT / "benchmark" / "run.py"),
             "--workload", cell["name"], "--seed", "2147483659",
             "--seconds", "10", "--trace", "0"], cwd=ROOT,
            capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["device"]["platform"] == "gpu"
