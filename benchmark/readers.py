"""The arithmetic of the metric readers (`metrics/<name>.py`), each a
function of the run's record that returns the metric, or None where the
run has nothing to read."""

from __future__ import annotations

import statistics

from benchmark import costs, traffic


def setup_s(r):
    return r["setup_s"]


def _done_in_window(r):
    t0, t1 = r["window"]
    return [a for a in r["answers"] if a["ok"] and t0 <= a["done"] < t1]


def tokens_per_s(r):
    """Tokens the served path generated in the window over its seconds
    (read on the host's clock at the window's open and close)."""
    return r["generated"] / r["seconds"]


def latency_ms_p90(r):
    """90th percentile of due-to-answer time over the requests due in the
    window; a failed request counts as never answered."""
    lat = [(a["done"] - a["due"]) * 1e3 if a["ok"] else float("inf")
           for a in r["answers"] if a["judged"]]
    return traffic.percentile(lat, 90) if lat else None


def rows_per_step(r):
    steps = r.get("steps")
    return statistics.fmean(s[2] for s in steps) if steps else None


def step_ms(r):
    steps = r.get("steps")
    return r["seconds"] * 1e3 / len(steps) if steps else None


def kernels_roofline(r):
    """Sum of the counted calls' bounds over the device time of their
    kernels, in %."""
    dev = r.get("op_device_s")
    return 100.0 * r["op_bound_s"] / dev if dev else None


def mfu_served(r):
    """Model operations of the requests answered in the window (prefill,
    decode and the tower's images) over the window at the bf16 peak, in
    %."""
    cfg = r["config"]
    ops = sum(costs.served_flops(cfg["llama"], a["prompt_len"],
                                 a["n_tokens"])
              + costs.vit_flops(cfg["vision"], a["images"])
              for a in _done_in_window(r))
    return 100.0 * ops / (r["seconds"] * costs.MFU_PEAK) if ops else None


def device_idle(r):
    t = r.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def encode_ms(r):
    ms = r.get("encode_ms")
    return statistics.median(ms) if ms else None


def images_per_s(r):
    """Images captioned over the seconds their whole batches took."""
    return r["images_done"] / r["seconds"]


def decode_ms_per_step(r):
    v = r.get("decode_ms_per_step")
    return statistics.median(v) if v else None


def mfu_caption(r):
    """Model operations of the window's batches (the tower over every
    image, the decoder's prefill of every prompt and its decode steps over
    every beam row) over the window at the bf16 peak, in %."""
    cfg, mix = r["config"], r["mix"]
    lm = cfg["llama"]
    ops = 0.0
    for b in r["batches"]:
        st = b["stats"]
        rows, s = st["rows"], st["prompt_len"]
        beams = rows * st["beams"]
        ops += costs.vit_flops(cfg["vision"], st["images"])
        ops += costs.llama_flops(lm, rows * s, (s + 1) / 2, rows)
        for t in range(st["decode_steps"]):
            ops += costs.llama_flops(lm, beams, s + t + 1, beams)
    return 100.0 * ops / (r["seconds"] * costs.MFU_PEAK) if ops else None
