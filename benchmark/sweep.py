"""The knee of an open-loop cell, found once on the chip:

    python3 benchmark/sweep.py --workload <cell> --seconds <s> \
        --seed <n> --rates <r> [<r> ...]

For each arrival rate (requests/s), in one process and in the order given,
one run of the cell with the mix's rate replaced: the latency of the
requests due in the window (median, 90th percentile, the worst), how late
the generator sent them, and how many were still unanswered at the close.
The knee is the highest rate whose p90 and lateness stay flat; the cell
runs at four fifths of it, written into its mix as a number.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args()
    import torch
    from benchmark import harness, traffic
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    print(f"card: {harness.card_line()}", flush=True)
    for rate in args.rates:
        mix = dict(traffic.load_mix(cell["traffic"]), rate=rate)
        driver = importlib.import_module(
            f"benchmark.drivers.{mix['driver']}")
        rec = driver.run(cell, config, mix, args.seed, args.seconds, False,
                         torch.device("cuda", 0), time.monotonic())
        due = [a for a in rec["answers"] if a["judged"]]
        ok = [a for a in due if a["ok"]]
        lat = sorted((a["done"] - a["due"]) * 1e3 for a in ok)
        late = [(a["sent"] - a["due"]) * 1e3 for a in due]
        n = len(lat)
        print(json.dumps({
            "rate": rate, "due": len(due), "answered": n,
            "p50_ms": lat[n // 2] if n else None,
            "p90_ms": traffic.percentile(
                [(a["done"] - a["due"]) * 1e3 if a["ok"] else float("inf")
                 for a in due], 90) if due else None,
            "max_ms": lat[-1] if n else None,
            "late_max_ms": max(late, default=None),
            "tokens_per_s": rec["generated"] / rec["seconds"],
            "correct": rec["correct"], "checks": rec["checks"]}),
            flush=True)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
