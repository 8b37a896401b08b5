"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is looked up in BENCHMARK.json at the root of the checkout: its
configuration file (`configs/<config>.json`) and its traffic mix
(`traffic/<mix>.json`) name the family and the driver that run it
(`families/<family>.py`, `drivers/<driver>.py`), and every metric is read
by a reader of its own (`metrics/<metric>.py`): with --trace 0 the cell's
end-to-end metrics, with --trace 1 its per-layer ones. The last line of
standard output is the result; the numbers compared for `correct` are the
last lines of standard error. Without a CUDA card, with fewer cards than the
cell asks for, or with the JAX package loaded, it exits non-zero and prints
no result.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))


def cell_metrics(bench: dict, name: str):
    """(end-to-end, per-layer) metric entries this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in moved)]
    return e2e, per


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == cell["config"])
    import torch
    from benchmark import harness, traffic
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    card = harness.card_line()
    print(f"card: {card}; cell {cell['name']}, seed {args.seed}, "
          f"{args.seconds} s, trace {args.trace}", flush=True)
    with open(ROOT / cfg_entry["file"]) as f:
        config = json.load(f)
    mix = traffic.load_mix(cell["traffic"])
    driver = importlib.import_module(f"benchmark.drivers.{mix['driver']}")
    device = torch.device("cuda", 0)
    record = driver.run(cell, config, mix, args.seed, args.seconds,
                        bool(args.trace), device, T0)
    e2e, per = cell_metrics(bench, cell["name"])
    metrics = {}
    for m in (per if args.trace else e2e):
        value = reader(m["name"])(record)
        if value is None:
            if not args.trace:
                print(f"end-to-end metric {m['name']} read nothing",
                      file=sys.stderr)
                return 3
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    for line in record.get("notes", []):
        print(line, flush=True)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"],
                   "memory_peak_bytes": record["memory_peak_bytes"]}
    result = {"correct": record["correct"], "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": device_info}
    trace = record.get("trace")
    if args.trace:
        if trace is None:
            print("the traced window holds no kernel", file=sys.stderr)
            return 3
        device_info["busy_s"] = trace["busy_s"]
        device_info["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    bad = harness.banned_modules()
    if bad:
        print(f"the JAX package or JAX is loaded: {bad}", file=sys.stderr)
        return 4
    harness.emit_result(result, record["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
