"""The readings a cell's `correct` limit is set from, on the chip:

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed, in one process, one run of the cell as `run.py` makes it
(a shorter window is enough to finish and compare as many requests), then
over the same sample of what was served: the program's reading (the number
`correct` compares) and the control's (the reference computed one step
lower in precision than the configuration states, put in the program's
place). One JSON line a seed. The benchmark's own runs never run the
control.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] --fault <name>

plants one of `faults.py`'s faults underneath the runs instead and reads
what the check makes of them (`correct` has to come out false).
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
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args()
    import torch
    from benchmark import harness, traffic
    if not torch.cuda.is_available():
        print("control readings need a CUDA card", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    mix = traffic.load_mix(cell["traffic"])
    driver = importlib.import_module(f"benchmark.drivers.{mix['driver']}")
    print(f"card: {harness.card_line()}", flush=True)
    if args.fault:
        from benchmark import faults
        faults.BY_NAME[args.fault](setattr)
    for seed in args.seeds:
        t = time.monotonic()
        rec = driver.run(cell, config, mix, seed, args.seconds, False,
                         torch.device("cuda", 0), t,
                         control=not args.fault)
        print(json.dumps({
            "seed": seed, "fault": args.fault, "correct": rec["correct"],
            "program": rec["checks"], "gaps": rec.get("gaps"),
            "control": rec["control_gap"], "attempted": rec["attempted"],
            "failed": rec["failed"], "notes": rec.get("notes", [])}),
            flush=True)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
