"""Readings from which the limits of ``correct`` are set: the check's
numbers for the program on many seeds, and for the control (the
reference in the precision below the configuration's, put in the
program's place) and the planted faults on a few, at the cell's own
size, in one process.

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 \
        --control-seeds 3 --out portbench/out/readings-<name>.json

Not part of a benchmark run; the limits files cite its output.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import device, harness
    cell, cfg, traffic, limits, _, _ = harness.load_cell(ROOT, args.workload)
    if args.device == "cuda":
        device.require_cards(torch, cell["chips"])
    port = harness.import_port(ROOT)
    kind = __import__(f"portbench.kinds.{traffic['kind']}",
                      fromlist=["start"])
    sync = torch.cuda.synchronize if args.device == "cuda" else (
        lambda: None)
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Ctx(torch, port, args.device, seed, cfg, traffic,
                          port.model_config(cfg), sync)
        run = kind.start(ctx)
        row = {"seed": seed,
               **run.readings(limits, control=i < args.control_seeds),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del run, ctx
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"workload": args.workload, "card": device.power_limit()
         if args.device == "cuda" else "cpu", "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
