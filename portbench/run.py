"""The port's benchmark: one run of one cell on the card(s) of this
machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell named in ``BENCHMARK.json``, sets it up (weights and
traffic drawn from ``--seed`` on the device, every shape warmed), then
either measures ``--seconds`` seconds and prints the cell's end-to-end
metrics, or (``--trace 1``) profiles a few units and prints its per-layer
metrics; then checks the timed path's outputs against the plain
reference.  The last line of standard output is the result, as JSON; the
numbers compared, each beside its limit, are the last lines of standard
error.  Without a card, or without the program, it prints no result and
exits with a code other than 0.  Caches of built kernels live in the
checkout (``build/``, ``portbench/out/cache/``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / "out" / "cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import device, harness

    def log(what):
        print(f"[portbench] {what} at {time.perf_counter() - T_START:.3f} s",
              file=sys.stderr, flush=True)
    log("torch imported")
    cell = harness.load_cell(ROOT, args.workload)[0]
    device.require_cards(torch, cell["chips"])
    log("the card found")
    try:
        harness.import_port(ROOT)
    except ImportError as e:
        sys.exit(f"portbench: the program is not in this checkout ({e})")
    log("the program imported")
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    print(f"[portbench] card: {device.power_limit()}", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        sys.exit(f"portbench: the run loaded {found}; the port's benchmark "
                 f"may load neither JAX nor the JAX package")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
