#!/usr/bin/env python3
"""Build, check and time versions of the f32 flash route on one card.

    python3 scripts/flash_f32_variants.py [--source NAME=PATH ...] [--out FILE]

The f32 route of ``src/repro_torch/kernels/csrc/flash_attention.cu``
(``flash_3xtf32_kernel``, route code 0) runs both products in 3xTF32 on
``mma.sync``.  This script builds the source as it ships and every
``--source`` (another ``flash_attention.cu`` with the same C entry point)
at once with the port's ``nvcc`` flags into ``build/``, and prints
ptxas's report for each instance of the f32 kernel: registers and spills.

Each version that builds is then checked in a process of its own (a kernel
that traps spoils its process's CUDA context): at the route's edges
against the plain version run in float64, max row rel 2e-5 (the limit of
``tests/test_torch_card.py``), and at the six f32 shapes of
``chip_smoke.py``'s phase 3 against the plain version in float32, max abs
5e-5 (``chip_smoke.F32_ABS_TOL``); the row-relative error is printed
beside it.  Those that pass are timed at the six shapes in turns, each
version and then again in reverse order (``chip_smoke.device_ms``: median
of trials of back-to-back calls between CUDA events), beside SDPA in f32.
The building, calling and timing are ``scripts/flash_variants_common.py``'s.

Needs one CUDA card and the CUDA toolkit; prints the card's name and power
limit.  Exits 1 if no version builds and passes.
"""
import argparse
import json
import os
import sys

from flash_variants_common import (ROOT, SOURCE, build, call, card,
                                   check_each, in_turns, inputs, load,
                                   ptxas_report, sdpa_ms, time_in_process)

WORK = os.path.join(ROOT, "build", "flash_f32_variants")
# (B, Hq, Hkv, L, D, causal, window): every head dim, ragged L, windows,
# GQA groups 1, 4 and 8, non-causal
EDGE_CASES = [(2, 4, 4, 333, d, True, 0) for d in (16, 32, 64, 128, 256)] + [
    (2, 8, 2, 1000, 128, True, 200), (2, 8, 1, 257, 64, False, 0),
    (1, 10, 1, 1000, 256, True, 200), (1, 2, 1, 20, 32, True, 0)]
F64_ROW_RTOL = 2e-5


def _errors(got, want):
    diff = got.double() - want.double()
    rel = diff.norm(dim=-1) / want.double().norm(dim=-1).clamp_min(1e-300)
    return float(diff.abs().max()), float(rel.max())


def check(name):
    """The edge cases against float64, the phase-3 shapes against float32;
    prints one JSON line; exit code 0 if every case is inside its limit."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    fn = load(WORK, name)[1]
    ok, rows = True, {}
    for shape in EDGE_CASES:
        causal, window = shape[5], shape[6]
        q, k, v = inputs(torch, shape, shape[3] + shape[4], torch.float32)
        got = call(torch, fn, 0, q, k, v, torch.empty_like(q), causal, window)
        torch.cuda.synchronize()
        want = cs.attention_keep(torch, q, k, v, cs.keep_mask(
            torch, shape[3], causal, window), cast=torch.Tensor.double)
        err, rel = _errors(got, want)
        ok &= rel <= F64_ROW_RTOL
        print(f"[check] {name} {shape} vs float64: max abs {err:.3e}, max "
              f"row rel {rel:.3e}", flush=True)
    for shape in cs.FLASH_SHAPES:
        causal, window = shape[5], shape[6]
        q, k, v = inputs(torch, shape, shape[3] + shape[4], torch.float32)
        got = call(torch, fn, 0, q, k, v, torch.empty_like(q), causal, window)
        want = fa.attention_plain(q, k, v, causal=causal, window=window)
        err, rel = _errors(got, want)
        ok &= err <= cs.F32_ABS_TOL
        rows[str(shape)] = dict(max_abs_err=err, max_row_rel_err=rel)
        print(f"[check] {name} {shape} vs float32: max abs {err:.3e}, max "
              f"row rel {rel:.3e}", flush=True)
        del got, want
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(dict(variant=name, ok=bool(ok), rows=rows)))
    return 0 if ok else 1


def time_variants(names):
    """{shape: {name: [ms, ms], "sdpa": ms, "bound_ms": ms}} in turns."""
    import torch

    import chip_smoke as cs
    fns = {name: load(WORK, name)[1] for name in names}
    out = {}
    for shape in cs.FLASH_SHAPES:
        b, hq, hkv, sl, d, causal, window = shape
        q, k, v = inputs(torch, shape, 1, torch.float32)
        o = torch.empty_like(q)
        ops = 4 * b * hq * d * cs._flash_pairs(sl, causal, window)
        row = in_turns(torch, cs, names, lambda name: call(
            torch, fns[name], 0, q, k, v, o, causal, window),
            label=f"{shape} ")
        for name, ts in row.items():
            print(f"[time] {shape} {name}: " + ", ".join(
                f"{ops / t / 1e9:.1f}" for t in ts)
                + " TFLOP/s of f32 work", flush=True)
        row["sdpa"] = sdpa_ms(torch, cs, q, k, v, causal, window)
        row["bound_ms"] = cs.flash_bound(
            4 * (2 * b * hq * sl * d + 2 * b * hkv * sl * d), ops)[0]
        print(f"[time] {shape} sdpa: {row['sdpa']:.4f} ms, 3xTF32 bound "
              f"{row['bound_ms']:.4f} ms", flush=True)
        out[str(shape)] = row
        del q, k, v, o
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="another flash_attention.cu")
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--check", help=argparse.SUPPRESS)
    ap.add_argument("--time", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    if args.check:
        return check(args.check)
    if args.time:
        print("RESULT " + json.dumps(time_variants(json.loads(args.time))))
        return 0

    smi = card()
    print(smi)
    sources = {"shipped": SOURCE}
    for spec in args.source:
        name, path = spec.split("=", 1)
        sources[name] = os.path.abspath(path)
    built = build(sources, WORK, lambda log: ptxas_report(
        log, "flash_3xtf32_kernel"))
    for name, (rc, dt, report) in built.items():
        print(f"[build] {name}: rc {rc}, {dt:.1f} s; {report}", flush=True)
    passed = check_each(__file__, {name: [] for name in sources
                                   if built[name][0] == 0})
    if not passed:
        return 1
    times = time_in_process(__file__, list(passed), timeout=1200)
    if times is None:
        return 1
    checks = {name: json.loads(next(ln for ln in out.splitlines()
                                    if ln.startswith("RESULT "))[7:])
              for name, out in passed.items()}
    result = dict(card=smi, ptxas={n: built[n][2] for n in built
                                   if built[n][0] == 0},
                  checks=checks, passed=list(passed), times=times)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
