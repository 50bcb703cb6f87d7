#!/usr/bin/env python3
"""Run phases of several checkouts' own ``chip_smoke.py`` on one card, in
turns, so that two versions of the port are compared inside one call.

    python3 scripts/torch_kernel_ab.py [--phase NAME ...] [--eq8 N:C ...] \\
        OLD_CHECKOUT . . OLD_CHECKOUT

Each argument is the root of a checkout.  Each runs in a process of its own
(the packages share one name), in the order given: it imports that
checkout's ``chip_smoke.py`` and port package, builds the kernels the
phases need with that checkout's ``phase_build``, and runs the phases with
that checkout's code, so each version is timed and checked as its own
smoke does it.  Their lines are printed under the checkout's name, after
the card's name and power limit.

Phases (``chip_smoke.py``'s function in brackets):

* ``eq8``: Eq. 8 against its plain version and ``torch.addmv``
  (``phase_kernel_vs_plain``) at the ``--eq8`` shapes, and with L2 flushed
  at the same shapes where the checkout's phase can (``flushed``);
* ``attention``, ``ssd``, ``adam``: the other kernels against their plain
  versions (``phase_attention_vs_plain``, ``phase_ssd_vs_plain``,
  ``phase_adam_vs_plain``);
* ``score``, ``score_mamba``: yi-6b and mamba2-370m scored at full width
  (``phase_score``, ``phase_score_mamba``);
* ``score_hybrid``, ``serve_hybrid``, ``dense_remainder``: recurrentgemma-2b
  scored and served at full width, and the three dense configs at full
  width and 2 layers (``phase_score_hybrid``, ``phase_serve_hybrid``,
  ``phase_dense_remainder``; checkouts from before the hybrid have none).

Needs one CUDA card and the CUDA toolkit.  Exits 1 if a phase failed in any
checkout.
"""
import argparse
import inspect
import os
import subprocess
import sys

PHASES = ("eq8", "attention", "ssd", "adam", "score", "score_mamba",
          "score_hybrid", "serve_hybrid", "dense_remainder")
EQ8_DEFAULT = ["79510:128", "1000003:16"]


def run_phases(root, phases, eq8_shapes):
    """The phases of the checkout at ``root`` (this process only)."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_adam as adam
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import stale_aggregate as agg
    if not cs.__file__.startswith(root) or not agg.__file__.startswith(root):
        raise RuntimeError(f"imported {cs.__file__} and {agg.__file__}, "
                           f"not {root}'s")
    mods = cs.import_port()

    def eq8():
        kw = {}
        if "flushed" in inspect.signature(cs.phase_kernel_vs_plain).parameters:
            kw["flushed"] = eq8_shapes
        cs.phase_kernel_vs_plain(torch, agg, eq8_shapes, **kw)

    table = {
        "eq8": ([agg], eq8),
        "attention": ([fa, da],
                      lambda: cs.phase_attention_vs_plain(torch, fa, da)),
        "ssd": ([ssd], lambda: cs.phase_ssd_vs_plain(torch, ssd)),
        "adam": ([adam], lambda: cs.phase_adam_vs_plain(torch, adam)),
        "score": ([fa, da], lambda: cs.phase_score(torch, fa, da, mods)),
        "score_mamba": ([ssd],
                        lambda: cs.phase_score_mamba(torch, ssd, mods)),
        "score_hybrid": ([fa],
                         lambda: cs.phase_score_hybrid(torch, fa, mods)),
        "serve_hybrid": ([], lambda: cs.phase_serve_hybrid(torch, mods)),
        "dense_remainder": ([fa], lambda: cs.phase_dense_remainder(
            torch, fa, mods)),
    }
    cs.phase_environment(torch)
    kernels = []
    for name in phases:
        kernels += [m for m in table[name][0] if m not in kernels]
    cs.phase_build(kernels)
    for name in phases:
        cs.timed(name, table[name][1])
        torch.cuda.empty_cache()


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", action="append", choices=PHASES,
                    help="a phase to run (repeatable; default eq8 and ssd)")
    ap.add_argument("--eq8", action="append", metavar="N:C",
                    help=f"an Eq.-8 shape (repeatable; default "
                         f"{' '.join(EQ8_DEFAULT)})")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="+", metavar="CHECKOUT")
    args = ap.parse_args(argv)
    phases = args.phase or ["eq8", "ssd"]
    eq8 = args.eq8 or EQ8_DEFAULT
    if args.one:
        shapes = [tuple(int(v) for v in s.split(":")) for s in eq8]
        run_phases(os.path.abspath(args.roots[0]), phases, shapes)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    flags = [f for p in phases for f in ("--phase", p)] + \
        [f for s in eq8 for f in ("--eq8", s)]
    failed = 0
    for i, root in enumerate(args.roots):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", *flags, root],
                             capture_output=True, text=True)
        label = f"[{i}:{root}]"
        for line in (res.stdout + res.stderr).splitlines():
            print(f"{label} {line}")
        print(f"{label} exit {res.returncode}", flush=True)
        failed |= res.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
