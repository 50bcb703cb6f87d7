#!/usr/bin/env python3
"""Compare the Eq.-8 and fused-Adam kernels of two checkouts on their
machine code: registers, spills and SASS, entry by entry.

    python3 scripts/kernel_sass_diff.py OLD_CHECKOUT [NEW_CHECKOUT] \\
        [--out chiprun_out/sass.json]

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``, ``cu++filt``); no card.
Each source of ``SOURCES`` under ``src/repro_torch/kernels/csrc/`` of
both checkouts is compiled to a cubin with the port's own flags
(``kernels/_build.py``: ``sm_90a``, ``-O3``, ``-Xptxas -v``).  ptxas's
report is printed for every kernel entry of both.  Then each entry of the
old cubin is matched to the new entry of the same name once the new
one's in-place template flag is dropped (``<..., false>`` is the
out-of-place instance), and their SASS is compared with the addresses
taken out: ``identical`` means the same instructions, encodings
included.  The new checkout's in-place instances
(``<..., true>``) have no old counterpart and are reported alone.  Exits
1 if an out-of-place entry's SASS, registers or spills differ.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

SOURCES = ("stale_aggregate.cu", "fused_adam.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xptxas", "-v")


def tool(name):
    return shutil.which(name) or os.path.join("/usr/local/cuda/bin", name)


def build(src, out_dir):
    """(cubin path, ptxas report {mangled entry: text})."""
    cubin = os.path.join(out_dir, os.path.basename(src) + ".cubin")
    proc = subprocess.run([tool("nvcc"), *FLAGS, "-cubin", "-o", cubin, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    report, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            report[name] = ""
        elif name and ("registers" in line or "spill" in line):
            report[name] += ("; " if report[name] else "") + \
                line.split(":", 1)[-1].strip()
    return cubin, report


def sass(cubin):
    """{mangled function: [instruction lines without addresses]}."""
    out = subprocess.run([tool("cuobjdump"), "-sass", cubin],
                         capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and line.strip().startswith(("/*", "/* ")):
            text = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
            if text:
                funcs[name].append(text)
    return funcs


def demangle(names):
    res = subprocess.run([tool("cu++filt"), "-p", *names],
                         capture_output=True, text=True)
    lines = res.stdout.splitlines()
    return lines if res.returncode == 0 and len(lines) == len(names) \
        else list(names)


def numbers(text):
    regs = re.search(r"Used (\d+) registers", text)
    spills = re.findall(r"(\d+) bytes spill", text)
    return (int(regs.group(1)) if regs else None,
            tuple(int(x) for x in spills))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new", nargs="?", default=".")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    result, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        for src in SOURCES:
            side = {}
            for tag, root in (("old", args.old), ("new", args.new)):
                d = os.path.join(tmp, tag)
                os.makedirs(d, exist_ok=True)
                path = os.path.join(root, "src", "repro_torch", "kernels",
                                    "csrc", src)
                cubin, report = build(path, d)
                code = sass(cubin)
                names = sorted(report)
                side[tag] = {dm: (report[mg], code.get(mg, []))
                             for mg, dm in zip(names, demangle(names))}
            rows = {}
            for dm, (rep, code) in side["new"].items():
                out_of_place = re.sub(r", (\(bool\)0|false)>", ">", dm)
                if out_of_place == dm:
                    rows[dm] = dict(ptxas=rep, instructions=len(code),
                                    old=None)
                    print(f"[sass] {src} {dm}: {rep} ({len(code)} "
                          f"instructions; in place, no old counterpart)")
                    continue
                old = side["old"].get(out_of_place)
                same = old is not None and old[1] == code
                same_numbers = old is not None and \
                    numbers(old[0]) == numbers(rep)
                ok = ok and same and same_numbers
                rows[dm] = dict(ptxas=rep, instructions=len(code),
                                old=out_of_place,
                                old_ptxas=old[0] if old else None,
                                sass_identical=same,
                                registers_spills_equal=same_numbers)
                print(f"[sass] {src} {dm}: {rep} ({len(code)} "
                      f"instructions) vs old {out_of_place}: "
                      f"{old[0] if old else 'missing'}; SASS "
                      f"{'identical' if same else 'DIFFERS'}")
            result[src] = rows
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"out_of_place_unchanged": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
