#!/usr/bin/env python3
"""Build, check and time layouts of the bf16 D-256 flash route on one card.

    python3 scripts/flash_d256_variants.py [--old-source PATH] [--out FILE]

At head dim 256 ``flash_wgmma_kernel`` is bound by registers: a consumer
thread holds O for 64 rows x 256 (128 f32 registers) beside a K tile's S
and P.  So its tile and CTA shape are a choice, and this script measures
the candidates.  It rewrites ``WgLayout``'s three choices at D 256 in
copies of ``src/repro_torch/kernels/csrc/flash_attention.cu`` (keys a K/V
tile, ring stages, and whether a producer warpgroup joins the two consumer
warpgroups: 384 threads, or 256 with a consumer thread issuing the
copies), adds the ``m64n32k16`` S product that 32-key tiles need, builds
every copy and the source as it ships at once with the port's ``nvcc``
flags into ``build/``, and prints ptxas's report for
``flash_wgmma_kernel<256>``: registers, spills, and any C75xx warning
(wgmmas serialised).

Each copy that builds is then held against ``attention_plain`` (f32) at
the route's edges and at recurrentgemma-2b's scoring shape
(``chip_smoke.FLASH_HYBRID_SHAPE``), also in the model's [B, L, H, D]
layout read through strides, at the flash limit (max row rel 1e-2), each
in a process of its own (a kernel that traps spoils its process's CUDA
context).  Those that pass are timed at that shape in turns, each variant
and then again in reverse order (``chip_smoke.device_ms``: median of
trials of back-to-back calls between CUDA events), beside SDPA with a
boolean mask.  ``--old-source`` adds an older ``flash_attention.cu`` whose
bf16 D-256 route is the ``mma.sync`` kernel (route code 1) to the checks
and the turns, and compares the machine code (``cuobjdump -sass``) of its
``flash_wgmma_kernel<64>`` and ``<128>`` with the shipped source's.

Needs one CUDA card and the CUDA toolkit; prints the card's name and power
limit.  Exits 1 if no variant builds and passes.  The building, calling and
timing are ``scripts/flash_variants_common.py``'s.
"""
import argparse
import json
import math
import os
import re
import subprocess
import sys

from flash_variants_common import (ROOT, SOURCE, build, call, card,
                                   check_each, in_turns, inputs, load,
                                   ptxas_report, sdpa_ms, time_in_process)

WORK = os.path.join(ROOT, "build", "flash_d256_variants")

# name: (keys a K/V tile, ring stages, producer warpgroup); "shipped" is
# the source as it is (64-key tiles, two stages, no producer warpgroup)
VARIANTS = {
    "bk32-s4-producer": (32, 4, True),    # the D 64/128 CTA, 32-key tiles
    "bk64-s2-producer": (64, 2, True),
    "bk32-s4-consumer": (32, 4, False),
}
# (B, Hq, Hkv, L, D, causal, window): L under a tile, ragged L, window
# edges inside 32- and 64-key tiles, GQA, MHA, non-causal; then the model's
CASES = [(1, 2, 1, 20, 256, True, 0), (1, 4, 2, 129, 256, True, 0),
         (2, 10, 1, 1000, 256, True, 200), (1, 4, 4, 1000, 256, True, 0),
         (1, 2, 1, 333, 256, True, 33), (1, 2, 1, 333, 256, True, 65),
         (2, 4, 2, 129, 256, False, 0)]
ROW_RTOL = 1e-2


def _layout_lines(bk, stages, producer):
    return {
        r"static constexpr int kBK = D == 64 \? 128 : 64;":
            f"static constexpr int kBK = D == 256 ? {bk} : D == 64 ? 128 : 64;",
        r"static constexpr int kStages = D == 256 \? \d+ :":
            f"static constexpr int kStages = D == 256 ? {stages} :",
        r"static constexpr bool kProducerWarpGroup = D != 256;":
            "static constexpr bool kProducerWarpGroup = D != 256 || "
            f"{'true' if producer else 'false'};",
    }


def _wgmma_ss(n, zero):
    """The source of d (64 x n, f32) {+}= A (smem, K-major) * B (smem,
    K-major), k16; ``zero`` writes d without reading it."""
    nr = n // 2
    name = f"wgmma_ss_n{n}" + ("_zero" if zero else "")
    regs = ", ".join(f"%{i}" for i in range(nr))
    outs = ", ".join(f'"{"=" if zero else "+"}f"(d[{i}])' for i in range(nr))
    acc = "" if zero else ", int accumulate"
    return (f"__device__ __forceinline__ void {name}(float (&d)[{nr}], "
            f"uint64_t desc_a, uint64_t desc_b{acc}) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nr + 2}, '
            f'0;\\n" "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 '
            f'{{{regs}}}, %{nr}, %{nr + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
            f"    : {outs}\n"
            f'    : "l"(desc_a), "l"(desc_b), "r"({0 if zero else "accumulate"}));'
            f"\n}}\n")


def variant_source(bk, stages, producer):
    """The kernel source with WgLayout<256> rewritten; raises if the source
    no longer has the lines this script rewrites."""
    src = open(SOURCE).read()
    for pattern, repl in _layout_lines(bk, stages, producer).items():
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise RuntimeError(f"{pattern!r} found {n} times in {SOURCE}")
    if bk == 32:
        marker = "// S = Q K^T for one tile"
        s_64 = ("      if (kk == 0)\n        wgmma_ss_n64_zero(s, dq, dk);\n"
                "      else\n        wgmma_ss_n64(s, dq, dk, 1);\n")
        s_32 = ("      if constexpr (BK == 32) {\n"
                "        if (kk == 0) wgmma_ss_n32_zero(s, dq, dk);\n"
                "        else wgmma_ss_n32(s, dq, dk, 1);\n"
                "      } else {\n" + s_64 + "      }\n")
        if src.count(marker) != 1 or src.count(s_64) != 1:
            raise RuntimeError(f"issue_s in {SOURCE} is not the one this "
                               f"script extends to 32-key tiles")
        src = src.replace(s_64, s_32).replace(
            marker, _wgmma_ss(32, False) + _wgmma_ss(32, True) + "\n" + marker)
    return src


def sass(so):
    """Kernel name -> its instructions (``cuobjdump -sass``), addresses
    and encodings left out."""
    from repro_torch.kernels._build import nvcc
    text = subprocess.run([os.path.join(os.path.dirname(nvcc()),
                                        "cuobjdump"), "-sass", so],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append(" ".join(m.group(1).split()))
    return funcs


def same_sass(old_so, new_so):
    """For D 64 and 128: (instructions old, new, identical)."""
    old, new = sass(old_so), sass(new_so)
    out = {}
    for d in (64, 128):
        key = f"flash_wgmma_kernelILi{d}E"
        a = next(v for k, v in old.items() if key in k)
        b = next(v for k, v in new.items() if key in k)
        out[f"flash_wgmma_kernel<{d}>"] = (len(a), len(b), a == b)
    return out


def check(name, route):
    """Every case, in the [B, H, L, D] layout and in the model's; prints
    one JSON line; exit code 0 if every row is inside the limit."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    lib, fn = load(WORK, name)
    worst = 0.0
    for shape in CASES + [cs.FLASH_HYBRID_SHAPE]:
        causal, window = shape[5], shape[6]
        q, k, v = inputs(torch, shape, shape[3] + shape[4], torch.bfloat16)
        got = call(torch, fn, route, q, k, v, torch.empty_like(q), causal,
                   window)
        qm, km, vm = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        got_m = torch.empty_like(qm)
        call(torch, fn, route, qm.transpose(1, 2), km.transpose(1, 2),
             vm.transpose(1, 2), got_m.transpose(1, 2), causal, window)
        torch.cuda.synchronize()
        want = fa.attention_plain(q.float(), k.float(), v.float(),
                                  causal=causal, window=window)
        rels = [float(((out.float() - want).norm(dim=-1)
                       / want.norm(dim=-1).clamp_min(1e-30)).max())
                for out in (got, got_m.transpose(1, 2))]
        worst = max([worst] + [r if math.isfinite(r) else math.inf
                               for r in rels])
        print(f"[check] {name} {shape}: max row rel {rels[0]:.3e}, model "
              f"layout {rels[1]:.3e}", flush=True)
        del got, got_m, want
        torch.cuda.empty_cache()
    print(json.dumps(dict(variant=name, max_row_rel=worst,
                          smem_bytes=lib.flash_attention_smem_bytes(route,
                                                                    256))))
    return 0 if worst <= ROW_RTOL else 1


def time_variants(routes):
    """{name: [ms, ms]} at FLASH_HYBRID_SHAPE in turns, and SDPA's ms."""
    import torch

    import chip_smoke as cs
    shape = cs.FLASH_HYBRID_SHAPE
    _, _, _, sl, _, causal, window = shape
    q, k, v = inputs(torch, shape, 1, torch.bfloat16)
    out = torch.empty_like(q)
    fns = {name: load(WORK, name)[1] for name in routes}
    ops = 4 * shape[0] * shape[1] * shape[4] * cs._flash_pairs(sl, causal,
                                                                window)
    ms = in_turns(torch, cs, routes, lambda name: call(
        torch, fns[name], routes[name], q, k, v, out, causal, window),
        trials=15)
    for name, ts in ms.items():
        print(f"[time] {name}: " + ", ".join(
            f"{ops / t / 1e9:.1f}" for t in ts) + " TFLOP/s", flush=True)
    sdpa = sdpa_ms(torch, cs, q, k, v, causal, window)
    print(f"[time] sdpa (bool mask): {sdpa:.4f} ms", flush=True)
    return dict(ms=ms, sdpa_ms=sdpa, flop=ops)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-source", help="an older flash_attention.cu whose "
                    "bf16 D-256 route is mma.sync (route code 1)")
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--check", nargs=2, metavar=("NAME", "ROUTE"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--time", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    if args.check:
        return check(args.check[0], int(args.check[1]))
    if args.time:
        print("RESULT " + json.dumps(time_variants(json.loads(args.time))))
        return 0

    smi = card()
    print(smi)
    os.makedirs(WORK, exist_ok=True)
    sources, routes = {}, {}
    for name, layout in VARIANTS.items():
        sources[name] = os.path.join(WORK, f"{name}.cu")
        with open(sources[name], "w") as f:
            f.write(variant_source(*layout))
        routes[name] = 2
    sources["shipped"], routes["shipped"] = SOURCE, 2
    if args.old_source:
        sources["old"], routes["old"] = os.path.abspath(args.old_source), 1
    built = build(sources, WORK, lambda log: ptxas_report(
        log, "flash_wgmma_kernel").get("256", ""))
    for name, (rc, dt, report) in built.items():
        print(f"[build] {name}: rc {rc}, {dt:.1f} s; {report}", flush=True)
    same = {}
    if args.old_source and built["old"][0] == 0 == built["shipped"][0]:
        same = same_sass(*(os.path.join(WORK, f"{n}.so")
                           for n in ("old", "shipped")))
        for kernel, (n_old, n_new, equal) in same.items():
            print(f"[sass] {kernel}: old {n_old} instructions, shipped "
                  f"{n_new}, identical: {equal}", flush=True)
    passed = {name: routes[name] for name in check_each(
        __file__, {name: [routes[name]] for name in routes
                   if built[name][0] == 0})}
    if not passed:
        return 1
    times = time_in_process(__file__, passed, timeout=900)
    if times is None:
        return 1
    result = dict(card=smi, layouts={n: VARIANTS.get(n) for n in routes},
                  ptxas={n: built[n][2] for n in built if built[n][0] == 0},
                  sass_d64_d128=same, passed=sorted(passed), **times)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
