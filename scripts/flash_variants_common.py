"""Build, load, call and time versions of the flash kernel's source side by
side on one card: the pieces that ``scripts/flash_d256_variants.py`` (the
bf16 D-256 route's layouts) and ``scripts/flash_f32_variants.py`` (versions
of the f32 route) share.

Each version is a copy of ``src/repro_torch/kernels/csrc/flash_attention.cu``
with the same C entry point (``flash_attention_fwd``), built with the port's
``nvcc`` flags into a shared library of its own and called through ctypes,
so that versions load side by side in one process.  Each is checked in a
process of its own (a kernel that traps spoils its process's CUDA context),
and the versions that pass are timed in turns, each and then again in
reverse order (``chip_smoke.device_ms``: median of trials of back-to-back
calls between CUDA events).
"""
import concurrent.futures
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "flash_attention.cu")


def card():
    """``nvidia-smi``'s name and power limit of card 0."""
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()


def ptxas_report(log, kernel):
    """ptxas's registers, spills and any C75xx warning (wgmmas serialised)
    for each instance of the template ``kernel``, by its head dim:
    {"256": "...", ...}."""
    inst = re.compile(re.escape(kernel) + r"ILi(\d+)E")
    out, cur = {}, None

    def add(d, text):
        out[d] = f"{out[d]}; {text}" if d in out else text

    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            d = inst.search(m.group(1))
            cur = d.group(1) if d else None
            continue
        warn = re.search(r"\((C75\d+)\) (.*) for the function '(\S+)'", line)
        if warn:
            d = inst.search(warn.group(3))
            if d:
                add(d.group(1), f"{warn.group(1)} {warn.group(2)}")
        elif cur and ("registers" in line or "spill" in line):
            add(cur, line.split(":", 1)[-1].strip())
    return out


def build(sources, work, report):
    """name -> (return code, seconds, ``report(ptxas log)`` or the
    compiler's error), every source at once into ``work/name.so``."""
    from repro_torch.kernels._build import NVCC_FLAGS, nvcc
    os.makedirs(work, exist_ok=True)

    def one(name):
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o",
                               os.path.join(work, f"{name}.so"),
                               sources[name]], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        return name, (proc.returncode, time.perf_counter() - t0,
                      report(log) if proc.returncode == 0 else log[-3000:])

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        return dict(ex.map(one, sources))


def load(work, name):
    """(the library, its ``flash_attention_fwd``)."""
    lib = ctypes.CDLL(os.path.join(work, f"{name}.so"))
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib, fn


def call(torch, fn, route, q, k, v, out, causal, window):
    """q, k, v, out as [B, H, L, D] views (head dim contiguous)."""
    b, hq, sl, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), route,
             b, hq, k.shape[1], sl, d, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], *out.stride()[:3], int(causal), int(window),
             1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return out


def inputs(torch, shape, seed, dtype):
    """q, k, v for (B, Hq, Hkv, L, D, causal, window), made on the card."""
    b, hq, hkv, sl, d, _, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in ((b, hq, sl, d), (b, hkv, sl, d), (b, hkv, sl, d))]


def check_each(script, args_by_name, timeout=600):
    """Run ``script --check NAME ARGS...`` for each name, each in a process
    of its own, its output passed through; returns {name: its stdout} of
    those that exit 0, and prints each verdict."""
    passed = {}
    for name, args in args_by_name.items():
        proc = subprocess.run([sys.executable, script, "--check", name,
                               *map(str, args)], capture_output=True,
                              text=True, timeout=timeout)
        print(proc.stdout + proc.stderr[-2000:], end="", flush=True)
        print(f"[check] {name}: "
              f"{'passed' if proc.returncode == 0 else 'FAILED'}", flush=True)
        if proc.returncode == 0:
            passed[name] = proc.stdout
    return passed


def time_in_process(script, payload, timeout):
    """Run ``script --time PAYLOAD`` in a process of its own, its output
    passed through; returns the JSON of its ``RESULT`` line, or None if it
    failed."""
    proc = subprocess.run([sys.executable, script, "--time",
                           json.dumps(payload)], capture_output=True,
                          text=True, timeout=timeout)
    print(proc.stdout + proc.stderr[-2000:], end="", flush=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        return None
    return json.loads(lines[0][len("RESULT "):])


def in_turns(torch, cs, names, run, label="", trials=10):
    """{name: [ms, ms]}: ``run(name)`` timed for each name in turn and then
    again in reverse order."""
    ms = {name: [] for name in names}
    for name in list(names) + list(names)[::-1]:
        t = cs.device_ms(torch, lambda: run(name), reps=3, trials=trials)
        ms[name].append(t)
        print(f"[time] {label}{name}: {t:.4f} ms", flush=True)
    return ms


def sdpa_ms(torch, cs, q, k, v, causal, window):
    """SDPA's time on the same inputs, the window as a boolean mask (a
    window as long as L cuts nothing)."""
    import torch.nn.functional as F
    sl = q.shape[2]
    mask = cs.keep_mask(torch, sl, True, window) if 0 < window < sl else None
    return cs.device_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True), reps=3, trials=10)
