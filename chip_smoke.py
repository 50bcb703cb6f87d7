#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports no JAX and
nothing of the JAX package.  Phases, in order — any failure exits non-zero:

1. environment: card name and power limit, torch and CUDA versions; TF32
   off for matmuls and convolutions;
2. build: ``nvcc`` compiles every kernel of the path from
   ``src/repro_torch/kernels/csrc/`` (timed);
3. kernel vs plain: each kernel against its plain torch version on the
   card at the main path's shapes, timed with CUDA events beside the
   library yardstick and the byte/operation bound;
4. main path: ``run_simulation(device="cuda")`` on the quickstart config
   (mnist_dnn at full width, 20 UEs, A = 5), batched and then sequential;
5. scale point: 256 UEs, A = 128 (the engine sweep's top point);
6. card-side golden: the first static golden of ``tests/test_driver.py``
   from the JAX package's seed-0 init (``src/repro_torch/testdata``).

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
"device": ...}`` line.
"""
import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12              # f32 outside the tensor cores

# tests/test_driver.py::test_static_trajectory_matches_pre_refactor_golden
GOLDEN_TIMES = ["0x0.0p+0", "0x1.b877293c2d615p-1",
                "0x1.ae97a23acc733p+0", "0x1.4066315c4298cp+1"]
GOLDEN_TOTAL = "0x1.4066315c4298cp+1"
GOLDEN_WAIT = "0x1.f2da4241021f8p-3"
GOLDEN_PI = [[1, 0, 0, 1, 0, 0, 0, 1], [0, 0, 1, 0, 0, 1, 1, 0],
             [0, 1, 0, 0, 1, 0, 0, 1], [1, 0, 1, 1, 0, 0, 0, 0],
             [0, 0, 0, 0, 0, 1, 1, 1], [0, 1, 1, 0, 1, 0, 0, 0]]
GOLDEN_LOSSES = [2.3583488166332245, 1.8240666687488556,
                 1.4705257415771484, 1.1463348343968391]
GOLDEN_GLOBAL = [2.7490968108177185, 2.1383248418569565,
                 1.7266773730516434, 1.365978181362152]


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------

def device_ms(torch, fn, *, reps=20, trials=50):
    """Median over ``trials`` of the per-call device time of ``reps``
    back-to-back calls, in ms.  A sleep kernel queued first holds the
    stream until every call is enqueued, so host launch cost is hidden and
    the events measure the card's own execution."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0      # enqueue cost of one trial
    torch.cuda.synchronize()
    sleep_cycles = int(2.0 * host_s * 2e9) + 100_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(trials):
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build(agg):
    t0 = time.perf_counter()
    log = agg.build()
    dt = time.perf_counter() - t0
    print(f"[build] stale_aggregate.cu -> sm_90a in {dt:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def _agg_inputs(torch, c, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(n, generator=g, device="cuda")
    buf = torch.randn(c, n, generator=g, device="cuda")
    # zeros (padded lanes) and fractional λ^τ-style weights
    choices = torch.tensor([0.0, 1.0, 0.5, 0.7 ** 3], device="cuda")
    mask = choices[torch.randint(0, 4, (c,), generator=g, device="cuda")]
    mask[0] = 1.0
    return p, buf, mask


def phase_kernel_vs_plain(torch, agg, shapes):
    """Every shape: kernel vs plain (max abs error), then device times of
    kernel, plain version and the one-call library yardstick."""
    rows = {}
    for n, c in shapes:
        p, buf, mask = _agg_inputs(torch, c, n, seed=n + c)
        got = agg.stale_aggregate_flat(p, buf, mask, beta=0.07)
        torch.cuda.synchronize()
        want = agg.stale_aggregate_plain(p, buf, mask, beta=0.07)
        err = float((got - want).abs().max())
        tol = 1e-6 * (1.0 + float(p.abs().max()))
        check(math.isfinite(err) and err <= tol,
              f"kernel disagrees with plain at N={n} C={c}: {err} > {tol}")
        a = max(float(mask.sum()), 1.0)
        t_kernel = device_ms(torch, lambda: agg.stale_aggregate_flat(
            p, buf, mask, beta=0.07))
        t_plain = device_ms(torch, lambda: agg.stale_aggregate_plain(
            p, buf, mask, beta=0.07), reps=5, trials=50)
        bt = buf.t()
        t_lib = device_ms(torch, lambda: torch.addmv(p, bt, mask,
                                                     alpha=-0.07 / a))
        nbytes = (c + 2) * n * 4 + c * 4
        flops = 2 * c * n + n
        b_bytes = nbytes / H100_BYTES_PER_S * 1e3
        b_ops = flops / H100_F32_FLOPS * 1e3
        bound = max(b_bytes, b_ops)
        rows[(n, c)] = dict(max_abs_err=err, ms=t_kernel, plain_ms=t_plain,
                            library_ms=t_lib, bound_ms=bound,
                            bound_by="bytes" if b_bytes >= b_ops
                            else "operations")
        print(f"[kernel] stale_aggregate N={n} C={c}: err={err:.3e} "
              f"(tol {tol:.1e})  kernel={t_kernel * 1e3:.2f} us  "
              f"plain={t_plain * 1e3:.2f} us  addmv={t_lib * 1e3:.2f} us  "
              f"bound={bound * 1e3:.2f} us ({nbytes / 1e6:.2f} MB)")
    return rows


def _quickstart(mods):
    cfg = mods.ExperimentConfig(
        model=mods.get_config("mnist_dnn"),
        fl=mods.FLConfig(n_ues=20, participants_per_round=5,
                         staleness_bound=5, alpha=0.03, beta=0.07,
                         inner_batch=16, outer_batch=16, hessian_batch=16))
    data = mods.synthetic_mnist(n=4000)
    return cfg, data


def _record_shapes(agg):
    """Wrap the flat entry point to note each (N, C) the path launches;
    the launch count itself stays the wrapper's own."""
    seen = collections.Counter()
    orig = agg.stale_aggregate_flat

    def recording(params, buffers, mask, *, beta):
        if params.is_cuda:
            seen[(int(buffers.shape[1]), int(buffers.shape[0]))] += 1
        return orig(params, buffers, mask, beta=beta)

    agg.stale_aggregate_flat = recording
    return seen, orig


def phase_main_path(torch, agg, mods, device="cuda"):
    cfg, data = _quickstart(mods)
    model = mods.build_model(cfg.model)
    engine = mods.SimulationEngine(model, cfg.fl, "perfed", device=device)
    seen, orig = _record_shapes(agg)
    try:
        agg.LAUNCHES = 0
        t0 = time.perf_counter()
        res = mods.run_simulation(
            cfg, model, mods.partition_noniid(data, 20, n_labels=4),
            algorithm="perfed", mode="semi", max_rounds=40, eval_every=10,
            engine=engine, device=device)
        wall = time.perf_counter() - t0
        launches = agg.LAUNCHES
    finally:
        agg.stale_aggregate_flat = orig
    rounds = int(res.pi.shape[0])
    check(rounds == 40, f"main path closed {rounds} rounds, not 40")
    leaves = mods.tree_leaves(res.params)
    check(all(x.device.type == device for x in leaves),
          "final params are not on the card")
    # one more payload through the same engine: payloads live on the card
    c0 = mods.partition_noniid(data, 20, n_labels=4)[0]
    pay = engine.compute_payloads([res.params], [c0.sample_triplet(16, 16, 16)],
                                  [0.03])[0]
    check(all(x.device.type == device for x in mods.tree_leaves(pay)),
          "payloads are not on the card")
    losses = res.losses
    check(len(losses) == 5 and all(math.isfinite(x) for x in losses),
          f"losses not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(set(res.pi.sum(1).tolist()) == {5}, "a Π row does not sum to A")
    check(launches > 0, "the main path launched the Eq.-8 kernel 0 times")
    print(f"[main] quickstart batched: 40 rounds in {wall:.2f} s = "
          f"{40 / wall:.2f} rounds/s (wall clock incl. 5 evals, first run); "
          f"ploss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"dispatches {res.payload_dispatches}; kernel launches {launches} "
          f"at (N, C) {dict(seen)}")

    # the same run on the warm engine, then once more under the tracer with
    # device timing (every dispatch synchronised) for the phase breakdown
    def again(**kw):
        t0 = time.perf_counter()
        mods.run_simulation(
            cfg, model, mods.partition_noniid(data, 20, n_labels=4),
            max_rounds=40, eval_every=10, engine=engine, device=device, **kw)
        return time.perf_counter() - t0

    warm = again()
    tracer = mods.Tracer(device=True)
    traced = again(tracer=tracer)
    print(f"[main] quickstart batched, warm engine: 40 rounds in {warm:.2f} s"
          f" = {40 / warm:.2f} rounds/s (incl. 5 evals)")
    host = {k: round(v, 4) for k, v in sorted(tracer.phase_s.items())}
    dev = {k: round(v, 4) for k, v in sorted(tracer.device_phase_s.items())}
    print(f"[main] traced run {traced:.2f} s: host phases {host}; device "
          f"(synchronised) {dev}; counts {dict(sorted(tracer.counts.items()))}")

    # one client with a short shard: its rounds miss the fused path's
    # single-signature condition and go through the batch-wise feed
    mixed = mods.partition_noniid(data, 20, n_labels=4)
    mixed[3].data = {k: v[:10] for k, v in mixed[3].data.items()}
    tracer = mods.Tracer()
    before = agg.LAUNCHES
    res_m = mods.run_simulation(cfg, model, mixed, max_rounds=10,
                                eval_every=10, engine=engine, device=device,
                                tracer=tracer)
    batchwise = tracer.counts.get("driver.rounds_batchwise", 0)
    check(res_m.pi.shape[0] == 10 and batchwise > 0
          and all(math.isfinite(x) for x in res_m.losses),
          f"mixed-shard run: {res_m.pi.shape[0]} rounds, {batchwise} "
          f"batch-wise, losses {res_m.losses}")
    print(f"[main] mixed shard sizes: 10 rounds, {batchwise} through the "
          f"batch-wise feed, kernel launches {agg.LAUNCHES - before}")

    # sequential feed: one Eq.-8 close (one launch) per round
    seq_engine = mods.SimulationEngine(model, cfg.fl, "perfed",
                                       payload_mode="sequential",
                                       device=device)
    before = agg.LAUNCHES
    t0 = time.perf_counter()
    res_s = mods.run_simulation(
        cfg, model, mods.partition_noniid(data, 20, n_labels=4),
        max_rounds=10, eval_every=10, engine=seq_engine, device=device)
    wall_s = time.perf_counter() - t0
    added = agg.LAUNCHES - before
    check(added == res_s.pi.shape[0] == 10,
          f"sequential run: {added} launches for {res_s.pi.shape[0]} rounds")
    print(f"[main] quickstart sequential: 10 rounds in {wall_s:.2f} s = "
          f"{10 / wall_s:.2f} rounds/s; launches added {added} == rounds "
          f"closed {res_s.pi.shape[0]}")
    return launches, seen


def phase_scale(torch, agg, mods, device="cuda"):
    n = 256
    cfg = mods.ExperimentConfig(
        model=mods.get_config("mnist_dnn"),
        fl=mods.FLConfig(n_ues=n, participants_per_round=n // 2,
                         staleness_bound=8, alpha=0.03, beta=0.07,
                         first_order=True, inner_batch=4, outer_batch=4,
                         hessian_batch=4))
    model = mods.build_model(cfg.model)
    data = mods.synthetic_mnist(n=max(2500, 40 * n), seed=0)
    out = {}
    engines = {}
    for mode in ("batched", "batched", "sequential"):
        warm = mode in engines
        engine = engines.setdefault(mode, mods.SimulationEngine(
            model, cfg.fl, "perfed", payload_mode=mode, device=device))
        before = agg.LAUNCHES
        t0 = time.perf_counter()
        res = mods.run_simulation(
            cfg, model, mods.partition_noniid(data, n, n_labels=4, seed=0),
            max_rounds=10, eval_every=0, engine=engine, device=device)
        wall = time.perf_counter() - t0
        added = agg.LAUNCHES - before
        check(res.pi.shape[0] == 10 and set(res.pi.sum(1).tolist()) == {128},
              f"scale point ({mode}) did not close 10 rounds of A=128")
        out[mode] = 10 / wall
        print(f"[scale] 256 UEs A=128 {mode}{' (warm)' if warm else ''}: "
              f"10 rounds in {wall:.2f} s = "
              f"{10 / wall:.2f} rounds/s; dispatches "
              f"{res.payload_dispatches}; kernel launches {added}")
    return out


def phase_golden(torch, mods, device="cuda"):
    import numpy as np
    cfg = mods.ExperimentConfig(
        model=mods.get_config("mnist_dnn"),
        fl=mods.FLConfig(n_ues=8, participants_per_round=3, staleness_bound=3,
                         alpha=0.03, beta=0.07, inner_batch=8, outer_batch=8,
                         hessian_batch=8))
    model = mods.build_model(cfg.model)
    init = dict(np.load(os.path.join(SRC, "repro_torch", "testdata",
                                     "mnist_dnn_init_seed0.npz")))
    model.init = lambda gen: mods.from_numpy_tree(init, "cpu")
    clients = mods.partition_noniid(mods.synthetic_mnist(n=600, seed=21), 8,
                                    n_labels=4, seed=0)
    res = mods.run_simulation(cfg, model, clients, algorithm="perfed",
                              mode="semi", max_rounds=6, eval_every=2, seed=0,
                              device=device)
    check([float(t).hex() for t in res.times] == GOLDEN_TIMES,
          f"golden times differ: {[float(t).hex() for t in res.times]}")
    check(float(res.total_time).hex() == GOLDEN_TOTAL, "golden total_time")
    check(float(res.wait_fraction).hex() == GOLDEN_WAIT, "golden wait")
    check(res.pi.tolist() == GOLDEN_PI, "golden Π differs")
    check(res.payload_dispatches == 8 and res.payloads_computed == 18,
          f"golden dispatches {res.payload_dispatches}/"
          f"{res.payloads_computed}, want 8/18")
    rel = max(abs(a / b - 1) for a, b in zip(res.losses, GOLDEN_LOSSES))
    rel_g = max(abs(a / b - 1) for a, b in zip(res.global_losses,
                                               GOLDEN_GLOBAL))
    check(rel <= 1e-4 and rel_g <= 1e-4,
          f"golden losses off by {rel:.2e} / {rel_g:.2e} (rtol 1e-4)")
    print(f"[golden] times/Π/wait/dispatches bitwise; losses rel err "
          f"{rel:.2e}, global {rel_g:.2e} (rtol 1e-4)")


def import_port():
    """The port's entry points, imported after the checks that need none."""
    from repro_torch.config import ExperimentConfig, FLConfig
    from repro_torch.configs import get_config
    from repro_torch.data import partition_noniid, synthetic_mnist
    from repro_torch.fl.engine import SimulationEngine
    from repro_torch.fl.simulation import run_simulation
    from repro_torch.models import build_model
    from repro_torch.obs.trace import Tracer
    from repro_torch.utils.tree import from_numpy_tree, tree_leaves
    return types.SimpleNamespace(**locals())


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs only "
              "on a card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no port package under {SRC}; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import stale_aggregate as agg

    phase_environment(torch)
    phase_build(agg)
    mods = import_port()
    # the main path's shapes: mnist_dnn's N with the server's close (C = A
    # = 5), the engine's padded bucket (8) and the scale point (128); one
    # large ragged N
    rows = phase_kernel_vs_plain(
        torch, agg, [(79_510, 1), (79_510, 5), (79_510, 8), (79_510, 128),
                     (1_000_003, 16)])
    launches, seen = phase_main_path(torch, agg, mods)
    phase_scale(torch, agg, mods)
    phase_golden(torch, mods)
    check("jax" not in sys.modules and not any(
        m == "repro" or m.startswith("repro.") for m in sys.modules),
        "the port pulled in JAX or the JAX package")

    # the kernel's line reports the shape the main path launched most
    shape = max(seen, key=seen.get) if seen else (79_510, 5)
    row = rows.get(shape) or rows[(79_510, 5)]
    print(json.dumps({"kernels": [{
        "name": "stale_aggregate_flat", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stale_aggregate.cu",
        "replaces": "src/repro/kernels/stale_aggregate.py:50",
        "launches": launches, "shape": list(shape), **row}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
