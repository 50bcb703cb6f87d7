#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on an NVIDIA card and check them.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports no JAX and
nothing of the JAX package.  Phases, in order — any failure exits non-zero,
and each prints its seconds:

1. environment: card name and power limit, torch and CUDA versions; TF32
   off for matmuls and convolutions;
2. build: ``nvcc`` compiles every kernel from
   ``src/repro_torch/kernels/csrc/``, one process per source, all at once,
   and prints each kernel's registers, static shared memory, stack and
   spills (``-Xptxas -v``);
3. kernel vs plain: each kernel against its plain torch version on the
   card at the main paths' shapes, timed with CUDA events beside the
   library yardstick and the byte/operation bound (Eq. 8 in f32, with its
   grid, and at C 128 and N 1,000,003 also with L2 flushed, beside
   ``addmv`` flushed alike; flash
   and decode attention in bf16, the working type, and in f32, each with
   its route, shared memory a CTA, S chunks for decode, and the first
   design's time, a constant from PERF.md, printed beside the new one but
   kept out of the kernels line; the SSD chunk in f32 at the mamba2
   scoring and prefill shapes, its rate over the j <= i pairs and over all
   pairs, and its shared memory a CTA; flash also at recurrentgemma-2b's
   local attention, MQA at head dim 256 with a 2,048 window, in bf16 (the
   wgmma route without a producer warpgroup) and f32; flash at
   mixtral-8x22b's sliding-window GQA
   (group 6, D 128, a 4,096-key window over 4,096 keys) in bf16 and f32;
   flash at llama-3.2-vision-11b's GQA (group 4, D 128) and at
   musicgen-large's full MHA (group 1, D 64, the wgmma route), both
   causal over 4,096 keys, in bf16 and f32; fused Adam on
   mamba2's in_proj leaf with bf16 p, on an f32 leaf and a ragged N; a
   working set smaller than L2 is timed with L2 flushed before each call).
   Each bf16 attention check, the SSD check (twice: the j <= i mask
   dropped, the diagonal dropped) and the Adam check are also shown a
   planted fault, which they must reject;
4. main path of slice 1: ``run_simulation(device="cuda")`` on the
   quickstart config (mnist_dnn at full width, 20 UEs, A = 5), batched and
   then sequential;
5. scale point: 256 UEs, A = 128 (the engine sweep's top point);
6. card-side golden: the first static golden of ``tests/test_driver.py``
   from the JAX package's seed-0 init (``src/repro_torch/testdata``);
6b. mobile edge (slice 6), every Eq.-8 launch counted and its (N, C)
   noted: ``benchmarks/mobility.py``'s sweep (1,024 UEs, A 64, {0, 20} m/s
   × {1 cell, 4 cells with the cell→cloud hierarchy}, 8 rounds, cold and
   warm), ``benchmarks/scenarios.py``'s matrix (its five registry
   scenarios × equal and Theorem-2 bandwidth, 64 UEs on the 3-cell
   hierarchy, 12 rounds), the degenerate mobile run against the static
   golden, a zero-rate scenario against the closed world, and one traced
   run whose JSONL must validate; then Eq. 8 held against its plain
   version on the path's own inputs at each (N, C) (a planted fault must
   be rejected), and the 4-cell 20 m/s point run again on the CPU: host
   numbers bitwise, params within float32 tolerance;
7. serve: full-width yi-6b in bf16 through ``repro_torch.launch.serve``
   (batch 4, prompt 2,048, 32 tokens, cache 4,096; then the CLI's own
   defaults), then the decode kernel held against the model's own decode
   attention on layer 0 of the live cache, and a few more decode steps
   under ``torch.profiler`` for the card's idle share;
8. score: full-width yi-6b ``loss`` with ``attn_impl="pallas"`` on two
   4,096-token user streams — the flash kernel's path, one launch per
   layer — against ``attn_impl="xla"`` on the same params: the losses,
   each token's logits, and each flash call held against the plain
   version on its own inputs; flash with the causal mask dropped must
   fail the logits check;
9. score mamba2: full-width mamba2-370m ``loss`` (bf16) with
   ``attn_impl="pallas"`` on the same two streams — the SSD kernel's path,
   one launch per layer (48), each call held against the plain version on
   its own inputs — against ``attn_impl="xla"``: the losses, each layer's
   output on the same input, and every token's logits end to end on an
   f32 copy of the params; the SSD with the j <= i mask dropped, and with
   its diagonal dropped, must fail the layer and logits checks;
10. serve mamba2: ``repro_torch.launch.serve --arch mamba2_370m --full``
   (batch 4, prompt 2,048, 32 tokens), then the SSD kernel against the
   plain version on layer 0's live prefill inputs;
10b. score recurrentgemma-2b: full-width, full-depth recurrentgemma-2b
   ``loss`` (bf16) with ``attn_impl="pallas"`` on the same two streams —
   the flash kernel at head dim 256, one launch per attention block (8),
   each held against the plain version on its own inputs — against
   ``attn_impl="xla"``: the losses, every token's logits in bf16 and on an
   f32 copy of the params (the f32 route), beside what a 1e-6 perturbation
   of each RG-LRU scan moves them; flash with the causal mask dropped must
   fail both logits checks;
10c. serve recurrentgemma-2b: ``repro_torch.launch.serve --arch
   recurrentgemma_2b --full`` (batch 4, prompt 2,048, 32 tokens, cache
   4,096; the ring keeps the 2,048 window), the served logits held against
   a teacher-forced forward over prompt + generated tokens, in bf16 and
   served in f32 (``--dtype float32``); logits one step late must fail the
   bf16 check, a conv tail that does not advance and a decode window one
   key short the f32 one;
10d. dense remainder: starcoder2-15b, nemotron-4-15b and deepseek-67b at
   full width, depth cut to 2 layers (deepseek-67b whole is 134 GB of
   bf16), each scored pallas against xla with 2 flash launches at D 128,
   each held against the plain version;
10e. score mixtral-8x22b: full width, 8 of 56 layers (bf16), on the same
   two streams, pallas (flash with the 4,096-key window, group 6, one
   launch per layer, each held against the plain version) against xla:
   the losses, and the logits rows of the tokens that route to the same
   (expert, kept) pairs in every layer (flips counted and printed), in
   bf16 and on an f32 copy of the params streamed a layer at a time; and
   each layer's bf16 output alone, pallas against xla on the xla path's
   input, on the tokens that route alike in that layer;
10f. score deepseek-v2-236b: full width, 4 of 60 layers; MLA runs sdpa
   (0 flash launches); losses and logits pallas against xla, two calls
   bitwise equal (the MoE's fixed-order combine);
10g. serve both at their depth cuts through ``launch/serve.py``'s ``run``
   (batch 4, prompt 2,048, 32 tokens, cache 4,096; DeepSeek-V2 decodes by
   the absorbed MLA), served logits held against a teacher-forced forward
   on the rows that route alike, in bf16 and served in f32 at 2 layers;
10h. score llama-3.2-vision-11b: full width and depth (40 self layers,
   8 gated cross layers over the 1,601 stub image tokens, gates drawn
   nonzero from a seeded generator), bf16, on the same two streams,
   pallas (40 flash launches, group 4, each held against the plain
   version; cross-attention runs sdpa) against xla: the losses, every
   token's logits in bf16 and on an f32 copy streamed a layer at a time;
   flash with the causal mask dropped must fail the bf16 check, the gates
   set back to zero the f32 one;
10i. serve it through ``launch/serve.py``'s ``run`` (batch 4, prompt
   2,048, 32 tokens, cache 4,096): prefill, decode beside the weight-read
   bound, peak memory, the image K/V projections every step recomputes
   timed alone; served logits against a teacher-forced forward in bf16,
   and served in f32 at 2 of the 8 groups;
10j–10k. the same for musicgen-large (48 layers of MHA at D 64, 48 flash
   launches; each stream 4,096 tokens x 4 codebooks), served in f32 at
   full depth;
11. train mamba2: ``launch/train_e2e``'s round loop on full-width
   mamba2-370m (bf16, ``attn_impl="xla"``; 4 cohorts, A 2, S 2, batch 4,
   seq 256) with the server Adam for 3 rounds — the fused Adam kernel's
   path, one launch per leaf (12) a round, held against the reference's
   plain Adam math on the first aggregate that holds gradients — then one
   β-SGD round through the Eq.-8 kernel on the mixed bf16/f32 tree, then
   ``launch.train --mode scale --arch mamba2_370m --steps 3``;
11b. train the rest of the zoo (slice 13): the same round loop at full
   width on recurrentgemma-2b (its group and tail) and musicgen-large (12
   of 48 layers) — two server-Adam rounds (the fused Adam kernel once a
   leaf a round, the largest leaf's launch held against plain), then one
   β-SGD round through the Eq.-8 kernel (held against plain on its own
   inputs, a chunk of N at a time) — llama-3.2-vision-11b (a group of 5
   self layers and its cross layer, gates drawn nonzero; two clipped
   β-SGD rounds, then the Eq.-8 round), and mixtral-8x22b (1 of 56
   layers, 3 clipped β-SGD rounds: no kernel's route fits beside it);
   ``ZOO_TRAIN`` gives each one's depth and cohorts;
11c. the zoo's five families at their reduced f32 configs, 2 semi-sync
   rounds on the card against the CPU's plain route from the same state
   and batches: staleness bitwise, params within 1e-5·(1 + max|p|);
11d. the six examples of ``repro_torch.examples`` at their own settings:
   Π row sums, finite losses, the quickstart's falling loss, cloud merges
   on ``mobile_edge``'s hierarchy, Eq.-8 launches in the simulations;
12. the SPMD layer (slice 10): on a world-1 NCCL mesh, mamba2's step with
   DTensor state against the plain step (fused Eq. 8, then the server
   Adam), finite and bitwise; Mixtral's EP against gather; the dry run.

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
"device": ...}`` line.
"""
import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data sheet (NVIDIA), dense rates at the 700 W limit
H100_BYTES_PER_S = 3.35e12          # HBM3
H100_F32_FLOPS = 67e12              # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12            # tf32 tensor cores
H100_BF16_FLOPS = 989e12            # bf16 tensor cores

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

L2_BYTES = 50 * 2**20                          # the H100's L2


def device_ms(torch, fn, *, reps=20, trials=50, flush_l2=False):
    """Median over ``trials`` of the per-call device time of ``reps``
    back-to-back calls, in ms.  A sleep kernel queued first holds the
    stream until every call is enqueued, so host launch cost is hidden and
    the events measure the card's own execution.  With ``flush_l2`` each
    call is timed alone after a 4 x L2 buffer is read (not written: dirty
    lines left in L2 would be written back inside the timed call), so a
    working set that fits in L2 is read from HBM as a byte bound
    assumes."""
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
    if flush_l2:
        flush = torch.ones(4 * L2_BYTES // 4, device="cuda")
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for _ in range(trials):
        torch.cuda._sleep(sleep_cycles)
        if flush_l2:
            for s, e in pairs:
                flush.sum()
                s.record()
                fn()
                e.record()
            torch.cuda.synchronize()
            out.append(sum(s.elapsed_time(e) for s, e in pairs) / reps)
            continue
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


def phase_build(kernels):
    """One ``nvcc`` per source, all started together (the builds are
    subprocesses, so threads overlap them).  Returns each source's
    ``ptxas_kernels`` report."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as ex:
        futs = {m.SOURCE.name: ex.submit(m.build) for m in kernels}
        logs = {name: f.result() for name, f in futs.items()}
    dt = time.perf_counter() - t0
    print(f"[build] {', '.join(logs)} -> sm_90a in {dt:.2f} s (parallel)")
    reports = {name: ptxas_kernels(log) for name, log in logs.items()}
    for name, report in reports.items():
        for kernel, info in report.items():
            print(f"[build] {name} {kernel}: {info}")
    return reports


def ptxas_kernels(log):
    """``-Xptxas -v``'s report per kernel entry: its name -> its registers,
    static shared memory, stack and spills, and any ``C75xx`` warning
    (wgmma serialised), which ptxas prints before the entry it names."""
    out, name = {}, None

    def add(kernel, text):
        out[kernel] = (out[kernel] + "; " if out.get(kernel) else "") + text

    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        w = re.search(r"\((C75\d+)\) (.*) for the function '(\S+)'", line)
        if m:
            name = m.group(1)
            out.setdefault(name, "")
        elif w:
            add(w.group(3), f"{w.group(1)} {w.group(2)}")
        elif name is not None and ("registers" in line or "spill" in line):
            add(name, line.split(":", 1)[-1].strip())
    return dict(zip(demangle(list(out)), out.values()))


def _instance(report, kernel, d):
    """The entries of a ptxas report for ``kernel<d>``, whether the name
    was demangled (``kernel<(int)d>``) or not (``kernelILi<d>E``)."""
    return {k: v for k, v in report.items()
            if re.search(rf"{kernel}(<(\(int\))?{d}>|ILi{d}E)", k)}


def demangle(names):
    """Kernel names through the toolkit's ``cu++filt`` (no parameter
    types); the mangled names where it is not found."""
    from repro_torch.kernels._build import nvcc
    filt = os.path.join(os.path.dirname(nvcc()), "cu++filt")
    if not names or not os.path.exists(filt):
        return names
    res = subprocess.run([filt, "-p", *names], capture_output=True,
                         text=True)
    lines = res.stdout.splitlines()
    return lines if res.returncode == 0 and len(lines) == len(names) \
        else names


def _agg_inputs(torch, c, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(n, generator=g, device="cuda")
    buf = torch.randn(c, n, generator=g, device="cuda")
    # zeros (padded lanes) and fractional λ^τ-style weights
    choices = torch.tensor([0.0, 1.0, 0.5, 0.7 ** 3], device="cuda")
    mask = choices[torch.randint(0, 4, (c,), generator=g, device="cuda")]
    mask[0] = 1.0
    return p, buf, mask


def phase_kernel_vs_plain(torch, agg, shapes, flushed=()):
    """Every shape: kernel vs plain (max abs error), then device times of
    kernel, plain version and the one-call library yardstick, back to back;
    the shapes in ``flushed`` also with L2 flushed before each call, kernel
    and yardstick alike (at N 79,510 even C 128's 41 MB sits in L2)."""
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
        bound, by = _bound(nbytes, flops, H100_F32_FLOPS)
        ctas, threads, per = agg.launch_shape(
            n, agg.vector_width(n, p, buf))
        rows[(n, c)] = dict(max_abs_err=err, ms=t_kernel, plain_ms=t_plain,
                            library_ms=t_lib, bound_ms=bound, bound_by=by,
                            grid=[ctas, threads, per])
        print(f"[kernel] stale_aggregate N={n} C={c}: err={err:.3e} "
              f"(tol {tol:.1e})  kernel={t_kernel * 1e3:.2f} us  "
              f"plain={t_plain * 1e3:.2f} us  addmv={t_lib * 1e3:.2f} us  "
              f"bound={bound * 1e3:.2f} us ({nbytes / 1e6:.2f} MB; grid "
              f"{ctas} CTAs x {threads} threads x {per} groups a thread)")
        if (n, c) in flushed:
            t_kf = device_ms(torch, lambda: agg.stale_aggregate_flat(
                p, buf, mask, beta=0.07), reps=5, trials=20, flush_l2=True)
            t_lf = device_ms(torch, lambda: torch.addmv(
                p, bt, mask, alpha=-0.07 / a), reps=5, trials=20,
                flush_l2=True)
            rows[(n, c)].update(ms_l2_flushed=t_kf,
                                library_ms_l2_flushed=t_lf)
            print(f"[kernel] stale_aggregate N={n} C={c}, L2 flushed before "
                  f"each call: kernel={t_kf * 1e3:.2f} us  addmv="
                  f"{t_lf * 1e3:.2f} us  bound={bound * 1e3:.2f} us")
    return rows


def _quickstart(mods):
    cfg = mods.ExperimentConfig(
        model=mods.get_config("mnist_dnn"),
        fl=mods.FLConfig(n_ues=20, participants_per_round=5,
                         staleness_bound=5, alpha=0.03, beta=0.07,
                         inner_batch=16, outer_batch=16, hessian_batch=16))
    data = mods.synthetic_mnist(n=4000)
    return cfg, data


def _capture_eq8(agg):
    """Wrap the flat entry point: count each (N, C) the path launches and
    keep a copy of the first launch's inputs at each; the launch count
    itself stays the wrapper's own."""
    seen, first = collections.Counter(), {}
    orig = agg.stale_aggregate_flat

    def recording(params, buffers, mask, *, beta):
        if params.is_cuda:
            shape = (int(buffers.shape[1]), int(buffers.shape[0]))
            seen[shape] += 1
            if shape not in first:
                first[shape] = (params.clone(), buffers.clone(),
                                mask.clone(), float(beta))
        return orig(params, buffers, mask, beta=beta)

    agg.stale_aggregate_flat = recording
    return seen, first, orig


def phase_main_path(torch, agg, mods, device="cuda"):
    cfg, data = _quickstart(mods)
    model = mods.build_model(cfg.model)
    engine = mods.SimulationEngine(model, cfg.fl, "perfed", device=device)
    seen, _, orig = _capture_eq8(agg)
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


def _golden_run(mods, device, **cfg_extra):
    """The first static golden's configuration, from the JAX package's
    seed-0 init; ``cfg_extra`` adds e.g. a degenerate mobility config."""
    import numpy as np
    cfg = mods.ExperimentConfig(
        model=mods.get_config("mnist_dnn"),
        fl=mods.FLConfig(n_ues=8, participants_per_round=3, staleness_bound=3,
                         alpha=0.03, beta=0.07, inner_batch=8, outer_batch=8,
                         hessian_batch=8), **cfg_extra)
    model = mods.build_model(cfg.model)
    init = dict(np.load(os.path.join(SRC, "repro_torch", "testdata",
                                     "mnist_dnn_init_seed0.npz")))
    model.init = lambda gen: mods.from_numpy_tree(init, "cpu")
    clients = mods.partition_noniid(mods.synthetic_mnist(n=600, seed=21), 8,
                                    n_labels=4, seed=0)
    return mods.run_simulation(cfg, model, clients, algorithm="perfed",
                               mode="semi", max_rounds=6, eval_every=2,
                               seed=0, device=device)


def check_golden(res, what):
    """Host numbers bitwise, losses within rtol 1e-4 of the golden."""
    check([float(t).hex() for t in res.times] == GOLDEN_TIMES,
          f"{what}: golden times differ: "
          f"{[float(t).hex() for t in res.times]}")
    check(float(res.total_time).hex() == GOLDEN_TOTAL,
          f"{what}: golden total_time")
    check(float(res.wait_fraction).hex() == GOLDEN_WAIT, f"{what}: golden wait")
    check(res.pi.tolist() == GOLDEN_PI, f"{what}: golden Π differs")
    check(res.payload_dispatches == 8 and res.payloads_computed == 18,
          f"{what}: golden dispatches {res.payload_dispatches}/"
          f"{res.payloads_computed}, want 8/18")
    rel = max(abs(a / b - 1) for a, b in zip(res.losses, GOLDEN_LOSSES))
    rel_g = max(abs(a / b - 1) for a, b in zip(res.global_losses,
                                               GOLDEN_GLOBAL))
    check(rel <= 1e-4 and rel_g <= 1e-4,
          f"{what}: golden losses off by {rel:.2e} / {rel_g:.2e} (rtol 1e-4)")
    return rel, rel_g


def phase_golden(torch, mods, device="cuda"):
    rel, rel_g = check_golden(_golden_run(mods, device), "static")
    print(f"[golden] times/Π/wait/dispatches bitwise; losses rel err "
          f"{rel:.2e}, global {rel_g:.2e} (rtol 1e-4)")


# ---------------------------------------------------------------------------
# slice 2: attention kernels, serving and scoring of yi-6b
# ---------------------------------------------------------------------------

# Kernel vs plain; the plain version runs on the same inputs in f32 and its
# output is not rounded.  f32: the largest absolute error (another
# summation order over up to L keys).  bf16: the largest error of an output
# row relative to that row, ||got - want|| / ||want|| over the head dim,
# so late rows, whose outputs average thousands of keys and are small,
# are held as tightly as early ones.  A kernel that computes in f32 and
# rounds its output once to bf16 stays under 2^-8 (half a bf16 ulp);
# the flash kernel also rounds P to bf16 for its tensor-core product.
F32_ABS_TOL = 5e-5
BF16_ROW_RTOL = {"flash": 1e-2, "decode": 4e-3}
# Scoring yi-6b in bf16, pallas against xla: the losses (the mean over
# 8,192 tokens), and the logits of each token as a row.  The residual
# stream is rounded to bf16 after every layer, so the attention's small
# differences flip roundings that 32 layers compound: the logits read
# 2.3e-2 on an NVIDIA H100 80GB HBM3 at 700 W, flash with the causal mask
# dropped 1.4.
SCORE_LOSS_RTOL = 1e-3
SCORE_LOGIT_ROW_RTOL = 5e-2


def attn_errors(got, want):
    """(max abs error, max over rows of ||got - want|| / ||want||); rows
    run along the last axis and ``want`` is f32."""
    diff = got.float() - want
    rel = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    return float(diff.abs().max()), float(rel.max())


def hold(torch, kernel, got, want, what):
    """Check a kernel's output against its f32 plain version by the rule
    of the output's dtype; returns (max abs error, max row rel error)."""
    err, rel = attn_errors(got, want)
    if got.dtype == torch.float32:
        ok, limit = err <= F32_ABS_TOL, f"abs {F32_ABS_TOL:.0e}"
    else:
        ok, limit = rel <= BF16_ROW_RTOL[kernel], \
            f"row rel {BF16_ROW_RTOL[kernel]:.0e}"
    check(math.isfinite(err) and math.isfinite(rel) and ok,
          f"{what}: max abs {err:.3e}, max row rel {rel:.3e} (limit {limit})")
    return err, rel


def control(torch, kernel, faulty, want, what):
    """A planted fault's output (the plain version with the fault, rounded
    to bf16 as a kernel's output would be) must fail the bf16 limit, or
    the check could not see it."""
    _, rel = attn_errors(faulty.to(torch.bfloat16), want)
    limit = BF16_ROW_RTOL[kernel]
    check(rel > limit, f"planted fault '{what}' reads {rel:.3e}, inside "
          f"the {kernel} limit {limit:.0e}: the check cannot see it")
    print(f"[control] {kernel}, planted fault '{what}': max row rel "
          f"{rel:.3e} > {limit:.0e}, rejected")
    return rel


def attention_keep(torch, q, k, v, keep):
    """Plain attention in f32 under an explicit [L, L] keep mask; a row
    that keeps no key gives 0, as the kernel's ``acc / max(l, 1e-30)``."""
    g = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(g, 1)) / math.sqrt(
                         q.shape[-1])
    p = torch.softmax(s.masked_fill_(~keep, -1e30), -1).mul_(keep)
    del s
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.float().repeat_interleave(g, 1))


def _flash_pairs(sl, causal, window):
    """(q, k) pairs the mask keeps: the work this input needs."""
    import numpy as np
    q = np.arange(sl)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    hi = q if causal else np.full_like(q, sl - 1)
    return int((hi - lo + 1).sum())


def _bound(nbytes, ops, peak_flops):
    b_bytes = nbytes / H100_BYTES_PER_S * 1e3
    b_ops = ops / peak_flops * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops
                                 else "operations")


def _flash_case(torch, fa, F, dtype, b, hq, hkv, sl, d, causal, window):
    g = torch.Generator(device="cuda").manual_seed(sl + d)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((b, hq, sl, d), (b, hkv, sl, d),
                             (b, hkv, sl, d)))

    def run():
        return fa.flash_attention_bhld(q, k, v, causal=causal, window=window)

    got = run()
    torch.cuda.synchronize()
    want = fa.attention_plain(q.float(), k.float(), v.float(), causal=causal,
                              window=window)
    err, rel = hold(torch, "flash", got, want, f"flash kernel vs plain "
                    f"({dtype}, L={sl}, window={window})")
    del got
    if dtype == torch.bfloat16 and 0 < window < sl:
        control(torch, "flash", fa.attention_plain(
            q.float(), k.float(), v.float(), causal=causal,
            window=window + 1), want, "window one key too wide")
    if dtype == torch.bfloat16:
        # the 64 keys of each row's own 64-key tile (the K tile at D 128
        # and 256) dropped, under the row's mask
        qp = torch.arange(sl, device="cuda")
        keep = (qp[None, :] <= qp[:, None]) if causal else \
            torch.ones(sl, sl, dtype=torch.bool, device="cuda")
        if window:
            keep &= (qp[:, None] - qp[None, :]) < window
        keep &= (qp[None, :] // 64) != (qp[:, None] // 64)
        control(torch, "flash", attention_keep(torch, q, k, v, keep), want,
                "diagonal tile skipped")
        del keep
    del want
    torch.cuda.empty_cache()
    slow = dtype == torch.float32
    t_kernel = device_ms(torch, run, reps=1 if slow else 3,
                         trials=3 if slow else 10)
    t_plain = device_ms(torch, lambda: fa.attention_plain(
        q, k, v, causal=causal, window=window), reps=1, trials=3)
    mask = None
    if 0 < window < sl:        # a window as long as L cuts nothing
        qp = torch.arange(sl, device="cuda")
        mask = (qp[None, :] <= qp[:, None]) & (qp[:, None] - qp[None, :]
                                               < window)
    t_lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True), reps=3, trials=10)
    elem = q.element_size()
    nbytes = (2 * b * hq * sl * d + 2 * b * hkv * sl * d) * elem
    ops = 4 * b * hq * d * _flash_pairs(sl, causal, window)
    bound, by = _bound(nbytes, ops, H100_BF16_FLOPS if elem == 2
                       else H100_F32_FLOPS)
    first = FIRST_DESIGN_MS.get(("flash", str(dtype)[6:],
                                 (b, hq, hkv, sl, d, causal, window)))
    row = dict(max_abs_err=err, max_row_rel_err=rel, ms=t_kernel,
               plain_ms=t_plain, library_ms=t_lib, bound_ms=bound,
               bound_by=by, kernel_route=fa.route(dtype, d),
               smem_bytes=fa.smem_bytes(dtype, d))
    print(f"[attn] flash {str(dtype)[6:]} B={b} Hq={hq} Hkv={hkv} L={sl} "
          f"D={d} causal={causal} window={window}, route "
          f"{row['kernel_route']} ({row['smem_bytes']} B shared memory a "
          f"CTA): err={err:.3e} row rel={rel:.3e}  kernel={t_kernel:.3f} ms "
          + (f"(first design, PERF.md: {first:.3f} ms)  " if first else "")
          + f"plain={t_plain:.3f} ms  "
          f"sdpa={t_lib:.3f} ms  bound={bound:.3f} ms ({by}; "
          f"{ops / t_kernel / 1e9:.1f} TFLOP/s)")
    return row


def _ring_inputs(torch, dtype, b, hq, hkv, s, d, seed):
    """A half-full ring that has wrapped: positions s .. 1.5 s - 1 sit in
    slots 0 .. s/2 - 1, the other half is empty; q_pos varies by row."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, hq, d), generator=g, device="cuda").to(dtype)
    kc, vc = (torch.randn((b, s, hkv, d), generator=g, device="cuda")
              .to(dtype) for _ in range(2))
    slot = torch.arange(s, device="cuda")
    pos = torch.where(slot < s // 2, slot + s, -1).to(torch.int32)
    pos = pos[None].repeat(b, 1)
    q_pos = (s + s // 2 - 1 - 7 * torch.arange(b, device="cuda")).to(
        torch.int32)
    return q, kc.transpose(1, 2), vc.transpose(1, 2), pos, q_pos


def _decode_bound(q, k, pos, q_pos, window=0):
    """Bytes of the slots the mask keeps (k and v), q, o, pos and q_pos."""
    b, hkv, _, d = k.shape
    keep = (pos >= 0) & (pos <= q_pos[:, None])
    if window:
        keep &= (q_pos[:, None] - pos) < window
    n_valid = int(keep.sum())
    elem = k.element_size()
    nbytes = (2 * hkv * n_valid * d * elem + 2 * q.numel() * elem
              + pos.numel() * 4 + q_pos.numel() * 4)
    ops = 4 * (q.shape[1] // hkv) * hkv * n_valid * d
    return _bound(nbytes, ops, H100_BF16_FLOPS if elem == 2
                  else H100_F32_FLOPS)


def _decode_case(torch, da, F, dtype, b, hq, hkv, s, d):
    q, k, v, pos, q_pos = _ring_inputs(torch, dtype, b, hq, hkv, s, d,
                                       seed=s)

    def run():
        return da.decode_attention_bhsd(q, k, v, pos, q_pos)

    got = run()
    torch.cuda.synchronize()
    qf, kf, vf = q.float(), k.float(), v.float()
    want = da.decode_attention_plain(qf, kf, vf, pos, q_pos)
    err, rel = hold(torch, "decode", got, want,
                    f"decode kernel vs plain ({dtype})")
    if dtype == torch.bfloat16:
        # rows b = 1..3 sit 7, 14 and 21 positions behind the newest slot
        control(torch, "decode", da.decode_attention_plain(
            qf, kf, vf, pos, torch.full_like(q_pos, 2 ** 30)), want,
            "pos <= q_pos mask dropped")
    del qf, kf, vf
    t_kernel = device_ms(torch, run)
    t_plain = device_ms(torch, lambda: da.decode_attention_plain(
        q, k, v, pos, q_pos), reps=5, trials=20)
    mask = ((pos >= 0) & (pos <= q_pos[:, None]))[:, None, None, :]
    t_lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True))
    bound, by = _decode_bound(q, k, pos, q_pos)
    chunk, chunks = da.plan(b, hkv, hq // hkv, s, torch.cuda.
                            get_device_properties(0).multi_processor_count)
    smem = da.smem_bytes(dtype, d, chunk)
    first = FIRST_DESIGN_MS[("decode", str(dtype)[6:])]
    print(f"[attn] decode {str(dtype)[6:]} B={b} Hq={hq} Hkv={hkv} S={s} "
          f"D={d} (half-full wrapped ring), {chunks} S chunks "
          f"({smem} B shared memory a CTA): err={err:.3e} "
          f"row rel={rel:.3e}  kernel={t_kernel * 1e3:.2f} us (first "
          f"design, PERF.md: {first * 1e3:.2f} us)  "
          f"plain={t_plain * 1e3:.2f} us  "
          f"sdpa={t_lib * 1e3:.2f} us  bound={bound * 1e3:.2f} us ({by})")
    return dict(max_abs_err=err, max_row_rel_err=rel, ms=t_kernel,
                plain_ms=t_plain, library_ms=t_lib, bound_ms=bound,
                bound_by=by, s_chunks=chunks, smem_bytes=smem)


FLASH_SCORE_SHAPE = (2, 32, 4, 4096, 128, True, 0)
FLASH_WINDOW_SHAPE = (2, 32, 4, 2047, 128, True, 512)
# recurrentgemma-2b's local attention on the scoring streams: MQA, D 256
FLASH_HYBRID_SHAPE = (2, 10, 1, 4096, 256, True, 2048)
# mixtral-8x22b's sliding-window GQA on the scoring streams: group 6, D 128,
# the 4,096-key window as long as each stream
FLASH_MOE_SHAPE = (2, 48, 8, 4096, 128, True, 4096)
# the rest of the zoo on the scoring streams: llama-3.2-vision-11b's self
# attention (group 4, D 128) and musicgen-large's full MHA at D 64
FLASH_VISION_SHAPE = (2, 32, 8, 4096, 128, True, 0)
FLASH_AUDIO_SHAPE = (2, 32, 32, 4096, 64, True, 0)
FLASH_ZOO_SHAPES = {"llama32_vision_11b": FLASH_VISION_SHAPE,
                    "musicgen_large": FLASH_AUDIO_SHAPE}
DECODE_SHAPE = (4, 32, 4, 4096, 128)
# the first designs' times at these shapes, printed for comparison only
# (constants, not measured here; PERF.md §6, the kernel table: the first
# design's chip_smoke.py runs on an NVIDIA H100 80GB HBM3 at 700.00 W)
FIRST_DESIGN_MS = {
    ("flash", "bfloat16", FLASH_SCORE_SHAPE): 4.277,
    ("flash", "bfloat16", FLASH_WINDOW_SHAPE): 0.535,
    ("flash", "bfloat16", FLASH_HYBRID_SHAPE): 1.698,      # its mma.sync kernel
    ("flash", "float32", FLASH_SCORE_SHAPE): 23.415,
    ("flash", "float32", FLASH_WINDOW_SHAPE): 2.911,
    ("decode", "bfloat16"): 0.12835, ("decode", "float32"): 0.15835}


def phase_attention_vs_plain(torch, fa, da):
    import torch.nn.functional as F
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in (FLASH_SCORE_SHAPE, FLASH_WINDOW_SHAPE,
                      FLASH_HYBRID_SHAPE, FLASH_MOE_SHAPE,
                      *FLASH_ZOO_SHAPES.values()):
            rows[("flash", dtype, shape)] = _flash_case(torch, fa, F, dtype,
                                                        *shape)
            torch.cuda.empty_cache()
        rows[("decode", dtype)] = _decode_case(torch, da, F, dtype,
                                               *DECODE_SHAPE)
    return rows


def phase_serve(torch, fa, da, mods, argv, device="cuda"):
    """Full yi-6b through the serve entry point; then the decode kernel
    against the model's own decode attention on layer 0 of the live cache
    after the last step, with the same q."""
    L = mods.layers
    fa.LAUNCHES = da.LAUNCHES = 0
    res = mods.serve.run(argv + ["--device", device])
    launches = {"flash": fa.LAUNCHES, "decode": da.LAUNCHES}
    cfg, params, cache, toks = res.cfg, res.params, res.cache, res.tokens
    b, n_gen = toks.shape
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "served tokens out of the vocabulary")
    print(f"[serve] {cfg.name}: prefill {res.prefill_ms:.1f} ms, decode "
          f"{res.decode_ms:.2f} ms/token, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches "
          f"on the serve path {launches}")

    # layer 0's q for the token the last step fed, at its position
    qp = res.prompts.shape[1] + n_gen - 2
    with torch.inference_mode():
        lp0 = mods.tree_map(lambda a: a[0], params["layers"])
        x = L.embed(params["embedding"], toks[:, n_gen - 2:n_gen - 1])
        h = L.rmsnorm(lp0["norm_attn"], x)
        hd = cfg.resolved_head_dim
        q = (h @ lp0["attn"]["w_q"]).reshape(b, 1, cfg.num_heads, hd)
        q = L.apply_rope(q, torch.tensor([qp], device=device),
                         cfg.rope_theta)
        ck, cv, cpos = cache["k"][0], cache["v"][0], cache["pos"][0]
        q_pos = torch.full((b,), qp, dtype=torch.int32, device=device)
        check(int(cpos.max()) == qp, f"cache holds {int(cpos.max())}, "
              f"the last step wrote {qp}")

        def model_attn():
            return L.sdpa(q, ck, cv, q_pos=q_pos[:, None], k_pos=cpos,
                          causal=True, window=cfg.sliding_window,
                          cast_f32=cfg.attn_cast_f32)[:, 0]

        def kernel():
            return da.decode_attention_bhsd(
                q[:, 0], ck.transpose(1, 2), cv.transpose(1, 2), cpos,
                q_pos, window=cfg.sliding_window)

        # the model's attention on the same values in f32, not rounded
        want = L.sdpa(q.float(), ck.float(), cv.float(), q_pos=q_pos[:, None],
                      k_pos=cpos, causal=True, window=cfg.sliding_window,
                      cast_f32=cfg.attn_cast_f32)[:, 0]
        got = kernel()
        torch.cuda.synchronize()
        err, rel = hold(torch, "decode", got, want, "decode kernel vs the "
                        "model's decode attention on the live cache")
        t_kernel = device_ms(torch, kernel)
        t_model = device_ms(torch, model_attn, reps=5, trials=20)
        bound, _ = _decode_bound(q[:, 0], ck.transpose(1, 2), cpos, q_pos)
    n_valid = int((cpos >= 0).sum()) // b
    hkv, hq = ck.shape[2], q.shape[2]
    _, chunks = da.plan(b, hkv, hq // hkv, ck.shape[1], torch.cuda.
                        get_device_properties(0).multi_processor_count)
    print(f"[serve] decode kernel vs the model's sdpa on layer 0 of the "
          f"live cache ({n_valid} of {cpos.shape[1]} slots filled, bf16; "
          f"{chunks} S chunks): "
          f"err={err:.3e} row rel={rel:.3e}; kernel {t_kernel * 1e3:.2f} us, "
          f"model sdpa {t_model * 1e3:.2f} us, bound {bound * 1e3:.2f} us")
    decode_profile(torch, mods, res)
    return res.prefill_ms, res.decode_ms, launches


def _union_us(spans):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def decode_profile(torch, mods, res, steps=8):
    """A few more decode steps on the live cache under ``torch.profiler``:
    the card's busy and idle shares of the wall clock, and the kernels
    launched per token."""
    import tempfile
    model = mods.build_model(res.cfg)
    cache, toks = res.cache, res.tokens[:, -1:]
    pos = res.prompts.shape[1] + res.tokens.shape[1] - 1
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with torch.inference_mode():
        logits, cache = model.decode_step(res.params, cache, toks, pos)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        try:
            prof.start()
        except RuntimeError as e:      # a card without profiler support
            print(f"[serve] decode profile not measured: the profiler did "
                  f"not start ({e})")
            return
        try:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, cache = model.decode_step(res.params, cache, toks,
                                                  pos + 1 + i)
                toks = torch.argmax(logits, dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            prof.stop()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "decode_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                       "gpu_memset")]
    if not dev:
        print("[serve] decode profile: the profiler recorded no device "
              "activity; busy share not measured")
        return
    busy = _union_us(dev)
    by_name = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            by_name[e.get("name", "?")[:48]] += e["dur"]
    n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
    # the serve loop's own ms/token, measured without the profiler
    plain_us = res.decode_ms * 1e3
    print(f"[serve] decode profile, {steps} steps under torch.profiler: "
          f"{wall_us / steps / 1e3:.2f} ms/token wall, card busy "
          f"{busy / steps / 1e3:.2f} ms/token ({busy / wall_us:.1%}; "
          f"{busy / steps / plain_us:.1%} of the unprofiled "
          f"{res.decode_ms:.2f} ms/token); {n_kernels / steps:.0f} kernels "
          f"per token; most device time: " + ", ".join(
              f"{name} {us / steps / 1e3:.2f} ms"
              for name, us in by_name.most_common(5)))


@contextlib.contextmanager
def _flash_through(fa, fn):
    """Within the block, the model's flash calls go through ``fn(flash, q,
    k, v, causal, window)``, ``flash`` being the wrapper it replaced."""
    flash = fa.flash_attention
    fa.flash_attention = (lambda q, k, v, *, causal=True, window=0:
                          fn(flash, q, k, v, causal, window))
    try:
        yield
    finally:
        fa.flash_attention = flash


def _recording(fa, calls):
    """Each call's inputs and output, to hold it against the plain version
    on its own inputs afterwards."""
    def rec(flash, q, k, v, causal, window):
        out = flash(q, k, v, causal=causal, window=window)
        calls.append((q, k, v, causal, window, out))
        return out
    return _flash_through(fa, rec)


def _no_causal(fa):
    """Planted fault: flash with the causal mask dropped."""
    return _flash_through(fa, lambda flash, q, k, v, causal, window: flash(
        q, k, v, causal=False, window=window))


def _score_batch(torch, mods, vocab, seq, device, codebooks=0):
    """The two users' token streams of the yi-6b phase (the seeds of
    ``examples/serve_personalized.py``); with ``codebooks`` K > 0 (the
    audio family) each user's stream is [seq, K], codebook k drawn with
    the user's seed + 100 k (codebook 0 is the text models' stream)."""
    import numpy as np

    def stream(s):
        if not codebooks:
            return mods.synthetic_lm_corpus(seq + 1, vocab=vocab, seed=s)
        return np.stack([mods.synthetic_lm_corpus(seq + 1, vocab=vocab,
                                                  seed=s + 100 * k)
                         for k in range(codebooks)], axis=-1)

    toks = torch.from_numpy(np.stack([stream(s) for s in (10, 11)])) \
        .to(device)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _timed_loss(torch, model, params, batch, device):
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = model.loss(params, batch)
    if device == "cuda":
        torch.cuda.synchronize()
    return float(loss), (time.perf_counter() - t0) * 1e3


def phase_score(torch, fa, da, mods, *, reduce=False, device="cuda"):
    """The flash kernel's path: ``loss`` of yi-6b under
    ``attn_impl="pallas"`` on two users' 4,096-token streams (the seeds of
    ``examples/serve_personalized.py``), against ``attn_impl="xla"``."""
    cfg = mods.get_config("yi_6b")
    seq = 4096
    if reduce:
        cfg, seq = cfg.reduced(), 96
    model_p = mods.build_model(dataclasses.replace(cfg, attn_impl="pallas"))
    model_x = mods.build_model(dataclasses.replace(cfg, attn_impl="xla"))
    params = model_p.init(torch.Generator(device=device).manual_seed(0))
    batch = _score_batch(torch, mods, cfg.vocab_size, seq, device)
    # each flash call on the path, kept to hold it against the plain
    # version on its own inputs afterwards
    calls = []
    with torch.inference_mode():
        with _recording(fa, calls):
            fa.LAUNCHES = da.LAUNCHES = 0
            loss_p, t_p = _timed_loss(torch, model_p, params, batch, device)
            launches = {"flash": fa.LAUNCHES, "decode": da.LAUNCHES}
        loss_x, t_x = _timed_loss(torch, model_x, params, batch, device)
        layer_rel = _hold_path_calls(torch, fa, calls)
        del calls
        logits_x = model_x.predict(params, batch)
        logit_rel = _logit_row_rel(model_p.predict(params, batch), logits_x)
        # planted fault: flash with the causal mask dropped on every layer
        with _no_causal(fa):
            logits_f = model_p.predict(params, batch)
        fault_rel = _logit_row_rel(logits_f, logits_x)
        loss_f = float(mods.layers.cross_entropy(logits_f, batch["targets"]))
        del logits_f, logits_x
    rel = abs(loss_p - loss_x) / abs(loss_x)
    rel_f = abs(loss_f - loss_x) / abs(loss_x)
    print(f"[score] {cfg.name} loss on 2 x {seq} tokens: pallas "
          f"{loss_p:.6f} ({t_p:.1f} ms, first call), xla "
          f"{loss_x:.6f} ({t_x:.1f} ms); rel diff {rel:.2e} (rtol "
          f"{SCORE_LOSS_RTOL:.0e}); launches {launches}")
    print(f"[score] each flash call on the path vs plain: max row rel "
          f"{layer_rel:.3e} (limit {BF16_ROW_RTOL['flash']:.0e}); logits, "
          f"pallas vs xla: max token row rel {logit_rel:.3e} (limit "
          f"{SCORE_LOGIT_ROW_RTOL:.0e})")
    print(f"[control] score, planted fault 'causal mask dropped': logits "
          f"max token row rel {fault_rel:.3e}, loss {loss_f:.6f} (rel diff "
          f"{rel_f:.2e})")
    check(math.isfinite(loss_p) and rel <= SCORE_LOSS_RTOL,
          f"pallas loss {loss_p} vs xla {loss_x}: rel {rel:.2e}")
    check(math.isfinite(logit_rel) and logit_rel <= SCORE_LOGIT_ROW_RTOL,
          f"pallas logits vs xla: max token row rel {logit_rel:.3e}")
    check(fault_rel > SCORE_LOGIT_ROW_RTOL,
          f"the planted fault passes the logits check ({fault_rel:.3e}): "
          f"it cannot see it")
    if device == "cuda":
        check(launches["flash"] == cfg.num_layers,
              f"the scoring forward launched flash {launches['flash']} "
              f"times, not once per layer ({cfg.num_layers})")
        print(f"[score] peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches


def _hold_path_calls(torch, fa, calls):
    """Each recorded flash call against the plain version in f32 on its
    own inputs (model layout [B, L, H, D]), one batch row at a time; the
    largest row rel error."""
    worst = 0.0
    for i, (q, k, v, causal, window, out) in enumerate(calls):
        for r in range(q.shape[0]):
            want = fa.attention_plain(*(t[r:r + 1].float().transpose(1, 2)
                                        for t in (q, k, v)),
                                      causal=causal, window=window)
            _, rel = hold(torch, "flash", out[r:r + 1].transpose(1, 2), want,
                          f"flash call {i} on the scoring path vs plain")
            worst = max(worst, rel)
            del want
    check(len(calls) > 0, "no flash call on the scoring path")
    return worst


def _logit_row_rel(got, want):
    """Max over tokens of ||got - want|| / ||want|| over the vocabulary,
    one batch row at a time."""
    return max(attn_errors(g, w.float())[1] for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# slice 3: Mamba-2 (SSD chunk kernel) scored, served and trained with the
# semi-synchronous step and a server Adam (fused Adam kernel)
# ---------------------------------------------------------------------------

# SSD chunk, kernel vs plain, both f32 on the same inputs: each of the four
# outputs held relative to its own scale, max |got - want| / max |want|.
# The kernel sums cum = cumsum(dt * a) serially, torch.cumsum does not, and
# exp(cum_i - cum_j) turns cum's rounding (|cum| reaches ~4e3 at a = -16)
# into relative error.
SSD_RTOL = 5e-4
SSD_SCORE_SHAPE = (2, 16, 256, 32, 64, 128)    # B, NC, Q, H, P, N: 2 x 4,096
SSD_PREFILL_SHAPE = (4, 8, 256, 32, 64, 128)   # serve: 4 x 2,048
# Scoring mamba2-370m, pallas against xla.  In bf16: the loss (mean over
# 8,192 tokens; it read 2.9e-4 on an NVIDIA H100 80GB HBM3 at 700 W) and
# each layer's output on the same input, per token row (4.0e-3: one bf16
# rounding of the output is up to 2^-8 of it).  Every token's logits end to
# end on an f32 copy of the params (6.2e-3, where a 1e-6 perturbation of
# each scan's output reads 3.1e-3 and the diagonal dropped 1.47); in bf16 at
# this random init that perturbation alone reads 0.68, the kernel 0.78.
MAMBA_LOSS_RTOL = 1e-3
MAMBA_LAYER_ROW_RTOL = 1e-2
MAMBA_F32_LOGIT_ROW_RTOL = 2e-2
ADAM_LEAF = (48, 1024, 4384)                   # mamba2-370m's in_proj
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8


def scaled_err(got, want):
    """(max |got - want|, that over max |want|); NaN or inf when either
    holds a value that is not finite."""
    err = (got.float() - want.float()).abs().max()
    return float(err), float(err / want.float().abs().max().clamp_min(
        1e-30))


def hold_ssd(torch, got, want, what):
    """The kernel's four outputs against the plain version's; returns (max
    abs error of y, max scaled error over the outputs)."""
    worst = 0.0
    for name, g, w in zip(("y", "states", "chunk_decay", "in_decay"), got,
                          want):
        check(g.shape == w.shape, f"{what}: {name} {tuple(g.shape)} vs "
              f"{tuple(w.shape)}")
        err, rel = scaled_err(g, w)
        check(math.isfinite(rel) and rel <= SSD_RTOL,
              f"{what}: {name} max abs {err:.3e}, scaled {rel:.3e} (limit "
              f"{SSD_RTOL:.0e})")
        worst = max(worst, rel)
    return scaled_err(got[0], want[0])[0], worst


def ssd_unmasked(torch, x, dt, a, b, c):
    """y_intra of the plain version with the j <= i mask dropped: the
    planted fault (exp of cum_i - cum_j > 0 overflows, so it is not even
    finite)."""
    cum = torch.cumsum((dt * a).movedim(-1, -2), dim=-1)
    lmat = torch.exp(cum[..., :, None] - cum[..., None, :])
    scores = torch.einsum("bzin,bzjn->bzij", c, b)
    return torch.einsum("bzhij,bzjhp->bzihp", scores[:, :, None] * lmat,
                        x * dt[..., None])


def _ssd_inputs(torch, shape, seed):
    """Inputs shaped like the model's: dt = softplus(N(0, 1)), a = -exp(A_log)
    = -linspace(1, 16, H) as the model initialises it."""
    b, nc, q, h, p, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device="cuda")

    x = randn(b, nc, q, h, p)
    dt = torch.nn.functional.softplus(randn(b, nc, q, h))
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    return x, dt, a, randn(b, nc, q, n), randn(b, nc, q, n)


def ssd_work(shape):
    """(bytes, operations over the (i, j <= i) pairs, operations over all
    (i, j) pairs as the TPU kernel computes them, and of the first the
    products' share) for one ``ssd_chunk``."""
    b, nc, q, h, p, n = shape
    bz = b * nc
    nbytes = 4 * (2 * bz * q * h * p + bz * q * h + h + 2 * bz * q * n
                  + bz * h * p * n + bz * h + bz * h * q)
    states = 2 * h * p * n * q

    def products(pairs):
        # scores c_i.b_j, y over P, the state
        return 2 * n * pairs + 2 * h * p * pairs + states

    def per_chunk(pairs):
        # the products and the weight S * exp * dt per head
        return products(pairs) + 3 * h * pairs

    pairs = q * (q + 1) // 2
    return (nbytes, bz * per_chunk(pairs), bz * per_chunk(q * q),
            bz * products(pairs))


def ssd_bound(nbytes, ops, mma_ops):
    """The SSD chunk's least time (ms) and what bounds it.  The products
    run in 3xTF32, three TF32 products on the tensor cores for each f32
    one, the weights on the CUDA cores in f32; the two units run side by
    side, so the slower of them bounds the operations."""
    b_bytes = nbytes / H100_BYTES_PER_S * 1e3
    b_ops = max(3 * mma_ops / H100_TF32_FLOPS,
                (ops - mma_ops) / H100_F32_FLOPS) * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops
                                 else "operations")


def phase_ssd_vs_plain(torch, ssd):
    rows = {}
    for shape in (SSD_SCORE_SHAPE, SSD_PREFILL_SHAPE):
        args = _ssd_inputs(torch, shape, seed=sum(shape))
        got = ssd.ssd_chunk(*args)
        torch.cuda.synchronize()
        want = ssd.ssd_chunk_plain(*args)
        err, rel = hold_ssd(torch, got, want, f"SSD kernel vs plain {shape}")
        # two planted faults on y: the mask dropped overflows to NaN; the
        # diagonal dropped stays finite, so it tests the limit itself
        for fname, fault_fn in (
                ("j <= i mask dropped", ssd_unmasked),
                ("diagonal j = i dropped",
                 lambda torch, *xs: ssd_diagonal_dropped(torch, ssd, *xs))):
            _, fault = scaled_err(fault_fn(torch, *args), want[0])
            check(not fault <= SSD_RTOL, f"planted fault '{fname}' reads "
                  f"{fault:.3e}, inside {SSD_RTOL:.0e}")
            print(f"[control] ssd, planted fault '{fname}': y scaled error "
                  f"{fault:.3e}, rejected")
        del got, want
        torch.cuda.empty_cache()
        t_kernel = device_ms(torch, lambda: ssd.ssd_chunk(*args), reps=3,
                             trials=10)
        t_plain = device_ms(torch, lambda: ssd.ssd_chunk_plain(*args),
                            reps=1, trials=3)
        nbytes, ops, ops_all, mma_ops = ssd_work(shape)
        bound, by = ssd_bound(nbytes, ops, mma_ops)
        _, _, q, _, p, n = shape
        smem = ssd.smem_bytes(q, p, n)
        rows[shape] = dict(max_abs_err=err, max_scaled_err=rel, ms=t_kernel,
                           plain_ms=t_plain, library_ms=None, bound_ms=bound,
                           bound_by=by, smem_bytes=smem)
        print(f"[ssd] chunk B,NC,Q,H,P,N={shape} f32: y err={err:.3e}, "
              f"scaled (all outputs) {rel:.3e}  kernel={t_kernel:.3f} ms  "
              f"plain={t_plain:.3f} ms  library: none  bound={bound:.3f} ms "
              f"({by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP over "
              f"j <= i, {mma_ops / 1e9:.2f} of them products, each three "
              f"TF32 products in 3xTF32; {ops_all / 1e9:.2f} over all "
              f"pairs; {ops / t_kernel / 1e9:.1f} TFLOP/s over j <= i, "
              f"{ops_all / t_kernel / 1e9:.1f} over all pairs, "
              f"{3 * mma_ops / t_kernel / 1e9:.1f} of TF32 issued; {smem} B "
              f"shared memory a CTA)")
        del args
        torch.cuda.empty_cache()
    return rows


def bf16_ulp(torch, x):
    """One bf16 ulp at each element of ``x`` (f32)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def adam_close(torch, got, want, p_old=None):
    """(p, m, v) against (p, m, v): bf16 p within one bf16 ulp, f32 p within
    1e-6 relative, m and v within 1e-6 relative.  Against math that rounds
    in another order (``p_old`` given), p may also differ by 2^-20 of the
    old |p|: p - lr * u cancels where lr * u ~ p, and the two orders' f32
    roundings of u, a few ulps of |p|, then stand alone.  Returns (ok, max
    abs error of p)."""
    gp, gm, gv = got
    wp, wm, wv = want
    dp = (gp.float() - wp.float()).abs()
    extra = 0.0 if p_old is None else 2.0 ** -20 * p_old.float().abs()
    if gp.dtype == torch.bfloat16:
        ok = bool((dp <= bf16_ulp(torch, wp.float()) + extra).all())
    else:
        ok = bool((dp <= 1e-6 * wp.abs() + 1e-30 + extra).all())
    for g, w in ((gm, wm), (gv, wv)):
        ok = ok and bool(((g - w).abs() <= 1e-6 * w.abs() + 1e-30).all())
    return ok, float(dp.max())


def _adam_leaf(torch, n, p_dtype, g_dtype, seed):
    """A leaf like in_proj's (N(0, 1/32) weights), its moments after a few
    steps and a small gradient."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(scale):
        return torch.randn(n, generator=g, device="cuda") * scale

    return (randn(1 / 32).to(p_dtype), randn(1e-4), randn(1e-4).square(),
            randn(1e-3).to(g_dtype))


ADAM_CASES = (
    # name, N, p dtype, g dtype
    ("in_proj, g f32 (the path's)", math.prod(ADAM_LEAF), "bfloat16",
     "float32"),
    ("in_proj, g bf16", math.prod(ADAM_LEAF), "bfloat16", "bfloat16"),
    ("A_log (f32 leaf)", 48 * 32, "float32", "float32"),
    ("ragged f32", 1_000_003, "float32", "float32"),
)


def phase_adam_vs_plain(torch, adam):
    rows = {}
    for name, n, p_dt, g_dt in ADAM_CASES:
        p, m, v, grad = _adam_leaf(torch, n, getattr(torch, p_dt),
                                   getattr(torch, g_dt), seed=n % 997)
        lr = torch.tensor(1e-3, device="cuda")
        t = torch.tensor(1, dtype=torch.int32, device="cuda")

        scal = adam.adam_scalars(lr, t, ADAM_B1, ADAM_B2, "cuda")

        def run():
            # the launch alone: [lr, bc1, bc2] is made once a step for the
            # whole tree (fused_adam_tree), so it is not timed here
            return adam._update(p, m, v, grad, scal, b1=ADAM_B1, b2=ADAM_B2,
                                eps=ADAM_EPS)

        got = adam.fused_adam_flat(p, m, v, grad, lr=lr, t=t, b1=ADAM_B1,
                                   b2=ADAM_B2, eps=ADAM_EPS)
        torch.cuda.synchronize()
        want = adam.fused_adam_plain(p, m, v, grad, scal, b1=ADAM_B1,
                                     b2=ADAM_B2, eps=ADAM_EPS)
        ok, err = adam_close(torch, got, want)
        check(ok and got[0].dtype == p.dtype, f"fused Adam vs plain ({name}):"
              f" max abs p error {err:.3e}, outside the limits")
        no_bc = torch.stack([scal[0], torch.ones_like(scal[1]),
                             torch.ones_like(scal[2])])
        fault = adam.fused_adam_plain(p, m, v, grad, no_bc, b1=ADAM_B1,
                                      b2=ADAM_B2, eps=ADAM_EPS)
        bad, fault_err = adam_close(torch, fault, want)
        check(not bad, f"planted fault 'bias corrections dropped' passes the "
              f"Adam check ({name})")
        print(f"[control] adam ({name}), planted fault 'bias corrections "
              f"dropped': max abs p error {fault_err:.3e}, rejected")
        del got, want, fault
        pe, ge = p.element_size(), grad.element_size()
        nbytes = n * (2 * pe + ge + 16)
        # a working set that fits in L2 is timed from HBM all the same
        flush = nbytes < L2_BYTES
        t_kernel = device_ms(torch, run, reps=3, trials=10, flush_l2=flush)
        t_plain = device_ms(torch, lambda: adam.fused_adam_plain(
            p, m, v, grad, scal, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS),
            reps=1, trials=5, flush_l2=flush)
        # yardstick: one torch.optim.Adam(fused=True) step on an f32 copy
        # (PyTorch keeps m and v in the parameter's type, so at bf16 it is
        # not the same function)
        p32 = torch.nn.Parameter(p.float())
        p32.grad = grad.float()
        yard = torch.optim.Adam([p32], lr=1e-3, betas=(ADAM_B1, ADAM_B2),
                                eps=ADAM_EPS, fused=True)
        yard.step()
        t_lib = device_ms(torch, yard.step, reps=3, trials=10, flush_l2=flush)
        del yard, p32
        bound, by = _bound(nbytes, 14 * n, H100_F32_FLOPS)
        rows[name] = dict(max_abs_err=err, ms=t_kernel, plain_ms=t_plain,
                          library_ms=t_lib, bound_ms=bound, bound_by=by,
                          n=n, p_dtype=p_dt, g_dtype=g_dt, l2_flushed=flush)
        print(f"[adam] {name}: N={n} p {p_dt} g {g_dt}: max abs p err "
              f"{err:.3e}  kernel={t_kernel:.3f} ms  plain={t_plain:.3f} ms  "
              f"torch.optim.Adam(fused=True) f32={t_lib:.3f} ms  "
              f"bound={bound:.3f} ms ({by}; {nbytes / 1e9:.3f} GB; "
              f"{nbytes / t_kernel / 1e6:.0f} GB/s"
              f"{'; L2 flushed before each call' if flush else ''})")
        del p, m, v, grad
        torch.cuda.empty_cache()
    return rows


def phase_ops(torch, fa, ssd, adam, mods):
    """One call each of ``ops.flash_attention`` (model layout, yi-6b's
    scoring shape in bf16), ``ops.ssd_chunked`` (mamba2's scoring shape,
    2 x 4,096 tokens in chunks of 256) and ``ops.fused_adam_tree`` (an
    in_proj-like bf16 leaf and an f32 one, g in bf16, which the wrapper
    casts to f32), each held against its oracle in ``ref`` at the limits
    of its kernel's phase: flash row rel 1e-2 against the f32 oracle left
    unrounded; the SSD scan against ``ref.ssd_chunk_ref``'s naive
    recurrence over the whole sequence (one chunk of 4,096 from a zero
    state: y and the final state), scaled 5e-4; Adam p within a bf16 ulp,
    m and v 1e-6 relative."""
    ops, ref = mods.ops, mods.ref
    g = torch.Generator(device="cuda").manual_seed(21)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    b, hq, hkv, sl, d, causal, window = FLASH_SCORE_SHAPE
    q = randn(b, sl, hq, d).bfloat16()
    k, v = (randn(b, sl, hkv, d).bfloat16() for _ in range(2))
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    check(fa.LAUNCHES - before == 1, "ops.flash_attention did not launch "
          "the flash kernel once")
    want = ref.attention_ref(*(t.float().transpose(1, 2) for t in (q, k, v)),
                             causal=causal, window=window).transpose(1, 2)
    _, flash_rel = hold(torch, "flash", got, want,
                        "ops.flash_attention vs ref.attention_ref")
    del q, k, v, got, want
    torch.cuda.empty_cache()

    bs, nc, qc, h, p, n = SSD_SCORE_SHAPE
    x, dt, a, bb, cc = (t.reshape((bs, nc * qc) + t.shape[3:])
                        if t.ndim > 1 else t
                        for t in _ssd_inputs(torch, SSD_SCORE_SHAPE, 22))
    before = ssd.LAUNCHES
    y, state = ops.ssd_chunked(x, dt, a, bb, cc, qc)
    torch.cuda.synchronize()
    check(ssd.LAUNCHES - before == 1, "ops.ssd_chunked did not launch the "
          "SSD kernel once")
    y_ref, s_ref, _ = ref.ssd_chunk_ref(x, dt, a, bb, cc)
    ssd_rel = 0.0
    for name, got_t, want_t in (("y", y, y_ref), ("final state", state,
                                                   s_ref)):
        err, rel = scaled_err(got_t, want_t)
        check(math.isfinite(rel) and rel <= SSD_RTOL, f"ops.ssd_chunked vs "
              f"ref.ssd_chunk_ref: {name} max abs {err:.3e}, scaled "
              f"{rel:.3e} (limit {SSD_RTOL:.0e})")
        ssd_rel = max(ssd_rel, rel)
    del x, dt, a, bb, cc, y, state, y_ref, s_ref

    leaves = {"in_proj": _adam_leaf(torch, math.prod(ADAM_LEAF),
                                    torch.bfloat16, torch.bfloat16, 23),
              "A_log": _adam_leaf(torch, 48 * 32, torch.float32,
                                  torch.bfloat16, 24)}
    tree = [{k: leaf[i] for k, leaf in leaves.items()} for i in range(4)]
    lr, t = 1e-3, 1
    before = adam.LAUNCHES
    new_p, new_m, new_v = ops.fused_adam_tree(*tree, lr=lr, t=t, b1=ADAM_B1,
                                              b2=ADAM_B2, eps=ADAM_EPS)
    torch.cuda.synchronize()
    check(adam.LAUNCHES - before == len(leaves), "ops.fused_adam_tree did "
          "not launch the Adam kernel once a leaf")
    adam_err = 0.0
    for name, (p0, m0, v0, g0) in leaves.items():
        wp, wm, wv = ref.adam_ref(p0.float(), m0, v0, g0.float(), lr=lr,
                                  b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS, t=t)
        ok, err = adam_close(torch, (new_p[name], new_m[name], new_v[name]),
                             (wp.to(p0.dtype), wm, wv), p_old=p0)
        check(ok, f"ops.fused_adam_tree vs ref.adam_ref, {name}: max abs p "
              f"error {err:.3e}, outside the limits")
        adam_err = max(adam_err, err)
    print(f"[ops] ops.flash_attention {FLASH_SCORE_SHAPE} bf16 vs "
          f"ref.attention_ref: max row rel {flash_rel:.3e}; ops.ssd_chunked "
          f"{SSD_SCORE_SHAPE} vs ref.ssd_chunk_ref over the whole sequence: "
          f"scaled {ssd_rel:.3e}; ops.fused_adam_tree ({len(leaves)} leaves, "
          f"g bf16 cast to f32) vs ref.adam_ref: max abs p error "
          f"{adam_err:.3e}")
    return dict(flash_row_rel=flash_rel, ssd_scaled=ssd_rel,
                adam_p_err=adam_err)


def ssd_diagonal_dropped(torch, ssd, x, dt, a, b, c):
    """y_intra of the plain version without its j = i terms (a planted
    fault that stays finite)."""
    y = ssd.ssd_chunk_plain(x, dt, a, b, c)[0]
    return y - (c * b).sum(-1)[..., None, None] * dt[..., None] * x


def _forward_with(torch, mods, model, params, tokens, scan):
    """Logits of ``model`` with every layer's scan replaced by ``scan``."""
    L = mods.layers
    x = L.embed(params["embedding"], tokens)
    for i in range(model.cfg.num_layers):
        x = model.layer(mods.tree_map(lambda t: t[i], params["layers"]), x,
                        scan)[0]
    x = L.rmsnorm(params["final_norm"], x)
    return L.unembed(params["embedding"], x)


def _row_rel(got, want):
    """Per-row ||got - want|| / ||want|| over the last axis (f32)."""
    return (got.float() - want.float()).norm(dim=-1) / want.float().norm(
        dim=-1).clamp_min(1e-30)


def phase_score_mamba(torch, ssd, mods, *, reduce=False, device="cuda"):
    """The SSD kernel's path: ``loss`` of mamba2-370m under
    ``attn_impl="pallas"`` on two 4,096-token streams, against
    ``attn_impl="xla"`` on the same params.

    In bf16 at this random init the stack is chaotic: a 1e-6 relative
    perturbation of one scan's output flips bf16 roundings that 48 layers
    amplify into ~0.7 of a token's logits, so in bf16 the loss is held
    end to end and every layer's output on the same input (teacher
    forcing); every token's logits are held end to end on an f32 copy of
    the params, where the same perturbation moves them by ~3e-3."""
    cfg = mods.get_config("mamba2_370m")
    seq = 4096
    if reduce:
        cfg, seq = cfg.reduced(), 96
    model_p = mods.build_model(dataclasses.replace(cfg, attn_impl="pallas"))
    model_x = mods.build_model(dataclasses.replace(cfg, attn_impl="xla"))
    params = model_p.init(torch.Generator(device=device).manual_seed(0))
    batch = _score_batch(torch, mods, cfg.vocab_size, seq, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    chunk = ssd.ssd_chunk
    held = []

    def recording(x, dt, a, b, c):
        # each call on the path, held against the plain version on its own
        # inputs at once (the plain version launches nothing)
        out = chunk(x, dt, a, b, c)
        held.append(hold_ssd(torch, out, ssd.ssd_chunk_plain(x, dt, a, b, c),
                             f"SSD call {len(held)} on the scoring path")[1])
        return out

    def with_y(fault):
        return lambda x, dt, a, b, c: (fault(x, dt, a, b, c),) + chunk(
            x, dt, a, b, c)[1:]

    faults = {
        "j <= i mask dropped": with_y(
            lambda *args: ssd_unmasked(torch, *args)),
        "diagonal j = i dropped": with_y(
            lambda *args: ssd_diagonal_dropped(torch, ssd, *args)),
    }

    with torch.inference_mode():
        ssd.ssd_chunk = recording
        try:
            ssd.LAUNCHES = 0
            loss_p, _ = model_p.loss(params, batch)
            launches = ssd.LAUNCHES
        finally:
            ssd.ssd_chunk = chunk
        sync()
        t0 = time.perf_counter()
        loss_p2, _ = model_p.loss(params, batch)
        sync()
        t_p = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss_x, _ = model_x.loss(params, batch)
        sync()
        t_x = time.perf_counter() - t0

        # bf16, teacher forced: each layer on the xla path's input
        layer_rel, fault_layer = 0.0, {k: 0.0 for k in faults}
        x = mods.layers.embed(params["embedding"], batch["tokens"])
        for i in range(cfg.num_layers):
            lp = mods.tree_map(lambda t: t[i], params["layers"])
            want = model_x.layer(lp, x, mods.ssm.ssd_chunked)[0]
            got = model_p.layer(lp, x, ssd.ssd_chunked)[0]
            layer_rel = max(layer_rel, float(_row_rel(got, want).max()))
            for name, fn in faults.items():
                ssd.ssd_chunk = fn
                try:
                    bad = model_p.layer(lp, x, ssd.ssd_chunked)[0]
                finally:
                    ssd.ssd_chunk = chunk
                r = float(_row_rel(bad, want).max())
                fault_layer[name] = r if math.isnan(r) else max(
                    fault_layer[name], r)
            x = want
        del got, want, bad, x

        # the reason for the two checks below, measured: each scan's output
        # times (1 + 1e-6 N(0, 1)) on the xla path, end to end
        gen = torch.Generator(device=device).manual_seed(1)

        def perturbed(x, dt, a, b, c, q):
            y, st = mods.ssm.ssd_chunked(x, dt, a, b, c, q)
            return y * (1 + 1e-6 * torch.randn(y.shape, generator=gen,
                                               device=y.device)), st

        logits_x = model_x.predict(params, batch)
        bf16_rel = float(_row_rel(model_p.predict(params, batch),
                                  logits_x).max())
        bf16_noise = float(_row_rel(_forward_with(
            torch, mods, model_x, params, batch["tokens"], perturbed),
            logits_x).max())
        del logits_x

        # f32 copy of the params, end to end: every token's logits
        p32 = mods.tree_map(lambda t: t.float(), params)
        m32 = mods.build_model(dataclasses.replace(cfg, dtype="float32"))
        logits_x = _forward_with(torch, mods, m32, p32, batch["tokens"],
                                 mods.ssm.ssd_chunked)
        logit_rel = float(_row_rel(_forward_with(
            torch, mods, m32, p32, batch["tokens"], ssd.ssd_chunked),
            logits_x).max())
        f32_noise = float(_row_rel(_forward_with(
            torch, mods, m32, p32, batch["tokens"], perturbed),
            logits_x).max())
        fault_logit = {}
        for name, fn in faults.items():
            ssd.ssd_chunk = fn
            try:
                fault_logit[name] = float(_row_rel(_forward_with(
                    torch, mods, m32, p32, batch["tokens"], ssd.ssd_chunked),
                    logits_x).max())
            finally:
                ssd.ssd_chunk = chunk
        del logits_x, p32
    loss_p, loss_x = float(loss_p), float(loss_x)
    rel = abs(loss_p - loss_x) / abs(loss_x)
    check(float(loss_p2) == loss_p, "the pallas loss changed between calls")
    print(f"[score] {cfg.name} loss on 2 x {seq} tokens, bf16: pallas "
          f"{loss_p:.6f} ({t_p * 1e3:.1f} ms, second call), xla {loss_x:.6f} "
          f"({t_x * 1e3:.1f} ms); rel diff {rel:.2e} (rtol "
          f"{MAMBA_LOSS_RTOL:.0e}); SSD launches {launches}")
    print(f"[score] each SSD call on the path vs plain: max scaled error "
          f"{max(held):.3e} over {len(held)} calls (limit {SSD_RTOL:.0e}); "
          f"each layer's bf16 output on the same input, pallas vs xla: max "
          f"token row rel {layer_rel:.3e} (limit {MAMBA_LAYER_ROW_RTOL:.0e}); "
          f"f32 params, every token's logits end to end: max row rel "
          f"{logit_rel:.3e} (limit {MAMBA_F32_LOGIT_ROW_RTOL:.0e})")
    print(f"[score] end to end, not held to a limit: bf16 logits pallas vs "
          f"xla max token row rel {bf16_rel:.3e}; the xla path with each "
          f"scan's output x (1 + 1e-6 N(0, 1)) against itself: bf16 "
          f"{bf16_noise:.3e}, f32 {f32_noise:.3e}")
    for name in faults:
        print(f"[control] mamba score, planted fault '{name}': layer output "
              f"max row rel {fault_layer[name]:.3e}, f32 logits max row rel "
              f"{fault_logit[name]:.3e}")
        check(not fault_layer[name] <= MAMBA_LAYER_ROW_RTOL
              and not fault_logit[name] <= MAMBA_F32_LOGIT_ROW_RTOL,
              f"planted fault '{name}' passes a scoring check")
    check(math.isfinite(loss_p) and rel <= MAMBA_LOSS_RTOL,
          f"pallas loss {loss_p} vs xla {loss_x}: rel {rel:.2e}")
    check(math.isfinite(layer_rel) and layer_rel <= MAMBA_LAYER_ROW_RTOL,
          f"a layer's output, pallas vs xla: max row rel {layer_rel:.3e}")
    check(math.isfinite(logit_rel) and logit_rel <= MAMBA_F32_LOGIT_ROW_RTOL,
          f"f32 logits, pallas vs xla: max token row rel {logit_rel:.3e}")
    check(len(held) == cfg.num_layers, f"{len(held)} SSD calls on the "
          f"scoring path, not one per layer ({cfg.num_layers})")
    if device == "cuda":
        check(launches == cfg.num_layers, f"the scoring forward launched the "
              f"SSD kernel {launches} times, not {cfg.num_layers}")
        print(f"[score] peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches


def phase_serve_mamba(torch, ssd, mods, *, reduce=False, device="cuda"):
    """Full-width mamba2-370m through the serve entry point; then the SSD
    kernel against the plain version on layer 0's live prefill inputs."""
    argv = ["--arch", "mamba2_370m", "--batch", "4", "--device", device]
    argv += (["--prompt-len", "64", "--gen", "4"] if reduce else
             ["--full", "--prompt-len", "2048", "--gen", "32"])
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ssd.LAUNCHES = 0
    res = mods.serve.run(argv)
    launches = ssd.LAUNCHES
    cfg = res.cfg
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "served tokens out of the vocabulary")
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else float("nan"))
    print(f"[serve] {cfg.name}: prefill {res.prefill_ms:.1f} ms, decode "
          f"{res.decode_ms:.2f} ms/token, peak memory {peak:.1f} GiB; SSD "
          f"launches on the serve path {launches} (prefill runs the model's "
          f"own scan, as in the reference)")
    model = mods.build_model(cfg)
    q = cfg.ssm.chunk_size
    with torch.inference_mode():
        lp0 = mods.tree_map(lambda t: t[0], res.params["layers"])
        x = mods.layers.embed(res.params["embedding"], res.prompts)
        _, _, xs, dt, a, b, c = model.ssd_inputs(lp0, x)
        bs, sl, h, p = xs.shape
        n = b.shape[-1]
        nc = sl // q
        args = (xs.float().reshape(bs, nc, q, h, p).contiguous(),
                dt.reshape(bs, nc, q, h).contiguous(), a.contiguous(),
                b.float().reshape(bs, nc, q, n).contiguous(),
                c.float().reshape(bs, nc, q, n).contiguous())
        got = ssd.ssd_chunk(*args)
        want = ssd.ssd_chunk_plain(*args)
        err, rel = hold_ssd(torch, got, want, "SSD kernel vs plain on layer "
                            "0's live prefill inputs")
        y_k, s_k = ssd.ssd_chunked(xs.float(), dt, a, b.float(), c.float(), q)
        y_m, s_m = mods.ssm.ssd_chunked(xs.float(), dt, a, b.float(),
                                        c.float(), q)
        _, rel_y = scaled_err(y_k, y_m)
        _, rel_s = scaled_err(s_k, s_m)
        check(rel_y <= SSD_RTOL and rel_s <= SSD_RTOL,
              f"layer 0's scan, kernel route vs the model's own: y {rel_y:.3e}"
              f", final state {rel_s:.3e}")
        del got, want, y_k, y_m
    print(f"[serve] SSD kernel vs plain on layer 0's live prefill inputs "
          f"{tuple(args[0].shape)}: y err {err:.3e}, scaled {rel:.3e}; the "
          f"kernel-backed scan vs the model's own: y {rel_y:.3e}, final "
          f"state {rel_s:.3e}")
    return res.prefill_ms, res.decode_ms, launches, peak


def hold_adam_on_path(torch, adam, mods, opt, exp, state, mask):
    """The server Adam's update on the path's own aggregate and state: the
    kernel route (``optimizer.update``) leaf by leaf against the kernel's
    plain version and against the reference's plain tree math; bias
    corrections dropped on the largest leaf must be rejected.  Returns the
    max abs p error against the plain version."""
    agg_t = mods.masked_aggregate_tree(state.buffers, mask)
    agg_t, gnorm = mods.clip_by_global_norm(agg_t, exp.train.grad_clip)
    got, got_st = opt.update(agg_t, state.opt_state, state.params,
                             exp.fl.beta)
    ref, ref_st = mods.adam_update_plain(
        agg_t, state.opt_state, state.params, exp.fl.beta, b1=ADAM_B1,
        b2=ADAM_B2, eps=ADAM_EPS, weight_decay=0.0, state_dtype=torch.float32)
    t = state.opt_state["t"] + 1
    scal = adam.adam_scalars(exp.fl.beta, t, ADAM_B1, ADAM_B2,
                             mods.tree_leaves(state.params)[0].device)
    paths = mods.tree_paths(state.params)
    flat = [[x.reshape(-1) for x in mods.tree_leaves(tree)] for tree in (
        state.params, state.opt_state["m"], state.opt_state["v"], agg_t,
        got, got_st["m"], got_st["v"], ref, ref_st["m"], ref_st["v"])]
    worst = worst_ref = 0.0
    for i, path in enumerate(paths):
        p0, m0, v0, g0, gp, gm, gv, rp, rm, rv = (f[i] for f in flat)
        want = adam.fused_adam_plain(p0, m0, v0, g0, scal, b1=ADAM_B1,
                                     b2=ADAM_B2, eps=ADAM_EPS)
        ok, err = adam_close(torch, (gp, gm, gv), want)
        check(ok and gp.dtype == p0.dtype, f"server Adam on the path, leaf "
              f"{path}: kernel vs its plain version outside the limits (max "
              f"abs p error {err:.3e})")
        ok, err_ref = adam_close(torch, (gp, gm, gv), (rp, rm, rv), p_old=p0)
        check(ok, f"server Adam on the path, leaf {path}: kernel vs the "
              f"reference's plain tree math outside the limits (max abs p "
              f"error {err_ref:.3e})")
        worst, worst_ref = max(worst, err), max(worst_ref, err_ref)
        if path == "layers/in_proj":
            no_bc = torch.stack([scal[0], torch.ones_like(scal[1]),
                                 torch.ones_like(scal[2])])
            fault = adam.fused_adam_plain(p0, m0, v0, g0, no_bc, b1=ADAM_B1,
                                          b2=ADAM_B2, eps=ADAM_EPS)
            bad, fault_err = adam_close(torch, fault, want)
            check(not bad, "planted fault 'bias corrections dropped' passes "
                  "the server Adam check on in_proj")
    print(f"[train] server Adam on the path's aggregate (grad norm "
          f"{float(gnorm):.3e} before clipping) and state, t = {int(t)}: "
          f"kernel route vs its plain version, max abs p error {worst:.3e}; "
          f"vs the reference's plain tree math {worst_ref:.3e} ({len(paths)} "
          f"leaves); planted fault 'bias corrections dropped' on in_proj: "
          f"{fault_err:.3e}, rejected")
    return worst


def profile_meta_gradient(torch, mods, model, exp, params, batches):
    """One cohort's Eq.-7 meta-gradient — a quarter of a round's work — once
    unprofiled, then under ``torch.profiler`` (device activity only, so the
    trace stays small): its wall clock, the card's busy share (the kernels'
    summed device time: one stream, so they do not overlap), the kernel
    count and the kernels that take the most time."""
    import torch.profiler as tp

    def loss(p, b):
        return model.loss(p, b)[0]

    one = mods.tree_map(lambda x: x[0], batches)

    def run():
        return mods.perfed.perfed_grad(loss, params, one, exp.fl.alpha)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    prof = tp.profile(activities=[tp.ProfilerActivity.CUDA])
    prof.start()
    try:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        prof.stop()
    t0 = time.perf_counter()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    count = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    bsz, seq = one["outer"]["tokens"].shape
    print(f"[train] one cohort's meta-gradient (batch {bsz} x {seq}): "
          f"{plain_wall:.2f} s unprofiled; under torch.profiler {wall:.2f} s "
          f"wall, card busy {busy:.3f} s ({busy / plain_wall:.1%} of the "
          f"unprofiled wall); {count} kernels; reading the trace took "
          f"{time.perf_counter() - t0:.1f} s; most device time: " + ", ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e6:.3f} s "
              f"({e.count})" for e in top))


def remat_round(torch, mods, cfg, exp, opt, state, cohorts, batches, mask,
                device):
    """One round of the plain step from ``state`` with ``cfg.remat`` True
    (the config's default: each layer checkpointed) and False, under
    deterministic algorithms (a scatter-add's atomics would otherwise
    differ between any two runs): the new params, moments, buffers and
    grad norm, and the loss and gradient of cohort 0's outer batch (by
    ``torch.autograd`` and by ``torch.func.grad``), must be bitwise equal.
    Prints each route's seconds and peak memory above its start."""
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    try:
        for remat in (True, False):
            model = mods.build_model(dataclasses.replace(cfg, remat=remat))
            step = mods.semi_sync.make_semi_sync_step(model, exp, opt,
                                                      cohorts)
            base = _peak_base(torch, device)
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, metrics = step(state, batches, mask)
            if device == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = _peak_above(torch, device, base)
            one = mods.tree_map(lambda x: x[0], batches["outer"])
            leaves = [x.detach().requires_grad_(True)
                      for x in mods.tree_leaves(state.params)]
            params = mods.tree_unflatten(state.params, leaves)
            loss = model.loss(params, one)[0]
            grads = torch.autograd.grad(loss, leaves)
            # torch.func runs through the model too (the checkpoint steps
            # aside inside a transform)
            func = mods.tree_leaves(torch.func.grad(
                lambda p: model.loss(p, one)[0])(state.params))
            out[remat] = ([x for tree in (new.params, new.opt_state,
                                          new.buffers)
                           for x in mods.tree_leaves(tree)]
                          + [metrics["grad_norm"], loss.detach()]
                          + list(grads) + func, seconds, peak)
            del new, metrics, loss, grads, leaves, params, func
    finally:
        torch.use_deterministic_algorithms(det)
    for i, (x, y) in enumerate(zip(out[True][0], out[False][0])):
        check(same_bits(torch, x, y), f"remat: result {i} of the round "
              f"(params, moments, buffers, grad norm, loss, gradients in "
              f"order) differs with cfg.remat True and False")
    print(f"[train] one round of the plain step, cfg.remat True vs False: "
          f"{len(out[True][0])} results bitwise equal (state, grad norm, "
          f"loss and gradients by autograd and torch.func on cohort 0's "
          f"batch); seconds "
          f"{out[True][1]:.2f} vs {out[False][1]:.2f}; peak memory above the "
          f"round's start {out[True][2]:.2f} GiB vs {out[False][2]:.2f} GiB")
    return dict(seconds=(out[True][1], out[False][1]),
                peak_gib=(out[True][2], out[False][2]))


def phase_train_mamba(torch, adam, agg, mods, *, reduce=False,
                      device="cuda"):
    """``train_e2e``'s round loop on mamba2-370m (bf16, attn_impl "xla":
    the SSD kernel has no backward, as in the reference): 4 cohorts, A 2,
    S 2, batch 4, seq 256, server Adam, 3 rounds; then one β-SGD round
    through the Eq.-8 kernel; then ``launch.train --mode scale``."""
    cfg = mods.get_config("mamba2_370m")
    cohorts, part, stale, bsz, seq, rounds = 4, 2, 2, 4, 256, 3
    if reduce:
        cfg, bsz, seq = cfg.reduced(), 2, 64
    e2e = mods.train_e2e
    model = mods.build_model(cfg)
    exp = e2e.experiment_cfg(cfg, staleness=stale, fused_agg=False)
    opt = mods.make_optimizer("adam")
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = mods.semi_sync.init_state(
        model, torch.Generator(device=device).manual_seed(0), opt, cohorts)
    pi = mods.greedy_schedule(mods.relative_frequencies(cohorts, "equal"),
                              part, rounds + 1)
    kw = dict(pi=pi, corpora=e2e.cohort_corpora(cohorts, cfg.vocab_size),
              batch=bsz, seq=seq, device=device)
    adam.LAUNCHES = 0
    per_round, seconds, adam_err = [], [], None
    for k in range(rounds):
        if k == 2:
            # round 2 is the first whose aggregate holds gradients (rounds
            # 0 and 1 apply the zero-initialised buffers of cohorts 0-1 and
            # 2-3): hold the kernel against the plain math on it first
            before = adam.LAUNCHES
            adam_err = hold_adam_on_path(
                torch, adam, mods, opt, exp, state,
                torch.as_tensor(pi[k], dtype=torch.float32, device=device))
            adam.LAUNCHES = before      # comparison launches do not count
        before = adam.LAUNCHES
        state, rec = e2e.train_rounds(model, exp, opt, state,
                                      rounds=range(k, k + 1), **kw)
        per_round.append(adam.LAUNCHES - before)
        seconds.append(rec[0]["seconds"])
        print(f"[train] round {k} mask {rec[0]['mask']}: "
              f"{rec[0]['seconds']:.2f} s, grad norm "
              f"{float(rec[0]['metrics']['grad_norm']):.3e}, max staleness "
              f"{int(rec[0]['metrics']['max_staleness'])}, fused Adam "
              f"launches {per_round[-1]}")
    with torch.no_grad():
        eb = mods.tree_map(lambda x: x[0], e2e.round_batches(
            kw["corpora"], 0, batch=bsz, seq=seq, device=device)["outer"])
        loss = float(model.loss(state.params, eb)[0])
    check(math.isfinite(loss), f"loss after {rounds} rounds is {loss}")
    if device == "cuda":
        check(per_round == [len(mods.tree_leaves(state.params))] * rounds,
              f"fused Adam launches per round {per_round}, not one per leaf")
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else float("nan"))
    print(f"[train] {cfg.name}, {cohorts} cohorts, A={part}, S={stale}, "
          f"batch {bsz}, seq {seq}, server Adam: rounds "
          f"{', '.join(f'{s:.2f}' for s in seconds)} s; loss on cohort 0's "
          f"batch {loss:.4f}; peak memory {peak:.1f} GiB")
    remat = remat_round(torch, mods, cfg, exp, opt, state, cohorts,
                        e2e.round_batches(kw["corpora"], rounds, batch=bsz,
                                          seq=seq, device=device),
                        torch.as_tensor(pi[rounds], dtype=torch.float32,
                                        device=device), device)
    if device == "cuda":
        profile_meta_gradient(torch, mods, model, exp, state.params,
                              e2e.round_batches(kw["corpora"], rounds,
                                                batch=bsz, seq=seq,
                                                device=device))

    # one β-SGD round without clipping: the fused Eq.-8 kernel on the
    # mixed bf16/f32 tree
    exp_f = e2e.experiment_cfg(cfg, staleness=stale, fused_agg=True)
    sgd = mods.make_optimizer("sgd")
    check(mods.semi_sync.uses_fused_eq8(sgd, exp_f), "--fused-agg settings "
          "do not take the Eq.-8 path")
    st = mods.semi_sync.SemiSyncState(state.params, sgd.init(state.params),
                                      state.buffers, state.staleness,
                                      state.step)
    del state
    before = agg.LAUNCHES
    st, rec = e2e.train_rounds(model, exp_f, sgd, st,
                               rounds=range(rounds, rounds + 1), **kw)
    eq8 = agg.LAUNCHES - before
    dtypes = sorted({str(x.dtype) for x in mods.tree_leaves(st.params)})
    check(all(math.isfinite(float(x.float().abs().max()))
              for x in mods.tree_leaves(st.params)), "fused round: params "
          "not finite")
    if device == "cuda":
        check(eq8 == 1, f"the fused round launched the Eq.-8 kernel {eq8} "
              f"times, not once")
    print(f"[train] --fused-agg round {rounds} mask {rec[0]['mask']}: "
          f"{rec[0]['seconds']:.2f} s, Eq.-8 launches {eq8} on the "
          f"{dtypes} tree")
    del st
    if device == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    argv = ["--mode", "scale", "--arch", "mamba2_370m", "--steps", "3",
            "--device", device] + (["--reduce"] if reduce else [])
    st_s, metrics = mods.train.run(argv)
    t_scale = time.perf_counter() - t0
    check(int(st_s.step) == 3 and math.isfinite(float(metrics["loss"])),
          "launch.train --mode scale did not take 3 finite steps")
    print(f"[train] launch.train --mode scale --arch mamba2_370m --steps 3: "
          f"{t_scale:.1f} s")
    del st_s
    return sum(per_round), per_round, seconds, peak, adam_err, eq8, remat


# ---------------------------------------------------------------------------
# slice 13: the rest of the zoo trained, and the examples
# ---------------------------------------------------------------------------

# (arch, layers, cohorts, A, server routes): full width, depth and cohorts
# cut so one card holds a round.  A round holds the old and the new params
# and Adam moments (the caller keeps the old state), C buffer rows in the
# params' dtype, and the meta-gradient's gradients; the Eq.-8 tree route
# adds an f32 [C, N] copy of the buffers and a flat f32 p and out.  Read on
# an NVIDIA H100 80GB HBM3 (700 W): musicgen-large at 12 of 48 layers
# (838,912,000 params, C 4) peaks at 39.1 GiB, llama-3.2-vision-11b at one
# group of 5 self layers and its cross layer (2,183,184,385, C 2, server
# Adam) at 69.7 alone, but ran out of memory in the whole script (74.5 GiB
# allocated), so its two rounds are clipped β-SGD (no m and v); at C 4 it,
# and recurrentgemma-2b at its group and 2-layer tail (1,751,211,520) or
# at the group alone (1,567,669,760), ran out of memory, so both take 2
# cohorts, A 1.  Mixtral at 1 of 56 layers (2,906,720,256; a
# bank leaf is 805,306,368) fits only the clipped β-SGD route (59.6 GiB at
# C 2); neither kernel's route fits beside it.  DeepSeek-V2 at one layer
# (5,020,697,600) does not fit one card in any route (>= 16 B a param).
ZOO_TRAIN = (("recurrentgemma_2b", 5, 2, 1, ("adam", "eq8")),
             ("llama32_vision_11b", 5, 2, 1, ("sgd", "eq8")),
             ("musicgen_large", 12, 4, 2, ("adam", "eq8")),
             ("mixtral_8x22b", 1, 2, 1, ("sgd",)))
ZOO_TRAIN_ROUNDS = 3        # two server rounds, then the Eq.-8 round
# CUDA against the CPU at the reduced f32 configs of the CPU parity tests
# (their FL settings and masks: S 1, 3 cohorts), both of their routes
ZOO_HOLD_ARCHS = (("recurrentgemma_2b", 0.0), ("mixtral_8x22b", 1.0),
                  ("deepseek_v2_236b", 0.0), ("llama32_vision_11b", 1.0),
                  ("musicgen_large", 0.0))
ZOO_HOLD_FL = dict(alpha=0.02, beta=0.1, staleness_bound=1,
                   algorithm="perfed")
ZOO_HOLD_MASKS = ([1.0, 1.0, 0.0], [1.0, 0.0, 0.0])
ZOO_HOLD_RTOL = 1e-5


def _zoo_masks(cohorts, a, rounds):
    """The first ``a`` cohorts arrive every round: round 0 applies the
    zero-initialised buffers and refreshes them, so every later round
    aggregates gradients (S 2 forces no other refresh in 3 rounds)."""
    row = [1.0] * a + [0.0] * (cohorts - a)
    return [row] * rounds


def _holding_eq8(torch, agg, out):
    """Wrap Eq. 8's flat entry point so that each launch on the card is
    held against the plain version on its own inputs right after it runs,
    a chunk of N at a time (the kernel is elementwise over N; an f32 copy
    of the whole [C, N] would not fit beside the state), and the check is
    shown the plain version with one arriving cohort's weight dropped.
    Results go to ``out``; the launch count stays the wrapper's own."""
    orig = agg.stale_aggregate_flat

    def holding(params, buffers, mask, *, beta):
        got = orig(params, buffers, mask, beta=beta)
        if params.is_cuda:
            n, c = int(params.shape[0]), int(buffers.shape[0])
            tol = 1e-6 * (1.0 + float(params.abs().max()))
            bad = mask.clone()
            bad[int(torch.nonzero(mask)[0])] = 0.0
            err = fault = 0.0
            step = 1 << 26
            for i in range(0, n, step):
                sl = slice(i, min(i + step, n))
                p, b = params[sl], buffers[:, sl].contiguous()
                want = agg.stale_aggregate_plain(p, b, mask, beta=beta)
                err = max(err, float((got[sl] - want).abs().max()))
                fault = max(fault, float((got[sl] - agg.stale_aggregate_plain(
                    p, b, bad, beta=beta)).abs().max()))
                del p, b, want
            out.append(dict(n=n, c=c, max_abs_err=err, fault_err=fault,
                            tol=tol))
        return got

    agg.stale_aggregate_flat = holding
    return orig


def _zoo_train_cfg(mods, arch, layers, reduce):
    cfg = mods.get_config(arch)
    if reduce:
        cfg = cfg.reduced()
    else:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    # flash has no backward, as in the JAX package: training runs xla
    return dataclasses.replace(cfg, attn_impl="xla")


def _finite_tree(torch, mods, tree):
    return all(bool(torch.isfinite(x).all()) for x in mods.tree_leaves(tree))


def phase_train_zoo(torch, adam, agg, mods, arch, layers, cohorts, part,
                    routes, smi, *, reduce=False, device="cuda"):
    """``launch/train_e2e``'s round loop on ``arch`` at full width and
    ``layers`` (bf16, ``attn_impl="xla"``; ``cohorts`` cohorts, A ``part``,
    S 2, batch 4, seq 256; a vlm's gates drawn nonzero): with ``routes``
    ("adam", "eq8"), two rounds of the server Adam, the fused Adam kernel
    once a leaf a round and its last launch held against the plain version,
    then one β-SGD round without clipping through the Eq.-8 kernel, held
    against the plain version on its own inputs; with ("sgd",), three
    rounds of clipped β-SGD.  Prints params, seconds a round, peak memory,
    launches a round and the loss."""
    cfg = _zoo_train_cfg(mods, arch, layers, reduce)
    stale, bsz, seq = 2, 4, 256
    if reduce:
        bsz, seq = 2, 64
    e2e = mods.train_e2e
    model = mods.build_model(cfg)
    server = "adam" if "adam" in routes else "sgd"
    exp = e2e.experiment_cfg(cfg, staleness=stale, fused_agg=False)
    opt = mods.make_optimizer(server)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = mods.semi_sync.init_state(
        model, torch.Generator(device=device).manual_seed(0), opt, cohorts)
    _gate_draw(torch, state.params, device)
    n_params = sum(x.numel() for x in mods.tree_leaves(state.params))
    n_leaves = len(mods.tree_leaves(state.params))
    dtypes = sorted({str(x.dtype).replace("torch.", "")
                     for x in mods.tree_leaves(state.params)})
    import numpy as np
    pi = np.asarray(_zoo_masks(cohorts, part, ZOO_TRAIN_ROUNDS))
    kw = dict(pi=pi, corpora=e2e.cohort_corpora(cohorts, cfg.vocab_size),
              batch=bsz, seq=seq, device=device)
    eval_batch = mods.tree_map(lambda x: x[0], e2e.round_batches(
        kw["corpora"], 0, batch=bsz, seq=seq, device=device,
        codebooks=cfg.num_audio_codebooks)["outer"])

    def loss_now(params):
        with torch.no_grad():
            return float(model.loss(params, eval_batch)[0])

    loss0 = loss_now(state.params)
    server_rounds = ZOO_TRAIN_ROUNDS - (1 if "eq8" in routes else 0)
    seconds, adam_launches, eq8_launches, adam_row = [], [], [], None
    last, orig = _last_adam(adam, largest=True)
    try:
        for k in range(server_rounds):
            last["armed"] = k == server_rounds - 1 and server == "adam"
            before = adam.LAUNCHES
            state, rec = e2e.train_rounds(model, exp, opt, state,
                                          rounds=range(k, k + 1), **kw)
            adam_launches.append(adam.LAUNCHES - before)
            seconds.append(rec[0]["seconds"])
    finally:
        adam._update = orig
    loss1 = loss_now(state.params)
    if server == "adam" and device == "cuda":
        before = adam.LAUNCHES
        adam_row = hold_adam_spmd(torch, adam, last, what=f"{arch} training")
        adam.LAUNCHES = before          # comparison launches do not count
    del last
    check(math.isfinite(loss1) and _finite_tree(torch, mods, state.params),
          f"{arch}: loss {loss1} or params not finite after "
          f"{server_rounds} {server} rounds")
    if device == "cuda" and server == "adam":
        check(adam_launches == [n_leaves] * server_rounds, f"{arch}: fused "
              f"Adam launches a round {adam_launches}, not one a leaf "
              f"({n_leaves})")

    eq8_row, loss2 = None, loss1
    if "eq8" in routes:
        exp_f = e2e.experiment_cfg(cfg, staleness=stale, fused_agg=True)
        sgd = mods.make_optimizer("sgd")
        check(mods.semi_sync.uses_fused_eq8(sgd, exp_f), "--fused-agg "
              "settings do not take the Eq.-8 path")
        st = mods.semi_sync.SemiSyncState(state.params,
                                          sgd.init(state.params),
                                          state.buffers, state.staleness,
                                          state.step)
        del state
        if device == "cuda":
            torch.cuda.empty_cache()
        holds = []
        orig = _holding_eq8(torch, agg, holds)
        try:
            before = agg.LAUNCHES
            st, rec = e2e.train_rounds(
                model, exp_f, sgd, st,
                rounds=range(server_rounds, server_rounds + 1), **kw)
            eq8_launches.append(agg.LAUNCHES - before)
        finally:
            agg.stale_aggregate_flat = orig
        seconds.append(rec[0]["seconds"])
        state = st
        loss2 = loss_now(state.params)
        check(math.isfinite(loss2) and _finite_tree(torch, mods,
                                                    state.params),
              f"{arch}: loss {loss2} or params not finite after the Eq.-8 "
              f"round")
        if device == "cuda":
            check(eq8_launches == [1] and len(holds) == 1, f"{arch}: the "
                  f"fused round launched Eq. 8 {eq8_launches} times")
            eq8_row = holds[0]
            check(math.isfinite(eq8_row["max_abs_err"])
                  and eq8_row["max_abs_err"] <= eq8_row["tol"],
                  f"{arch}: Eq. 8 on the path vs its plain version: "
                  f"{eq8_row['max_abs_err']} > {eq8_row['tol']}")
            check(eq8_row["fault_err"] > eq8_row["tol"], f"{arch}: the Eq.-8 "
                  f"check accepts a planted fault ({eq8_row['fault_err']})")
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else float("nan"))
    del state
    if device == "cuda":
        torch.cuda.empty_cache()
    route = {"adam": "server Adam", "sgd": "clipped β-SGD"}[server]
    print(f"[train zoo] {cfg.name}, {cfg.num_layers} layers (full width), "
          f"{n_params:,} params ({', '.join(dtypes)}, {n_leaves} leaves), "
          f"{cohorts} cohorts, A {part}, S {stale}, batch {bsz}, seq {seq}, "
          f"cfg.remat {cfg.remat} (the step differentiates through "
          f"torch.autograd, where remat checkpoints each layer): {route} "
          f"rounds "
          f"{', '.join(f'{s:.2f}' for s in seconds[:server_rounds])} s"
          + (f", the Eq.-8 round {seconds[-1]:.2f} s" if eq8_launches
             else "")
          + f"; fused Adam launches a round {adam_launches}, Eq.-8 "
          f"launches {eq8_launches}; loss on cohort 0's batch {loss0:.4f} "
          f"-> {loss1:.4f}" + (f" -> {loss2:.4f}" if eq8_launches else "")
          + f"; peak memory {peak:.2f} GiB [{smi}]")
    if adam_row:
        print(f"[train zoo] {arch}: fused Adam's largest-leaf launch (N "
              f"{adam_row['n']:,}, p {adam_row['p_dtype']}) vs plain: "
              f"err {adam_row['max_abs_err']:.3e}, planted fault "
              f"{adam_row['fault_err']:.3e} rejected; {adam_row['ms']:.3f} ms, "
              f"plain {adam_row['plain_ms']:.3f} ms, bound "
              f"{adam_row['bound_ms']:.3f} ms")
    if eq8_row:
        print(f"[train zoo] {arch}: Eq. 8's launch (N {eq8_row['n']:,}, C "
              f"{eq8_row['c']}) vs plain on its own inputs: err "
              f"{eq8_row['max_abs_err']:.3e} (limit {eq8_row['tol']:.1e}), "
              f"planted fault {eq8_row['fault_err']:.3e} rejected")
    return dict(params=n_params, leaves=n_leaves, seconds=seconds,
                peak_gib=peak, adam_launches=adam_launches,
                eq8_launches=eq8_launches, losses=[loss0, loss1, loss2],
                adam=adam_row, eq8=eq8_row)


def _hold_cfgs(mods, arch, grad_clip):
    cfg = dataclasses.replace(mods.get_config(arch).reduced(),
                              dtype="float32")
    exp = mods.ExperimentConfig(model=cfg, fl=mods.FLConfig(**ZOO_HOLD_FL),
                                train=mods.TrainConfig(grad_clip=grad_clip))
    return cfg, exp


def phase_zoo_vs_cpu(torch, agg, mods, *, device="cuda"):
    """Each family of the zoo at its reduced f32 config, as the CPU parity
    tests hold it against the JAX package: 2 rounds of the semi-sync step
    (``ZOO_HOLD_MASKS``, β-SGD fused or clipped as those tests take it) on
    ``device`` (the kernels on, TF32 off) and on the CPU (the plain
    versions) from the same state and batches: staleness bitwise, params
    within 1e-5·(1 + max|p|) a leaf."""
    import numpy as np
    out = {}
    for arch, grad_clip in ZOO_HOLD_ARCHS:
        cfg, exp = _hold_cfgs(mods, arch, grad_clip)
        model = mods.build_model(cfg)
        opt = mods.make_optimizer("sgd")
        cohorts = len(ZOO_HOLD_MASKS[0])
        st_cpu = mods.semi_sync.init_state(
            model, torch.Generator().manual_seed(0), opt, cohorts)
        _gate_draw(torch, st_cpu.params, "cpu")
        st_dev = st_cpu._replace(
            params=mods.tree_map(lambda x: x.to(device), st_cpu.params),
            buffers=mods.tree_map(lambda x: x.to(device), st_cpu.buffers),
            staleness=st_cpu.staleness.to(device),
            step=st_cpu.step.to(device))
        step = mods.semi_sync.make_semi_sync_step(model, exp, opt, cohorts)
        rng = np.random.default_rng(0)
        k_cb = cfg.num_audio_codebooks
        before = agg.LAUNCHES
        for m in ZOO_HOLD_MASKS:
            def one():
                t = rng.integers(0, cfg.vocab_size, size=(cohorts, 2, 33)
                                 + ((k_cb,) if k_cb else ())).astype(np.int32)
                t = torch.from_numpy(t)
                return {"tokens": t[:, :, :-1], "targets": t[:, :, 1:]}
            batches = {"inner": one(), "outer": one(), "hessian": one()}
            mask = torch.tensor(m)
            st_cpu, _ = step(st_cpu, batches, mask)
            st_dev, _ = step(st_dev, mods.tree_map(lambda x: x.to(device),
                                                   batches), mask.to(device))
        launches = agg.LAUNCHES - before
        check(torch.equal(st_dev.staleness.cpu(), st_cpu.staleness),
              f"{arch}: staleness on the card differs from the CPU's")
        worst = 0.0
        for path, got, want in zip(mods.tree_paths(st_cpu.params),
                                   mods.tree_leaves(st_dev.params),
                                   mods.tree_leaves(st_cpu.params)):
            scale = 1.0 + float(want.abs().max())
            err = float((got.cpu() - want).abs().max()) / scale
            check(math.isfinite(err) and err <= ZOO_HOLD_RTOL,
                  f"{arch}: params {path} on the card vs the CPU: "
                  f"{err:.3e} of 1 + max|p| (limit {ZOO_HOLD_RTOL:.0e})")
            worst = max(worst, err)
        if device == "cuda" and grad_clip == 0.0:
            check(launches == len(ZOO_HOLD_MASKS), f"{arch}: Eq. 8 launched "
                  f"{launches} times in {len(ZOO_HOLD_MASKS)} fused rounds")
        out[arch] = dict(err=worst, eq8_launches=launches)
    print("[zoo vs cpu] reduced f32, 2 semi-sync rounds on the card (kernels "
          "on, TF32 off) against the CPU's plain route from the same state "
          "and batches, staleness bitwise, worst params error / (1 + "
          "max|p|): " + "; ".join(
              f"{arch} ({'fused Eq. 8' if g == 0.0 else 'clipped'}, Eq.-8 "
              f"launches {out[arch]['eq8_launches']}) {out[arch]['err']:.3e}"
              for arch, g in ZOO_HOLD_ARCHS)
          + f" (limit {ZOO_HOLD_RTOL:.0e})")
    return out


def phase_examples(torch, agg, mods, smi, *, device="cuda", max_rounds=None):
    """Each of ``repro_torch.examples``' ``main()`` at its own settings on
    ``device``: Π row sums equal A (⌈A / cells⌉ on a hierarchy's edge
    rounds), losses finite, the quickstart's personalized loss falls,
    ``mobile_edge``'s hierarchy merges in the cloud, and the simulations
    launch Eq. 8.  Prints each example's seconds."""
    import importlib

    import numpy as np
    argv = ["--device", str(device)]
    seconds, eq8 = {}, {}

    def run(name, **kw):
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        before = agg.LAUNCHES
        t0 = time.perf_counter()
        res = mod.main(argv, **kw)
        seconds[name] = time.perf_counter() - t0
        eq8[name] = agg.LAUNCHES - before
        return mod, res

    def sims_ok(name, results, a):
        for label, r in results.items():
            want = -(-a // r.n_cells)     # a hierarchy's edge rounds
            check(r.pi.shape[0] > 0 and set(r.pi.sum(1).tolist()) == {want},
                  f"examples: {name} {label}: Π row sums "
                  f"{sorted(set(r.pi.sum(1).tolist()))}, not {want}")
            check(np.isfinite(r.losses).all() and np.isfinite(
                r.global_losses).all(), f"examples: {name} {label}: losses "
                  f"not finite")

    rk = {} if max_rounds is None else {"max_rounds": max_rounds}
    _, res = run("quickstart", **rk)
    sims_ok("quickstart", {"": res}, 5)
    check(res.losses[-1] < res.losses[0], f"examples: quickstart's "
          f"personalized loss {res.losses[0]} -> {res.losses[-1]}")
    mod, res = run("compare_algorithms", **rk)
    for label, r in res.items():
        a = {"sync": 10, "semi": 3, "async": 1}[mod.ALGORITHMS[label][1]]
        sims_ok("compare_algorithms", {label: r}, a)
    _, res = run("wireless_scheduling")
    check(res["round_time_opt"] <= res["round_time_eq"], "examples: "
          "Theorem 2's round is slower than the equal split")
    _, res = run("mobile_edge", **rk)
    sims_ok("mobile_edge", res, 6)
    check(res["hierarchy"].cloud_rounds > 0, "examples: mobile_edge's "
          "hierarchy merged nothing in the cloud")
    _, res = run("hetero_cells", **rk)
    sims_ok("hetero_cells", res, 6)
    _, res = run("serve_personalized")
    check(all(math.isfinite(x) for x in res["meta_losses"]
              + res["adapted_losses"]), "examples: serve_personalized's "
          "losses not finite")
    sims = ("quickstart", "compare_algorithms", "mobile_edge",
            "hetero_cells")
    if device == "cuda":
        check(all(eq8[n] > 0 for n in sims), f"examples: Eq.-8 launches "
              f"{eq8}")
    print("[examples] seconds " + ", ".join(
        f"{n} {s:.1f}" for n, s in seconds.items()) + "; Eq.-8 launches "
          + ", ".join(f"{n} {eq8[n]}" for n in sims) + f" [{smi}]")
    return dict(seconds=seconds, launches=sum(eq8[n] for n in sims),
                per_example={n: eq8[n] for n in sims})


# ---------------------------------------------------------------------------
# slice 6: the mobile multi-cell and open-world path
# ---------------------------------------------------------------------------

# benchmarks/mobility.py's full sweep: mnist_dnn, 1,024 UEs, A 64, S 8,
# first-order payloads, batches 4/4/4, equal bandwidth, step_s 1.0, a cloud
# merge every 4 edge rounds, 8 rounds, no evals
MOBILITY_N_UES = 1024
MOBILITY_SPEEDS = (0.0, 20.0)
MOBILITY_CELLS = (1, 4)
MOBILITY_ROUNDS = 8
# benchmarks/scenarios.py's matrix: 64 UEs, A 8, the 3-cell hierarchy at
# 20 m/s, step_s 0.2, a cloud merge every 4 edge rounds, 12 rounds, under
# equal and Theorem-2 bandwidth; its registry, copied as constants
SCENARIO_N_UES = 64
SCENARIO_ROUNDS = 12
SCENARIO_POLICIES = ("equal", "theorem2")
SCENARIOS = {
    "static": dict(enabled=False),
    "churn": dict(enabled=True, initial_active_frac=0.75, arrival_rate=1.0,
                  departure_rate=0.05, min_active=8),
    "diurnal": dict(enabled=True, initial_active_frac=0.75,
                    arrival_rate=2.0, departure_rate=0.05, min_active=8,
                    diurnal_amplitude=0.9, diurnal_period_s=4.0),
    "flash_crowd": dict(enabled=True, initial_active_frac=0.6,
                        arrival_rate=0.5, departure_rate=0.03, min_active=8,
                        flash_time_s=0.5, flash_duration_s=2.0,
                        flash_arrival_boost=6.0, flash_hotspot_cell=0,
                        flash_hotspot_frac=0.5),
    "drift": dict(enabled=True, initial_active_frac=0.9, arrival_rate=0.5,
                  departure_rate=0.02, min_active=8, drift_rate=0.5,
                  drift_frac=0.3),
}
# final params of a card run against the same run on the CPU (f32; TF32 is
# off): payload matmuls sum in another order, Eq. 8 in the same
MOBILE_PARAM_RTOL, MOBILE_PARAM_ATOL = 1e-5, 1e-6


def _mobile_setup(mods, n, *, a, speed, n_cells, step_s, scenario=None,
                  data_n=None):
    """The benchmarks' mobile configuration: first-order PerFed, batches
    4/4/4, S 8, random-waypoint UEs, a hierarchy over more than one cell."""
    cfg = mods.ExperimentConfig(
        model=mods.get_config("mnist_dnn"),
        fl=mods.FLConfig(n_ues=n, participants_per_round=a,
                         staleness_bound=8, alpha=0.03, beta=0.07,
                         first_order=True, inner_batch=4, outer_batch=4,
                         hessian_batch=4),
        mobility=mods.MobilityConfig(
            enabled=True, model="random_waypoint", speed_mps=speed,
            n_cells=n_cells, hierarchy=n_cells > 1, cloud_sync_every=4,
            step_s=step_s),
        scenario=mods.ScenarioConfig(**(scenario or {})))
    data = mods.synthetic_mnist(n=data_n or max(2500, 10 * n), seed=0)
    return cfg, data


def host_numbers(res):
    """Every host-side number of a run, floats as hex (bitwise)."""
    hexes = lambda xs: [float(x).hex() for x in xs]      # noqa: E731
    return {"times": hexes(res.times), "rounds": res.rounds.tolist(),
            "pi": res.pi.tolist(), "total_time": float(res.total_time).hex(),
            "wait_fraction": float(res.wait_fraction).hex(),
            "eta_realised": hexes(res.eta_realised),
            **{k: int(getattr(res, k)) for k in (
                "payload_dispatches", "payloads_computed", "n_cells",
                "handovers", "cloud_rounds", "departed_arrivals", "ue_joins",
                "ue_departures", "label_drifts", "aborted_rounds",
                "pending_uploads")}}


def host_mismatch(a, b):
    return sorted(k for k in a if a[k] != b[k])


def hold_eq8_on_path(torch, agg, first, tag):
    """Eq. 8 against its plain version on the inputs the mobile path gave
    it at each (N, C); the same check must reject the plain version with
    the last lane's weight dropped (a planted fault).  Times each shape
    beside the plain version, ``addmv`` and the byte bound."""
    rows = {}
    for (n, c), (p, buf, mask, beta) in sorted(first.items()):
        got = agg.stale_aggregate_flat(p, buf, mask, beta=beta)
        want = agg.stale_aggregate_plain(p, buf, mask, beta=beta)
        tol = 1e-6 * (1.0 + float(p.abs().max()))
        err = float((got - want).abs().max())
        check(math.isfinite(err) and err <= tol,
              f"mobile path Eq. 8 at N={n} C={c}: {err} > {tol}")
        bad_mask = mask.clone()
        bad_mask[-1] = 0.0 if float(mask[-1]) != 0.0 else 1.0
        if c == 1:
            bad_buf = buf * 1.5           # one lane: scale its payload
            faulty = agg.stale_aggregate_plain(p, bad_buf, mask, beta=beta)
        else:
            faulty = agg.stale_aggregate_plain(p, buf, bad_mask, beta=beta)
        fault = float((got - faulty).abs().max())
        check(fault > tol, f"mobile path Eq. 8 at N={n} C={c}: the check "
              f"accepts a planted fault ({fault} <= {tol})")
        a = max(float(mask.sum()), 1.0)
        bt = buf.t()
        t_kernel = device_ms(torch, lambda: agg.stale_aggregate_flat(
            p, buf, mask, beta=beta))
        t_plain = device_ms(torch, lambda: agg.stale_aggregate_plain(
            p, buf, mask, beta=beta), reps=5, trials=20)
        t_lib = device_ms(torch, lambda: torch.addmv(p, bt, mask,
                                                     alpha=-beta / a))
        nbytes = (c + 2) * n * 4 + c * 4
        bound, by = _bound(nbytes, 2 * c * n + n, H100_F32_FLOPS)
        rows[(n, c)] = dict(max_abs_err=err, fault_err=fault, ms=t_kernel,
                            plain_ms=t_plain, library_ms=t_lib,
                            bound_ms=bound, bound_by=by)
        print(f"[mobile] {tag} Eq. 8 on the path's inputs N={n} C={c}: "
              f"err={err:.3e} (tol {tol:.1e}), planted fault {fault:.3e} "
              f"rejected; kernel={t_kernel * 1e3:.2f} us  plain="
              f"{t_plain * 1e3:.2f} us  addmv={t_lib * 1e3:.2f} us  "
              f"bound={bound * 1e3:.2f} us")
    return rows


def _params_err(torch, mods, got, want):
    """Largest |got - want| - (atol + rtol |want|) over the leaves (<= 0
    when every element is within tolerance), and the largest |got - want|."""
    worst, big = -math.inf, 0.0
    for g, w in zip(mods.tree_leaves(got), mods.tree_leaves(want)):
        g, w = g.detach().double().cpu(), w.detach().double().cpu()
        d = (g - w).abs()
        worst = max(worst, float((d - MOBILE_PARAM_ATOL
                                  - MOBILE_PARAM_RTOL * w.abs()).max()))
        big = max(big, float(d.max()))
    return worst, big


def phase_mobile_edge(torch, agg, mods, smi, *, device="cuda", reduce=False):
    """The mobility sweep, the scenario matrix, the card-side goldens and a
    traced run, with every Eq.-8 launch counted and its shapes noted; then
    the kernel held on the path's own inputs, and the sweep's 4-cell
    20 m/s point run again on the CPU (host numbers bitwise, params within
    float32 tolerance).  ``reduce`` shrinks the UE counts for a CPU
    rehearsal."""
    tag = f"({smi})"
    n_sweep = 128 if reduce else MOBILITY_N_UES
    n_scen = 32 if reduce else SCENARIO_N_UES
    out = {"sweep": [], "matrix": []}
    seen, first, orig = _capture_eq8(agg)
    agg.LAUNCHES = 0
    try:
        # --- mobility sweep: cold (fresh engine) and warm ---------------
        for n_cells in MOBILITY_CELLS:
            for speed in MOBILITY_SPEEDS:
                cfg, data = _mobile_setup(mods, n_sweep, a=n_sweep // 16,
                                          speed=speed, n_cells=n_cells,
                                          step_s=1.0)
                model = mods.build_model(cfg.model)
                engine = mods.SimulationEngine(model, cfg.fl, "perfed",
                                               device=device)
                walls, res = [], None
                for _ in ("cold", "warm"):
                    before, shapes0 = agg.LAUNCHES, collections.Counter(seen)
                    t0 = time.perf_counter()
                    res = mods.run_simulation(
                        cfg, model, mods.partition_noniid(data, n_sweep,
                                                          n_labels=4, seed=0),
                        algorithm="perfed", mode="semi",
                        bandwidth_policy="equal",
                        max_rounds=MOBILITY_ROUNDS, eval_every=0, seed=0,
                        engine=engine, device=device)
                    if device == "cuda":
                        torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    launched = agg.LAUNCHES - before
                    shapes = dict(collections.Counter(seen) - shapes0)
                rounds = int(res.pi.shape[0])
                check(rounds == MOBILITY_ROUNDS,
                      f"mobility point v={speed} cells={n_cells} closed "
                      f"{rounds} rounds")
                check(n_cells == 1 or res.cloud_rounds == MOBILITY_ROUNDS // 4,
                      f"mobility point v={speed} cells={n_cells}: "
                      f"{res.cloud_rounds} cloud merges")
                pt = dict(speed_mps=speed, n_cells=n_cells, rounds=rounds,
                          rounds_per_s_cold=rounds / walls[0],
                          rounds_per_s_warm=rounds / walls[1],
                          handovers=res.handovers,
                          cloud_rounds=res.cloud_rounds,
                          sim_time_s=res.total_time,
                          payload_dispatches=res.payload_dispatches,
                          eq8_launches=launched,
                          eq8_shapes={f"{n}x{c}": k
                                      for (n, c), k in shapes.items()})
                out["sweep"].append(pt)
                if n_cells == 4 and speed == 20.0:
                    out["cpu_ref"] = (cfg, data, res)
                print(f"[mobile] {tag} sweep {n_sweep} UEs A={n_sweep // 16}"
                      f" v={speed:g} m/s cells={n_cells}: "
                      f"{pt['rounds_per_s_cold']:.3f} rounds/s cold, "
                      f"{pt['rounds_per_s_warm']:.3f} warm; handovers "
                      f"{res.handovers}, cloud merges {res.cloud_rounds}, "
                      f"simulated {res.total_time:.4f} s, dispatches "
                      f"{res.payload_dispatches}; Eq.-8 launches {launched} "
                      f"(warm run) at (N, C) {shapes}")
        moving = [p for p in out["sweep"]
                  if p["speed_mps"] > 0 and p["n_cells"] > 1]
        check(reduce or any(p["handovers"] > 0 for p in moving),
              "no handover in any moving multi-cell point")

        # --- scenario matrix on the 3-cell hierarchy ----------------------
        for name, scen in SCENARIOS.items():
            for policy in SCENARIO_POLICIES:
                cfg, data = _mobile_setup(
                    mods, n_scen, a=n_scen // 8, speed=20.0, n_cells=3,
                    step_s=0.2, scenario=scen,
                    data_n=max(1250, 10 * n_scen))
                model = mods.build_model(cfg.model)
                before = agg.LAUNCHES
                t0 = time.perf_counter()
                res = mods.run_simulation(
                    cfg, model, mods.partition_noniid(data, n_scen,
                                                      n_labels=4, seed=0),
                    algorithm="perfed", mode="semi", bandwidth_policy=policy,
                    max_rounds=SCENARIO_ROUNDS, eval_every=0, seed=0,
                    device=device)
                wall = time.perf_counter() - t0
                pt = dict(scenario=name, policy=policy,
                          rounds=int(res.pi.shape[0]), wall_s=wall,
                          sim_time_s=res.total_time,
                          wait_fraction=res.wait_fraction,
                          handovers=res.handovers, ue_joins=res.ue_joins,
                          ue_departures=res.ue_departures,
                          label_drifts=res.label_drifts,
                          aborted_rounds=res.aborted_rounds,
                          pending_uploads=res.pending_uploads,
                          eq8_launches=agg.LAUNCHES - before)
                out["matrix"].append(pt)
                check(pt["rounds"] == SCENARIO_ROUNDS
                      and pt["aborted_rounds"] == 0,
                      f"scenario {name}/{policy}: {pt['rounds']}/"
                      f"{SCENARIO_ROUNDS} rounds, {pt['aborted_rounds']} "
                      f"aborted")
                print(f"[mobile] {tag} scenario {name:<11s} {policy:<8s}: "
                      f"{pt['rounds']} rounds in {wall:.3f} s, simulated "
                      f"{res.total_time:.4f} s, joins {res.ue_joins}, "
                      f"departures {res.ue_departures}, drifts "
                      f"{res.label_drifts}, aborted {res.aborted_rounds}, "
                      f"pending {res.pending_uploads}, handovers "
                      f"{res.handovers}, wait {res.wait_fraction:.4f}, "
                      f"Eq.-8 launches {pt['eq8_launches']}")
        churny = [p for p in out["matrix"] if p["scenario"] != "static"]
        check(any(p["ue_joins"] > 0 for p in churny)
              and any(p["ue_departures"] > 0 for p in churny),
              "the scenario matrix fired no join or no departure")

        # --- card-side goldens -------------------------------------------
        degen = _golden_run(mods, device, mobility=mods.MobilityConfig(
            enabled=True, speed_mps=0.0, n_cells=1, hierarchy=False))
        rel, rel_g = check_golden(degen, "degenerate mobile")
        check(degen.handovers == degen.cloud_rounds == 0,
              "degenerate mobile run handed over or merged")
        print(f"[mobile] {tag} degenerate mobile (1 cell, 0 m/s) = the "
              f"static golden: times/Π/wait/dispatches bitwise; losses rel "
              f"err {rel:.2e}, global {rel_g:.2e} (rtol 1e-4)")
        runs = {}
        for label, scen in (("closed", None), ("zero-rate", {"enabled": True})):
            cfg, data = _mobile_setup(mods, n_scen, a=n_scen // 8,
                                      speed=20.0, n_cells=3, step_s=0.2,
                                      scenario=scen,
                                      data_n=max(1250, 10 * n_scen))
            runs[label] = mods.run_simulation(
                cfg, mods.build_model(cfg.model),
                mods.partition_noniid(data, n_scen, n_labels=4, seed=0),
                algorithm="perfed", mode="semi", bandwidth_policy="equal",
                max_rounds=SCENARIO_ROUNDS, eval_every=0, seed=0,
                device=device)
        diff = host_mismatch(host_numbers(runs["closed"]),
                             host_numbers(runs["zero-rate"]))
        check(not diff, f"zero-rate scenario differs from the closed world "
              f"in {diff}")
        worst, pdiff = _params_err(torch, mods, runs["zero-rate"].params,
                                   runs["closed"].params)
        check(worst <= 0.0, f"zero-rate scenario params differ from the "
              f"closed world by {pdiff}")
        print(f"[mobile] {tag} zero-rate scenario = closed world on the "
              f"3-cell hierarchy: every host number bitwise; params max "
              f"|diff| {pdiff:.3e}")

        # --- one traced run on the 4-cell 20 m/s point ---------------------
        cfg, data, _ = out["cpu_ref"]
        trace_dir = os.path.join(ROOT, "build", "mobile_edge_trace")
        if os.path.exists(os.path.join(trace_dir, "metrics.jsonl")):
            os.remove(os.path.join(trace_dir, "metrics.jsonl"))
        before = agg.LAUNCHES
        t0 = time.perf_counter()
        traced = mods.run_simulation(
            cfg, mods.build_model(cfg.model),
            mods.partition_noniid(data, n_sweep, n_labels=4, seed=0),
            algorithm="perfed", mode="semi", bandwidth_policy="equal",
            max_rounds=MOBILITY_ROUNDS, eval_every=0, seed=0, device=device,
            tracer=mods.Tracer(device=True), trace_dir=trace_dir)
        wall = time.perf_counter() - t0
        traced_launches = agg.LAUNCHES - before
    finally:
        agg.stale_aggregate_flat = orig
    launches = agg.LAUNCHES
    rows = mods.read_metrics(traced.telemetry["trace_path"])
    errs = mods.validate_rows(rows)
    check(not errs, f"the traced mobile run's JSONL fails validation: {errs}")
    diff = host_mismatch(host_numbers(traced), host_numbers(out["cpu_ref"][2]))
    check(not diff, f"tracing changed the mobile trajectory: {diff}")
    t = traced.telemetry
    host = {k: round(v, 4) for k, v in sorted(t["phase_s"].items(),
                                               key=lambda kv: -kv[1])}
    dev = {k: round(v, 4) for k, v in sorted(t["device_phase_s"].items(),
                                              key=lambda kv: -kv[1])}
    out["traced"] = dict(wall_s=wall, phase_s=t["phase_s"],
                         device_s=t["device_s"],
                         device_phase_s=t["device_phase_s"],
                         counts=t["counts"], eq8_launches=traced_launches)
    print(f"[mobile] {tag} traced 4-cell 20 m/s run: {wall:.3f} s wall "
          f"({t['rounds']} rounds, JSONL valid, {len(rows) - 2} records); "
          f"device (synchronised) {t['device_s']:.4f} s by phase {dev}; "
          f"host phases {host}; counts {dict(sorted(t['counts'].items()))}")

    if device == "cuda":
        check(launches > 0, "the mobile path launched the Eq.-8 kernel 0 "
              "times")
    out["launches"] = launches
    out["shapes"] = dict(seen)
    print(f"[mobile] {tag} Eq.-8 launches on the mobile path: {launches} at "
          f"(N, C) {dict(sorted(seen.items()))}")
    out["holds"] = (hold_eq8_on_path(torch, agg, first, tag)
                    if device == "cuda" else {})

    # --- the 4-cell 20 m/s point on the CPU, against the card's run --------
    if device == "cuda":
        cfg, data, card = out["cpu_ref"]
        t0 = time.perf_counter()
        cpu = mods.run_simulation(
            cfg, mods.build_model(cfg.model),
            mods.partition_noniid(data, n_sweep, n_labels=4, seed=0),
            algorithm="perfed", mode="semi", bandwidth_policy="equal",
            max_rounds=MOBILITY_ROUNDS, eval_every=0, seed=0, device="cpu")
        cpu_wall = time.perf_counter() - t0
        a, b = host_numbers(card), host_numbers(cpu)
        diff = host_mismatch(a, b)
        check(not diff, f"card and CPU differ in host numbers {diff}")
        planted = dict(a, total_time=(
            float.fromhex(a["total_time"]) + 1e-12).hex())
        check(host_mismatch(planted, b), "the host comparison accepts a "
              "planted fault")
        worst, big = _params_err(torch, mods, card.params, cpu.params)
        check(worst <= 0.0, f"card and CPU params differ by {big} (over "
              f"rtol {MOBILE_PARAM_RTOL}, atol {MOBILE_PARAM_ATOL})")
        out["cpu_check"] = dict(cpu_wall_s=cpu_wall, params_max_abs=big)
        print(f"[mobile] {tag} 4-cell 20 m/s point on the CPU "
              f"({cpu_wall:.2f} s): all {len(a)} host fields bitwise equal to "
              f"the card's (a planted 1e-12 s shift is rejected); final "
              f"params max |card - CPU| {big:.3e} (rtol "
              f"{MOBILE_PARAM_RTOL}, atol {MOBILE_PARAM_ATOL})")
    out.pop("cpu_ref")
    return out


# ---------------------------------------------------------------------------
# slice 7: RecurrentGemma-2B (RG-LRU + local attention; the flash kernel at
# head dim 256) scored and served, and the dense remainder of the zoo
# ---------------------------------------------------------------------------

# Scoring recurrentgemma-2b, pallas against xla, on the same params: the
# loss (mean over 8,192 tokens) and every token's logits in bf16, at the
# yi-6b phase's bounds (SCORE_LOSS_RTOL, SCORE_LOGIT_ROW_RTOL).  Unlike
# mamba2's, this stack is not chaotic in bf16 at random init: each RG-LRU
# scan's output x (1 + 1e-6 N(0, 1)) moves the bf16 logits by 3.7e-2 and
# the kernel by 3.2e-2, on an NVIDIA H100 80GB HBM3 at 700 W.  On an f32
# copy of the params that perturbation reads 1.5e-5 and the kernel (the f32
# route at D 256) 5.5e-6, held at 1e-4.  Serving: the logits each token was
# chosen from against a teacher-forced forward over prompt + generated
# tokens, row by row, at the reference's own 5e-2
# (tests/test_decode_consistency.py; 4.1e-2 on that card: the RG-LRU state
# is stored in bf16 between decode steps, as in the reference).
HYBRID_F32_LOGIT_ROW_RTOL = 1e-4
SERVE_LOGIT_ROW_RTOL = 5e-2
# The same check served in f32 (``serve --dtype float32``): the state is
# kept in f32 between steps, so only f32 rounding separates decode from
# the teacher-forced forward.
HYBRID_F32_SERVE_ROW_RTOL = 1e-4
DENSE_REMAINDER = ("starcoder2_15b", "nemotron4_15b", "deepseek_67b")
DENSE_REMAINDER_LAYERS = 2


def phase_score_hybrid(torch, fa, mods, *, reduce=False, device="cuda"):
    """The flash kernel's path at head dim 256: ``loss`` of
    recurrentgemma-2b (full width and depth, bf16) under
    ``attn_impl="pallas"`` on the two 4,096-token streams, one flash launch
    per attention block (8), each held against the plain version on its
    own inputs, against ``attn_impl="xla"`` on the same params: losses and
    every token's logits.  Measured beside them, not held: the xla path
    with each RG-LRU scan's f32 output x (1 + 1e-6 N(0, 1)) against
    itself (how far bf16 roundings alone move the logits), and the same on
    an f32 copy of the params, where pallas against xla is held too."""
    cfg = mods.get_config("recurrentgemma_2b")
    seq = 4096
    if reduce:
        cfg, seq = dataclasses.replace(cfg.reduced(), num_layers=8), 96
    model_p = mods.build_model(dataclasses.replace(cfg, attn_impl="pallas"))
    model_x = mods.build_model(dataclasses.replace(cfg, attn_impl="xla"))
    params = model_p.init(torch.Generator(device=device).manual_seed(0))
    batch = _score_batch(torch, mods, cfg.vocab_size, seq, device)
    gen = torch.Generator(device=device).manual_seed(1)
    scan = mods.hybrid.rglru_scan

    def perturbed_scan(*args, **kw):
        h, last = scan(*args, **kw)
        return h * (1 + 1e-6 * torch.randn(h.shape, generator=gen,
                                            device=h.device)), last

    def noise_logits(model, p):
        mods.hybrid.rglru_scan = perturbed_scan
        try:
            return model.predict(p, batch)
        finally:
            mods.hybrid.rglru_scan = scan

    calls = []
    with torch.inference_mode():
        with _recording(fa, calls):
            fa.LAUNCHES = 0
            loss_p = float(model_p.loss(params, batch)[0])
            launches = fa.LAUNCHES
        loss_p2, t_p = _timed_loss(torch, model_p, params, batch, device)
        loss_x, t_x = _timed_loss(torch, model_x, params, batch, device)
        call_rel = _hold_path_calls(torch, fa, calls)
        shapes = sorted({(tuple(c[0].shape), tuple(c[1].shape), c[3], c[4])
                         for c in calls})
        n_calls = len(calls)
        del calls
        logits_x = model_x.predict(params, batch)
        bf16_rel = _logit_row_rel(model_p.predict(params, batch), logits_x)
        bf16_noise = _logit_row_rel(noise_logits(model_x, params), logits_x)
        with _no_causal(fa):
            logits_f = model_p.predict(params, batch)
        fault_rel = _logit_row_rel(logits_f, logits_x)
        del logits_f, logits_x
        if device == "cuda":
            torch.cuda.empty_cache()

        # an f32 copy of the params: pallas (the f32 route at D 256) vs xla
        p32 = mods.tree_map(lambda t: t.float(), params)
        m32_p, m32_x = (mods.build_model(dataclasses.replace(
            cfg, dtype="float32", attn_impl=impl)) for impl in ("pallas",
                                                                "xla"))
        logits_x = m32_x.predict(p32, batch)
        f32_rel = _logit_row_rel(m32_p.predict(p32, batch), logits_x)
        f32_noise = _logit_row_rel(noise_logits(m32_x, p32), logits_x)
        with _no_causal(fa):
            f32_fault = _logit_row_rel(m32_p.predict(p32, batch), logits_x)
        del logits_x, p32
    rel = abs(loss_p - loss_x) / abs(loss_x)
    print(f"[score] {cfg.name} loss on 2 x {seq} tokens, bf16: pallas "
          f"{loss_p:.6f} ({t_p:.1f} ms, second call), xla {loss_x:.6f} "
          f"({t_x:.1f} ms); rel diff {rel:.2e} (rtol {SCORE_LOSS_RTOL:.0e}); "
          f"flash launches {launches} at {shapes}")
    print(f"[score] each flash call on the path vs plain: max row rel "
          f"{call_rel:.3e} over {n_calls} calls (limit "
          f"{BF16_ROW_RTOL['flash']:.0e}); bf16 logits, pallas vs xla: max "
          f"token row rel {bf16_rel:.3e} (limit {SCORE_LOGIT_ROW_RTOL:.0e})")
    print(f"[score] f32 copy of the params, pallas vs xla: max token row "
          f"rel {f32_rel:.3e} (limit {HYBRID_F32_LOGIT_ROW_RTOL:.0e}); not "
          f"held to a limit: the xla path with each RG-LRU scan's output x "
          f"(1 + 1e-6 N(0, 1)) against itself: bf16 {bf16_noise:.3e}, f32 "
          f"{f32_noise:.3e}")
    print(f"[control] hybrid score, planted fault 'causal mask dropped': "
          f"bf16 logits max token row rel {fault_rel:.3e}, f32 "
          f"{f32_fault:.3e}")
    check(loss_p2 == loss_p, "the pallas loss changed between calls")
    check(math.isfinite(loss_p) and rel <= SCORE_LOSS_RTOL,
          f"pallas loss {loss_p} vs xla {loss_x}: rel {rel:.2e}")
    check(math.isfinite(bf16_rel) and bf16_rel <= SCORE_LOGIT_ROW_RTOL,
          f"pallas logits vs xla: max token row rel {bf16_rel:.3e}")
    check(math.isfinite(f32_rel) and f32_rel <= HYBRID_F32_LOGIT_ROW_RTOL,
          f"f32 logits, pallas vs xla: max token row rel {f32_rel:.3e}")
    check(fault_rel > SCORE_LOGIT_ROW_RTOL
          and f32_fault > HYBRID_F32_LOGIT_ROW_RTOL,
          f"the planted fault passes a logits check ({fault_rel:.3e}, "
          f"{f32_fault:.3e})")
    check(n_calls == model_p.n_groups, f"{n_calls} flash calls on the "
          f"scoring path, not one per attention block ({model_p.n_groups})")
    if device == "cuda":
        check(launches == model_p.n_groups, f"the scoring forward launched "
              f"flash {launches} times, not {model_p.n_groups}")
        print(f"[score] peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return dict(launches=launches, loss_ms=t_p, xla_ms=t_x,
                call_rel=call_rel, logit_rel=bf16_rel)


@contextlib.contextmanager
def _patched(obj, name, make):
    """Within the block, ``obj.name`` is ``make(the original)``."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _conv_tail_late(mods):
    """Planted fault: a decode step leaves the recurrent blocks' conv tail
    where it was (it ends one input early, and the window never moves)."""
    def make(rec_apply):
        def late(self, pl, x, *, conv_state=None, h_state=None,
                 decode=False):
            out, new_conv, h = rec_apply(self, pl, x, conv_state=conv_state,
                                         h_state=h_state, decode=decode)
            return out, (conv_state if decode else new_conv), h
        return late
    return _patched(mods.hybrid.RecurrentGemmaLM, "_rec_apply", make)


def _window_short(mods):
    """Planted fault: a decode step's local attention sees one key fewer
    than the window (the ring's oldest slot is masked)."""
    def make(attn_apply):
        def short(self, pl, x, positions, cache, window):
            decode = cache is not None and x.shape[1] == 1
            return attn_apply(self, pl, x, positions, cache,
                              window - 1 if decode else window)
        return short
    return _patched(mods.hybrid.RecurrentGemmaLM, "_attn_apply", make)


def _served_vs_forced(torch, mods, argv):
    """``serve.run(argv)``, and the logits each token was chosen from
    against a teacher-forced ``predict`` over prompt + generated tokens:
    (result, max token row rel, the same with the logits one step late)."""
    res = mods.serve.run(argv)
    lp = res.prompts.shape[1]
    with torch.inference_mode():
        toks = torch.cat([res.prompts, res.tokens[:, :-1]], dim=1)
        want = mods.build_model(res.cfg).predict(res.params,
                                                 {"tokens": toks})
        want = want[:, lp - 1:]
    rel = float(_row_rel(res.logits, want).max())
    shifted = float(_row_rel(res.logits[:, 1:], want[:, :-1]).max())
    return res, rel, shifted


def phase_serve_hybrid(torch, mods, *, reduce=False, device="cuda"):
    """Full-width recurrentgemma-2b through the serve entry point (batch
    4, prompt 2,048, 32 tokens, cache 4,096 of which the ring keeps the
    window, 2,048); the logits each token was chosen from against a
    teacher-forced forward over prompt + generated tokens: in bf16 at the
    reference's 5e-2, and served in f32 (``--dtype float32``, the same
    seed's params unrounded) at f32 rounding, where a conv tail that does
    not advance and a window one key short must fail."""
    argv = ["--arch", "recurrentgemma_2b", "--batch", "4", "--device", device]
    argv += (["--prompt-len", "80", "--gen", "6", "--cache-len", "128"]
             if reduce else ["--full", "--prompt-len", "2048", "--gen", "32",
                             "--cache-len", "4096"])
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res, rel, shifted = _served_vs_forced(torch, mods, argv)
    cfg, lp, n_gen = res.cfg, res.prompts.shape[1], res.tokens.shape[1]
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else float("nan"))
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "served tokens out of the vocabulary")
    ring = res.cache["attn"]["pos"]
    window = cfg.hybrid.attention_window
    check(ring.shape[-1] == min(int(argv[-1]), window) and
          int(ring.max()) == lp + n_gen - 2,
          f"ring of {ring.shape[-1]} slots holds up to {int(ring.max())}")
    prefill_ms, decode_ms, ring_slots = res.prefill_ms, res.decode_ms, \
        ring.shape[-1]
    del res
    with _conv_tail_late(mods):
        bf16_fault = _served_vs_forced(torch, mods, argv)[1]
    f32 = argv + ["--dtype", "float32"]
    rel32 = _served_vs_forced(torch, mods, f32)[1]
    with _conv_tail_late(mods):
        f32_fault = _served_vs_forced(torch, mods, f32)[1]
    with _window_short(mods):
        f32_window = _served_vs_forced(torch, mods, f32)[1]
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"[serve] {cfg.name}: prefill {prefill_ms:.1f} ms, decode "
          f"{decode_ms:.2f} ms/token, peak memory {peak:.1f} GiB; ring "
          f"of {ring_slots} slots; served logits vs the teacher-forced "
          f"forward, max token row rel: bf16 {rel:.3e} (limit "
          f"{SERVE_LOGIT_ROW_RTOL:.0e}), served in f32 {rel32:.3e} (limit "
          f"{HYBRID_F32_SERVE_ROW_RTOL:.0e})")
    print(f"[control] hybrid serve, planted fault 'logits one step late': "
          f"bf16 {shifted:.3e}; 'conv tail not advanced': f32 "
          f"{f32_fault:.3e}, bf16 {bf16_fault:.3e} (not held); 'window one "
          f"key short': f32 {f32_window:.3e}")
    check(math.isfinite(rel) and rel <= SERVE_LOGIT_ROW_RTOL,
          f"served logits vs the teacher-forced forward: {rel:.3e}")
    check(math.isfinite(rel32) and rel32 <= HYBRID_F32_SERVE_ROW_RTOL,
          f"f32 served logits vs the teacher-forced forward: {rel32:.3e}")
    check(shifted > SERVE_LOGIT_ROW_RTOL, "the check cannot see logits one "
          "step late")
    check(f32_fault > HYBRID_F32_SERVE_ROW_RTOL, "the f32 check cannot see "
          "a conv tail that does not advance")
    check(f32_window > HYBRID_F32_SERVE_ROW_RTOL, "the f32 check cannot see "
          "a window one key short")
    return dict(prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gib=peak,
                logit_rel=rel, f32_logit_rel=rel32)


def phase_dense_remainder(torch, fa, mods, *, reduce=False, device="cuda"):
    """starcoder2-15b (gelu), nemotron-4-15b (squared ReLU) and
    deepseek-67b (silu) at full width, depth cut to 2 layers (deepseek-67b
    is 134 GB of bf16 whole), scored on the two streams: pallas vs xla
    (loss, every token's logits), 2 flash launches at D 128 each, each
    held against the plain version on its own inputs."""
    out = {}
    for arch in DENSE_REMAINDER:
        cfg = mods.get_config(arch)
        seq = 4096
        if reduce:
            cfg, seq = cfg.reduced(), 96
        cfg = dataclasses.replace(cfg, num_layers=DENSE_REMAINDER_LAYERS)
        model_p = mods.build_model(dataclasses.replace(cfg,
                                                       attn_impl="pallas"))
        model_x = mods.build_model(dataclasses.replace(cfg, attn_impl="xla"))
        params = model_p.init(torch.Generator(device=device).manual_seed(0))
        batch = _score_batch(torch, mods, cfg.vocab_size, seq, device)
        calls = []
        with torch.inference_mode():
            with _recording(fa, calls):
                fa.LAUNCHES = 0
                loss_p = float(model_p.loss(params, batch)[0])
                launches = fa.LAUNCHES
            _, t_p = _timed_loss(torch, model_p, params, batch, device)
            loss_x, t_x = _timed_loss(torch, model_x, params, batch, device)
            call_rel = _hold_path_calls(torch, fa, calls)
            d = calls[0][0].shape[-1]
            del calls
            logit_rel = _logit_row_rel(model_p.predict(params, batch),
                                       model_x.predict(params, batch))
        del params
        if device == "cuda":
            torch.cuda.empty_cache()
        rel = abs(loss_p - loss_x) / abs(loss_x)
        print(f"[score] {cfg.name} ({cfg.activation}), {cfg.num_layers} of "
              f"{mods.get_config(arch).num_layers} layers: loss pallas "
              f"{loss_p:.6f} ({t_p:.1f} ms), xla {loss_x:.6f} ({t_x:.1f} "
              f"ms), rel diff {rel:.2e} (rtol {SCORE_LOSS_RTOL:.0e}); flash "
              f"launches {launches} at D {d}, each vs plain max row rel "
              f"{call_rel:.3e}; logits max token row rel {logit_rel:.3e} "
              f"(limit {SCORE_LOGIT_ROW_RTOL:.0e})")
        check(math.isfinite(loss_p) and rel <= SCORE_LOSS_RTOL,
              f"{arch}: pallas loss {loss_p} vs xla {loss_x}: rel {rel:.2e}")
        check(math.isfinite(logit_rel) and logit_rel <= SCORE_LOGIT_ROW_RTOL,
              f"{arch}: pallas logits vs xla: max row rel {logit_rel:.3e}")
        if device == "cuda":
            check(launches == cfg.num_layers, f"{arch}: {launches} flash "
                  f"launches, not one per layer ({cfg.num_layers})")
        out[arch] = dict(launches=launches, head_dim=d, loss_ms=t_p,
                         xla_ms=t_x, loss_rel=rel)
    return out


# ---------------------------------------------------------------------------
# slice 8: the MoE family (Mixtral-8x22B: MoE + sliding-window GQA through
# the flash kernel; DeepSeek-V2-236B: MLA + routed and shared experts)
# ---------------------------------------------------------------------------

# Depth cuts at full width: the whole models are 281.3 and 478.8 GB of
# bf16; 8 Mixtral layers are 40.9 GB, 4 DeepSeek-V2 layers 33.9 GB.  In f32
# they would be 81.8 and 67.8 GB, so the f32 serving checks cut to 2.
MOE_LAYERS = {"mixtral_8x22b": 8, "deepseek_v2_236b": 4}
MOE_F32_SERVE_LAYERS = 2
# Routing trap: the router sees the attention's bf16 rounding, and a token
# whose k-th and (k+1)-th router probabilities nearly tie routes to
# another expert under flash than under sdpa; its logits row then moves
# far past 5e-2.  So the logits rows held are those of the tokens whose
# (expert, kept) pairs agree in every layer, and they must be at least a
# share of the tokens, or the check would hold too little.  In bf16 85.1%
# of Mixtral's scored tokens route alike, and 90.6% (Mixtral) and 78.9%
# (DeepSeek-V2) of the served rows (NVIDIA H100 80GB HBM3, 700 W); in f32
# a flip needs a near-exact tie, and every row was held.
MOE_MIN_HELD = {"bf16": 0.5, "f32": 0.9}
# Mixtral scored on an f32 copy of the params (streamed a layer at a
# time), pallas (the f32 flash route) against xla, and the served f32
# logits against a teacher-forced f32 forward (both models, 2 layers):
# 8.4e-6, 7.1e-6 and 6.3e-6 on an NVIDIA H100 80GB HBM3 at 700 W.
MOE_F32_ROW_RTOL = 1e-4
# Mixtral's layers held one at a time in bf16 (teacher forced on the xla
# path's input, pallas against xla, on the tokens that route alike in the
# layer), as mamba2's layers are held: half the logits' limit.  Layer 0
# read 1.045e-2 (its input, the embedding, is small beside the attention
# output), the others 3.0e-3-8.5e-3, and flash with the causal mask
# dropped 1.344 (NVIDIA H100 80GB HBM3, 700 W).
MOE_LAYER_ROW_RTOL = 2.5e-2
# Served against teacher forcing, the experts' capacity must drop nothing:
# the gather path's capacity grows with a call's token count, so prefill
# (8,192 tokens), decode (4) and the forward (8,316) would drop different
# pairs, and the reference's own decode-consistency test runs dropless
# (``reduced()`` sets 8).  Mixtral's 4.0 = E / k lets an expert take every
# token; DeepSeek-V2's 4.0 gives each expert 4x its mean load (dropless by
# construction, 160 / 6, would take ~50 GB of buffers), and the phase
# checks that no pair dropped.  Timings are read at the config's 1.25.
MOE_SERVE_CAPACITY = {"mixtral_8x22b": 4.0, "deepseek_v2_236b": 4.0}


@contextlib.contextmanager
def _routing(mods, out):
    """Within the block, each routing's experts [T, k] are appended to
    ``out`` in call order."""
    route = mods.layers._route

    def rec(params, xf, e):
        probs, idx, aux = route(params, xf, e)
        out.append(idx.clone())
        return probs, idx, aux

    mods.layers._route = rec
    try:
        yield
    finally:
        mods.layers._route = route


def _route_keys(mods, idx, moe):
    """Each token's (expert, kept) pairs as sorted keys expert * 2 + kept,
    kept by the capacity of the call that routed ``idx``."""
    cap = mods.layers.moe_capacity(idx.shape[0], moe)
    kept = mods.layers.moe_dispatch(idx, moe.num_experts, cap) \
        < moe.num_experts * cap
    return (idx * 2 + kept).sort(dim=-1).values


def _agreement(torch, keys_a, keys_b):
    """Over the layers' keys ([B, L, k] each): the tokens whose (expert,
    kept) pairs agree in every layer [B, L], the tokens whose expert set
    differs in some layer, the tokens whose sets agree but a kept flag
    differs, and the (token, layer) pairs whose sets differ."""
    agree = torch.ones(keys_a[0].shape[:-1], dtype=torch.bool,
                       device=keys_a[0].device)
    set_flip = torch.zeros_like(agree)
    n_layer_flips = 0
    for ka, kb in zip(keys_a, keys_b):
        same_set = ((ka // 2) == (kb // 2)).all(-1)
        set_flip |= ~same_set
        n_layer_flips += int((~same_set).sum())
        agree &= (ka == kb).all(-1)
    return (agree, int(set_flip.sum()),
            int((~agree & ~set_flip).sum()), n_layer_flips)


def _scored_keys(mods, routes, cfg, b, sl):
    return [_route_keys(mods, r, cfg.moe).reshape(b, sl, -1) for r in routes]


def _held_rows(torch, got, want, agree, what, kind):
    """Max token row rel of ``got`` vs ``want`` over the rows that
    ``agree``, and over all rows; fails if they are under the
    ``MOE_MIN_HELD[kind]`` share of the tokens."""
    rel = _row_rel(got, want)
    share = float(agree.float().mean())
    need = MOE_MIN_HELD[kind]
    check(share >= need, f"{what}: only {share:.1%} of the tokens route "
          f"alike in every layer (need {need:.0%})")
    return float(rel[agree].max()), float(rel.max()), share


def _predict_routed(mods, model, params, batch):
    routes = []
    with _routing(mods, routes):
        logits = model.predict(params, batch)
    return logits, routes


def _forward_f32_streamed(torch, mods, model, params, tokens):
    """Logits of ``model`` (an f32 config) on an f32 copy of the bf16
    ``params``, made one layer at a time, so the copy of the stack is never
    held whole (8 Mixtral layers, or llama-3.2-vision-11b whole, in f32
    would not fit the card beside the bf16 params).  A model with cross
    layers runs each after its group, over the stub image in f32."""
    top = {k: mods.tree_map(lambda t: t.float(), params[k])
           for k in ("embedding", "final_norm")}
    x = model._embed(top, tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    every = model.cfg.cross_attn_every
    if model.n_cross:
        image = model.stub_image_embeds(tokens.shape[0], torch.float32,
                                        device=tokens.device)
    for i in range(model.cfg.num_layers):
        lp = mods.tree_map(lambda t: t[i].float(), params["layers"])
        x, _ = model._layer_apply(lp, x, positions, None,
                                  model.cfg.sliding_window)
        del lp
        if model.n_cross and (i + 1) % every == 0:
            cp = mods.tree_map(lambda t: t[(i + 1) // every - 1].float(),
                               params["cross_layers"])
            x = model._cross_apply(cp, x, image)
    x = mods.layers.make_norm(model.cfg)[1](top["final_norm"], x)
    return model._unembed(top, x)


def _mixtral_layers(torch, fa, mods, model_p, model_x, params, tokens):
    """Teacher forced in bf16: each layer run under pallas and under xla on
    the xla path's input to it; the max token row rel of the two outputs
    over the tokens whose (expert, kept) pairs agree in that layer, and
    that share, per layer; and layer 0 under flash with the causal mask
    dropped against xla, over the same kind of rows."""
    b, sl = tokens.shape
    moe = model_x.cfg.moe
    positions = torch.arange(sl, dtype=torch.int32, device=tokens.device)
    window = model_x.cfg.sliding_window
    x = model_x._embed(params, tokens)
    rels, shares, fault = [], [], float("nan")

    def layer(model, lp, x):
        routes = []
        with _routing(mods, routes):
            out, _ = model._layer_apply(lp, x, positions, None, window)
        return out, _route_keys(mods, routes[0], moe).reshape(b, sl, -1)

    for i in range(model_x.cfg.num_layers):
        lp = mods.tree_map(lambda t: t[i], params["layers"])
        want, keys_x = layer(model_x, lp, x)
        got, keys_p = layer(model_p, lp, x)
        agree = (keys_p == keys_x).all(-1)
        rels.append(float(_row_rel(got, want)[agree].max()))
        shares.append(float(agree.float().mean()))
        if i == 0:
            with _no_causal(fa):
                bad, keys_f = layer(model_p, lp, x)
            agree_f = (keys_f == keys_x).all(-1)
            fault = float(_row_rel(bad, want)[agree_f].max()) \
                if bool(agree_f.any()) else float("inf")
            del bad
        x = want
        del got, lp
    return rels, shares, fault


def _moe_cfg(mods, arch, reduce):
    """The scoring config at its depth cut and the stream length."""
    cfg = mods.get_config(arch)
    if reduce:
        return cfg.reduced(), 96
    return dataclasses.replace(cfg, num_layers=MOE_LAYERS[arch]), 4096


def phase_score_mixtral(torch, fa, mods, *, reduce=False, device="cuda"):
    """Mixtral-8x22B at full width, 8 of 56 layers (bf16), scored on the
    two 4,096-token streams under ``attn_impl="pallas"`` — the flash
    kernel with its 4,096-key window, one launch per layer, each held
    against the plain version on its own inputs — against
    ``attn_impl="xla"``: the losses; the logits rows of the tokens that
    route alike in every layer (the rest are counted); and the same on an
    f32 copy of the params, streamed a layer at a time.  Flash with the
    causal mask dropped must fail the held check."""
    cfg, seq = _moe_cfg(mods, "mixtral_8x22b", reduce)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model_p = mods.build_model(dataclasses.replace(cfg, attn_impl="pallas"))
    model_x = mods.build_model(dataclasses.replace(cfg, attn_impl="xla"))
    params = model_p.init(torch.Generator(device=device).manual_seed(0))
    batch = _score_batch(torch, mods, cfg.vocab_size, seq, device)
    b = batch["tokens"].shape[0]
    calls = []
    with torch.inference_mode():
        with _recording(fa, calls):
            fa.LAUNCHES = 0
            loss_p = float(model_p.loss(params, batch)[0])
            launches = fa.LAUNCHES
        loss_p2, t_p = _timed_loss(torch, model_p, params, batch, device)
        loss_x, t_x = _timed_loss(torch, model_x, params, batch, device)
        call_rel = _hold_path_calls(torch, fa, calls)
        shapes = sorted({(tuple(c[0].shape), tuple(c[1].shape), c[3], c[4])
                         for c in calls})
        n_calls = len(calls)
        del calls

        logits_x, routes_x = _predict_routed(mods, model_x, params, batch)
        keys_x = _scored_keys(mods, routes_x, cfg, b, seq)
        logits_p, routes_p = _predict_routed(mods, model_p, params, batch)
        agree, set_flips, drop_flips, layer_flips = _agreement(
            torch, _scored_keys(mods, routes_p, cfg, b, seq), keys_x)
        drops = _dropped(mods, routes_x, cfg.moe)
        held, every, share = _held_rows(torch, logits_p, logits_x, agree,
                                        "bf16 logits, pallas vs xla",
                                        "bf16")
        del logits_p
        layer_rel, layer_share, fault_layer = _mixtral_layers(
            torch, fa, mods, model_p, model_x, params, batch["tokens"])
        with _no_causal(fa):
            logits_f, routes_f = _predict_routed(mods, model_p, params,
                                                 batch)
        agree_f = _agreement(torch, _scored_keys(mods, routes_f, cfg, b,
                                                 seq), keys_x)[0]
        fault_rel = float(_row_rel(logits_f, logits_x)[agree_f].max()) \
            if bool(agree_f.any()) else float("inf")
        fault_share = float(agree_f.float().mean())
        del logits_f, logits_x
        if device == "cuda":
            torch.cuda.empty_cache()

        # an f32 copy: pallas (the f32 flash route) vs xla
        m32_p, m32_x = (mods.build_model(dataclasses.replace(
            cfg, dtype="float32", attn_impl=impl)) for impl in ("pallas",
                                                                "xla"))
        routes32_x, routes32_p = [], []
        with _routing(mods, routes32_x):
            logits_x = _forward_f32_streamed(torch, mods, m32_x, params,
                                             batch["tokens"])
        with _routing(mods, routes32_p):
            logits_p = _forward_f32_streamed(torch, mods, m32_p, params,
                                             batch["tokens"])
        agree32, set32, drop32, _ = _agreement(
            torch, _scored_keys(mods, routes32_p, cfg, b, seq),
            _scored_keys(mods, routes32_x, cfg, b, seq))
        f32_held, f32_every, _ = _held_rows(torch, logits_p, logits_x,
                                            agree32, "f32 logits", "f32")
        del logits_p, logits_x
    rel = abs(loss_p - loss_x) / abs(loss_x)
    n_tok = agree.numel()
    print(f"[score] {cfg.name}, {cfg.num_layers} of "
          f"{mods.get_config('mixtral_8x22b').num_layers} layers, loss on 2 "
          f"x {seq} tokens, bf16: pallas {loss_p:.6f} ({t_p:.1f} ms, second "
          f"call), xla {loss_x:.6f} ({t_x:.1f} ms); rel diff {rel:.2e} (rtol "
          f"{SCORE_LOSS_RTOL:.0e}); flash launches {launches} at {shapes}")
    print(f"[score] each flash call on the path vs plain: max row rel "
          f"{call_rel:.3e} over {n_calls} calls (limit "
          f"{BF16_ROW_RTOL['flash']:.0e})")
    print(f"[score] routing, pallas vs xla, bf16 (the xla path drops "
          f"{drops} (token, expert) pairs at capacity factor "
          f"{cfg.moe.capacity_factor}): {set_flips} of {n_tok} "
          f"tokens change their expert set in some layer ({layer_flips} "
          f"(token, layer) pairs), {drop_flips} more keep their sets but "
          f"not the same pairs; held: the {share:.1%} that route alike in "
          f"every layer, logits max token row rel {held:.3e} (limit "
          f"{SCORE_LOGIT_ROW_RTOL:.0e}); every token, not held: {every:.3e}")
    print(f"[score] each layer's bf16 output on the xla path's input, "
          f"pallas vs xla, on the tokens that route alike in that layer: "
          f"max token row rel by layer " + ", ".join(
              f"{r:.3e}" for r in layer_rel) + f" (limit "
          f"{MOE_LAYER_ROW_RTOL:.1e}; held {min(layer_share):.1%}-"
          f"{max(layer_share):.1%} of the tokens), beside the bf16 logits' "
          f"{held:.3e}; planted fault 'causal mask dropped' on layer 0: "
          f"{fault_layer:.3e}")
    print(f"[score] f32 copy of the params, pallas vs xla: {set32} tokens "
          f"change their expert set, {drop32} their kept pairs; held rows "
          f"max token row rel {f32_held:.3e} (limit "
          f"{MOE_F32_ROW_RTOL:.0e}); every token {f32_every:.3e}")
    print(f"[control] mixtral score, planted fault 'causal mask dropped': "
          f"{fault_share:.1%} of the tokens route alike, their logits max "
          f"token row rel {fault_rel:.3e}")
    check(loss_p2 == loss_p, "the pallas loss changed between calls")
    check(math.isfinite(loss_p) and rel <= SCORE_LOSS_RTOL,
          f"pallas loss {loss_p} vs xla {loss_x}: rel {rel:.2e}")
    check(math.isfinite(held) and held <= SCORE_LOGIT_ROW_RTOL,
          f"pallas logits vs xla on the held rows: {held:.3e}")
    check(math.isfinite(f32_held) and f32_held <= MOE_F32_ROW_RTOL,
          f"f32 logits, pallas vs xla on the held rows: {f32_held:.3e}")
    check(all(math.isfinite(r) and r <= MOE_LAYER_ROW_RTOL
              for r in layer_rel), f"a layer's bf16 output, pallas vs xla "
          f"on the held rows: {layer_rel}")
    check(not fault_layer <= MOE_LAYER_ROW_RTOL, f"the planted fault passes "
          f"the per-layer check ({fault_layer:.3e})")
    check(fault_share < MOE_MIN_HELD["bf16"]
          or fault_rel > SCORE_LOGIT_ROW_RTOL,
          f"the planted fault passes the held check ({fault_rel:.3e})")
    check(n_calls == cfg.num_layers, f"{n_calls} flash calls on the "
          f"scoring path, not one per layer ({cfg.num_layers})")
    if device == "cuda":
        check(launches == cfg.num_layers, f"the scoring forward launched "
              f"flash {launches} times, not {cfg.num_layers}")
        print(f"[score] peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return dict(launches=launches, loss_ms=t_p, xla_ms=t_x,
                call_rel=call_rel, logit_rel=held, set_flips=set_flips,
                tokens=n_tok, f32_logit_rel=f32_held, layer_rel=layer_rel)


def phase_score_deepseek_v2(torch, fa, mods, *, reduce=False,
                            device="cuda"):
    """DeepSeek-V2-236B at full width, 4 of 60 layers (bf16), scored on
    the two streams under both ``attn_impl``s: MLA runs ``sdpa`` under
    either, as in the reference, so flash launches 0 times; the losses and
    logits agree, and two calls give the same logits bitwise (the MoE
    combine sums in a fixed order, no atomics)."""
    cfg, seq = _moe_cfg(mods, "deepseek_v2_236b", reduce)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model_p = mods.build_model(dataclasses.replace(cfg, attn_impl="pallas"))
    model_x = mods.build_model(dataclasses.replace(cfg, attn_impl="xla"))
    params = model_p.init(torch.Generator(device=device).manual_seed(0))
    batch = _score_batch(torch, mods, cfg.vocab_size, seq, device)
    with torch.inference_mode():
        fa.LAUNCHES = 0
        loss_p = float(model_p.loss(params, batch)[0])
        launches = fa.LAUNCHES
        loss_p2, t_p = _timed_loss(torch, model_p, params, batch, device)
        loss_x, t_x = _timed_loss(torch, model_x, params, batch, device)
        first = model_p.predict(params, batch)
        same = bool(torch.equal(first, model_p.predict(params, batch)))
        logit_rel = _logit_row_rel(first, model_x.predict(params, batch))
        del first
    rel = abs(loss_p - loss_x) / abs(loss_x)
    print(f"[score] {cfg.name}, {cfg.num_layers} of "
          f"{mods.get_config('deepseek_v2_236b').num_layers} layers, loss on "
          f"2 x {seq} tokens, bf16: pallas {loss_p:.6f} ({t_p:.1f} ms, "
          f"second call), xla {loss_x:.6f} ({t_x:.1f} ms); rel diff "
          f"{rel:.2e}; logits max token row rel {logit_rel:.3e}; two calls "
          f"bitwise equal: {same}; flash launches {launches}")
    check(loss_p2 == loss_p and same, "the logits changed between calls")
    check(math.isfinite(loss_p) and rel <= SCORE_LOSS_RTOL,
          f"pallas loss {loss_p} vs xla {loss_x}: rel {rel:.2e}")
    check(math.isfinite(logit_rel) and logit_rel <= SCORE_LOGIT_ROW_RTOL,
          f"pallas logits vs xla: max token row rel {logit_rel:.3e}")
    check(launches == 0, f"MLA launched flash {launches} times")
    if device == "cuda":
        print(f"[score] peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return dict(launches=launches, loss_ms=t_p, xla_ms=t_x,
                logit_rel=logit_rel)


@contextlib.contextmanager
def _served_cfg(mods, layers, capacity_factor=None):
    """Within the block, the serve entry point's configs have ``layers``
    layers (the CLI has no depth flag, as in the reference) and, if given,
    the experts' ``capacity_factor``."""
    get = mods.serve.get_config

    def cut(arch):
        cfg = dataclasses.replace(get(arch), num_layers=layers)
        if capacity_factor is None:
            return cfg
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))

    mods.serve.get_config = cut
    try:
        yield
    finally:
        mods.serve.get_config = get


def _served_keys(torch, mods, routes, moe, b, lp, n_gen, layers):
    """Per layer, the (expert, kept) keys [B, Lp + n_gen - 1, k] of a
    served run's tokens: the prefill's call, then one call a step."""
    keys = []
    for i in range(layers):
        steps = [_route_keys(mods, routes[layers * (1 + j) + i], moe)
                 .reshape(b, 1, -1) for j in range(n_gen - 1)]
        keys.append(torch.cat([_route_keys(mods, routes[i], moe)
                               .reshape(b, lp, -1)] + steps, dim=1))
    return keys


def _dropped(mods, routes, moe):
    """(token, expert) pairs the capacity dropped, over the calls."""
    return sum(int((_route_keys(mods, r, moe) % 2 == 0).sum())
               for r in routes)


def _serve_moe(torch, mods, argv, layers, capacity_factor):
    """Serve at the depth cut with ``capacity_factor``, and hold the
    logits each token was chosen from against a teacher-forced forward
    over prompt + generated tokens, on the rows whose token routes alike in
    every layer in both runs.  Returns (result, held rel, every rel, held
    share, set flips, pairs dropped in either run, the held rel with the
    logits one step late)."""
    served, forced = [], []
    with _served_cfg(mods, layers, capacity_factor), \
            _routing(mods, served):
        res = mods.serve.run(argv)
    lp, (b, n_gen) = res.prompts.shape[1], res.tokens.shape
    with torch.inference_mode(), _routing(mods, forced):
        toks = torch.cat([res.prompts, res.tokens[:, :-1]], dim=1)
        want = mods.build_model(res.cfg).forward(res.params, toks)[0]
    moe = res.cfg.moe
    agree, set_flips, _, _ = _agreement(
        torch, _served_keys(torch, mods, served, moe, b, lp, n_gen,
                            res.cfg.num_layers),
        [_route_keys(mods, r, moe).reshape(b, lp + n_gen - 1, -1)
         for r in forced])
    rows = agree[:, lp - 1:]
    held, every, share = _held_rows(
        torch, res.logits, want[:, lp - 1:], rows,
        f"{res.cfg.name} served logits ({res.cfg.dtype})",
        "f32" if res.cfg.dtype == "float32" else "bf16")
    late = _row_rel(res.logits[:, 1:], want[:, lp - 1:-1])[rows[:, 1:]]
    drops = _dropped(mods, served, moe) + _dropped(mods, forced, moe)
    return res, held, every, share, set_flips, drops, float(late.max())


def phase_serve_moe(torch, mods, arch, *, reduce=False, device="cuda"):
    """Serve at the depth cut through ``launch/serve.py``'s ``run`` (batch
    4, prompt 2,048, 32 tokens, cache 4,096; for DeepSeek-V2 the decode
    steps run the absorbed MLA against the latent cache): timed and its
    peak memory read as configured; then, with the experts' capacity
    raised so that no call drops a pair (``MOE_SERVE_CAPACITY``), held
    against a teacher-forced forward in bf16 at the reference's 5e-2 and
    served in f32 at 2 layers (``--dtype float32``) at f32 rounding;
    logits one step late must fail both."""
    argv = ["--arch", arch, "--batch", "4", "--device", device]
    argv += (["--prompt-len", "40", "--gen", "6", "--cache-len", "64"]
             if reduce else ["--full", "--prompt-len", "2048", "--gen", "32",
                             "--cache-len", "4096"])
    layers = MOE_LAYERS[arch]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    routes = []
    with _served_cfg(mods, layers), _routing(mods, routes):
        res = mods.serve.run(argv)
    cfg = res.cfg
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else float("nan"))
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "served tokens out of the vocabulary")
    check(int(res.cache["pos"].max()) == res.prompts.shape[1]
          + res.tokens.shape[1] - 2, "the cache does not hold the last step")
    prefill_ms, decode_ms, cache_keys = res.prefill_ms, res.decode_ms, \
        sorted(res.cache)
    drops = _dropped(mods, routes, cfg.moe)
    del res, routes
    if device == "cuda":
        torch.cuda.empty_cache()
    cf = MOE_SERVE_CAPACITY[arch]
    res, held, every, share, flips, drops16, late = _serve_moe(
        torch, mods, argv, layers, cf)
    del res
    if device == "cuda":
        torch.cuda.empty_cache()
    f32_layers = min(layers, MOE_F32_SERVE_LAYERS)
    res, held32, every32, share32, flips32, drops32, late32 = _serve_moe(
        torch, mods, argv + ["--dtype", "float32"], f32_layers, cf)
    del res
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"[serve] {cfg.name}, {cfg.num_layers} layers, capacity factor "
          f"{cfg.moe.capacity_factor}: prefill {prefill_ms:.1f} ms, decode "
          f"{decode_ms:.2f} ms/token, peak memory {peak:.1f} GiB; cache "
          f"{cache_keys}; {drops} (token, expert) pairs dropped")
    print(f"[serve] {cfg.name} at capacity factor {cf} ({drops16} and "
          f"{drops32} pairs dropped): served logits vs the teacher-forced "
          f"forward, max token row rel on the rows that route alike: bf16 "
          f"{held:.3e} on {share:.1%} ({flips} tokens change their expert "
          f"set in some layer; limit {SERVE_LOGIT_ROW_RTOL:.0e}; every row, "
          f"not held: {every:.3e}); served in f32 at {f32_layers} layers "
          f"{held32:.3e} on {share32:.1%} ({flips32} set flips; limit "
          f"{MOE_F32_ROW_RTOL:.0e}; every row {every32:.3e})")
    print(f"[control] {cfg.name} serve, planted fault 'logits one step "
          f"late': bf16 {late:.3e}, f32 {late32:.3e}")
    check(drops16 == 0 and drops32 == 0, f"the capacity factor {cf} "
          f"dropped {drops16} and {drops32} pairs")
    check(math.isfinite(held) and held <= SERVE_LOGIT_ROW_RTOL,
          f"served logits vs the teacher-forced forward: {held:.3e}")
    check(math.isfinite(held32) and held32 <= MOE_F32_ROW_RTOL,
          f"f32 served logits vs the teacher-forced forward: {held32:.3e}")
    check(late > SERVE_LOGIT_ROW_RTOL and late32 > MOE_F32_ROW_RTOL,
          "the checks cannot see logits one step late")
    return dict(prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gib=peak,
                logit_rel=held, f32_logit_rel=held32, set_flips=flips,
                dropped=drops)


# ---------------------------------------------------------------------------
# slice 9: the rest of the zoo (Llama-3.2-11B-Vision: gated cross-attention
# over a stub image; MusicGen-Large: 4 codebooks, full MHA at head dim 64),
# both at full width and depth
# ---------------------------------------------------------------------------

ZOO = ("llama32_vision_11b", "musicgen_large")
# Scored on an f32 copy of the params, streamed a layer at a time (an f32
# copy of llama-3.2-vision-11b is 40.4 GB), pallas (the f32 flash route)
# against xla; and served in f32 against a teacher-forced f32 forward:
# only f32 rounding separates them.  llama-3.2-vision-11b serves in f32
# at 2 of its 8 groups (10 layers, 2 cross layers): whole it would be
# 40.4 GB of f32 params and two f32 passes over 8,316 tokens.
ZOO_F32_ROW_RTOL = 1e-4
ZOO_F32_SERVE_LAYERS = {"llama32_vision_11b": 10, "musicgen_large": None}


def _gate_draw(torch, params, device, seed=1):
    """The cross layers' gates drawn in [0.5, 1.5) from a seeded
    generator, in place: at their zero init tanh(0) * out hides the whole
    cross-attention from every check."""
    if "cross_layers" in params:
        gate = params["cross_layers"]["gate_cross"]
        g = torch.Generator(device=device).manual_seed(seed)
        gate.copy_(torch.rand(gate.shape, generator=g, device=device) + 0.5)
    return params


def _gated_serve(torch, mods):
    """Within the block, the served vlm's params get their gates drawn
    (``_gate_draw``) as ``serve.run`` makes them."""
    def make(init):
        def gated(self, gen, *, device=None):
            params = init(self, gen, device=device)
            return _gate_draw(torch, params, params["final_norm"]["scale"]
                              .device)
        return gated
    return _patched(mods.vlm.VisionLM, "init", make)


def _zoo_cfg(mods, arch, reduce):
    cfg = mods.get_config(arch)
    if reduce:
        return dataclasses.replace(cfg.reduced(), num_layers=4), 96
    return cfg, 4096


def phase_score_zoo(torch, fa, mods, arch, *, reduce=False, device="cuda"):
    """llama-3.2-vision-11b (group 4, D 128; 8 cross layers over the 1,601
    stub image tokens, gates drawn nonzero) or musicgen-large (MHA at D
    64, 4 codebooks a token) at full width and depth (bf16), scored on the
    two 4,096-token streams under ``attn_impl="pallas"`` — one flash
    launch per self layer (40, 48), each held against the plain version
    on its own inputs; cross-attention runs ``sdpa``, as in the reference
    — against ``attn_impl="xla"``: the losses, every token's logits in
    bf16 and on an f32 copy of the params streamed a layer at a time.
    Flash with the causal mask dropped must fail the bf16 logits check;
    for the vlm, the gates set back to zero must fail the f32 one (or the
    cross layers would not be seen)."""
    cfg, seq = _zoo_cfg(mods, arch, reduce)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model_p = mods.build_model(dataclasses.replace(cfg, attn_impl="pallas"))
    model_x = mods.build_model(dataclasses.replace(cfg, attn_impl="xla"))
    params = _gate_draw(torch, model_p.init(
        torch.Generator(device=device).manual_seed(0)), device)
    batch = _score_batch(torch, mods, cfg.vocab_size, seq, device,
                         cfg.num_audio_codebooks)
    calls = []
    with torch.inference_mode():
        with _recording(fa, calls):
            fa.LAUNCHES = 0
            loss_p = float(model_p.loss(params, batch)[0])
            launches = fa.LAUNCHES
        loss_p2, t_p = _timed_loss(torch, model_p, params, batch, device)
        loss_x, t_x = _timed_loss(torch, model_x, params, batch, device)
        call_rel = _hold_path_calls(torch, fa, calls)
        shapes = sorted({(tuple(c[0].shape), tuple(c[1].shape), c[3], c[4])
                         for c in calls})
        n_calls = len(calls)
        del calls
        logits_x = model_x.predict(params, batch)
        bf16_rel = _logit_row_rel(model_p.predict(params, batch), logits_x)
        with _no_causal(fa):
            fault_rel = _logit_row_rel(model_p.predict(params, batch),
                                       logits_x)
        del logits_x
        if device == "cuda":
            torch.cuda.empty_cache()
        m32_p, m32_x = (mods.build_model(dataclasses.replace(
            cfg, dtype="float32", attn_impl=impl)) for impl in ("pallas",
                                                                "xla"))
        logits_x = _forward_f32_streamed(torch, mods, m32_x, params,
                                         batch["tokens"])
        f32_rel = _logit_row_rel(_forward_f32_streamed(
            torch, mods, m32_p, params, batch["tokens"]), logits_x)
        gate_rel = None
        if model_p.n_cross:
            # the stub image is small (0.02 N(0, 1)-like), so what the
            # cross layers add is held at f32 rounding, not bf16's
            cross = dict(params["cross_layers"])
            cross["gate_cross"] = torch.zeros_like(cross["gate_cross"])
            gate_rel = _logit_row_rel(_forward_f32_streamed(
                torch, mods, m32_p, dict(params, cross_layers=cross),
                batch["tokens"]), logits_x)
        del logits_x
    rel = abs(loss_p - loss_x) / abs(loss_x)
    n_tok = batch["tokens"].shape[0] * seq
    print(f"[score] {cfg.name}, {cfg.num_layers} layers"
          + (f" + {model_p.n_cross} cross layers over "
             f"{cfg.num_image_tokens} stub image tokens" if model_p.n_cross
             else f", {cfg.num_audio_codebooks} codebooks a token")
          + f", loss on 2 x {seq} tokens, bf16: pallas {loss_p:.6f} "
          f"({t_p:.1f} ms, second call; {n_tok / t_p * 1e3:.0f} tokens/s), "
          f"xla {loss_x:.6f} ({t_x:.1f} ms); rel diff {rel:.2e} (rtol "
          f"{SCORE_LOSS_RTOL:.0e}); flash launches {launches} at {shapes}")
    print(f"[score] each flash call on the path vs plain: max row rel "
          f"{call_rel:.3e} over {n_calls} calls (limit "
          f"{BF16_ROW_RTOL['flash']:.0e}); logits, pallas vs xla, max token "
          f"row rel: bf16 {bf16_rel:.3e} (limit {SCORE_LOGIT_ROW_RTOL:.0e}), "
          f"f32 copy {f32_rel:.3e} (limit {ZOO_F32_ROW_RTOL:.0e})")
    print(f"[control] {cfg.name} score, planted fault 'causal mask "
          f"dropped': bf16 logits max token row rel {fault_rel:.3e}"
          + (f"; gates set back to zero: f32 logits {gate_rel:.3e}"
             if gate_rel is not None else ""))
    check(loss_p2 == loss_p, "the pallas loss changed between calls")
    check(math.isfinite(loss_p) and rel <= SCORE_LOSS_RTOL,
          f"pallas loss {loss_p} vs xla {loss_x}: rel {rel:.2e}")
    check(math.isfinite(bf16_rel) and bf16_rel <= SCORE_LOGIT_ROW_RTOL,
          f"pallas logits vs xla: max token row rel {bf16_rel:.3e}")
    check(math.isfinite(f32_rel) and f32_rel <= ZOO_F32_ROW_RTOL,
          f"f32 logits, pallas vs xla: max token row rel {f32_rel:.3e}")
    check(fault_rel > SCORE_LOGIT_ROW_RTOL, f"the planted fault passes the "
          f"logits check ({fault_rel:.3e})")
    check(gate_rel is None or gate_rel > ZOO_F32_ROW_RTOL,
          f"zero gates pass the f32 logits check ({gate_rel}): the cross "
          f"layers are not seen")
    check(n_calls == cfg.num_layers, f"{n_calls} flash calls on the "
          f"scoring path, not one per self layer ({cfg.num_layers})")
    if device == "cuda":
        check(launches == cfg.num_layers, f"the scoring forward launched "
              f"flash {launches} times, not {cfg.num_layers}")
        print(f"[score] peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return dict(launches=launches, loss_ms=t_p, xla_ms=t_x,
                call_rel=call_rel, logit_rel=bf16_rel, f32_logit_rel=f32_rel)


def _image_kv_ms(torch, mods, res):
    """Device time of what every decode step recomputes in the vlm's cross
    layers: the image tokens' K and V projections, all cross layers (the
    reference keeps no cross K/V cache); (ms, its operation bound in ms)."""
    model = mods.build_model(res.cfg)
    b = res.tokens.shape[0]
    attn = res.params["cross_layers"]["attn"]
    with torch.inference_mode():
        img = model.stub_image_embeds(b, device="cuda")

        def kv():
            for j in range(model.n_cross):
                img @ attn["w_k"][j]
                img @ attn["w_v"][j]
        ms = device_ms(torch, kv, reps=3, trials=5)
    ops = 2 * img.numel() * (attn["w_k"].shape[-1] + attn["w_v"].shape[-1]) \
        * model.n_cross
    return ms, ops / H100_BF16_FLOPS * 1e3


def phase_serve_zoo(torch, mods, arch, *, reduce=False, device="cuda"):
    """Serve at full width and depth through ``launch/serve.py``'s ``run``
    (batch 4, prompt 2,048, 32 tokens, cache 4,096; the vlm's gates drawn
    nonzero, audio tokens [B, L, 4]): prefill ms, decode ms a token beside
    the weight-read bound, peak memory; the served logits held against a
    teacher-forced forward in bf16 at the reference's 5e-2 and served in
    f32 (``--dtype float32``; the vlm at 2 of its 8 groups) at f32
    rounding; logits one step late must fail both.  A few more decode
    steps run under ``torch.profiler``; for the vlm, the image K/V
    projections each decode step recomputes are also timed alone."""
    argv = ["--arch", arch, "--batch", "4", "--device", device]
    argv += (["--prompt-len", "40", "--gen", "6", "--cache-len", "64"]
             if reduce else ["--full", "--prompt-len", "2048", "--gen", "32",
                             "--cache-len", "4096"])
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with _gated_serve(torch, mods):
        res, rel, late = _served_vs_forced(torch, mods, argv)
        cfg = res.cfg
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device == "cuda" else float("nan"))
        check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size))
                   .all()), "served tokens out of the vocabulary")
        check(int(res.cache["pos"].max()) == res.prompts.shape[1]
              + res.tokens.shape[1] - 2, "the cache does not hold the last "
              "step")
        weights = sum(t.numel() * t.element_size()
                      for t in mods.tree_leaves(res.params))
        bound_ms = weights / H100_BYTES_PER_S * 1e3
        kv = (_image_kv_ms(torch, mods, res)
              if device == "cuda" and "cross_layers" in res.params else None)
        if device == "cuda":
            decode_profile(torch, mods, res)
        out = dict(prefill_ms=res.prefill_ms, decode_ms=res.decode_ms,
                   peak_gib=peak, logit_rel=rel, decode_bound_ms=bound_ms,
                   tokens_shape=list(res.tokens.shape))
        del res
        if device == "cuda":
            torch.cuda.empty_cache()
        layers = ZOO_F32_SERVE_LAYERS[arch]
        f32 = argv + ["--dtype", "float32"]
        with (_served_cfg(mods, layers) if layers and not reduce
              else contextlib.nullcontext()):
            _, rel32, late32 = _served_vs_forced(torch, mods, f32)
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"[serve] {cfg.name}: prefill {out['prefill_ms']:.1f} ms, decode "
          f"{out['decode_ms']:.2f} ms/token (weight-read bound "
          f"{bound_ms:.2f} ms: {weights / 1e9:.1f} GB at 3.35 TB/s), peak "
          f"memory {peak:.1f} GiB; tokens {out['tokens_shape']}; served "
          f"logits vs the teacher-forced forward, max token row rel: bf16 "
          f"{rel:.3e} (limit {SERVE_LOGIT_ROW_RTOL:.0e}), served in f32"
          + (f" at {layers} layers" if layers and not reduce else "")
          + f" {rel32:.3e} (limit {ZOO_F32_ROW_RTOL:.0e})")
    if kv is not None:
        out["image_kv_ms"], out["image_kv_bound_ms"] = kv
        print(f"[serve] {cfg.name} decode: the image K/V projections of the "
              f"cross layers, recomputed every step, take {kv[0]:.3f} ms "
              f"alone ({kv[0] / out['decode_ms']:.1%} of a token's "
              f"{out['decode_ms']:.2f} ms; operation bound {kv[1]:.3f} ms)")
    print(f"[control] {cfg.name} serve, planted fault 'logits one step "
          f"late': bf16 {late:.3e}, f32 {late32:.3e}")
    check(math.isfinite(rel) and rel <= SERVE_LOGIT_ROW_RTOL,
          f"served logits vs the teacher-forced forward: {rel:.3e}")
    check(math.isfinite(rel32) and rel32 <= ZOO_F32_ROW_RTOL,
          f"f32 served logits vs the teacher-forced forward: {rel32:.3e}")
    check(late > SERVE_LOGIT_ROW_RTOL and late32 > ZOO_F32_ROW_RTOL,
          "the checks cannot see logits one step late")
    out["f32_logit_rel"] = rel32
    return out


# ---------------------------------------------------------------------------
# slice 10: the SPMD layer — DTensor state on a world-1 NCCL mesh, the
# expert-parallel MoE, and the dry run on fake production meshes
# ---------------------------------------------------------------------------

# the dry run's production-mesh cases: (arch, shape, mesh, moe impl)
# (arch, shape, mesh, moe impl, levers); yi-6b's train_4k runs twice, the
# second time without activation checkpointing
DRYRUN_CASES = (("yi_6b", "train_4k", "single_pod", "gather", ()),
                ("yi_6b", "train_4k", "single_pod", "gather", ("no_remat",)),
                ("yi_6b", "train_4k", "multi_pod", "gather", ()),
                ("mixtral_8x22b", "train_4k", "single_pod", "ep", ()),
                ("llama32_vision_11b", "decode_32k", "single_pod", "gather",
                 ()))
DRYRUN_TIMEOUT_S = 600
# π of the two rounds: the same two cohorts twice, so the second round's
# Eq. 8 applies the gradients the first one buffered
SPMD_MASKS = ([1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0])
SPMD_MOE_LAYERS = 2
# the server-Adam rounds on the mesh, cut for time (12 of mamba2's 48)
SPMD_ADAM_LAYERS = 12
# EP against gather: the JAX package's own limits (tests/test_moe_ep.py)
EP_ROW_RTOL, EP_AUX_ATOL = 1e-4, 1e-5


def start_dryrun(out_dir):
    """Each production-mesh case in its own process (the fake process
    group cannot share a process with NCCL's), all at once, off the card."""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape, mesh, impl, opts in DRYRUN_CASES:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--moe-impl", impl,
               "--out", out_dir, "--tag", _dryrun_tag(opts)]
        for lever in opts:
            cmd += ["--opt", lever]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True,
                                       env=env),
                      (arch, shape, mesh, impl, opts)))
    return procs


def _dryrun_tag(opts):
    return "_".join(("chip",) + tuple(opts))


def finish_dryrun(procs, out_dir, smi, t_start):
    """Wait for the dry-run processes (killing any left on a failure) and
    print each record on one line."""
    recs = []
    try:
        for proc, (arch, shape, mesh, impl, opts) in procs:
            left = max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter()
                                                 - t_start))
            try:
                _, err = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                check(False, f"dry run {arch} {shape} {mesh} took more than "
                      f"{DRYRUN_TIMEOUT_S} s")
            check(proc.returncode == 0, f"dry run {arch} {shape} {mesh} "
                  f"failed:\n{err[-3000:]}")
            with open(os.path.join(out_dir, f"{_dryrun_tag(opts)}_{arch}_"
                                   f"{shape}_{mesh.split('_')[0]}.json")) as f:
                rec = json.load(f)
            mem = rec.get("memory", {})
            check(rec["status"] == "ok" and rec["flops"] > 0
                  and mem["peak_bytes"] >= mem["argument_bytes"]
                  and mem["temp_bytes"] >= 0,
                  f"dry run {arch} {shape} {mesh}: {rec.get('error')}")
            coll = rec["collectives"]["bytes_by_kind"]
            rf = rec["roofline"]
            print(f"[dryrun] {arch} {shape} {mesh} (moe {impl}"
                  f"{''.join(', ' + o for o in opts)}), "
                  f"{rec['n_devices']} ranks, one rank: args "
                  f"{mem['argument_bytes']} B (params "
                  f"{mem['param_bytes']} B), peak {mem['peak_bytes']} B "
                  f"({mem['peak_bytes'] / 2**30:.2f} GiB), temp "
                  f"{mem['temp_bytes']} B, FLOPs "
                  f"{rec['flops']:.4e}, bytes accessed "
                  f"{rec['bytes_accessed']:.4e}, collectives "
                  f"{json.dumps(coll)}; roofline on H100 SXM5 rates: compute "
                  f"{rf['compute_s']:.4e} s, memory {rf['memory_s']:.4e} s, "
                  f"collective {rf['collective_s']:.4e} s ({rf['dominant']}); "
                  f"{rec['total_s']} s on the host [{smi}]")
            recs.append(rec)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return recs


def _nccl_world(torch):
    """A process group of one rank on NCCL (any free port on localhost)."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    return dist


def _last_eq8(agg):
    """Wrap Eq. 8's flat entry point to keep a host copy of the inputs of
    the last launch made while ``last["armed"]`` is set (the launch count
    stays the wrapper's own).  On the host, so that the copy (9.4 GB of
    f32 at mamba2's full size) is no part of the card's peak memory."""
    last = {"armed": False}
    orig = agg.stale_aggregate_flat

    def recording(params, buffers, mask, *, beta):
        if params.is_cuda and last["armed"]:
            last["args"] = (params.cpu(), buffers.cpu(), mask.cpu(),
                            float(beta))
        return orig(params, buffers, mask, beta=beta)

    agg.stale_aggregate_flat = recording
    return last, orig


def hold_eq8_spmd(torch, agg, args):
    """Eq. 8 against its plain version on the mesh path's own last launch;
    the check must reject the plain version with one arriving cohort's
    weight dropped.  Timed once beside the plain version and the bound."""
    p, buf, mask = (x.cuda() for x in args[:3])
    beta = args[3]
    n, c = int(p.shape[0]), int(buf.shape[0])
    got = agg.stale_aggregate_flat(p, buf, mask, beta=beta)
    want = agg.stale_aggregate_plain(p, buf, mask, beta=beta)
    tol = 1e-6 * (1.0 + float(p.abs().max()))
    err = float((got - want).abs().max())
    check(math.isfinite(err) and err <= tol,
          f"spmd Eq. 8 at N={n} C={c}: {err} > {tol}")
    bad = mask.clone()
    bad[int(torch.nonzero(mask)[0])] = 0.0
    fault = float((got - agg.stale_aggregate_plain(p, buf, bad, beta=beta))
                  .abs().max())
    check(fault > tol, f"spmd Eq. 8: the check accepts a planted fault "
          f"({fault} <= {tol})")
    t_kernel = device_ms(torch, lambda: agg.stale_aggregate_flat(
        p, buf, mask, beta=beta), reps=5, trials=5)
    t_plain = device_ms(torch, lambda: agg.stale_aggregate_plain(
        p, buf, mask, beta=beta), reps=2, trials=3)
    bound, by = _bound((c + 2) * n * 4 + c * 4, 2 * c * n + n,
                       H100_F32_FLOPS)
    return dict(n=n, c=c, max_abs_err=err, fault_err=fault, ms=t_kernel,
                plain_ms=t_plain, bound_ms=bound, bound_by=by)


def _last_adam(adam, largest=False):
    """Wrap the fused Adam launch (``fused_adam._update``, which the tree's
    mesh route runs on each local shard) to keep the last launch's inputs
    and outputs while ``last["armed"]`` is set (with ``largest``, those of
    the launch on the largest leaf): p, m, v, the scalars and the outputs
    by reference (the old and new state hold them anyway), the gradient,
    which the round frees, as a host copy."""
    last = {"armed": False}
    orig = adam._update

    def recording(p, m, v, g, scal, *, b1, b2, eps):
        out = orig(p, m, v, g, scal, b1=b1, b2=b2, eps=eps)
        if p.is_cuda and last["armed"] and not (
                largest and "args" in last
                and last["args"][0].numel() >= p.numel()):
            last.update(args=(p, m, v, g.cpu(), scal), out=out)
        return out

    adam._update = recording
    return last, orig


def hold_adam_spmd(torch, adam, last, what="spmd"):
    """The fused Adam kernel against its plain version on a path's own
    last launch (on the mesh, a local shard's p, m, v, g and [lr, bc1,
    bc2]); the plain version with the bias corrections dropped must be
    rejected.  Timed once beside the plain version and the bound."""
    p, m, v, g, scal = last["args"]
    g = g.cuda()
    want = adam.fused_adam_plain(p, m, v, g, scal, b1=ADAM_B1, b2=ADAM_B2,
                                 eps=ADAM_EPS)
    ok, err = adam_close(torch, last["out"], want)
    n = int(p.numel())
    check(ok, f"{what} fused Adam at N={n}: kernel vs its plain version "
          f"outside the limits (max abs p error {err:.3e})")
    no_bc = torch.stack([scal[0], torch.ones_like(scal[1]),
                         torch.ones_like(scal[2])])
    bad, fault_err = adam_close(torch, adam.fused_adam_plain(
        p, m, v, g, no_bc, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS), want)
    check(not bad, f"{what} fused Adam: the check accepts the planted "
          f"fault 'bias corrections dropped'")
    flat = [x.reshape(-1) for x in (p, m, v, g)]
    t_kernel = device_ms(torch, lambda: adam._update(
        *flat, scal, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS), reps=3, trials=5)
    t_plain = device_ms(torch, lambda: adam.fused_adam_plain(
        *flat, scal, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS), reps=1, trials=3)
    nbytes = n * (2 * p.element_size() + g.element_size() + 16)
    bound, by = _bound(nbytes, 14 * n, H100_F32_FLOPS)
    return dict(n=n, p_dtype=str(p.dtype).replace("torch.", ""),
                max_abs_err=err, fault_err=fault_err, ms=t_kernel,
                plain_ms=t_plain, bound_ms=bound, bound_by=by)


def _peak_base(torch, device):
    """Bytes allocated now, the peak counter reset (CUDA only)."""
    if device != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_above(torch, device, base):
    """GiB the peak rose above ``base`` since the reset."""
    if device != "cuda":
        return float("nan")
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def same_bits(torch, a, b):
    """Bitwise equality: the same dtype, shape and bit patterns (a NaN
    equals a NaN of the same bits, as ``torch.equal`` would not have it)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    view = as_int[a.element_size()]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def _alloc_site(frames):
    """The innermost frame of an allocation's Python stack in this
    repository's code, as "file:line function"."""
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" in name or name.endswith("chip_smoke.py"):
            short = name.split("src/")[-1] if "repro_torch" in name \
                else "chip_smoke.py"
            return f"{short}:{f.get('line')} {f.get('name')}"
    return "(no Python frame: autograd's device thread)" if not frames \
        else "(outside the repository's code)"


def memory_split(snapshot):
    """Replay the allocator's trace of one recorded round: (the most bytes
    allocated in the round live at once, {allocation site: its bytes live
    at that moment}).  Blocks allocated before the recording are not in
    the trace; their frees are skipped."""
    events = [e for trace in snapshot["device_traces"] for e in trace]
    live, total, peak, at = {}, 0, 0, -1
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            total += e["size"]
            if total > peak:
                peak, at = total, i
        elif e["action"] in ("free_requested", "free_completed"):
            total -= live.pop(e["addr"], 0)
    live = {}
    for e in events[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], _alloc_site(e.get("frames", [])))
        elif e["action"] in ("free_requested", "free_completed"):
            live.pop(e["addr"], None)
    sites = collections.Counter()
    for size, site in live.values():
        sites[site] += size
    return peak, dict(sites)


def _spmd_rounds(torch, mods, step, state, corpora, *, bsz, seq, device,
                 mesh=None, rules=None, on_last=None, count=None,
                 record=False, keep_first=True, base=0):
    """``SPMD_MASKS``' rounds from ``state``.  Returns (state, seconds a
    round, a copy of the buffers after the first round or None, extras):
    ``on_last()`` runs before the last round; ``count()`` (a launch
    counter) gives extras["launches"] a round; ``record`` takes an
    allocator snapshot of the last round on the card (extras["start_gib"]:
    allocated at its start above ``base`` bytes, extras["split"]:
    ``memory_split``)."""
    seconds, first, extras = [], None, {"launches": []}
    for k, m in enumerate(SPMD_MASKS):
        last = k == len(SPMD_MASKS) - 1
        batches = mods.train_e2e.round_batches(corpora, k, batch=bsz,
                                               seq=seq, device=device)
        mask = torch.tensor(m, dtype=torch.float32, device=device)
        if last and on_last is not None:
            on_last()
        recording = last and record and device == "cuda"
        if device == "cuda":
            torch.cuda.synchronize()
            if recording:
                extras["start_gib"] = (torch.cuda.memory_allocated()
                                       - base) / 2**30
                torch.cuda.memory._record_memory_history(
                    context="alloc", stacks="python", max_entries=4_000_000)
        before = count() if count else 0
        t0 = time.perf_counter()
        with (mods.sharding.use_mesh(mesh, rules) if mesh is not None
              else contextlib.nullcontext()):
            state, _ = step(state, batches, mask)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if count:
            extras["launches"].append(count() - before)
        if recording:
            snap = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            extras["split"] = memory_split(snap)
            del snap
        if first is None and keep_first:
            first = [(x.to_local() if hasattr(x, "to_local") else x).clone()
                     for x in mods.tree_leaves(state.buffers)]
    return state, seconds, first, extras


def _print_split(mesh_ex, plain_ex, smi, what=""):
    """The last round's allocations by site in both routes: each route's
    allocated bytes at the round's start and the most its allocations held
    at once, then the sites whose bytes at that moment differ most."""
    if "split" not in mesh_ex:
        return None
    (m_peak, m_sites), (p_peak, p_sites) = mesh_ex["split"], \
        plain_ex["split"]
    gib = 2.0 ** 30
    for name, ex, peak, sites in (("mesh", mesh_ex, m_peak, m_sites),
                                  ("plain", plain_ex, p_peak, p_sites)):
        top = sorted(sites.items(), key=lambda kv: -kv[1])[:4]
        print(f"[spmd] memory{what}, round 2 of the {name} route: "
              f"{ex['start_gib']:.2f} GiB allocated at its start above the "
              f"route's; its allocations peak at "
              f"{peak / gib:.2f} GiB, then held by " + "; ".join(
                  f"{site} {b / gib:.2f} GiB" for site, b in top)
              + f" [{smi}]")
    diff = {s: m_sites.get(s, 0) - p_sites.get(s, 0)
            for s in set(m_sites) | set(p_sites)}
    top = sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:5]
    print(f"[spmd] memory{what}, round 2, mesh less plain: at the start "
          f"{mesh_ex['start_gib'] - plain_ex['start_gib']:+.2f} GiB, at the "
          f"allocations' peak {(m_peak - p_peak) / gib:+.2f} GiB; by site: "
          + "; ".join(f"{site} {b / gib:+.3f} GiB" for site, b in top))
    return dict(start_gib=(mesh_ex["start_gib"], plain_ex["start_gib"]),
                round_peak_gib=(m_peak / gib, p_peak / gib),
                sites_gib={s: b / gib for s, b in top})


def phase_spmd_mamba(torch, agg, mods, mesh, smi, *, reduce=False,
                     device="cuda", adam=None):
    """mamba2-370m at full width and depth, ``train_e2e``'s settings (4
    cohorts, A 2, S 2, batch 4, seq 256, β-SGD through the fused Eq.-8
    path): 2 rounds with the state as DTensors placed by
    ``state_shardings`` on the mesh, then 2 rounds of the plain step from
    the same state and batches; params, buffers and staleness bitwise
    equal; Eq. 8 launched once a round on the mesh, its last launch held
    against the plain version; the allocator's trace of round 2 in both
    routes split by allocation site.  Then the same for the server Adam
    (``_spmd_adam``; ``adam`` the fused Adam module, taken from the port
    when not given)."""
    cfg = mods.get_config("mamba2_370m")
    cohorts, stale, bsz, seq = 4, 2, 4, 256
    if reduce:
        cfg, bsz, seq = cfg.reduced(), 2, 64
    e2e = mods.train_e2e
    model = mods.build_model(cfg)
    exp = e2e.experiment_cfg(cfg, staleness=stale, fused_agg=True)
    sgd = mods.make_optimizer("sgd")
    check(mods.semi_sync.uses_fused_eq8(sgd, exp), "the settings do not "
          "take the fused Eq.-8 path")
    rules = mods.specs.arch_rules(cfg, mesh)
    step = mods.semi_sync.make_semi_sync_step(model, exp, sgd, cohorts)
    corpora = e2e.cohort_corpora(cohorts, cfg.vocab_size)
    if device == "cuda":
        torch.cuda.empty_cache()
    base = _peak_base(torch, device)

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    with mods.sharding.use_mesh(mesh, rules):
        st_mesh = mods.semi_sync.init_state(model, gen(), sgd, cohorts,
                                            mesh=mesh, rules=rules)
    p0 = [x.to_local().cpu() for x in mods.tree_leaves(st_mesh.params)]
    last, orig = _last_eq8(agg)
    try:
        agg.LAUNCHES = 0
        st_mesh, mesh_s, first_mesh, mesh_ex = _spmd_rounds(
            torch, mods, step, st_mesh, corpora, bsz=bsz, seq=seq,
            device=device, mesh=mesh, rules=rules,
            on_last=lambda: last.update(armed=True), record=True, base=base)
        launches = agg.LAUNCHES
    finally:
        agg.stale_aggregate_flat = orig
    peak = _peak_above(torch, device, base)
    base = _peak_base(torch, device)
    st_plain = mods.semi_sync.init_state(model, gen(), sgd, cohorts)
    before = agg.LAUNCHES
    st_plain, plain_s, first_plain, plain_ex = _spmd_rounds(
        torch, mods, step, st_plain, corpora, bsz=bsz, seq=seq,
        device=device, record=True, base=base)
    plain_launches = agg.LAUNCHES - before
    peak_plain = _peak_above(torch, device, base)

    def local(x):
        return x.to_local() if hasattr(x, "to_local") else x

    # the first round's meta-gradients, finite, then the state after both
    # rounds (the first round's unclipped β-SGD step moves mamba2's params
    # far enough that round 2's meta-gradients go non-finite, in both
    # routes alike: bit patterns compared, non-finite elements counted).
    # Part of it was the port's: torch.logaddexp's second derivative read
    # 0 · inf = NaN where softplus's input fell below -88 (28,490,129
    # elements in 10 buffer leaves before ``layers.softplus``; at 8 layers
    # on the CPU the JAX package stayed finite on the same inputs,
    # ``scripts/mamba2_fused_agg_overflow.py``).  What is left at 48
    # layers (one layer's in_proj, conv, A, D, dt and pre-norm gradients,
    # and the embedding rows of the batch's tokens, in both refreshed
    # cohorts: 11,070,144 elements in 8 leaves) is not held against the
    # reference, which the CPU runs only to 8 layers at full width.
    for path, x, y in zip(mods.tree_paths(st_plain.buffers), first_mesh,
                          first_plain):
        check(bool(torch.isfinite(y).all()) and same_bits(torch, x, y),
              f"spmd: round 0's buffers {path}: the mesh route differs "
              f"from the plain step's, or they are not finite")
    del first_mesh, first_plain
    nonfinite = {}
    for what, a, b in (("params", st_mesh.params, st_plain.params),
                       ("buffers", st_mesh.buffers, st_plain.buffers)):
        for path, x, y in zip(mods.tree_paths(a), mods.tree_leaves(a),
                              mods.tree_leaves(b)):
            check(same_bits(torch, local(x), y), f"spmd: {what} {path} of "
                  f"the mesh route differ from the plain step's")
            bad = int((~torch.isfinite(y)).sum())
            if bad:
                nonfinite[f"{what}/{path}"] = bad
    check(same_bits(torch, local(st_mesh.staleness), st_plain.staleness),
          "spmd: staleness differs")
    check(not any(k.startswith("params/") for k in nonfinite),
          f"spmd: non-finite params {nonfinite}")
    moved = any(not torch.equal(local(x).cpu(), y) for x, y in zip(
        mods.tree_leaves(st_mesh.params), p0))
    check(moved, "spmd: two rounds left the params where they started")
    want = mods.specs.state_shardings(st_plain, mods.sharding.param_placements(
        st_plain.params, mesh, rules), mesh)
    check(all(tuple(x.placements) == tuple(pl) for x, pl in zip(
        mods.tree_leaves(st_mesh.buffers), mods.tree_leaves(want.buffers))),
        "spmd: the buffers left the placements state_shardings gives them")
    row = None
    if device == "cuda":
        check(launches == len(SPMD_MASKS) and plain_launches == launches,
              f"spmd: Eq. 8 launched {launches} times on the mesh and "
              f"{plain_launches} unsharded, not once a round")
        row = hold_eq8_spmd(torch, agg, last["args"])
    del st_mesh, st_plain, p0, last
    overhead = [m / p - 1.0 for m, p in zip(mesh_s, plain_s)]
    print(f"[spmd] {cfg.name}, {cohorts} cohorts, A 2, S {stale}, batch "
          f"{bsz}, seq {seq}, masks {list(SPMD_MASKS)}: mesh "
          f"{dict(mods.sharding.mesh_shape(mesh))} on "
          f"{torch.distributed.get_backend()}, DTensor state "
          f"s/round {', '.join(f'{s:.3f}' for s in mesh_s)}; plain step "
          f"{', '.join(f'{s:.3f}' for s in plain_s)}; DTensor overhead "
          f"{', '.join(f'{o:+.1%}' for o in overhead)}; params, buffers and "
          f"staleness bitwise equal (round 0's meta-gradients finite; after "
          f"round 1, bit patterns, non-finite elements in both: "
          f"{sum(nonfinite.values())} in {len(nonfinite)} leaves: "
          f"{nonfinite}); "
          f"Eq.-8 launches {launches} on the mesh "
          f"({plain_launches} unsharded); peak memory above each route's "
          f"start: mesh {peak:.2f} GiB, plain {peak_plain:.2f} GiB [{smi}]")
    if row:
        print(f"[spmd] Eq. 8 on the mesh path's last launch N={row['n']} "
              f"C={row['c']}: err {row['max_abs_err']:.3e}, planted fault "
              f"{row['fault_err']:.3e} rejected; kernel {row['ms']:.3f} ms, "
              f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} "
              f"ms [{smi}]")
    split = _print_split(mesh_ex, plain_ex, smi)
    if adam is None:
        from repro_torch.kernels import fused_adam as adam
    del model
    adam_res = _spmd_adam(torch, adam, mods, mesh, rules, cfg, corpora, gen,
                          smi, cohorts=cohorts, stale=stale, bsz=bsz,
                          seq=seq, device=device)
    return dict(launches=launches, mesh_s=mesh_s, plain_s=plain_s,
                peak_gib=peak, plain_peak_gib=peak_plain, row=row,
                split=split, adam=adam_res)


def _spmd_adam(torch, adam, mods, mesh, rules, cfg, corpora, gen, smi, *,
               cohorts, stale, bsz, seq, device):
    """``SPMD_MASKS``' two rounds of the step with the server Adam
    (``train_e2e``'s ``--server-opt adam`` settings: masked mean, clip 1.0,
    Adam at β), DTensor state on the mesh against the plain step: params,
    moments, t, buffers and staleness bitwise; the fused Adam kernel
    launched once a leaf a round in both routes (on the mesh on each
    leaf's local shard), the mesh route's last launch held against the
    plain version; round 2's allocations split by site in both routes.
    Round 1 applies round 0's meta-gradients (round 0's aggregate is the
    zero-initialised buffers).  Full width, depth cut to
    ``SPMD_ADAM_LAYERS`` of the 48 layers for time (the tree keeps its 12
    leaves, each stacked over the layers)."""
    cfg = dataclasses.replace(cfg, num_layers=min(cfg.num_layers,
                                                  SPMD_ADAM_LAYERS))
    model = mods.build_model(cfg)
    exp = mods.train_e2e.experiment_cfg(cfg, staleness=stale,
                                        fused_agg=False)
    opt = mods.make_optimizer("adam")
    step = mods.semi_sync.make_semi_sync_step(model, exp, opt, cohorts)
    kw = dict(bsz=bsz, seq=seq, device=device, keep_first=False,
              count=lambda: adam.LAUNCHES, record=True)
    if device == "cuda":
        torch.cuda.empty_cache()
    base = _peak_base(torch, device)
    with mods.sharding.use_mesh(mesh, rules):
        st_mesh = mods.semi_sync.init_state(model, gen(), opt, cohorts,
                                            mesh=mesh, rules=rules)
    last, orig = _last_adam(adam)
    try:
        st_mesh, mesh_s, _, mesh_ex = _spmd_rounds(
            torch, mods, step, st_mesh, corpora, mesh=mesh, rules=rules,
            on_last=lambda: last.update(armed=True), base=base, **kw)
    finally:
        adam._update = orig
    peak = _peak_above(torch, device, base)
    base = _peak_base(torch, device)
    st_plain = mods.semi_sync.init_state(model, gen(), opt, cohorts)
    st_plain, plain_s, _, plain_ex = _spmd_rounds(
        torch, mods, step, st_plain, corpora, base=base, **kw)
    peak_plain = _peak_above(torch, device, base)

    def local(x):
        return x.to_local() if hasattr(x, "to_local") else x

    # the update's outputs and the buffers (meta-gradients at the moved
    # params) bitwise equal and finite, as in the fused rounds
    nonfinite = 0
    for what, a, b in (("params", st_mesh.params, st_plain.params),
                       ("opt_state", st_mesh.opt_state, st_plain.opt_state),
                       ("buffers", st_mesh.buffers, st_plain.buffers)):
        for path, x, y in zip(mods.tree_paths(a), mods.tree_leaves(a),
                              mods.tree_leaves(b)):
            bad = int((~torch.isfinite(y.float())).sum())
            check(same_bits(torch, local(x), y) and not bad,
                  f"spmd adam: {what} {path} of the mesh route differ from "
                  f"the plain step's, or are not finite ({bad})")
            nonfinite += bad
    check(same_bits(torch, local(st_mesh.staleness), st_plain.staleness),
          "spmd adam: staleness differs")
    n_leaves = len(mods.tree_leaves(st_plain.params))
    row = None
    if device == "cuda":
        want = [n_leaves] * len(SPMD_MASKS)
        check(mesh_ex["launches"] == want and plain_ex["launches"] == want,
              f"spmd adam: fused Adam launches a round {mesh_ex['launches']}"
              f" on the mesh, {plain_ex['launches']} unsharded, not "
              f"{n_leaves} (one a leaf)")
        row = hold_adam_spmd(torch, adam, last)
    t = int(local(st_mesh.opt_state["t"]))
    del st_mesh, st_plain, last
    print(f"[spmd] {cfg.name} at {cfg.num_layers} layers, server Adam "
          f"(clip {exp.train.grad_clip}, lr β {exp.fl.beta}), masks "
          f"{list(SPMD_MASKS)}: DTensor state "
          f"s/round {', '.join(f'{s:.3f}' for s in mesh_s)}; plain step "
          f"{', '.join(f'{s:.3f}' for s in plain_s)}; params, m, v, t "
          f"({t}), buffers and staleness bitwise equal and finite "
          f"({nonfinite} non-finite elements); fused Adam launches "
          f"a round {mesh_ex['launches']} on the mesh (local shards), "
          f"{plain_ex['launches']} unsharded; peak memory above each "
          f"route's start: mesh {peak:.2f} GiB, plain {peak_plain:.2f} GiB "
          f"[{smi}]")
    if row:
        print(f"[spmd] fused Adam on the mesh path's last launch N="
              f"{row['n']} (p {row['p_dtype']}): max abs p err "
              f"{row['max_abs_err']:.3e}, planted fault 'bias corrections "
              f"dropped' {row['fault_err']:.3e} rejected; kernel "
              f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}) [{smi}]")
    split = _print_split(mesh_ex, plain_ex, smi, " (server Adam)")
    return dict(layers=cfg.num_layers, split=split,
                launches=sum(mesh_ex["launches"]),
                launches_a_round=mesh_ex["launches"], mesh_s=mesh_s,
                plain_s=plain_s, peak_gib=peak, plain_peak_gib=peak_plain,
                row=row)


def phase_spmd_mixtral(torch, fa, mods, mesh, smi, *, reduce=False,
                       device="cuda"):
    """Mixtral-8x22B at full width, 2 of 56 layers, f32,
    ``attn_impl="pallas"``, dropless (capacity factor E / k): logits and
    aux with ``moe_impl="ep"`` on the mesh against ``"gather"`` unsharded;
    each flash launch of the mesh run held against the plain version."""
    base = mods.get_config("mixtral_8x22b")
    seq = 4096
    if reduce:
        base, seq = base.reduced(), 96
    cfg = dataclasses.replace(
        base, num_layers=SPMD_MOE_LAYERS if not reduce else base.num_layers,
        dtype="float32", attn_impl="pallas",
        moe=dataclasses.replace(
            base.moe, capacity_factor=MOE_SERVE_CAPACITY["mixtral_8x22b"]))
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    m_ep = mods.build_model(cfg, moe_impl="ep")
    m_g = mods.build_model(cfg, moe_impl="gather")
    params = m_g.init(torch.Generator(device=device).manual_seed(0))
    batch = _score_batch(torch, mods, cfg.vocab_size, seq, device)
    rules = mods.specs.arch_rules(cfg, mesh)
    calls = []
    with torch.inference_mode():
        with mods.sharding.use_mesh(mesh, rules):
            dparams = mods.sharding.param_shardings(params, mesh, rules)
            tokens = mods.sharding.distribute(
                batch["tokens"], mods.sharding.placements_for(
                    ("batch", None), mesh, rules), mesh)
            with _recording(fa, calls):
                fa.LAUNCHES = 0
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits_ep, _, aux_ep = m_ep.forward(dparams, tokens)
                logits_ep, aux_ep = (x.full_tensor() for x in (logits_ep,
                                                                aux_ep))
                if device == "cuda":
                    torch.cuda.synchronize()
                t_ep = time.perf_counter() - t0
                launches = fa.LAUNCHES
        t0 = time.perf_counter()
        logits_g, _, aux_g = m_g.forward(params, batch["tokens"])
        if device == "cuda":
            torch.cuda.synchronize()
        t_g = time.perf_counter() - t0
        rel = _logit_row_rel(logits_ep, logits_g)
        aux_err = abs(float(aux_ep) - float(aux_g))
        call_rel = _hold_path_calls(torch, fa, calls)
        n_calls = len(calls)
        del calls, logits_ep, logits_g
    check(math.isfinite(rel) and rel <= EP_ROW_RTOL,
          f"EP vs gather logits: max token row rel {rel:.3e}")
    check(aux_err <= EP_AUX_ATOL, f"EP vs gather aux: {aux_err:.3e}")
    check(n_calls == cfg.num_layers, f"{n_calls} flash calls on the EP "
          f"path, not one a layer ({cfg.num_layers})")
    if device == "cuda":
        check(launches == cfg.num_layers, f"the EP forward launched flash "
              f"{launches} times, not {cfg.num_layers}")
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else float("nan"))
    print(f"[spmd] {cfg.name}, {cfg.num_layers} layers, f32, pallas, "
          f"capacity factor {cfg.moe.capacity_factor} (dropless), 2 x {seq} "
          f"tokens: moe_impl ep on the mesh vs gather unsharded: logits max "
          f"token row rel {rel:.3e} (limit {EP_ROW_RTOL:.0e}), aux |diff| "
          f"{aux_err:.3e} (limit {EP_AUX_ATOL:.0e}); forward {t_ep:.2f} s "
          f"(ep) vs {t_g:.2f} s (gather); flash launches {launches}, each "
          f"vs plain max row rel {call_rel:.3e}; peak memory {peak:.1f} GiB "
          f"[{smi}]")
    return dict(launches=launches, logit_rel=rel, aux_err=aux_err,
                call_rel=call_rel)


def phase_spmd(torch, agg, fa, adam, mods, smi):
    """Slice 10 on the card: the dry run's production-mesh cases
    (``DRYRUN_CASES``) start in their own processes; meanwhile, on a world-1
    NCCL mesh (pod 1, data 1, model 1), the sharded mamba2 step against the
    plain one, fused Eq. 8 and then the server Adam, and Mixtral's EP
    against gather."""
    out_dir = os.path.join(ROOT, "build", "dryrun")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = start_dryrun(out_dir)
    # a bitwise comparison needs the deterministic kernel where torch has
    # one (warn only where it has none)
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        dist = _nccl_world(torch)
        try:
            mesh = mods.mesh.make_host_mesh(1, 1, pods=1)
            mamba = timed("spmd: mamba2 step", phase_spmd_mamba, torch, agg,
                          mods, mesh, smi, adam=adam)
            mixtral = timed("spmd: mixtral ep", phase_spmd_mixtral, torch,
                            fa, mods, mesh, smi)
        finally:
            dist.destroy_process_group()
        dry = timed("spmd: dry run (wait)", finish_dryrun, procs, out_dir,
                    smi, t0)
    finally:
        torch.use_deterministic_algorithms(det)
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return dict(mamba=mamba, mixtral=mixtral, dryrun=dry)


def import_port():
    """The port's entry points, imported after the checks that need none."""
    from repro_torch.config import (ExperimentConfig, FLConfig,
                                    MobilityConfig, ScenarioConfig,
                                    TrainConfig)
    from repro_torch.configs import get_config
    from repro_torch.core import perfed, semi_sync
    from repro_torch.core.scheduler import (greedy_schedule,
                                            relative_frequencies)
    from repro_torch.data import partition_noniid, synthetic_mnist
    from repro_torch.data.synthetic import synthetic_lm_corpus
    from repro_torch.fl.engine import SimulationEngine
    from repro_torch.fl.simulation import run_simulation
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.stale_aggregate import masked_aggregate_tree
    from repro_torch import sharding
    from repro_torch.launch import mesh, serve, specs, train, train_e2e
    from repro_torch.models import build_model
    from repro_torch.models import audio, hybrid, layers, ssm, vlm
    from repro_torch.obs import Tracer, validate_rows
    from repro_torch.optim import clip_by_global_norm, make_optimizer
    from repro_torch.optim.optimizers import adam_update_plain
    from repro_torch.utils.metrics import read_metrics
    from repro_torch.utils.tree import (from_numpy_tree, tree_leaves, tree_map,
                                        tree_paths, tree_unflatten)
    return types.SimpleNamespace(**locals())


def timed(name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


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
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_adam as adam
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import stale_aggregate as agg

    t_start = time.perf_counter()
    smi = timed("environment", phase_environment, torch)
    ptxas = timed("build", phase_build, [agg, fa, da, ssd, adam])
    for kernel, info in ptxas["flash_attention.cu"].items():
        # a wgmma kernel that spills or serialises its wgmmas has lost its
        # design (reported only for a library built in this run)
        if "flash_wgmma_kernel" in kernel:
            check("C75" not in info and re.search(
                r"(?<!\d)0 bytes spill stores, 0 bytes spill loads", info),
                f"ptxas: {kernel}: {info}")
    mods = import_port()
    # the main path's shapes: mnist_dnn's N with the server's close (C = A
    # = 5), the engine's padded bucket (8) and the scale point (128); one
    # large ragged N; mamba2-370m's --fused-agg round (N of the whole
    # model, C = 4)
    rows = timed("kernel vs plain (Eq. 8)", phase_kernel_vs_plain, torch,
                 agg, [(79_510, 1), (79_510, 5), (79_510, 8),
                       (79_510, 128), (1_000_003, 16), (419_825_152, 4)],
                 flushed=[(79_510, 128), (1_000_003, 16)])
    torch.cuda.empty_cache()
    attn = timed("kernel vs plain (attention)", phase_attention_vs_plain,
                 torch, fa, da)
    check(attn[("flash", torch.bfloat16, FLASH_HYBRID_SHAPE)]["kernel_route"]
          == "wgmma-tma", "bf16 flash at D 256 left the wgmma route")
    ssd_rows = timed("kernel vs plain (SSD chunk)", phase_ssd_vs_plain,
                     torch, ssd)
    adam_rows = timed("kernel vs plain (fused Adam)", phase_adam_vs_plain,
                      torch, adam)
    timed("ops vs ref", phase_ops, torch, fa, ssd, adam, mods)
    torch.cuda.empty_cache()
    launches, seen = timed("main path (slice 1)", phase_main_path, torch,
                           agg, mods)
    timed("scale point", phase_scale, torch, agg, mods)
    timed("golden", phase_golden, torch, mods)
    mobile = timed("mobile edge", phase_mobile_edge, torch, agg, mods, smi)
    timed("serve", phase_serve, torch, fa, da, mods,
          ["--full", "--batch", "4", "--prompt-len", "2048", "--gen", "32",
           "--cache-len", "4096"])
    torch.cuda.empty_cache()
    timed("serve (CLI defaults)", mods.serve.main, ["--full"])
    torch.cuda.empty_cache()
    score_launches = timed("score", phase_score, torch, fa, da, mods)
    torch.cuda.empty_cache()
    ssd_launches = timed("score mamba2", phase_score_mamba, torch, ssd, mods)
    torch.cuda.empty_cache()
    timed("serve mamba2", phase_serve_mamba, torch, ssd, mods)
    torch.cuda.empty_cache()
    hybrid_score = timed("score recurrentgemma-2b", phase_score_hybrid, torch,
                         fa, mods)
    torch.cuda.empty_cache()
    timed("serve recurrentgemma-2b", phase_serve_hybrid, torch, mods)
    torch.cuda.empty_cache()
    dense = timed("dense remainder (2 layers each)", phase_dense_remainder,
                  torch, fa, mods)
    torch.cuda.empty_cache()
    mixtral = timed("score mixtral-8x22b (8 layers)", phase_score_mixtral,
                    torch, fa, mods)
    torch.cuda.empty_cache()
    deepseek = timed("score deepseek-v2-236b (4 layers)",
                     phase_score_deepseek_v2, torch, fa, mods)
    torch.cuda.empty_cache()
    for arch in MOE_LAYERS:
        timed(f"serve {arch} ({MOE_LAYERS[arch]} layers)", phase_serve_moe,
              torch, mods, arch)
        torch.cuda.empty_cache()
    zoo = {}
    for arch in ZOO:
        score = timed(f"score {arch}", phase_score_zoo, torch, fa, mods, arch)
        torch.cuda.empty_cache()
        zoo[arch] = dict(score=score, serve=timed(
            f"serve {arch}", phase_serve_zoo, torch, mods, arch))
        torch.cuda.empty_cache()
    adam_launches, *_ = timed("train mamba2", phase_train_mamba, torch, adam,
                              agg, mods)
    torch.cuda.empty_cache()
    # slice 13: the zoo's training path, counted from 0
    adam.LAUNCHES = agg.LAUNCHES = 0
    zoo_train = {}
    for arch, layers, cohorts, part, routes in ZOO_TRAIN:
        gc.collect()                    # earlier phases' reference cycles
        torch.cuda.empty_cache()
        print(f"[train zoo] allocated before {arch}: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        zoo_train[arch] = timed(f"train {arch} ({layers} layers)",
                                phase_train_zoo, torch, adam, agg, mods,
                                arch, layers, cohorts, part, routes, smi)
        torch.cuda.empty_cache()
    zoo_adam, zoo_eq8 = adam.LAUNCHES, agg.LAUNCHES
    agg.LAUNCHES = 0
    zoo_cpu = timed("zoo on the card vs the CPU", phase_zoo_vs_cpu, torch,
                    agg, mods)
    zoo_cpu_eq8 = agg.LAUNCHES
    torch.cuda.empty_cache()
    agg.LAUNCHES = 0
    examples = timed("examples", phase_examples, torch, agg, mods, smi)
    examples_eq8 = agg.LAUNCHES
    torch.cuda.empty_cache()
    spmd = timed("spmd (slice 10)", phase_spmd, torch, agg, fa, adam, mods,
                 smi)
    check("jax" not in sys.modules and not any(
        m == "repro" or m.startswith("repro.") for m in sys.modules),
        "the port pulled in JAX or the JAX package")
    print(f"[time] total {time.perf_counter() - t_start:.1f} s")

    # the Eq.-8 line reports the shape the main path launched most
    shape = max(seen, key=seen.get) if seen else (79_510, 5)
    row = rows.get(shape) or rows[(79_510, 5)]
    adam_row = dict(adam_rows[ADAM_CASES[0][0]])
    adam_shape = [adam_row.pop(k) for k in ("n", "p_dtype", "g_dtype")]
    print(json.dumps({"kernels": [
        {"name": "stale_aggregate_flat", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/stale_aggregate.cu",
         "replaces": "src/repro/kernels/stale_aggregate.py:50",
         "launches": launches, "shape": list(shape), "dtype": "float32",
         "ptxas": ptxas["stale_aggregate.cu"], **row,
         "mobile_edge": {
             "launches": mobile["launches"],
             "shapes": {f"{n}x{c}": k
                        for (n, c), k in sorted(mobile["shapes"].items())},
             "on_path_inputs": {f"{n}x{c}": r for (n, c), r
                                in sorted(mobile["holds"].items())}},
         "spmd": {
             "path": "mamba2-370m semi-sync step with DTensor state on a "
                     "world-1 NCCL mesh, 2 rounds, one launch a round on "
                     "the local shard through local_map",
             "launches": spmd["mamba"]["launches"],
             **(spmd["mamba"]["row"] or {})},
         "zoo_train": {
             "path": "train_e2e's rounds at full width, one --fused-agg "
                     "round each (recurrentgemma-2b, llama-3.2-vision-11b, "
                     "musicgen-large), each launch held against the plain "
                     "version on its own inputs",
             "launches": zoo_eq8,
             "holds": {arch: r["eq8"] for arch, r in zoo_train.items()
                       if r["eq8"]}},
         "zoo_vs_cpu": {
             "path": "2 fused semi-sync rounds of the reduced f32 "
                     "recurrentgemma, deepseek-v2 and musicgen, against "
                     "the CPU",
             "launches": zoo_cpu_eq8,
             "max_params_err_rel": {a: r["err"] for a, r in zoo_cpu.items()}},
         "examples": {
             "path": "repro_torch.examples' simulations at their own "
                     "settings",
             "launches": examples_eq8,
             "per_example": examples["per_example"]}},
        {"name": "fused_adam_flat", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_adam.cu",
         "replaces": "src/repro/kernels/fused_adam.py:36",
         "launches": adam_launches,
         "path": "server Adam of the semi-sync step, mamba2-370m, 3 rounds",
         "shape": [adam_shape[0]],
         "dtype": f"p {adam_shape[1]}, g {adam_shape[2]}, m/v float32",
         "library": "torch.optim.Adam(fused=True).step() on an f32 copy",
         **adam_row,
         "zoo_train": {
             "path": "server Adam rounds of train_e2e's loop at full "
                     "width, one launch a leaf a round, the largest "
                     "leaf's launch held against the plain version",
             "launches": zoo_adam,
             "per_arch": {arch: {"launches_a_round": r["adam_launches"],
                                 "largest_leaf_launch": r["adam"]}
                          for arch, r in zoo_train.items() if r["adam"]}},
         "spmd": {
             "path": f"mamba2-370m semi-sync step (full width, "
                     f"{spmd['mamba']['adam']['layers']} layers) with the "
                     f"server Adam and DTensor state on a world-1 NCCL "
                     f"mesh, 2 rounds, one launch a leaf a round on its "
                     f"local shard through local_map",
             "launches": spmd["mamba"]["adam"]["launches"],
             **(spmd["mamba"]["adam"]["row"] or {})}},
        {"name": "flash_attention_bhld", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:75",
         "launches": score_launches["flash"],
         "path": "yi-6b scoring forward, one launch per layer",
         "shape": list(FLASH_SCORE_SHAPE), "dtype": "bfloat16",
         **attn[("flash", torch.bfloat16, FLASH_SCORE_SHAPE)],
         "hybrid": {
             "path": "recurrentgemma-2b scoring forward, one launch per "
                     "attention block",
             "launches": hybrid_score["launches"],
             "shape": list(FLASH_HYBRID_SHAPE), "dtype": "bfloat16",
             "ptxas": _instance(ptxas["flash_attention.cu"],
                                "flash_wgmma_kernel", 256),
             **attn[("flash", torch.bfloat16, FLASH_HYBRID_SHAPE)],
             "float32": dict(
                 attn[("flash", torch.float32, FLASH_HYBRID_SHAPE)],
                 ptxas=_instance(ptxas["flash_attention.cu"],
                                 "flash_f32_kernel", 256))},
         "dense_remainder": {
             arch: {"launches": r["launches"], "head_dim": r["head_dim"]}
             for arch, r in dense.items()},
         "moe": {
             "path": "mixtral-8x22b scoring forward (8 of 56 layers), one "
                     "launch per layer; deepseek-v2-236b's MLA runs sdpa, "
                     "as in the JAX package",
             "launches": mixtral["launches"],
             "layer_row_rel": mixtral["layer_rel"],
             "deepseek_v2_launches": deepseek["launches"],
             "shape": list(FLASH_MOE_SHAPE), "dtype": "bfloat16",
             **attn[("flash", torch.bfloat16, FLASH_MOE_SHAPE)],
             "float32": attn[("flash", torch.float32, FLASH_MOE_SHAPE)]},
         "zoo": {
             arch: {"path": f"{arch} scoring forward (full depth), one "
                            f"launch per self layer; cross-attention runs "
                            f"sdpa, as in the JAX package",
                    "launches": zoo[arch]["score"]["launches"],
                    "shape": list(shape), "dtype": "bfloat16",
                    **attn[("flash", torch.bfloat16, shape)],
                    "float32": attn[("flash", torch.float32, shape)]}
             for arch, shape in FLASH_ZOO_SHAPES.items()},
         "spmd": {
             "path": "mixtral-8x22b forward (2 layers, f32, moe_impl ep) "
                     "on a world-1 NCCL mesh, the kernel on each rank's "
                     "head shard through sharding.map_local",
             "launches": spmd["mixtral"]["launches"],
             "max_row_rel_vs_plain": spmd["mixtral"]["call_rel"]}},
        {"name": "decode_attention_bhsd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:65",
         "launches": score_launches["decode"],
         "path": "kernel API only: no model calls it, as in the JAX "
                 "package",
         "shape": list(DECODE_SHAPE), "dtype": "bfloat16",
         **attn[("decode", torch.bfloat16)]},
        {"name": "ssd_chunk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:52",
         "launches": ssd_launches,
         "path": "mamba2-370m scoring forward, one launch per layer",
         "shape": list(SSD_SCORE_SHAPE), "dtype": "float32",
         "library": "none: no single PyTorch call computes it",
         "bound_ops": "j <= i pairs only; each product three TF32 "
                      "products (3xTF32)",
         "ptxas": ptxas["ssd_scan.cu"], **ssd_rows[SSD_SCORE_SHAPE]},
    ]}))
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
