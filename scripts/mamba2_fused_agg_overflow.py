#!/usr/bin/env python3
"""Does mamba2's ``--fused-agg`` step overflow in the JAX package too?

    PYTHONPATH=src python scripts/mamba2_fused_agg_overflow.py \
        [--layers 2 4] [--dtypes bfloat16 float32] [--carry] [--remat] \
        [--hvp-route autograd|func] [--logaddexp-softplus] [--norm-sweep] \
        [--out FILE]

On the card, two rounds of mamba2-370m's semi-synchronous step at
``train_e2e``'s ``--fused-agg`` settings (alpha 0.02, beta 0.5, no
clipping: beta-SGD through the fused Eq.-8 update; 4 cohorts, A 2, S 2,
batch 4, seq 256, the masks ``chip_smoke.SPMD_MASKS``) leave non-finite
elements in the second round's buffers.  This script runs both packages
on the CPU at full width (d_model 1,024, the full vocabulary) and a cut
depth: the reference's ``init_state`` under
``jax.threefry_partitionable(False)``, its state carried across to the
port as numpy, the same numpy batches (``train_e2e.round_batches``) and
masks into both, each package then stepping on its own state.  After
each round it prints, for each package, the non-finite elements of each
params and buffer leaf, the largest finite magnitude of the buffers, and
the port's largest error against the reference on the finite elements
(relative to 1 + max|p|).  ``--out`` writes the same as JSON.

In bf16 the two packages' states part after the first round (mamba2 in
bf16 is chaotic: the round-0 meta-gradients differ by bf16 roundings,
and the unclipped beta-0.5 step carries that into the params), so
``--carry`` gives the port the reference's state anew before every round:
then each round's non-finite counts compare the two packages on the same
inputs.  ``--logaddexp-softplus`` runs the port with ``torch.logaddexp``'s
softplus, whose second derivative reads 0 · inf = NaN below x ≈ -88
(``models/layers.softplus`` keeps the value and takes the derivatives of
max(x, 0) + log1p(e^-|x|)).

``--remat`` runs both packages with ``remat=True`` (each layer
checkpointed, the configs' own default, which cuts the reference's memory
to the layer boundaries; the values do not change), where the script
otherwise turns it off.  ``--hvp-route`` picks the port's Hessian-vector
product: ``autograd`` (the default) is the step's own route, reverse over
reverse through ``torch.autograd``; ``func`` takes the meta-gradients
through ``perfed.perfed_grad(..., autograd=False)``, forward over reverse
(``torch.func.jvp`` through ``torch.func.grad``), as the reference takes
its HVP (``jax.jvp`` through ``jax.grad``).  The two routes agree wherever
every derivative is finite; where one route's chain rule meets 0 · inf and
the other's does not, their non-finite counts part.

``--norm-sweep`` runs only the gated RMSNorm (``norm_sweep``): its HVP
at a grid of input and direction magnitudes by the port's two routes, by
the port's expression with torch's own rsqrt derivatives, by the JAX
package, and in float64.

A one-off experiment: it imports both packages (as the parity tests do)
and is not part of the port.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MASKS = ([1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0])   # SPMD_MASKS
COHORTS, STALENESS, BATCH, SEQ = 4, 2, 4, 256


def _configs(layers, dtype, remat=False):
    from repro.config import ExperimentConfig as RefExp
    from repro.config import FLConfig as RefFL
    from repro.config import TrainConfig as RefTrain
    from repro.configs import get_config as ref_get_config
    from repro_torch.config import ExperimentConfig, FLConfig, TrainConfig
    from repro_torch.configs import get_config
    fl = dict(alpha=0.02, beta=0.5, staleness_bound=STALENESS,
              algorithm="perfed")
    ref_m = dataclasses.replace(ref_get_config("mamba2_370m"),
                                num_layers=layers, dtype=dtype, remat=remat)
    port_m = dataclasses.replace(get_config("mamba2_370m"),
                                 num_layers=layers, dtype=dtype, remat=remat)
    return (RefExp(model=ref_m, fl=RefFL(**fl),
                   train=RefTrain(grad_clip=0.0)),
            ExperimentConfig(model=port_m, fl=FLConfig(**fl),
                             train=TrainConfig(grad_clip=0.0)))


def _count(paths, leaves):
    """{path: non-finite elements} and the largest finite magnitude."""
    bad, top = {}, 0.0
    for path, x in zip(paths, leaves):
        x = np.asarray(x, np.float32)
        fin = np.isfinite(x)
        if not fin.all():
            bad[path] = int((~fin).sum())
        if fin.any():
            top = max(top, float(np.abs(x[fin]).max()))
    return bad, top


def _err(port_leaves, ref_leaves):
    """The port's largest error on the elements finite in both, relative
    to 1 + max|p| of the reference's leaf."""
    worst = 0.0
    for got, want in zip(port_leaves, ref_leaves):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        fin = np.isfinite(got) & np.isfinite(want)
        if fin.any():
            scale = 1.0 + float(np.abs(want[fin]).max())
            worst = max(worst, float(np.abs(got[fin] - want[fin]).max())
                        / scale)
    return worst


def _func_meta_grad(perfed, semi_sync):
    """The port's meta-gradient through ``torch.func`` (forward-over-reverse
    HVP) in place of the step's ``torch.autograd`` route."""
    def meta_grad(model, cfg, params, batches):
        return perfed.perfed_grad(semi_sync._scalar_loss(model), params,
                                  batches, cfg.fl.alpha,
                                  first_order=cfg.fl.first_order,
                                  autograd=False)
    return meta_grad


def run_case(layers, dtype, carry=False, logaddexp=False, remat=False,
             hvp_route="autograd"):
    import jax
    import jax.numpy as jnp
    import torch

    from repro.core import semi_sync as ref_semi_sync
    from repro.models import build_model as ref_build_model
    from repro.optim import make_optimizer as ref_make_optimizer
    from repro_torch.core import perfed, semi_sync
    from repro_torch.launch import train_e2e
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import (from_numpy_tree, tree_leaves,
                                        tree_map, tree_paths)

    if logaddexp:
        from repro_torch.models import layers
        layers.softplus = lambda x: torch.logaddexp(x, torch.zeros_like(x))
    if hvp_route == "func":
        semi_sync._meta_grad = _func_meta_grad(perfed, semi_sync)
    ref_cfg, cfg = _configs(layers, dtype, remat)
    ref, port = ref_build_model(ref_cfg.model), build_model(cfg.model)
    ref_opt, opt = ref_make_optimizer("sgd"), make_optimizer("sgd")
    assert semi_sync.uses_fused_eq8(opt, cfg)
    assert ref_semi_sync.uses_fused_eq8(ref_opt, ref_cfg)
    ref_step = jax.jit(ref_semi_sync.make_semi_sync_step(ref, ref_cfg,
                                                         ref_opt, COHORTS))
    step = semi_sync.make_semi_sync_step(port, cfg, opt, COHORTS)
    with jax.threefry_partitionable(False):
        ref_state = ref_semi_sync.init_state(ref, jax.random.PRNGKey(0),
                                             ref_opt, COHORTS)

    def carried(ref_state):
        params = from_numpy_tree(jax.tree.map(np.asarray, ref_state.params),
                                 "cpu")
        return semi_sync.SemiSyncState(
            params=params, opt_state=opt.init(params),
            buffers=from_numpy_tree(jax.tree.map(np.asarray,
                                                 ref_state.buffers), "cpu"),
            staleness=torch.from_numpy(np.array(ref_state.staleness)),
            step=torch.tensor(int(ref_state.step), dtype=torch.int32))

    state = carried(ref_state)
    params = state.params
    n_params = sum(x.numel() for x in tree_leaves(params))
    corpora = train_e2e.cohort_corpora(COHORTS, cfg.model.vocab_size)
    paths = tree_paths(state.params)
    rounds = []
    for k, m in enumerate(MASKS):
        batches = train_e2e.round_batches(corpora, k, batch=BATCH, seq=SEQ,
                                          device="cpu")
        np_batches = tree_map(lambda x: x.numpy(), batches)
        if carry and k:
            state = carried(ref_state)
        t0 = time.perf_counter()
        ref_state, _ = ref_step(ref_state, np_batches, jnp.asarray(m),
                                jax.random.PRNGKey(k))
        jax.block_until_ready(ref_state.params)
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, _ = step(state, batches, torch.tensor(m))
        t_port = time.perf_counter() - t0
        rec = {"round": k, "mask": m, "seconds": {"reference": t_ref,
                                                  "port": t_port}}
        for name, tree_ref, tree_port in (
                ("params", ref_state.params, state.params),
                ("buffers", ref_state.buffers, state.buffers)):
            ref_leaves = [np.asarray(x, np.float32)
                          for x in jax.tree.leaves(tree_ref)]
            port_leaves = [x.float().numpy() for x in tree_leaves(tree_port)]
            bad_ref, top_ref = _count(paths, ref_leaves)
            bad_port, top_port = _count(paths, port_leaves)
            rec[name] = {
                "reference": {"nonfinite": bad_ref, "max_abs": top_ref},
                "port": {"nonfinite": bad_port, "max_abs": top_port},
                "port_err_rel": _err(port_leaves, ref_leaves)}
        rounds.append(rec)
        b = rec["buffers"]
        print(f"[{layers} layers, {dtype}{', carried' if carry else ''}"
              f"{', logaddexp softplus' if logaddexp else ''}"
              f"{', remat' if remat else ''}, port HVP {hvp_route}] "
              f"round {k} mask {m}: reference "
              f"{t_ref:.1f} s, port {t_port:.1f} s; non-finite buffer "
              f"elements: reference {sum(b['reference']['nonfinite'].values())}"
              f" in {len(b['reference']['nonfinite'])} leaves, port "
              f"{sum(b['port']['nonfinite'].values())} in "
              f"{len(b['port']['nonfinite'])} leaves; largest finite |buf| "
              f"{b['reference']['max_abs']:.3e} / {b['port']['max_abs']:.3e}; "
              f"port vs reference on the finite elements: params "
              f"{rec['params']['port_err_rel']:.3e}, buffers "
              f"{b['port_err_rel']:.3e}; non-finite params: reference "
              f"{sum(rec['params']['reference']['nonfinite'].values())}, port "
              f"{sum(rec['params']['port']['nonfinite'].values())}",
              flush=True)
        for who in ("reference", "port"):
            if b[who]["nonfinite"]:
                print(f"    {who}: " + ", ".join(
                    f"{p} {n}" for p, n in b[who]["nonfinite"].items()),
                    flush=True)
    return {"layers": layers, "dtype": dtype, "carry": carry,
            "logaddexp_softplus": logaddexp, "remat": remat,
            "hvp_route": hvp_route,
            "params": n_params, "rounds": rounds}


# (log10 |x|, log10 |v_x|) of the norm-op sweep: the card's round-2 gated
# norms read |x| up to 2.6e19
NORM_GRID = ((0, 0), (12, 15), (15, 10), (17, 17), (18, 19), (19, 19))


def _rmsnorm_torch_rsqrt(params, x, eps=1e-6):
    """The port's ``rmsnorm`` expression with torch's own derivatives."""
    import torch
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["scale"].float()).to(x.dtype)


def norm_sweep(grid=NORM_GRID, rows=64, width=2048, seed=0):
    """The gated RMSNorm alone (mamba2-370m's d_inner): the HVP of
    sum(rmsnorm(x) · w) in (x, scale, w), x and the direction's x part
    drawn at each grid magnitude, five ways: the port's ``rmsnorm`` by
    reverse over reverse (the step's route) and by ``torch.func`` forward
    over reverse, its expression with torch's own rsqrt derivatives by
    reverse over reverse, the JAX package's ``rmsnorm`` by ``jax.jvp``
    through ``jax.grad``, and the same function in float64 (reverse over
    reverse).  Prints each one's non-finite elements and its largest
    error against float64 relative to float64's largest |h|."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models import layers as RL
    from repro_torch.core import perfed
    from repro_torch.models import layers as L

    rng = np.random.default_rng(seed)
    out = []
    for kx, kv in grid:
        def draw(x_scale):
            return {"x": (rng.standard_normal((rows, width)) * 10.0 ** x_scale)
                    .astype(np.float32),
                    "scale": rng.uniform(0.5, 1.5, width).astype(np.float32),
                    "w": rng.standard_normal((rows, width)).astype(np.float32)}
        p, v = draw(kx), draw(kv)

        def port(norm):
            return lambda q, _b: (norm({"scale": q["scale"]}, q["x"])
                                  * q["w"]).sum()

        def f64(q, _b):
            x = q["x"]
            r = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)
            return (x * r * q["scale"] * q["w"]).sum()

        tp = {k: torch.from_numpy(a) for k, a in p.items()}
        tv = {k: torch.from_numpy(a) for k, a in v.items()}
        exact = perfed.hvp_autograd(f64, {k: t.double() for k, t in tp.items()},
                                    None, {k: t.double() for k, t in tv.items()})
        routes = {
            "port_reverse_over_reverse": perfed.hvp_autograd(
                port(L.rmsnorm), tp, None, tv),
            "port_forward_over_reverse": perfed.hvp(port(L.rmsnorm), tp,
                                                    None, tv),
            "torch_rsqrt_reverse_over_reverse": perfed.hvp_autograd(
                port(_rmsnorm_torch_rsqrt), tp, None, tv),
            "jax_jvp_of_grad": {k: torch.from_numpy(np.asarray(a)) for k, a
                                in jax.jvp(jax.grad(lambda q: jnp.sum(
                                    RL.rmsnorm({"scale": q["scale"]}, q["x"])
                                    * q["w"])), (p,), (v,))[1].items()}}
        rec = {"log10_x": kx, "log10_v": kv}
        for name, h in routes.items():
            bad = sum(int((~torch.isfinite(t)).sum()) for t in h.values())
            err = max(float((h[k].double() - exact[k]).abs().max())
                      / float(exact[k].abs().max()) for k in h)
            rec[name] = {"nonfinite": bad, "err_vs_float64": err}
        out.append(rec)
        print(f"[norm |x| 1e{kx}, |v| 1e{kv}] " + "; ".join(
            f"{n} {r['nonfinite']} non-finite, err {r['err_vs_float64']:.3e}"
            for n, r in rec.items() if isinstance(r, dict)), flush=True)
    return out


def _rmsnorm_scaled(params, x, eps=1e-6):
    """An earlier repair of the port's norm (kept to report on): the value
    of x · rsqrt(mean(x²) + eps) · scale, its derivatives taken on x
    scaled by its row's largest |x| (at least 1)."""
    import torch
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                         + eps)
    top = xf.detach().abs().amax(dim=-1, keepdim=True).clamp(min=1.0)
    xs = xf / top
    ys = xs * torch.rsqrt(torch.mean(torch.square(xs), dim=-1, keepdim=True)
                          + eps / (top * top))
    y = y.detach() + (ys - ys.detach())
    return (y * params["scale"].float()).to(x.dtype)


def _bf16_to_jax(t):
    import jax.numpy as jnp
    import torch
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _nonfinite(h):
    """Non-finite elements (and rows) of (hx, hs, dy)."""
    hx, hs, dy = h
    return {"dy": int((~np.isfinite(dy)).sum()),
            "dy_rows": int((~np.isfinite(dy)).any(1).sum()),
            "hx": int((~np.isfinite(hx)).sum()),
            "hx_rows": int((~np.isfinite(hx)).any(1).sum()),
            "hs": int((~np.isfinite(hs)).sum())}


def _fmt(r):
    return (f"{r['dy']}, {r['dy_rows']}; {r['hx']}, {r['hx_rows']}; "
            f"{r['hs']}")


def norm_dump(directory, flush_denormal=False):
    """Each gated-norm dump of ``scripts/mamba2_hvp_bisect.py --dump``
    (x, scale, g, dx, ds, dg of one layer and cohort, bf16, [rows, d]):
    the norm's own pieces of the HVP, its output's tangent dy along (dx,
    ds) and (hx, hs) = the JVP of its VJP along (dx, ds, dg), by the JAX
    package (``jax.jvp`` of its ``rmsnorm`` and of ``jax.vjp`` of it) and
    by the port five ways (its ``rmsnorm`` and the expression with torch's
    own derivatives, each by reverse over reverse and by ``torch.func``;
    the scaled-derivative repair by reverse over reverse).  Prints for
    each the non-finite elements of dy, hx and hs and the rows holding
    any, whether they are the JAX package's elements, and the largest
    difference from the JAX package's on the elements finite in both
    (relative to the largest such |h|).  ``flush_denormal``: torch flushes
    float32 subnormals to zero, as XLA's CPU backend does (the norm's
    c = -0.5 · r / ve is subnormal in rows whose rms lies between ~5e12
    and ~1e15)."""
    import glob

    import jax
    import torch

    from mamba2_hvp_bisect import norm_hvp, norm_tangent, norm_ways
    from repro.models import layers as RL
    from repro_torch.models import layers as L

    out = []
    # XLA's CPU backend flushes float32 subnormals to zero; torch on the
    # CPU keeps them unless told to flush
    torch.set_flush_denormal(flush_denormal)
    for path in sorted(glob.glob(os.path.join(directory, "*.pt"))):
        t = torch.load(path)
        j = {k: _bf16_to_jax(t[k]) for k in ("x", "s", "g", "dx", "ds", "dg")}

        def vjp(x, s, g):
            return jax.vjp(lambda x, s: RL.rmsnorm({"scale": s}, x), x,
                           s)[1](g)
        jh = jax.jit(lambda a: jax.jvp(vjp, (a["x"], a["s"], a["g"]),
                                       (a["dx"], a["ds"], a["dg"]))[1]
                     + (jax.jvp(lambda x, s: RL.rmsnorm({"scale": s}, x),
                                (a["x"], a["s"]), (a["dx"], a["ds"]))[1],))(j)
        # (hx, hs, dy)
        want = [np.asarray(h.astype(np.float32)) for h in jh]
        ways = {n: (norm, route) for n, norm, route
                in norm_ways(torch, L.rmsnorm)}
        ways["scaled_autograd"] = (_rmsnorm_scaled, "autograd")
        tt = {k: t[k] for k in ("x", "s", "g", "dx", "ds", "dg")}
        rec = {"file": os.path.basename(path), "cohort": t.get("cohort"),
               "layer": t.get("layer"), "norm": t.get("norm"),
               "rows": int(t["x"].shape[0]),
               "x_max_abs": float(t["x"].float().abs().max()),
               "x_max_row_rms": float(t["x"].double().pow(2).mean(-1).sqrt()
                                      .max()),
               "dx_max_abs": float(t["dx"].float().abs().max()),
               "jax": _nonfinite(want)}
        for name, (norm, route) in ways.items():
            got = [h.float().numpy() for h in norm_hvp(torch, norm, tt, route)
                   + (norm_tangent(torch, norm, tt, route),)]
            same = all(np.array_equal(np.isfinite(a), np.isfinite(b))
                       for a, b in zip(got, want))
            err = 0.0
            for a, b in zip(got, want):
                both = np.isfinite(a) & np.isfinite(b)
                if both.any():
                    scale = float(np.abs(b[both]).max()) or 1.0
                    err = max(err, float(np.abs(a[both].astype(np.float64)
                                                - b[both]).max()) / scale)
            rec[name] = {**_nonfinite(got), "same_nonfinite_as_jax": same,
                         "err_vs_jax": err}
        out.append(rec)
        print(f"[{rec['file']}: cohort {rec['cohort']}, layer {rec['layer']}, "
              f"{rec['rows']} rows, run's norm {rec['norm']}; max|x| "
              f"{rec['x_max_abs']:.3e}, max row rms {rec['x_max_row_rms']:.3e}"
              f", max|dx| {rec['dx_max_abs']:.3e}] non-finite (dy, rows; hx, "
              f"rows; hs): JAX ({_fmt(rec['jax'])}); " + "; ".join(
                  f"{n} ({_fmt(r)}) same elements as JAX "
                  f"{r['same_nonfinite_as_jax']}, err {r['err_vs_jax']:.3e}"
                  for n, r in rec.items() if isinstance(r, dict)
                  and n != "jax"), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--carry", action="store_true",
                    help="the reference's state carried into the port "
                         "before every round, not only the first")
    ap.add_argument("--logaddexp-softplus", action="store_true",
                    help="the port's softplus as torch.logaddexp(x, 0)")
    ap.add_argument("--remat", action="store_true",
                    help="both packages with remat=True (the configs' "
                         "default)")
    ap.add_argument("--hvp-route", choices=("autograd", "func"),
                    default="autograd",
                    help="the port's HVP: reverse over reverse (the "
                         "step's) or forward over reverse (torch.func)")
    ap.add_argument("--norm-sweep", action="store_true",
                    help="only the gated RMSNorm's HVP at NORM_GRID's "
                         "magnitudes, five ways (``norm_sweep``)")
    ap.add_argument("--norm-dump", default="",
                    help="a directory of mamba2_hvp_bisect.py --dump files: "
                         "their gated-norm HVPs by the JAX package and the "
                         "port (``norm_dump``)")
    ap.add_argument("--flush-denormal", action="store_true",
                    help="with --norm-dump: torch flushes float32 "
                         "subnormals to zero, as XLA's CPU backend does")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.norm_dump:
        out = norm_dump(args.norm_dump, args.flush_denormal)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    if args.norm_sweep:
        out = norm_sweep()
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    out = []
    for layers in args.layers:
        for dtype in args.dtypes:
            t0 = time.perf_counter()
            case = run_case(layers, dtype, carry=args.carry,
                            logaddexp=args.logaddexp_softplus,
                            remat=args.remat, hvp_route=args.hvp_route)
            case["seconds"] = time.perf_counter() - t0
            print(f"[{layers} layers, {dtype}] {case['params']:,} params, "
                  f"{case['seconds']:.1f} s", flush=True)
            out.append(case)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
