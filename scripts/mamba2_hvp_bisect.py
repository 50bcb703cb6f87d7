#!/usr/bin/env python3
"""Where do mamba2's ``--fused-agg`` round-2 meta-gradients go non-finite?

    python3 scripts/mamba2_hvp_bisect.py [--layers 48] [--device cuda]
        [--reduce] [--norm port|torch-rsqrt] [--dump DIR] [--origins]
        [--out FILE]

Runs the port only (never JAX).  From ``chip_smoke.phase_spmd_mamba``'s
settings (mamba2-370m at full width, bf16, ``train_e2e``'s ``--fused-agg``
round: 4 cohorts, A 2, S 2, batch 4, seq 256, alpha 0.02, beta 0.5, no
clipping, the masks ``chip_smoke.SPMD_MASKS``, the params drawn from
``torch.Generator(device).manual_seed(0)``), it takes the plain step's
round 1, applies round 2's Eq. 8 and then recomputes round 2's
meta-gradients of the refreshed cohorts two ways:

* ``autograd``: the step's own route, ``perfed.perfed_grad(...,
  autograd=True)``: every derivative through ``torch.autograd``, the
  Hessian-vector product by reverse over reverse;
* ``func``: ``perfed.perfed_grad(..., autograd=False)``: ``torch.func``,
  the Hessian-vector product forward over reverse (``jvp`` through
  ``grad``), which is the JAX package's route.

For each it prints the non-finite elements of every leaf of the inner
gradient, the outer gradient, the HVP and the meta-gradient.

In the ``autograd`` route's HVP it also takes, at every layer's gated
RMSNorm (``ssm.py``'s ``norm_gate``), what the norm's part of the HVP
reads: its input x, its output's cotangent g (first backward), x's
tangent dx (the second backward's cotangent of x's gradient), the
output's second-order cotangent dg, and the direction's part ds on the
norm's scale.  From those it recomputes the norm's own pieces of the HVP,
its output's tangent dy along (dx, ds) and (hx, hs) = the JVP of its VJP
along (dx, ds, dg), four ways: the port's ``rmsnorm`` (the JAX package's
derivative rules) and the same expression with torch's own derivatives
(``--norm torch-rsqrt``), each by reverse over reverse and by
``torch.func``, checks the run's own way against what the model's
second backward gave there, and prints per layer the non-finite elements
of each beside the magnitudes of its inputs.  A layer fails where a
piece's inputs are finite and its output by the run's own norm (reverse
over reverse) is not.  ``--dump DIR`` saves, for each refreshed cohort,
the inputs of the first failing layer in the second backward's order
(the tangents run from layer 0 up, the cotangents from the top down):
all rows when the run's norm is ``torch-rsqrt``, else the rows that go
non-finite in any of the four ways and 64 that do not.
``scripts/mamba2_fused_agg_overflow.py --norm-dump DIR`` holds them
against the JAX package on the CPU.

``--norm torch-rsqrt`` runs the whole script (the step's rounds
included) with ``layers.rmsnorm`` as the expression x · rsqrt(mean(x²) +
eps) · scale with torch's own derivatives, the port's norm before it
took the JAX package's rules.

``--origins`` then runs the first piece that is non-finite in the
``autograd`` route again under a dispatch mode that watches every op
(forward, backward and the backward of the backward) and names the ops
whose outputs hold non-finite values while all their tensor inputs are
finite: the autograd node, the forward source line of the op (anomaly
mode's trace), and the magnitudes of its inputs (max |x|, mean square,
the range of log2 |x| over the nonzero elements).  ``--out`` writes the
same as JSON.

``--reduce --device cpu --layers 2 --trace --origins`` rehearses it on
the CPU at a reduced config (no non-finite values are expected there;
``--trace`` runs the origins pass all the same).
"""
import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

MASKS = ([1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0])   # SPMD_MASKS
COHORTS, STALENESS, BATCH, SEQ = 4, 2, 4, 256
PIECES = ("inner", "outer", "hvp", "meta")


def magnitudes(torch, t):
    """max |x| over the finite elements, the non-finite count, the mean
    square (float64) and log2 |x|'s range over the finite nonzero ones."""
    x = t.detach().double()
    fin = torch.isfinite(x)
    xf = x[fin]
    nz = xf[xf != 0].abs()
    return {"shape": list(t.shape), "dtype": str(t.dtype).replace(
                "torch.", ""),
            "nonfinite": int((~fin).sum()),
            "max_abs": float(xf.abs().max()) if xf.numel() else None,
            "mean_square": float((xf * xf).mean()) if xf.numel() else None,
            "log2_range": ([float(nz.min().log2()), float(nz.max().log2())]
                           if nz.numel() else None)}


def _site(node):
    """The forward source line of an autograd node (anomaly mode keeps the
    stack that made it): the innermost frame in the port's model code.  A
    node made by a backward (the graph of a gradient taken with
    ``create_graph``) is named through the chain of nodes whose backward
    made it, as "Node <- Parent site"."""
    names = []
    while node is not None:
        names.append(node.name())
        meta = node.metadata if hasattr(node, "metadata") else {}
        trace = meta.get("traceback_")
        lines = (trace if isinstance(trace, list)
                 else str(trace or "").splitlines())
        frames = [ln.strip() for ln in "".join(lines).splitlines()
                  if ln.strip().startswith("File ")]
        for ln in reversed(frames):
            if "repro_torch" in ln and "/core/" not in ln:
                return " <- ".join(names) + " " + \
                    ln.split("repro_torch/")[-1]
        node = meta.get("parent_")
    return " <- ".join(names) or None


def _caller():
    """The innermost frame of the port's model code on the Python stack."""
    import traceback
    for f in reversed(traceback.extract_stack()):
        if "repro_torch" in f.filename and "/core/" not in f.filename:
            return (f"{f.filename.split('repro_torch/')[-1]}, line "
                    f"{f.lineno}, in {f.name}")
    return None


def origins_mode(torch):
    """A dispatch mode recording every op whose floating outputs hold a
    non-finite value while all its floating tensor inputs are finite."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def floats(tree):
        return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)
                and t.is_floating_point()]

    class Origins(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.events = {}
            self.n_ops = 0
            self.piece = None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.n_ops += 1
            if func.__name__.startswith(("empty", "new_empty")):
                return out               # uninitialised memory
            outs = floats(out)
            if outs and not all(bool(torch.isfinite(t).all()) for t in outs):
                ins = floats((args, kwargs))
                if all(bool(torch.isfinite(t).all()) for t in ins):
                    node = torch._C._current_autograd_node()
                    key = (self.piece, str(func),
                           node.name() if node else "forward",
                           _site(node) if node else _caller())
                    ev = self.events.get(key)
                    if ev is None:
                        self.events[key] = ev = {
                            "piece": key[0], "op": key[1], "node": key[2],
                            "site": key[3],
                            "first_op_index": self.n_ops, "count": 0,
                            "in_backward":
                                torch._C._current_graph_task_id() != -1,
                            "inputs": [magnitudes(torch, t) for t in ins],
                            "outputs": [magnitudes(torch, t) for t in outs]}
                    ev["count"] += 1
            return out

    return Origins()


def count_tree(mods, tree):
    """{path: non-finite elements} over the leaves that hold any."""
    out = {}
    for path, x in zip(mods.tree_paths(tree), mods.tree_leaves(tree)):
        bad = int((~mods.torch.isfinite(x)).sum())
        if bad:
            out[path] = bad
    return out


def bad_layers(mods, tree):
    """The layer indices of the stacked ``layers`` leaves that hold
    non-finite elements, with their counts."""
    per = {}
    for x in mods.tree_leaves(tree.get("layers", {})):
        bad = (~mods.torch.isfinite(x)).reshape(x.shape[0], -1).sum(1)
        for i in mods.torch.nonzero(bad).flatten().tolist():
            per[i] = per.get(i, 0) + int(bad[i])
    return per


def pieces(mods, perfed, loss, params, batches, alpha, autograd,
           label=lambda piece: None):
    """perfed_grad's pieces: (inner gradient, outer gradient, HVP,
    meta-gradient), each a tree like ``params``; ``label(piece)`` is
    called as each starts."""
    from repro_torch.utils.tree import tree_axpy
    label("inner")
    if autograd:
        g_in = perfed.grad_autograd(loss, params, batches["inner"])
    else:
        g_in = perfed._grad(loss, params, batches["inner"])
    # perfed.adapt's update, op for op
    adapted = tree_axpy(-alpha, g_in, mods.tree_map(lambda x: x.detach(),
                                                    params))
    label("outer")
    g_out = (perfed.grad_autograd(loss, adapted, batches["outer"])
             if autograd else perfed._grad(loss, adapted, batches["outer"]))
    del adapted
    label("hvp")
    hvp = (_hvp_autograd(mods, perfed, loss, params, batches["hessian"],
                         g_out, label)
           if autograd else perfed.hvp(loss, params, batches["hessian"],
                                       g_out))
    meta = tree_axpy(-alpha, hvp, g_out)
    return {"inner": g_in, "outer": g_out, "hvp": hvp, "meta": meta}


def _hvp_autograd(mods, perfed, loss, params, batch, vector, label):
    """``perfed.hvp_autograd``, op for op, with its second backward pass
    labelled apart from the first (the gradient it differentiates)."""
    torch = mods.torch
    p = mods.tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        g = perfed.grad_autograd(loss, p, batch, create_graph=True)
        label("hvp, 2nd backward")
        dot = 0.0
        for gi, vi in zip(mods.tree_leaves(g), mods.tree_leaves(vector)):
            dot = dot + torch.sum(gi * vi)
        h = torch.autograd.grad(dot, mods.tree_leaves(p))
    return mods.tree_unflatten(params, list(h))


def rmsnorm_torch_rsqrt(torch):
    """``layers.rmsnorm``'s expression with torch's own derivatives (rsqrt's
    backward -0.5 · g · r³): the port's norm before it took the JAX
    package's rules, bitwise the same value."""
    def rmsnorm(params, x, eps=1e-6):
        xf = x.float()
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * params["scale"].float()).to(x.dtype)
    return rmsnorm


class GatedNormCapture:
    """While ``on``, wraps ``layers.rmsnorm`` so that each call on a
    ``width``-wide input (the gated norm's d_inner) records x and the
    scale, and hooks the norm's output (first backward: g, whose own hook
    then takes the model's dy, the output's tangent, in the second;
    second backward: dg) and x (first backward: its gradient gx, whose
    own hook then takes dx in the second; second backward: the model's
    hx) in a new entry of ``calls``, in forward order (layer 0 first)."""

    def __init__(self, torch, layers, width):
        self.torch, self.layers, self.width = torch, layers, width
        self.inner = layers.rmsnorm
        self.on, self.calls = False, []

    def __enter__(self):
        def wrapped(params, x, *a, **k):
            out = self.inner(params, x, *a, **k)
            if self.on and x.shape[-1] == self.width and x.requires_grad:
                rec = {"x": x.detach(), "s": params["scale"].detach()}
                self.calls.append(rec)

                def on_x(gx):
                    if "gx" in rec:
                        rec["hx_model"] = gx.detach()
                        return
                    rec["gx"] = True
                    if gx.requires_grad:
                        gx.register_hook(
                            lambda dx: rec.__setitem__("dx", dx.detach()))

                def on_out(g):
                    if "g" in rec:
                        rec["dg"] = g.detach()
                        return
                    rec["g"] = g.detach()
                    if g.requires_grad:
                        g.register_hook(
                            lambda dy: rec.__setitem__("dy_model",
                                                       dy.detach()))
                x.register_hook(on_x)
                out.register_hook(on_out)
            return out
        self.layers.rmsnorm = wrapped
        return self

    def __exit__(self, *exc):
        self.layers.rmsnorm = self.inner


def norm_hvp(torch, norm, t, route):
    """The gated norm's own HVP at ``t`` (x, s, g, dx, ds, dg): the JVP of
    its VJP (x, s) -> (gx, gs) along (dx, ds, dg), by reverse over reverse
    (``autograd``) or forward over reverse (``func``).  Returns (hx, hs)."""
    if route == "autograd":
        x = t["x"].detach().requires_grad_(True)
        s = t["s"].detach().requires_grad_(True)
        with torch.enable_grad():
            out = norm({"scale": s}, x)
            gx, gs = torch.autograd.grad(out, (x, s), t["g"],
                                         create_graph=True)
            return torch.autograd.grad((gx, gs, out), (x, s),
                                       (t["dx"], t["ds"], t["dg"]))

    def vjp(x, s, g):
        _, f = torch.func.vjp(lambda x, s: norm({"scale": s}, x), x, s)
        return f(g)
    return torch.func.jvp(vjp, (t["x"], t["s"], t["g"]),
                          (t["dx"], t["ds"], t["dg"]))[1]


def norm_tangent(torch, norm, t, route):
    """The gated norm's output tangent dy along (dx, ds) at ``t``: by
    reverse over reverse the second backward's cotangent of its output's
    cotangent g (``autograd``, as the step's HVP takes it), or
    ``torch.func.jvp`` (``func``)."""
    if route == "autograd":
        x = t["x"].detach().requires_grad_(True)
        s = t["s"].detach().requires_grad_(True)
        g = t["g"].detach().requires_grad_(True)
        with torch.enable_grad():
            out = norm({"scale": s}, x)
            gx, gs = torch.autograd.grad(out, (x, s), g, create_graph=True)
            return torch.autograd.grad((gx, gs), g, (t["dx"], t["ds"]))[0]
    return torch.func.jvp(lambda x, s: norm({"scale": s}, x),
                          (t["x"], t["s"]), (t["dx"], t["ds"]))[1]


def norm_ways(torch, port_norm):
    """The four ways ``norm_hvp`` is taken: (name, norm, route)."""
    plain = rmsnorm_torch_rsqrt(torch)
    return (("port_autograd", port_norm, "autograd"),
            ("port_func", port_norm, "func"),
            ("torch_rsqrt_autograd", plain, "autograd"),
            ("torch_rsqrt_func", plain, "func"))


def row_magnitudes(torch, t):
    """Per tensor: max |x|, the largest row rms (float64) and the
    non-finite count."""
    x = t.detach().double().reshape(-1, t.shape[-1])
    fin = torch.isfinite(x)
    xf = torch.where(fin, x, torch.zeros_like(x))
    return {"max_abs": float(xf.abs().max()),
            "max_row_rms": float((xf * xf).mean(-1).sqrt().max()),
            "nonfinite": int((~fin).sum())}


def _held(torch, got, want):
    """``got`` against the model's ``want``: the largest difference on the
    elements finite in both (relative to 1 + max|want| there) and whether
    the non-finite elements are the same."""
    m = want.float()
    both = torch.isfinite(got) & torch.isfinite(m)
    return (float((got.float() - m).abs().where(both, 0.0).max()
                  / (1.0 + m.abs().where(both, 0.0).max())),
            bool(torch.equal(torch.isfinite(got), torch.isfinite(m))))


def norm_layers(torch, calls, ds_stack, port_norm, own):
    """Per layer of the captured gated norms: the inputs' magnitudes, the
    model's dy and hx non-finite counts, and each of ``norm_ways``' dy
    (``norm_tangent``) and (hx, hs) (``norm_hvp``) non-finite counts and
    rows.  Also the failing layers, in the order the second backward meets
    them: first those (from layer 0 up, the order the tangents run in)
    whose x, g, dx and ds are finite and whose dy by ``own`` (the run's
    norm: "port" or "torch_rsqrt") by reverse over reverse is not, then
    those (from the top down) whose inputs are all finite and whose hx by
    the same is not."""
    out, tangent_fail, hvp_fail = [], [], []
    for layer in range(len(calls)):
        rec = calls[layer]
        if not all(k in rec for k in ("g", "dx", "dg")):
            out.append({"layer": layer, "incomplete": sorted(rec)})
            continue
        t = {k: rec[k] for k in ("x", "s", "g", "dx", "dg")}
        t["ds"] = ds_stack[layer].to(t["s"].dtype)
        row = {"layer": layer,
               "inputs": {k: row_magnitudes(torch, v) for k, v in t.items()},
               "model_nonfinite": {
                   k: (int((~torch.isfinite(rec[f"{k}_model"])).sum())
                       if f"{k}_model" in rec else None)
                   for k in ("dy", "hx")},
               "ways": {}}
        n_rows = t["x"].reshape(-1, t["x"].shape[-1]).shape[0]
        bad_rows = torch.zeros(n_rows, dtype=torch.bool, device=t["x"].device)
        for name, norm, route in norm_ways(torch, port_norm):
            dy = norm_tangent(torch, norm, t, route)
            hx, hs = norm_hvp(torch, norm, t, route)
            w = {}
            for k, v in (("dy", dy), ("hx", hx)):
                rows = (~torch.isfinite(v)).reshape(n_rows, -1).any(1)
                bad_rows |= rows
                w[k] = int((~torch.isfinite(v)).sum())
                w[f"{k}_rows"] = int(rows.sum())
            w["hs"] = int((~torch.isfinite(hs)).sum())
            row["ways"][name] = w
            if name == f"{own}_autograd":
                # the norm's own pieces against the model's: the capture's
                # check
                for k, v in (("dy", dy), ("hx", hx)):
                    if f"{k}_model" in rec:
                        row[f"model_{k}_err"], row[f"model_{k}_same"] = \
                            _held(torch, v, rec[f"{k}_model"])
        fin = {k: v["nonfinite"] == 0 for k, v in row["inputs"].items()}
        row["inputs_finite"] = all(fin.values())
        mine = row["ways"][f"{own}_autograd"]
        if fin["x"] and fin["g"] and fin["dx"] and fin["ds"] and mine["dy"]:
            tangent_fail.append(layer)
        if row["inputs_finite"] and mine["hx"]:
            hvp_fail.append(layer)
        row["_bad_rows"] = bad_rows
        out.append(row)
    return out, tangent_fail + hvp_fail[::-1]


def dump_layer(torch, calls, ds_stack, layer, rows, path, meta):
    """Saves layer ``layer``'s gated-norm inputs (``rows``: the row indices
    of the [B·L, d] view to keep, None for all) to ``path``."""
    rec = calls[layer]
    t = {k: rec[k] for k in ("x", "s", "g", "dx", "dg")}
    t["ds"] = ds_stack[layer].to(t["s"].dtype)
    d = t["x"].shape[-1]
    for k in ("x", "g", "dx", "dg"):
        t[k] = t[k].reshape(-1, d)
        if rows is not None:
            t[k] = t[k][rows]
    torch.save({**{k: v.detach().cpu() for k, v in t.items()},
                "rows": None if rows is None else rows.cpu(), **meta}, path)
    return {k: list(v.shape) for k, v in t.items()}


def norm_rec(torch, rec, c, calls, vector, port_norm, own, args, dev):
    """``norm_layers`` on cohort ``c``'s captured gated norms (the HVP's
    direction ``vector``: the outer gradient), printed, kept in ``rec``
    and, with ``--dump``, the first failing layer saved."""
    ds_stack = vector["layers"]["norm_gate"]["scale"]
    rows, failing = norm_layers(torch, calls, ds_stack, port_norm, own)
    first = failing[0] if failing else None
    saved = None
    if args.dump and first is not None:
        os.makedirs(args.dump, exist_ok=True)
        bad = next(r for r in rows if r["layer"] == first)["_bad_rows"]
        keep = None
        if own == "port":
            good = torch.nonzero(~bad).flatten()[:64]
            keep = torch.cat([torch.nonzero(bad).flatten(), good]).sort()[0]
        path = os.path.join(args.dump, f"cohort{c}_layer{first}.pt")
        shapes = dump_layer(torch, calls, ds_stack, first, keep, path,
                            {"cohort": c, "layer": first, "norm": args.norm,
                             "device": dev})
        saved = {"path": path, "shapes": shapes}
    for r in rows:
        r.pop("_bad_rows", None)
    rec["cohorts"][c]["gated_norm"] = {"failing_layers": failing,
                                       "dump": saved, "layers": rows}
    for r in rows:
        if "ways" not in r:
            print(f"[cohort {c}, gated norm, layer {r['layer']}] incomplete "
                  f"capture {r.get('incomplete')}", flush=True)
            continue
        if not (any(w["dy"] or w["hx"] or w["hs"]
                    for w in r["ways"].values())
                or any(r["model_nonfinite"].values())):
            continue
        print(f"[cohort {c}, gated norm, layer {r['layer']}] inputs "
              + ", ".join(f"{k} max|.| {m['max_abs']:.3e} row rms "
                          f"{m['max_row_rms']:.3e}"
                          + (f" ({m['nonfinite']} non-finite)"
                             if m["nonfinite"] else "")
                          for k, m in r["inputs"].items())
              + "; the model's non-finite "
              + ", ".join(f"{k} {n} (the norm's own against it: "
                          f"{r.get(f'model_{k}_err', 0):.3e}, same elements "
                          f"{r.get(f'model_{k}_same')})"
                          for k, n in r["model_nonfinite"].items())
              + "; the norm's own, non-finite (dy, rows; hx, rows; hs): "
              + ", ".join(f"{n} ({w['dy']}, {w['dy_rows']}; {w['hx']}, "
                          f"{w['hx_rows']}; {w['hs']})"
                          for n, w in r["ways"].items()), flush=True)
    print(f"[cohort {c}, gated norm] failing layers by the run's norm "
          f"({own}, reverse over reverse; the output tangent from finite "
          f"x, g, dx, ds, then the HVP from all finite): {failing}"
          + (f"; saved {saved}" if saved else ""), flush=True)


def run(args):
    import types

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import perfed, semi_sync
    from repro_torch.kernels.stale_aggregate import stale_aggregate_tree
    from repro_torch.launch import train_e2e
    from repro_torch.models import build_model, layers, ssm
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import (tree_leaves, tree_map, tree_paths,
                                        tree_unflatten)
    mods = types.SimpleNamespace(torch=torch, tree_leaves=tree_leaves,
                                 tree_map=tree_map, tree_paths=tree_paths,
                                 tree_unflatten=tree_unflatten)
    dev = args.device
    # as chip_smoke's slice-10 phase runs the step (the embedding's
    # backward, for one, sums in another order without it)
    torch.use_deterministic_algorithms(True, warn_only=True)
    port_norm = layers.rmsnorm
    own = "port" if args.norm == "port" else "torch_rsqrt"
    if args.norm == "torch-rsqrt":
        layers.rmsnorm = rmsnorm_torch_rsqrt(torch)
    cfg = get_config("mamba2_370m")
    bsz, seq = BATCH, SEQ
    if args.reduce:
        cfg, bsz, seq = cfg.reduced(), 2, 64
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build_model(cfg)
    # the recomputation without remat (the same values): each gated norm
    # then runs once a forward, in layer order, for the capture
    model_nr = build_model(dataclasses.replace(cfg, remat=False))
    exp = train_e2e.experiment_cfg(cfg, staleness=STALENESS, fused_agg=True)
    sgd = make_optimizer("sgd")
    step = semi_sync.make_semi_sync_step(model, exp, sgd, COHORTS)
    corpora = train_e2e.cohort_corpora(COHORTS, cfg.vocab_size)
    state = semi_sync.init_state(
        model, torch.Generator(device=dev).manual_seed(0), sgd, COHORTS)
    t0 = time.perf_counter()
    state, _ = step(state, train_e2e.round_batches(
        corpora, 0, batch=bsz, seq=seq, device=dev),
        torch.tensor(MASKS[0], device=dev))
    rec = {"config": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                      "dtype": cfg.dtype, "remat": cfg.remat,
                      "batch": bsz, "seq": seq, "norm": args.norm},
           "round1_s": time.perf_counter() - t0,
           "round1_buffers_nonfinite": count_tree(mods, state.buffers)}
    mask = torch.tensor(MASKS[1], device=dev)
    params = stale_aggregate_tree(state.params, state.buffers, mask,
                                  beta=exp.fl.beta)
    batches = train_e2e.round_batches(corpora, 1, batch=bsz, seq=seq,
                                      device=dev)
    # the step's own round 2: its refreshed buffer rows are what the
    # recomputation below must give through the step's route
    t0 = time.perf_counter()
    state, _ = step(state, batches, mask)
    stepped = {c: tree_map(lambda b: b[c].clone(), state.buffers)
               for c in range(COHORTS) if MASKS[1][c]}
    rec["round2_s"] = time.perf_counter() - t0
    rec["round2_buffers_nonfinite"] = count_tree(mods, state.buffers)
    print(f"[step] round 2's buffers, non-finite elements: "
          f"{sum(rec['round2_buffers_nonfinite'].values())} in "
          f"{len(rec['round2_buffers_nonfinite'])} leaves "
          f"({rec['round2_buffers_nonfinite']})", flush=True)
    del state

    def loss(p, b):
        return model_nr.loss(p, b)[0]

    alpha = exp.fl.alpha
    rec["params_nonfinite"] = count_tree(mods, params)
    rec["cohorts"] = {}
    first = None
    with torch.autograd.set_multithreading_enabled(False):
        for c in range(COHORTS):
            if not MASKS[1][c]:
                continue
            cb = tree_map(lambda x: x[c], batches)
            rec["cohorts"][c] = {}
            for route in ("autograd", "func"):
                t0 = time.perf_counter()
                cap = GatedNormCapture(torch, layers, ssm._dims(cfg)[0])
                with cap:
                    got = pieces(mods, perfed, loss, params, cb, alpha,
                                 route == "autograd",
                                 lambda p: setattr(
                                     cap, "on", route == "autograd"
                                     and p.startswith("hvp")))
                counts = {k: count_tree(mods, v) for k, v in got.items()}
                by_layer = {k: bad_layers(mods, v) for k, v in got.items()}
                if route == "autograd":
                    norm_rec(torch, rec, c, cap.calls, got["outer"], port_norm,
                             own, args, dev)
                del cap
                if route == "autograd":
                    # the step's route, recomputed: bitwise the step's rows
                    same = all(
                        torch.equal(a.to(b.dtype).view(-1).view(
                            torch.int16 if b.element_size() == 2
                            else torch.int32),
                            b.view(-1).view(torch.int16 if b.element_size()
                                            == 2 else torch.int32))
                        for a, b in zip(tree_leaves(got["meta"]),
                                        tree_leaves(stepped[c])))
                    rec["cohorts"][c]["same_bits_as_step"] = same
                    print(f"[cohort {c}] the recomputed meta-gradient is "
                          f"{'bitwise' if same else 'NOT bitwise'} the "
                          f"step's buffer row", flush=True)
                del got
                rec["cohorts"][c][route] = {"seconds":
                                            time.perf_counter() - t0,
                                            **counts, "layers": by_layer}
                print(f"[cohort {c}, {route}] non-finite elements: " + "; "
                      .join(f"{k} {sum(v.values())} in {len(v)} leaves"
                            + (f" ({v}; by layer {by_layer[k]})" if v
                               else "")
                            for k, v in counts.items()), flush=True)
                if route == "autograd" and any(counts[k] for k in PIECES):
                    first = first or []
                    first.append(c)
                if dev == "cuda":
                    torch.cuda.empty_cache()
        rec["first_nonfinite"] = first
        if first is None and args.trace:
            first = [MASKS[1].index(1.0)]
        rec["origins"] = {}
        if not args.origins:
            first = None
        # torch.func under a Python dispatch mode crashes (torch 2.11,
        # 2.13): the origins pass runs the step's own route only
        for c in first or ():
            cb = tree_map(lambda x: x[c], batches)
            mode = origins_mode(torch)
            t0 = time.perf_counter()
            with torch.autograd.set_detect_anomaly(True, check_nan=False):
                with mode:
                    got = pieces(mods, perfed, loss, params, cb, alpha, True,
                                 lambda p: setattr(mode, "piece", p))
                    del got
            events = sorted(mode.events.values(),
                            key=lambda e: e["first_op_index"])
            rec["origins"][c] = {"ops": mode.n_ops,
                                 "seconds": time.perf_counter() - t0,
                                 "events": events}
            print(f"[origins, cohort {c}, autograd] {mode.n_ops} ops; "
                  f"{len(events)} (piece, op, node, site) made non-finite "
                  f"values from finite inputs:", flush=True)
            for e in events:
                print(f"    {e['piece']}: op #{e['first_op_index']} "
                      f"{e['op']} node {e['node']} site {e['site']} "
                      f"x{e['count']} backward={e['in_backward']}; inputs "
                      + json.dumps(e["inputs"]) + "; outputs "
                      + json.dumps(e["outputs"]), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="depth (default: the config's, 48)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduce", action="store_true",
                    help="the reduced config, batch 2, seq 64")
    ap.add_argument("--trace", action="store_true",
                    help="run the origins pass even when every piece is "
                         "finite (on the first refreshed cohort)")
    ap.add_argument("--norm", choices=("port", "torch-rsqrt"),
                    default="port",
                    help="layers.rmsnorm as the port has it, or its "
                         "expression with torch's own derivatives")
    ap.add_argument("--dump", default="",
                    help="a directory for each cohort's first failing "
                         "gated-norm inputs")
    ap.add_argument("--origins", action="store_true",
                    help="the dispatch-mode pass naming the ops that go "
                         "non-finite from finite inputs")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    rec = run(args)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
