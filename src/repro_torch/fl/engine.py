"""SimulationEngine — batched device math under the event-driven simulator.

The port of the JAX package's ``fl/engine.py``.  The driver pops arrival
events, asks this engine for the corresponding client payloads, and feeds
them to the Algorithm-1 server.  The engine owns every device dispatch:

* **sequential** mode — one payload call per arrival (the correctness
  reference).
* **batched** mode — a whole round of arrivals runs as one dispatch per
  *model-version group* (``round_update``): the ``torch.func.vmap``-ed
  payload computation plus the Eq. (8) masked stale aggregation
  (``kernels/stale_aggregate``).  Lanes sharing a version are grouped so the
  weights are read once per group; when versions are mostly distinct, one
  all-lanes dispatch carries each lane's own flat version instead.  Arrival
  counts are padded to power-of-two *bucket* sizes (1, 2, 4, ...
  ``max_bucket``) with zero aggregation weight on padded lanes.

A "dispatch" here is one call of a vmapped (or single-lane) payload
function; the counters count exactly as the reference's jit dispatches do,
so the two packages report the same ``payload_dispatches``.  Payload and
eval calls draw no random numbers (the paper's small models are
deterministic given their batches), so no keys are threaded through.
Batches arrive as host numpy trees and move to ``device`` here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.config import FLConfig
from repro_torch.fl.client import make_payload_fn, personalized_eval
from repro_torch.kernels.stale_aggregate import stale_aggregate_tree
from repro_torch.obs import trace as obs
from repro_torch.utils.tree import (TreeFlattener, tree_leaves, tree_map,
                                    tree_paths)

__all__ = ["SimulationEngine", "bucket_size", "ensure_engine"]


def bucket_size(m: int, max_bucket: int = 256) -> int:
    """Smallest power of two ≥ m, capped at ``max_bucket``."""
    if m <= 0:
        raise ValueError("empty batch")
    b = 1
    while b < m:
        b <<= 1
    return min(b, max_bucket)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but torch sees no CUDA "
                           f"device; pass device='cpu' to run on the CPU")
    return dev


def ensure_engine(engine: Optional["SimulationEngine"], model, fl, *,
                  algorithm: str, payload_mode: Optional[str],
                  device) -> "SimulationEngine":
    """Build a fresh engine, or validate a caller-supplied one against the
    run's (model, algorithm, FLConfig, payload_mode, device)."""
    if engine is None:
        return SimulationEngine(model, fl, algorithm,
                                payload_mode=payload_mode or "batched",
                                device=device)
    if engine.algorithm != algorithm or engine.model is not model:
        raise ValueError(
            f"engine was built for algorithm {engine.algorithm!r} and "
            f"its own model; cannot run algorithm {algorithm!r} with it")
    # the engine's payload fns bake in its FLConfig — only the
    # scheduling-side eta_mode may differ between runs sharing an engine
    if dataclasses.replace(engine.fl, eta_mode=fl.eta_mode) != fl:
        raise ValueError("engine.fl differs from cfg.fl beyond eta_mode; "
                         "build a fresh SimulationEngine for this config")
    if payload_mode is not None and payload_mode != engine.payload_mode:
        raise ValueError(
            f"payload_mode={payload_mode!r} conflicts with the supplied "
            f"engine's mode {engine.payload_mode!r}")
    if resolve_device(device) != engine.device:
        raise ValueError(f"device={str(device)!r} conflicts with the "
                         f"supplied engine's device {engine.device}")
    return engine


def _shape_signature(batches: Any) -> Tuple:
    """Hashable (path-ordered) leaf shape+dtype signature of a batch tree."""
    return (tuple(tree_paths(batches)),
            tuple((tuple(x.shape), str(x.dtype)) for x in tree_leaves(batches)))


def _leading_len(tree: Any) -> int:
    """Length of the leading (lane) axis of a stacked batch tree."""
    return int(tree_leaves(tree)[0].shape[0])


class SimulationEngine:
    """Vectorized payload computation for a (model, FLConfig, algorithm)."""

    def __init__(self, model, fl: FLConfig, algorithm: str, *,
                 payload_mode: str = "batched", max_bucket: int = 256,
                 device="cuda"):
        if payload_mode not in ("batched", "sequential"):
            raise ValueError(f"unknown payload_mode {payload_mode!r}")
        self.model = model
        self.fl = fl
        self.algorithm = algorithm
        self.payload_mode = payload_mode
        self.max_bucket = max_bucket
        self.device = resolve_device(device)
        self._raw = make_payload_fn(model, fl, algorithm)
        self._batched = vmap(self._raw, in_dims=(0, 0, 0))
        # params BROADCAST: the common case is every lane holding the same
        # model version, where stacking k copies of the tree costs more
        # than the payload math itself
        self._batched_shared = vmap(self._raw, in_dims=(None, 0, 0))
        self._eval_v = vmap(self._eval_raw, in_dims=(None, 0))
        # id-keyed cache of flattened model versions; holding the tree ref
        # keeps ids stable for the cache's lifetime
        self._flat_versions: Dict[int, Tuple[Any, torch.Tensor]] = {}
        self.dispatches = 0            # payload calls issued (for benchmarks)
        self.payloads_computed = 0
        self.eval_dispatches = 0       # eval calls (kept off payload count)

    # ------------------------------------------------------------------
    # host → device
    # ------------------------------------------------------------------
    def _to_dev(self, tree: Any) -> Any:
        return tree_map(lambda x: torch.as_tensor(x, device=self.device),
                        tree)

    def _stack_host(self, trees: Sequence[Any]) -> Any:
        """Host numpy trees → one stacked tree on the device (one transfer
        per leaf)."""
        return tree_map(
            lambda *xs: torch.as_tensor(np.stack(xs), device=self.device),
            *trees)

    def _alphas(self, values: Sequence[float]) -> torch.Tensor:
        return torch.tensor([float(a) for a in values], dtype=torch.float32,
                            device=self.device)

    def _alpha(self, value: float) -> torch.Tensor:
        return torch.tensor(float(value), dtype=torch.float32,
                            device=self.device)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _eval_raw(self, params, batches):
        ploss, paux = personalized_eval(self.model, self.fl, params, batches)
        gout = self.model.loss(params, batches["outer"])
        gloss = gout[0] if isinstance(gout, tuple) else gout
        acc = paux.get("acc") if isinstance(paux, dict) else None
        if acc is None:
            acc = torch.full_like(ploss, math.nan)
        return ploss, gloss, acc

    def eval_one(self, params, batches):
        """(personalized loss, global loss, accuracy) for one client."""
        self.eval_dispatches += 1
        obs.CURRENT.add("engine.dispatch.eval_one")
        return obs.CURRENT.device_call("engine.eval", self._eval_raw,
                                       params, self._to_dev(batches))

    def eval_many(self, params, batches_list: Sequence[Any]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Evaluate a cohort of clients against ONE ``params``: per-client
        (personalized loss, global loss, accuracy) as ``[m]`` arrays.

        Clients sharing a batch-shape signature are stacked and evaluated
        as one vmapped call with the weights broadcast; singleton groups go
        through ``eval_one``.
        """
        m = len(batches_list)
        pl = np.zeros(m)
        gl = np.zeros(m)
        ac = np.zeros(m)
        groups: Dict[Tuple, List[int]] = {}
        for i, b in enumerate(batches_list):
            groups.setdefault(_shape_signature(b), []).append(i)
        for idx in groups.values():
            if len(idx) == 1:
                i = idx[0]
                p, g, a = self.eval_one(params, batches_list[i])
                pl[i], gl[i], ac[i] = float(p), float(g), float(a)
                continue
            batches_b = self._stack_host([batches_list[i] for i in idx])
            obs.CURRENT.add("engine.dispatch.eval_vmap")
            p, g, a = obs.CURRENT.device_call(
                "engine.eval", self._eval_v, params, batches_b)
            self.eval_dispatches += 1
            # the one deliberate host sync per eval sweep
            pl[idx] = p.cpu().numpy()
            gl[idx] = g.cpu().numpy()
            ac[idx] = a.cpu().numpy()
        return pl, gl, ac

    # ------------------------------------------------------------------
    # per-arrival payloads (sequential mode / partial batches / tests)
    # ------------------------------------------------------------------
    def compute_payloads(self, params_list: Sequence[Any],
                         batches_list: Sequence[Any],
                         alphas: Sequence[float]) -> List[Any]:
        """Payload tree per arrival; inputs are parallel per-arrival lists.

        ``params_list[i]`` is the model version arrival ``i`` computed
        against (staleness ⇒ entries may differ), ``alphas[i]`` its inner
        learning rate α_i.
        """
        m = len(params_list)
        if not m == len(batches_list) == len(alphas):
            raise ValueError("compute_payloads: per-arrival lists differ "
                             "in length")
        if m == 0:
            return []
        if self.payload_mode == "sequential":
            tr = obs.CURRENT
            out = [tr.device_call("engine.payload", self._raw, p,
                                  self._to_dev(b), self._alpha(a))
                   for p, b, a in zip(params_list, batches_list, alphas)]
            self.dispatches += m
            self.payloads_computed += m
            tr.add("engine.dispatch.sequential", m)
            return out

        # group by batch-shape signature (stragglers with short shards get
        # their own bucket; the common case is a single group)
        groups: Dict[Tuple, List[int]] = {}
        for i, b in enumerate(batches_list):
            groups.setdefault(_shape_signature(b), []).append(i)

        results: List[Any] = [None] * m
        for idx in groups.values():
            if len(idx) == 1:
                i = idx[0]
                obs.CURRENT.add("engine.dispatch.single")
                results[i] = obs.CURRENT.device_call(
                    "engine.payload", self._raw, params_list[i],
                    self._to_dev(batches_list[i]), self._alpha(alphas[i]))
                self.dispatches += 1
                self.payloads_computed += 1
                continue
            for lo in range(0, len(idx), self.max_bucket):
                self._run_bucket(idx[lo:lo + self.max_bucket], params_list,
                                 batches_list, alphas, results)
        return results

    def _run_bucket(self, idx: List[int], params_list, batches_list, alphas,
                    results: List[Any]) -> None:
        k = len(idx)
        bucket = bucket_size(k, self.max_bucket)
        # pad by repeating the first arrival — padded lanes are discarded
        pad = idx + [idx[0]] * (bucket - k)
        params_b = tree_map(lambda *xs: torch.stack(xs),
                            *[params_list[i] for i in pad])
        batches_b = self._stack_host([batches_list[i] for i in pad])
        alphas_b = self._alphas([alphas[i] for i in pad])
        obs.CURRENT.add("engine.dispatch.bucket")
        out = obs.CURRENT.device_call("engine.payload", self._batched,
                                      params_b, batches_b, alphas_b)
        self.dispatches += 1
        self.payloads_computed += k
        for lane, i in enumerate(idx):
            results[i] = tree_map(lambda x, lane=lane: x[lane], out)

    # ------------------------------------------------------------------
    # stacked payloads (batch-wise protocol feed)
    # ------------------------------------------------------------------
    def compute_payloads_stacked(self, params_list: Sequence[Any],
                                 groups: Sequence[Tuple[List[int], Any]],
                                 alphas: Sequence[float]) -> Any:
        """Payloads of one drained batch as ONE stacked tree (leading lane
        axis, drain arrival order) — the batch-wise feed's engine entry.

        ``groups`` covers every lane exactly once as ``(lanes,
        batches_stacked)`` pairs: ``lanes`` are global lane indices and
        ``batches_stacked`` the matching client batches with a leading
        lane axis (``data.partition.sample_triplet_many``).
        ``params_list``/``alphas`` stay per-lane.  Singleton chunks run the
        single-lane payload function.
        """
        m = len(params_list)
        if m == 0 or m != len(alphas):
            raise ValueError("compute_payloads_stacked: need one alpha per "
                             "lane and at least one lane")
        parts: List[Any] = []
        order: List[int] = []
        for lanes, batches in groups:
            batches = self._to_dev(batches)
            for lo in range(0, len(lanes), self.max_bucket):
                chunk = lanes[lo:lo + self.max_bucket]
                rows = np.arange(lo, lo + len(chunk))
                parts.append(self._stacked_bucket(chunk, rows, batches,
                                                  params_list, alphas))
                order.extend(chunk)
        if order == list(range(m)):
            # single signature: chunk order IS arrival order — concat only
            if len(parts) == 1:
                return parts[0]
            return tree_map(lambda *xs: torch.cat(xs, dim=0), *parts)
        # concat in chunk order, then inverse-permute to arrival order —
        # aggregation sums rows in stacked order, so this keeps the batch
        # feed's summation order identical to the per-arrival path
        pos = np.empty(m, dtype=np.int64)
        pos[np.asarray(order, dtype=np.int64)] = np.arange(m)
        pos_t = torch.as_tensor(pos, device=self.device)
        return tree_map(lambda *xs: torch.cat(xs, dim=0)[pos_t], *parts)

    def _stacked_bucket(self, chunk: List[int], rows: np.ndarray, batches,
                        params_list, alphas) -> Any:
        """One padded vmapped call over ``chunk``; returns the valid
        ``[k, ...]`` rows of the stacked payload output."""
        k = len(chunk)
        if k == 1:
            i = chunk[0]
            b = tree_map(lambda x: x[int(rows[0])], batches)
            obs.CURRENT.add("engine.dispatch.single")
            out = obs.CURRENT.device_call(
                "engine.payload", self._raw, params_list[i], b,
                self._alpha(alphas[i]))
            self.dispatches += 1
            self.payloads_computed += 1
            return tree_map(lambda x: x[None], out)
        bucket = bucket_size(k, self.max_bucket)
        pad = list(chunk) + [chunk[0]] * (bucket - k)
        # dedupe model versions by tree identity (distribution hands every
        # lane of a version the SAME object): the usual single-version
        # bucket broadcasts the weights instead of stacking them
        uniq: List[Any] = []
        vidx: List[int] = []
        seen: Dict[int, int] = {}
        for i in pad:
            t = params_list[i]
            j = seen.get(id(t))
            if j is None:
                j = seen[id(t)] = len(uniq)
                uniq.append(t)
            vidx.append(j)
        if bucket == k and rows[0] == 0 and _leading_len(batches) == k:
            batches_b = batches               # whole group, no padding
        else:
            ridx = torch.as_tensor(np.concatenate(
                [rows, np.full(bucket - k, rows[0], dtype=np.int64)]),
                device=self.device)
            batches_b = tree_map(lambda x: x[ridx], batches)
        alphas_b = self._alphas([alphas[i] for i in pad])
        if len(uniq) == 1:
            obs.CURRENT.add("engine.dispatch.stacked_shared")
            out = obs.CURRENT.device_call(
                "engine.payload", self._batched_shared, uniq[0], batches_b,
                alphas_b)
        else:
            vj = torch.as_tensor(vidx, device=self.device)
            params_b = tree_map(lambda *xs: torch.stack(xs)[vj], *uniq)
            obs.CURRENT.add("engine.dispatch.stacked_keyed")
            out = obs.CURRENT.device_call(
                "engine.payload", self._batched, params_b, batches_b,
                alphas_b)
        self.dispatches += 1
        self.payloads_computed += k
        if bucket == k:
            return out
        return tree_map(lambda x: x[:k], out)

    # ------------------------------------------------------------------
    # fused round update (batched mode fast path)
    # ------------------------------------------------------------------
    # at most ~staleness-bound distinct versions are live at once; a small
    # multiple of the bucket leaves headroom without pinning dead models
    _FLAT_CACHE_LIMIT = 64

    def _cache_flat(self, tree, flat: torch.Tensor) -> None:
        while len(self._flat_versions) >= self._FLAT_CACHE_LIMIT:
            # evict oldest first — each entry pins a full model copy
            self._flat_versions.pop(next(iter(self._flat_versions)))
        self._flat_versions[id(tree)] = (tree, flat)

    def _flat_of(self, tree, flattener: TreeFlattener) -> torch.Tensor:
        ent = self._flat_versions.get(id(tree))
        if ent is not None:
            return ent[1]
        flat = flattener.flatten(tree)
        self._cache_flat(tree, flat)
        return flat

    def _round_all_lanes(self, flattener: TreeFlattener, p_tree, versions,
                         batches, alphas, weights, beta):
        """All-lanes path: every lane carries its own flat model version;
        payloads are vmapped, then Eq. (8) runs through the kernel."""
        raw = self._raw

        def one(v, b, a):
            return raw(flattener.unflatten(v), b, a)

        payloads = vmap(one)(versions, batches, alphas)
        new_tree = stale_aggregate_tree(p_tree, payloads, weights, beta=beta)
        return new_tree, flattener.flatten(new_tree)

    def _group_partial(self, params, batches, alphas, weights):
        """Shared-version path: params broadcast, so the weights are read
        ONCE per version group instead of once per lane.  Returns the
        group's weighted payload sum."""
        raw = self._raw
        pay = vmap(lambda b, a: raw(params, b, a))(batches, alphas)
        return tree_map(
            lambda bl: torch.tensordot(weights, bl.to(torch.float32),
                                       dims=1), pay)

    def _combine(self, params, scale: float, partials):
        """w ← w − scale·Σ_g partial_g."""
        s = torch.tensor(scale, dtype=torch.float32, device=self.device)
        tot = tree_map(lambda *xs: sum(xs[1:], xs[0]), *partials)
        return tree_map(
            lambda p, t: (p.to(torch.float32) - s * t).to(p.dtype),
            params, tot)

    def _round_grouped(self, server_params, groups, gparams, batches_list,
                       alphas, weights, beta):
        partials = []
        for g, group_lanes in enumerate(groups):
            bucket = bucket_size(len(group_lanes), self.max_bucket)
            lanes = group_lanes + [group_lanes[0]] * (bucket -
                                                      len(group_lanes))
            batches = self._stack_host([batches_list[i] for i in lanes])
            alphas_b = self._alphas([alphas[i] for i in lanes])
            w = np.zeros(bucket, np.float32)
            w[:len(group_lanes)] = [float(weights[i]) for i in group_lanes]
            obs.CURRENT.add("engine.dispatch.group")
            partials.append(obs.CURRENT.device_call(
                "engine.round", self._group_partial, gparams[g], batches,
                alphas_b, torch.as_tensor(w, device=self.device)))
            self.dispatches += 1
        a_tot = max(float(np.asarray(weights, np.float32).sum()), 1.0)
        self.dispatches += 1                       # the combine call below
        obs.CURRENT.add("engine.dispatch.combine")
        return obs.CURRENT.device_call(
            "engine.round", self._combine, server_params, beta / a_tot,
            partials)

    def round_update(self, server_params, params_list: Sequence[Any],
                     batches_list: Sequence[Any], alphas: Sequence[float],
                     weights: np.ndarray, *, beta: float):
        """Fused round: payloads of a full round + Eq. (8) update, in one
        dispatch per model-version group (one total when versions are
        mostly distinct).

        ``weights`` are the server's aggregation weights (1s, or λ^τ
        staleness discounts); padded lanes get weight 0 so they never touch
        the update.  Returns the new global params tree.
        """
        m = len(params_list)
        if m > self.max_bucket:
            raise ValueError(f"round of {m} arrivals exceeds max_bucket="
                             f"{self.max_bucket}")
        # group lanes by the model version they computed against
        index: Dict[int, int] = {}
        groups: List[List[int]] = []
        gparams: List[Any] = []
        for i, t in enumerate(params_list):
            g = index.get(id(t))
            if g is None:
                g = index[id(t)] = len(groups)
                groups.append([])
                gparams.append(t)
            groups[g].append(i)

        self.payloads_computed += m
        if len(groups) <= max(1, m // 2):
            # enough version sharing to win from broadcasting the weights
            return self._round_grouped(server_params, groups, gparams,
                                       batches_list, alphas, weights, beta)

        flattener = TreeFlattener.for_tree(server_params)
        bucket = bucket_size(m, self.max_bucket)
        lanes = list(range(m)) + [0] * (bucket - m)
        versions = torch.stack([self._flat_of(params_list[i], flattener)
                                for i in lanes])
        batches = self._stack_host([batches_list[i] for i in lanes])
        alphas_b = self._alphas([alphas[i] for i in lanes])
        w = np.zeros(bucket, np.float32)
        w[:m] = np.asarray(weights, np.float32)
        obs.CURRENT.add("engine.dispatch.round")
        new_params, new_flat = obs.CURRENT.device_call(
            "engine.round", self._round_all_lanes, flattener, server_params,
            versions, batches, alphas_b,
            torch.as_tensor(w, device=self.device), float(beta))
        self.dispatches += 1
        self._cache_flat(new_params, new_flat)
        return new_params
