"""Algorithm 1 — the PerFedS² parameter-server round logic (simulation path).

This is the *protocol* object: it owns the global model, collects arriving
client payloads, advances the round once ``A`` of them are in (semi-sync),
and decides who receives the new model (the round's participants plus any
client whose staleness exceeded ``S``).  ``mode`` generalises it:

  sync  → A = n   (classic synchronous round)
  semi  → A = A   (the paper)
  async → A = 1   (update on every arrival)

Wall-clock time, channels and scheduling live in ``fl/simulation.py``; model
math (what a "payload" is) lives in ``fl/client.py``.  Eq. (8) runs through
``kernels.stale_aggregate`` on the params' device (the Hopper kernel on a
card), with the JAX package's summation order: pending uploads in arrival
order, segments concatenated in feed order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.stale_aggregate import stale_aggregate_tree
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclass
class ServerConfig:
    n_ues: int
    participants_per_round: int      # A
    staleness_bound: int             # S
    beta: float                      # global step size
    mode: str = "semi"               # sync | semi | async
    staleness_discount: float = 1.0  # SAFA/FedSA-style λ^τ payload weighting
                                     # (refs [20][21]); 1.0 = paper's Eq. (8)


class SemiSyncServer:
    """Collects payloads; applies Eq. (8); tracks staleness and distribution."""

    def __init__(self, params: Any, cfg: ServerConfig):
        self.cfg = cfg
        self.params = params
        self.round = 0
        self.a = {"sync": cfg.n_ues, "semi": cfg.participants_per_round,
                  "async": 1}[cfg.mode]
        # effective close threshold for the CURRENT round: equals ``a``
        # until ``set_live_cap`` clamps it to live membership (open-world
        # churn: a cell that shrinks below A must keep closing — smaller —
        # rounds instead of live-locking).  Frozen between cap updates so
        # ``arrivals_until_round`` is stable across one driver drain.
        self._target = self.a
        self._live_cap: Optional[int] = None
        # which UEs currently exist (scenario churn departs/joins them);
        # inactive UEs are never distributed to — a pending upload from a
        # UE that departed before its round closed still aggregates, but
        # must not resurrect it with a fresh model
        self.ue_active = np.ones(cfg.n_ues, dtype=bool)
        # version of the global model each UE last received
        self.ue_version = np.zeros(cfg.n_ues, dtype=np.int64)
        # (ue, payload, staleness-at-arrival) per pending upload
        self._pending: List[Tuple[int, Any, int]] = []
        # segment-pending uploads from the batch-wise feed: (ues, taus,
        # stacked payload tree) per drained batch, concatenated at close
        self._pending_seg: List[Tuple[np.ndarray, np.ndarray, Any]] = []
        self._seg_n = 0                  # lanes across _pending_seg (O(1))
        # bookkeeping for analysis / tests
        self.history_pi: List[np.ndarray] = []       # realised Π rows
        self.history_staleness: List[np.ndarray] = []

    # ------------------------------------------------------------------
    @property
    def target(self) -> int:
        """The current round's effective close threshold (≤ A)."""
        return self._target

    def pending_uploads(self) -> int:
        """Uploads held for the currently open round (both feed paths)."""
        return len(self._pending) + self._seg_n

    def pending_ue_set(self) -> set:
        """UEs with an upload held for the open round (both feed paths) —
        the ``pre_drain`` live-cap computation subtracts these from the
        members that can still produce an arrival."""
        out = {ue for ue, _, _ in self._pending}
        for ues, _, _ in self._pending_seg:
            out.update(int(u) for u in ues)
        return out

    def set_live_cap(self, members: int, in_flight: int) -> None:
        """Clamp the effective round size to what can still arrive.

        ``target = min(A, pending + in_flight)``: every upload already
        held counts, plus each live member whose cycle is still in flight
        can contribute at most one more before the close — the round
        never waits for uploads no existing UE can produce.  The caller
        (``TopologyAdapter.pre_drain``) computes ``in_flight`` as live
        members without a pending upload here.  Caps are pushed only
        BETWEEN drains, so the threshold is constant while a drain is in
        flight — the drain invariant (at most one round closes, on the
        last lane) is preserved.  With membership ≥ A this is exactly
        ``target = A``: closed-world runs are bitwise unaffected.  When
        the clamp lands at (or below) the pending count no future arrival
        will trigger the close — ``flush`` closes such a round.
        """
        self._live_cap = int(members)
        p = self.pending_uploads()
        self._target = max(1, min(self.a, p + max(int(in_flight), 0)))

    def activate(self, ue: int) -> None:
        """(Re-)join: the UE exists again and starts from the current
        round's model (the caller hands it the params; version = round
        means staleness 0)."""
        self.ue_active[ue] = True
        self.ue_version[ue] = self.round

    def deactivate(self, ue: int) -> None:
        """Depart: no future distribution; any in-flight upload is the
        caller's to cancel (driver epoch bump)."""
        self.ue_active[ue] = False

    def arrivals_until_round(self) -> int:
        """How many more uploads close the current round (target − pending).

        Until that many arrive, no global update, distribution, or
        cancellation can happen — which is exactly what lets the simulator
        drain that many events and compute their payloads as one batch.
        """
        return self._target - len(self._pending) - self._seg_n

    def staleness(self, ue: int) -> int:
        """τ_k^i — rounds since UE i last received the global model."""
        return self.round - int(self.ue_version[ue])

    def on_arrival(self, ue: int, payload: Any) -> Optional[Dict[str, Any]]:
        """Register one client upload.  Returns None while the round is open;
        once the A-th payload arrives, applies the global update and returns
        {"round", "distribute": [ue...], "params"}.
        """
        if self._pending_seg:
            raise RuntimeError("segment uploads pending; feed rounds "
                               "through on_arrival_batch consistently")
        self._pending.append((ue, payload, self.staleness(ue)))
        if len(self._pending) < self._target:
            return None
        return self._close_pending()

    def _close_pending(self) -> Dict[str, Any]:
        arrived = self._pending
        self._pending = []
        # --- Eq. (8): w_{k+1} = w_k − β/A Σ_{i∈A_k} ∇̃F_i(w_{k−τ_k^i}),
        # optionally λ^τ staleness-discounted — the discount folds into the
        # aggregation mask, so every mode shares the one fused kernel path --
        mask = self._weights([tau for _, _, tau in arrived])
        self.params = stale_aggregate_tree(
            self.params, [g for _, g, _ in arrived], self._mask(mask),
            beta=self.cfg.beta)
        return self._advance_round([i for i, _, _tau in arrived])

    def on_arrival_batch(self, ues: np.ndarray, payloads: Any,
                         taus: Optional[np.ndarray] = None
                         ) -> Optional[Dict[str, Any]]:
        """Segment feed: one drained batch of uploads with the payloads
        STACKED (leading lane axis, arrival order) — the batch-wise
        driver path.

        Returns ``None`` while the round stays open.  On the segment
        whose last lane is the A-th pending upload, the pending segments
        are concatenated in arrival order and Eq. (8) runs ONCE over the
        stacked tree — the summation order (stacked row order) is exactly
        the per-arrival path's, so trajectories match.  The driver's
        drain invariant guarantees a segment never overshoots A (the
        drain breaks on the closing arrival); ``taus`` overrides the
        staleness-at-arrival vector (the hierarchy stamps transient
        visiting versions and must snapshot τ before reverting them).
        """
        if self._pending:
            raise RuntimeError("per-arrival uploads pending; feed rounds "
                               "through on_arrival consistently")
        ues = np.asarray(ues, dtype=np.int64)
        if taus is None:
            taus = self.round - self.ue_version[ues]
        self._pending_seg.append((ues, np.asarray(taus, np.int64), payloads))
        self._seg_n += len(ues)
        if self._seg_n > self._target:
            raise RuntimeError(f"segment overshoots target={self._target}: "
                               f"{self._seg_n} lanes pending")
        if self._seg_n < self._target:
            return None
        return self._close_segments()

    def _close_segments(self) -> Dict[str, Any]:
        segs = self._pending_seg
        self._pending_seg, self._seg_n = [], 0
        all_ues = np.concatenate([u for u, _, _ in segs])
        all_taus = np.concatenate([t for _, t, _ in segs])
        mask = self._weights(all_taus)
        if len(segs) == 1:
            stacked = segs[0][2]
        else:
            stacked = tree_map(lambda *xs: torch.cat(xs, dim=0),
                               *[p for _, _, p in segs])
        self.params = stale_aggregate_tree(
            self.params, stacked, self._mask(mask), beta=self.cfg.beta)
        return self._advance_round([int(u) for u in all_ues])

    def flush(self) -> Optional[Dict[str, Any]]:
        """Close the open round NOW if its pending uploads already meet
        the live-cap-clamped target.

        Churn can lower the target to (or below) the pending count
        *after* those uploads arrived — every remaining member's upload
        is already in — so no future arrival exists to trigger the
        ordinary close and waiting would live-lock.  Returns the round
        result, or ``None`` while more arrivals are still possible."""
        p = self.pending_uploads()
        if p == 0 or p < self._target:
            return None
        if self._pending:
            return self._close_pending()
        return self._close_segments()

    def on_round_batch(self, ues: Sequence[int],
                       aggregate_fn: Callable) -> Dict[str, Any]:
        """Fused fast path: a full round of uploads arrives at once.

        The simulator drains exactly the A arrivals that close the round and
        delegates the Eq. (8) math to ``aggregate_fn(params, weights) →
        new_params`` (the engine's single fused dispatch: payload
        computation + masked stale aggregation).  Protocol state — rounds,
        Π, staleness, the distribution rule — stays here, identical to the
        per-arrival path.
        """
        if self._pending or self._pending_seg:
            raise RuntimeError("pending uploads exist; use on_arrival / "
                               "on_arrival_batch")
        if len(ues) != self._target:
            raise ValueError(f"round batch needs exactly target="
                             f"{self._target} uploads, got {len(ues)}")
        weights = self._weights([self.staleness(u) for u in ues])
        self.params = aggregate_fn(self.params, weights)
        return self._advance_round(list(ues))

    # ------------------------------------------------------------------
    def _mask(self, weights: np.ndarray) -> torch.Tensor:
        """Host aggregation weights → f32 mask on the params' device."""
        return torch.as_tensor(weights, dtype=torch.float32,
                               device=tree_leaves(self.params)[0].device)

    def _weights(self, taus: Sequence[int]) -> np.ndarray:
        """Aggregation mask: 1s, or normalised λ^τ staleness discounts."""
        lam = self.cfg.staleness_discount
        if lam < 1.0:
            wts = np.array([lam ** tau for tau in taus])
            # normalise by the realised round size (== A except for
            # live-cap-clamped rounds under churn)
            return wts * (len(taus) / max(wts.sum(), 1e-12))
        return np.ones(len(taus))

    def _advance_round(self, arrived_ues: List[int]) -> Dict[str, Any]:
        pi_row = np.zeros(self.cfg.n_ues, dtype=np.int64)
        stale_row = np.array([self.staleness(i) for i in range(self.cfg.n_ues)])
        for i in arrived_ues:
            pi_row[i] = 1
        self.history_pi.append(pi_row)
        self.history_staleness.append(stale_row)

        self.round += 1
        # --- distribution rule (Alg. 1 line 13-15) -------------------------
        # departed UEs are filtered out: an upload from a UE that left
        # while pending still aggregated above, but distribution would
        # resurrect it with a fresh cycle
        distribute = sorted(
            {i for i in arrived_ues if self.ue_active[i]}
            | {i for i in range(self.cfg.n_ues)
               if self.ue_active[i]
               and self.staleness(i) > self.cfg.staleness_bound})
        for i in distribute:
            self.ue_version[i] = self.round
        if self._live_cap is not None:
            # re-arm the next round's threshold from the last cap push
            # (pending is empty again; refreshed at the next pre_drain)
            self._target = max(1, min(self.a, max(self._live_cap, 1)))
        return {"round": self.round, "distribute": distribute,
                "params": self.params}

    # ------------------------------------------------------------------
    def pi_matrix(self) -> np.ndarray:
        """Realised scheduling matrix Π (rows = completed rounds)."""
        if not self.history_pi:
            return np.zeros((0, self.cfg.n_ues), dtype=np.int64)
        return np.stack(self.history_pi)

    def realised_eta(self) -> np.ndarray:
        """Empirical relative participation frequencies (Eq. 15)."""
        pi = self.pi_matrix()
        tot = pi.sum()
        return pi.sum(0) / max(tot, 1)
