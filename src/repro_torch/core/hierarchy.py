"""Hierarchical cell → cloud aggregation (HPFL-style, cf. arXiv:2303.10580).

Each cell runs its own ``SemiSyncServer`` — the Algorithm-1 / Eq.-8
semi-synchronous protocol, unchanged, over the UEs currently associated
with that cell — and a cloud tier periodically merges the per-cell edge
models with ``masked_aggregate_tree`` (the same unified aggregation API the
edge update itself uses), weighted by each cell's arrival count since the
last merge.  After a merge every edge server continues from the merged
model; UEs receive it lazily, at their next distribution event, exactly as
they receive ordinary round updates.

Cell membership is dynamic: ``handover(ue, src, dst)`` retires the UE from
``src`` (a sentinel version means "never considered stale here") and grafts
its *current staleness* onto ``dst``'s round clock — so a UE that hands
over mid-computation shows up in the new cell exactly as stale as it really
is, and the τ > S forced-refresh rule fires across cell boundaries
(handover-induced staleness).

The port of the JAX package's ``core/hierarchy.py``.  Membership, staleness
and cadence bookkeeping is the reference's host code unchanged; the device
parts are torch: per-cell payload segments are sliced (or gathered with
``index_select``) on the card, and the cloud merge is the port's
``masked_aggregate_tree`` (a leaf-wise ``tensordot``, not a kernel).  After
a merge every cell holds the SAME tree object; that is safe because no code
path updates params in place (Eq. 8 writes a fresh buffer).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.server import SemiSyncServer, ServerConfig
from repro_torch.kernels.stale_aggregate import masked_aggregate_tree
from repro_torch.obs import trace as obs
from repro_torch.utils.tree import tree_leaves, tree_map

# version sentinel: staleness = round − version stays hugely negative, so a
# non-member UE never triggers this cell's forced-refresh rule
NON_MEMBER = np.int64(1) << 60


@dataclass(frozen=True)
class HierarchyConfig:
    n_cells: int
    cloud_sync_every: int = 5        # merge every N completed edge rounds
    cell_weighting: str = "arrivals"  # arrivals | uniform


class HierarchicalServer:
    """Per-cell ``SemiSyncServer`` edge tier + periodic cloud merge."""

    def __init__(self, params: Any, cell_cfgs: Sequence[ServerConfig],
                 hcfg: HierarchyConfig,
                 members: Sequence[np.ndarray]):
        if len(cell_cfgs) != hcfg.n_cells or len(members) != hcfg.n_cells:
            raise ValueError("need one ServerConfig + member set per cell")
        self.hcfg = hcfg
        self.cells = [SemiSyncServer(params, cfg) for cfg in cell_cfgs]
        n = cell_cfgs[0].n_ues
        # −1 = not a member of any cell (dormant / departed under the
        # open-world scenario; a closed-world init covers every index)
        self.member_cell = np.full(n, -1, dtype=np.int64)
        for c, srv in enumerate(self.cells):
            srv.ue_version[:] = NON_MEMBER
            idx = np.asarray(members[c], dtype=np.int64)
            srv.ue_version[idx] = 0
            self.member_cell[idx] = c
        self.cloud_params = params
        self.edge_rounds = 0             # completed rounds across all cells
        self.cloud_rounds = 0            # completed cloud merges
        self.departed_arrivals = 0       # uploads landing after a handover
        self._arrivals_since_sync = np.zeros(hcfg.n_cells, dtype=np.int64)
        self.history_pi: List[np.ndarray] = []   # edge-round order, all cells
        self.history_cell: List[int] = []

    # ------------------------------------------------------------------
    def cell(self, c: int) -> SemiSyncServer:
        return self.cells[c]

    def arrivals_until_round(self, c: int) -> int:
        return self.cells[c].arrivals_until_round()

    def set_live_cap(self, c: int, members: int, in_flight: int) -> None:
        """Clamp cell ``c``'s effective round size to live membership
        (see ``SemiSyncServer.set_live_cap``)."""
        self.cells[c].set_live_cap(members, in_flight)

    def flush(self, c: int) -> Optional[Dict[str, Any]]:
        """Close cell ``c``'s round if its clamped target is already met
        (``SemiSyncServer.flush``), with the full hierarchy bookkeeping —
        membership-filtered distribution, cloud-merge cadence."""
        res = self.cells[c].flush()
        return None if res is None else self._finish(c, res)

    def pending_uploads(self) -> int:
        return sum(srv.pending_uploads() for srv in self.cells)

    def open_rounds(self) -> int:
        """Cells currently holding uploads toward an unclosed round."""
        return sum(1 for srv in self.cells if srv.pending_uploads() > 0)

    # --- open-world UE lifecycle (scenario churn) ----------------------
    def join(self, ue: int, c: int) -> None:
        """Activate ``ue`` as a member of cell ``c`` with a fresh model
        (version = the cell's current round → staleness 0)."""
        self.member_cell[ue] = c
        self.cells[c].ue_version[ue] = self.cells[c].round

    def leave(self, ue: int) -> None:
        """Depart ``ue``: it stops being a member anywhere.  Its pending
        upload (if any) still aggregates when the round closes, but
        ``_finish``'s membership filter keeps it out of the distribution
        — no resurrection.  The caller cancels in-flight computation via
        the driver's epoch mechanism."""
        c = int(self.member_cell[ue])
        if c >= 0:
            self.cells[c].ue_version[ue] = NON_MEMBER
        self.member_cell[ue] = -1

    @property
    def params(self) -> Any:
        """Latest cloud model (cell 0's edge model before the first merge)."""
        return self.cloud_params if self.cloud_rounds else \
            self.cells[0].params

    # ------------------------------------------------------------------
    def handover(self, ue: int, src: int, dst: int) -> None:
        """Move a UE between cells, carrying its staleness across."""
        if src == dst:
            return
        tau = self.cells[src].staleness(ue)
        self.cells[src].ue_version[ue] = NON_MEMBER
        # round − version = τ in the new cell's clock (version may go
        # negative for a UE staler than the cell is old — still correct)
        self.cells[dst].ue_version[ue] = self.cells[dst].round - max(tau, 0)
        self.member_cell[ue] = dst

    def _visiting_version(self, c: int, ue: int) -> np.int64:
        """A version giving a *departed* UE a sensible τ in cell ``c``'s
        clock: its current staleness, read from the cell it now lives in."""
        cur = int(self.member_cell[ue])
        if cur < 0:
            # departed the whole network (open-world churn): no live round
            # clock to read — weight the straggler upload as fresh
            return np.int64(self.cells[c].round)
        tau = max(int(self.cells[cur].staleness(ue)), 0)
        return np.int64(self.cells[c].round - tau)

    # ------------------------------------------------------------------
    def on_arrival(self, c: int, ue: int,
                   payload: Any) -> Optional[Dict[str, Any]]:
        srv = self.cells[c]
        # an upload can complete at a cell the UE has since handed over
        # from (it was in flight when the handover hit) — give it a sane
        # staleness for the weighting, without resurrecting membership
        departed = int(self.member_cell[ue]) != c
        if departed:
            self.departed_arrivals += 1
            srv.ue_version[ue] = self._visiting_version(c, ue)
        res = srv.on_arrival(ue, payload)
        if res is None:
            if departed:
                srv.ue_version[ue] = NON_MEMBER
            return None
        return self._finish(c, res)

    def on_arrival_batch(self, cells: np.ndarray, ues: np.ndarray,
                         payloads: Any) -> Optional[Dict[str, Any]]:
        """Multi-cell segment feed of one drained batch (payloads stacked
        in lane order — the driver's batch-wise path).

        The drain invariant makes this simple: at most ONE round closes
        per drain and its closing arrival is the batch's LAST lane.  So
        lanes are fed per cell with the last lane's cell processed LAST —
        every other cell's visiting-staleness reads of round clocks happen
        before the close can advance one.  Departed lanes get a transient
        visiting version for the τ weighting, reverted to NON_MEMBER
        unless they are the literal closing arrival — whose stamp the
        per-arrival path lets ``_advance_round``'s staleness snapshot see
        (``_finish`` strips it from membership afterwards either way).
        """
        cells = np.asarray(cells, dtype=np.int64)
        ues = np.asarray(ues, dtype=np.int64)
        last_cell = int(cells[-1])
        order = [c for c in dict.fromkeys(int(x) for x in cells)
                 if c != last_cell] + [last_cell]
        lanes_of = [np.nonzero(cells == c)[0] for c in order]

        def seg_of(ln: np.ndarray) -> Any:
            """Per-cell rows of the stacked payloads, in lane (arrival)
            order — a contiguous slice when the driver cell-sorted the
            batch (its fast path), one gather per cell otherwise.
            Payload trees are [k, model]-sized, so avoiding whole-tree
            copies here is what keeps the feed device-bound."""
            if len(ln) == len(ues):
                return payloads
            if int(ln[-1]) - int(ln[0]) + 1 == len(ln):    # contiguous
                lo, hi = int(ln[0]), int(ln[-1]) + 1
                return tree_map(lambda x: x[lo:hi], payloads)
            lj = torch.as_tensor(ln, device=tree_leaves(payloads)[0].device)
            return tree_map(lambda x: torch.index_select(x, 0, lj), payloads)

        result: Optional[Dict[str, Any]] = None
        for c, lanes in zip(order, lanes_of):
            seg = seg_of(lanes)
            srv = self.cells[c]
            cus = ues[lanes]
            departed = [int(u) for u in cus
                        if int(self.member_cell[u]) != c]
            for u in departed:
                self.departed_arrivals += 1
                srv.ue_version[u] = self._visiting_version(c, u)
            taus = srv.round - srv.ue_version[cus]      # τ at arrival
            final = int(ues[-1]) if c == last_cell else None
            for u in departed:
                if u != final:
                    srv.ue_version[u] = NON_MEMBER
            res = srv.on_arrival_batch(cus, seg, taus=taus)
            if res is None:
                # possible only when the drain ended on heap exhaustion —
                # then the last lane closed nothing, so revert its stamp
                if final is not None and final in departed:
                    srv.ue_version[final] = NON_MEMBER
                continue
            assert c == last_cell, "drain invariant: only the last lane's " \
                                   "cell may close a round"
            result = self._finish(c, res)
        return result

    def on_round_batch(self, c: int, ues: Sequence[int],
                       aggregate_fn: Callable) -> Dict[str, Any]:
        srv = self.cells[c]
        for u in ues:
            if int(self.member_cell[u]) != c:
                self.departed_arrivals += 1
                srv.ue_version[u] = self._visiting_version(c, u)
        return self._finish(c, srv.on_round_batch(ues, aggregate_fn))

    def _finish(self, c: int, res: Dict[str, Any]) -> Dict[str, Any]:
        self.edge_rounds += 1
        self.history_pi.append(self.cells[c].history_pi[-1])
        self.history_cell.append(c)
        # realised round size (== A except live-cap-clamped churn rounds)
        self._arrivals_since_sync[c] += int(self.cells[c].history_pi[-1].sum())
        res = dict(res)
        # the cell's _advance_round stamped fresh versions on everyone it
        # distributes to — departed UEs must not be resurrected as members
        # here, nor receive this cell's model (they live elsewhere now)
        srv = self.cells[c]
        keep = []
        for i in res["distribute"]:
            if int(self.member_cell[i]) == c:
                keep.append(i)
            else:
                srv.ue_version[i] = NON_MEMBER
        res["distribute"] = keep
        res["cell"] = c
        res["round"] = self.edge_rounds      # global edge-round clock
        res["cloud_synced"] = False
        every = self.hcfg.cloud_sync_every
        if every > 0 and self.edge_rounds % every == 0:
            self.cloud_sync()
            res["params"] = self.cells[c].params   # the merged model
            res["cloud_synced"] = True
        return res

    # ------------------------------------------------------------------
    def cloud_sync(self) -> None:
        """Merge cell models: weighted mean via ``masked_aggregate_tree``."""
        with obs.CURRENT.span("cloud_sync"):
            obs.CURRENT.add("hierarchy.cloud_syncs")
            self._cloud_sync()

    def _cloud_sync(self) -> None:
        if self.hcfg.cell_weighting == "arrivals" and \
                self._arrivals_since_sync.sum() > 0:
            w = self._arrivals_since_sync.astype(np.float32)
        else:
            w = np.ones(self.hcfg.n_cells, np.float32)
        ref = self.cells[0].params
        merged = obs.CURRENT.device_call(
            "cloud_sync", masked_aggregate_tree,
            [srv.params for srv in self.cells],
            torch.as_tensor(w, device=tree_leaves(ref)[0].device))
        merged = tree_map(lambda m, p: m.to(p.dtype), merged, ref)
        for srv in self.cells:
            srv.params = merged
        self.cloud_params = merged
        self.cloud_rounds += 1
        self._arrivals_since_sync[:] = 0

    # ------------------------------------------------------------------
    def pi_matrix(self) -> np.ndarray:
        """Realised Π across all cells, rows in edge-round completion order."""
        if not self.history_pi:
            n = self.cells[0].cfg.n_ues
            return np.zeros((0, n), dtype=np.int64)
        return np.stack(self.history_pi)

    def realised_eta(self) -> np.ndarray:
        pi = self.pi_matrix()
        tot = pi.sum()
        return pi.sum(0) / max(tot, 1)
