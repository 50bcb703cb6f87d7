"""Non-i.i.d. federated partitioning — Sec. VI-A-3 of the paper.

Each UE is allocated a different local data size and holds exactly ``n_labels`` of
the label classes (the non-iid level; smaller = more heterogeneous).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class ClientDataset:
    """One UE's local dataset + batch sampler (train/test split)."""
    data: Dict[str, np.ndarray]
    test: Dict[str, np.ndarray]
    labels_held: np.ndarray
    rng: np.random.Generator

    def __len__(self) -> int:
        return len(next(iter(self.data.values())))

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        n = len(self)
        idx = self.rng.integers(0, n, size=min(batch_size, n))
        return {k: v[idx] for k, v in self.data.items()}

    def triplet_sizes(self, b_in: int, b_o: int, b_h: int
                      ) -> "tuple[int, int, int]":
        """Actual (inner, outer, hessian) batch sizes ``sample_triplet``
        will return — the truncation rule lives HERE, next to the sampler,
        so shape-compatibility checks can't drift from it."""
        n = len(self)
        return (min(b_in, n), min(b_o, n), min(b_h, n))

    def drift_labels(self, rng: np.random.Generator, frac: float,
                     label_key: str = "y") -> int:
        """Non-stationary label drift (scenario suite): remap a random
        ``frac`` of this client's samples under a random permutation of
        the classes it holds, in BOTH splits — the personalized eval
        then reflects the drifted distribution, not the drop-time one.

        Draws only from the caller's ``rng`` (the scenario stream), never
        from the private sampling generator, so enabling drift does not
        perturb the batch-index schedule of undrifted clients.  Returns
        the number of samples whose label actually changed (0 when the
        client holds fewer than two classes, or has no label field).
        """
        if label_key not in self.data:
            return 0
        classes = np.unique(np.concatenate(
            [self.data[label_key], self.test[label_key]]))
        if len(classes) < 2:
            return 0
        perm = classes[rng.permutation(len(classes))]
        lut = np.zeros(int(classes.max()) + 1, dtype=classes.dtype)
        lut[classes] = perm
        changed = 0
        for split in (self.data, self.test):
            y = split[label_key]
            pick = rng.random(len(y)) < frac
            new_y = np.where(pick, lut[y], y)
            changed += int(np.count_nonzero(new_y != y))
            split[label_key] = new_y
        self.labels_held = np.unique(self.data[label_key])
        return changed

    def sample_triplet(self, b_in: int, b_o: int, b_h: int) -> Dict[str, Dict]:
        """Three *independent* batches (D_in, D_o, D_h of Eq. 7).

        Drawn as ONE index vector + one gather per field, then sliced into
        the three views — the simulator calls this once per arrival, so it
        sits on the event-loop hot path.
        """
        s_in, s_o, s_h = self.triplet_sizes(b_in, b_o, b_h)
        idx = self.rng.integers(0, len(self), size=s_in + s_o + s_h)
        full = {k: v[idx] for k, v in self.data.items()}
        return {"inner": {k: v[:s_in] for k, v in full.items()},
                "outer": {k: v[s_in:s_in + s_o] for k, v in full.items()},
                "hessian": {k: v[s_in + s_o:] for k, v in full.items()}}


def sample_triplet_many(clients: List[ClientDataset], b_in: int, b_o: int,
                        b_h: int) -> Dict[str, Dict[str, np.ndarray]]:
    """Stacked ``sample_triplet`` for several clients in ONE pass.

    Returns the same ``{"inner"/"outer"/"hessian": {field: array}}`` layout
    with a leading client axis, gathered straight into preallocated stacked
    buffers — the batch-wise driver feed hands these to the engine without
    re-stacking per lane.  Each client consumes exactly the one
    ``rng.integers`` call ``sample_triplet`` would, in list order, so the
    result is bitwise identical to the per-UE loop (each ``ClientDataset``
    owns a private generator).  All clients must share triplet sizes and
    field shapes (the driver groups lanes by shape signature first).
    """
    if not clients:
        raise ValueError("sample_triplet_many needs at least one client")
    s_in, s_o, s_h = clients[0].triplet_sizes(b_in, b_o, b_h)
    total = s_in + s_o + s_h
    m = len(clients)
    stacked: Dict[str, np.ndarray] = {
        k: np.empty((m, total) + v.shape[1:], dtype=v.dtype)
        for k, v in clients[0].data.items()}
    for i, c in enumerate(clients):
        if c.triplet_sizes(b_in, b_o, b_h) != (s_in, s_o, s_h):
            raise ValueError("sample_triplet_many: mixed triplet sizes — "
                             "group clients by shape signature first")
        idx = c.rng.integers(0, len(c), size=total)
        for k, v in c.data.items():
            np.take(v, idx, axis=0, out=stacked[k][i])
    return {"inner": {k: v[:, :s_in] for k, v in stacked.items()},
            "outer": {k: v[:, s_in:s_in + s_o] for k, v in stacked.items()},
            "hessian": {k: v[:, s_in + s_o:] for k, v in stacked.items()}}


def partition_noniid(data: Dict[str, np.ndarray], n_clients: int,
                     n_labels: int,
                     *, n_classes: Optional[int] = None, seed: int = 0,
                     label_key: str = "y", test_frac: float = 0.2,
                     size_spread: float = 3.0) -> List[ClientDataset]:
    """Partition ``data`` so each client holds exactly ``n_labels`` classes.

    Shards per class are split round-robin among the clients holding that
    class; client sizes vary by up to ``size_spread``× (paper: "each UE is
    allocated a different local data size").
    """
    rng = np.random.default_rng(seed)
    y = data[label_key]
    classes = np.unique(y) if n_classes is None else np.arange(n_classes)
    n_cls = len(classes)
    n_labels = max(1, min(n_labels, n_cls))

    # assign exactly n_labels distinct classes per client; spread coverage by
    # preferring the least-held classes (classes no client holds stay unused
    # — with n·n_labels < n_classes full coverage is impossible anyway)
    held_count = {int(c): 0 for c in classes}
    client_classes = []
    for _ in range(n_clients):
        order = sorted(classes, key=lambda c: (held_count[int(c)],
                                               rng.random()))
        mine = np.array(sorted(order[:n_labels]))
        for c in mine:
            held_count[int(c)] += 1
        client_classes.append(mine)

    # holders per class
    holders: Dict[int, List[int]] = {int(c): [] for c in classes}
    for ci, cls in enumerate(client_classes):
        for c in cls:
            holders[int(c)].append(ci)

    # heterogeneous size weights
    weights = np.exp(rng.uniform(0, np.log(size_spread), size=n_clients))

    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx_c = np.where(y == c)[0]
        rng.shuffle(idx_c)
        hs = holders[int(c)]
        if not hs:
            continue
        w = weights[hs] / weights[hs].sum()
        cuts = np.floor(np.cumsum(w) * len(idx_c)).astype(int)
        prev = 0
        for hi, cut in zip(hs, cuts):
            client_idx[hi].extend(idx_c[prev:cut].tolist())
            prev = cut

    out: List[ClientDataset] = []
    for ci in range(n_clients):
        idx = np.array(sorted(client_idx[ci]), dtype=np.int64)
        if len(idx) < 4:                   # guarantee a usable shard — pad
            pool = np.where(np.isin(y, client_classes[ci]))[0]
            extra = rng.choice(pool, size=8)    # ...from the SAME n_labels classes
            idx = np.concatenate([idx, extra])
        rng.shuffle(idx)
        n_test = max(1, int(len(idx) * test_frac))
        test_idx, train_idx = idx[:n_test], idx[n_test:]
        out.append(ClientDataset(
            data={k: v[train_idx] for k, v in data.items()},
            test={k: v[test_idx] for k, v in data.items()},
            labels_held=np.unique(y[train_idx]),
            rng=np.random.default_rng(seed * 1000 + ci + 1),
        ))
    return out


def sequence_clients(role_data: Dict[int, Dict[str, np.ndarray]],
                     n_clients: int, seed: int = 0,
                     test_frac: float = 0.2) -> List[ClientDataset]:
    """Shakespeare-style: each client = one role's sequences."""
    roles = sorted(role_data)[:n_clients]
    out = []
    for ci, role in enumerate(roles):
        d = role_data[role]
        n = len(d["tokens"])
        n_test = max(1, int(n * test_frac))
        out.append(ClientDataset(
            data={k: v[n_test:] for k, v in d.items()},
            test={k: v[:n_test] for k, v in d.items()},
            labels_held=np.array([role]),
            rng=np.random.default_rng(seed * 1000 + ci + 1),
        ))
    return out
