"""Synthetic stand-ins for the paper's datasets (offline container — no
downloads).  Each generator produces *learnable* class/sequence structure so
training curves are meaningful, with per-class signal strong enough that the
paper's qualitative phenomena (personalization gain, non-iid degradation)
reproduce.

* ``synthetic_mnist``       — 10-class Gaussian prototypes in 28×28
* ``synthetic_cifar``       — 100-class colored pattern prototypes in 32×32×3
* ``synthetic_shakespeare`` — per-role Markov character streams (80-char vocab)
* ``synthetic_lm_corpus``   — Zipfian bigram token stream for LLM examples
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_mnist(n: int = 6000, n_classes: int = 10, seed: int = 0,
                    noise: float = 0.35) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, 28, 28)).astype(np.float32)
    # low-pass the prototypes so they look like smooth strokes
    for _ in range(2):
        protos = (protos + np.roll(protos, 1, 1) + np.roll(protos, -1, 1)
                  + np.roll(protos, 1, 2) + np.roll(protos, -1, 2)) / 5.0
    protos /= np.abs(protos).max(axis=(1, 2), keepdims=True)
    y = rng.integers(0, n_classes, size=n)
    x = protos[y] + noise * rng.normal(size=(n, 28, 28)).astype(np.float32)
    return {"x": x.astype(np.float32), "y": y.astype(np.int32)}


def synthetic_cifar(n: int = 6000, n_classes: int = 100, seed: int = 1,
                    noise: float = 0.4) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, 32, 32, 3)).astype(np.float32)
    for _ in range(2):
        protos = (protos + np.roll(protos, 1, 1) + np.roll(protos, -1, 1)
                  + np.roll(protos, 1, 2) + np.roll(protos, -1, 2)) / 5.0
    protos /= np.abs(protos).max(axis=(1, 2, 3), keepdims=True)
    y = rng.integers(0, n_classes, size=n)
    x = protos[y] + noise * rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    return {"x": x.astype(np.float32), "y": y.astype(np.int32)}


def synthetic_shakespeare(n_roles: int = 188, chars_per_role: int = 2000,
                          vocab: int = 80, seq_len: int = 32, seed: int = 2
                          ) -> Dict[int, Dict[str, np.ndarray]]:
    """Per-role character streams from role-specific Markov chains.

    LEAF's Shakespeare is non-iid by speaking role; we mirror that: each role
    has its own transition matrix (shared backbone + role-specific
    perturbation), so the next-char distribution differs per client.
    Returns {role: {"tokens": [n_seq, L], "targets": [n_seq, L]}}.
    """
    rng = np.random.default_rng(seed)
    base = rng.dirichlet(np.full(vocab, 0.3), size=vocab)
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for role in range(n_roles):
        pert = rng.dirichlet(np.full(vocab, 0.15), size=vocab)
        trans = 0.6 * base + 0.4 * pert
        trans /= trans.sum(1, keepdims=True)
        stream = np.empty(chars_per_role, dtype=np.int32)
        stream[0] = rng.integers(vocab)
        for t in range(1, chars_per_role):
            stream[t] = rng.choice(vocab, p=trans[stream[t - 1]])
        n_seq = (chars_per_role - 1) // seq_len
        toks = stream[:n_seq * seq_len].reshape(n_seq, seq_len)
        targ = stream[1:n_seq * seq_len + 1].reshape(n_seq, seq_len)
        out[role] = {"tokens": toks, "targets": targ}
    return out


def conflicting_label_clients(n_clients: int, n_per_client: int = 300,
                              n_classes: int = 10, n_swap: int = 4,
                              seed: int = 0, noise: float = 0.35):
    """Clients share the input distribution but each permutes ``n_swap`` of
    the labels — no single global model fits everyone, while a meta-learned
    initialisation can adapt to each client in one gradient step.  This is
    the regime where PFL provably beats FL (the paper's motivation §I).

    Returns a list of {"x", "y"} dicts (feed to ClientDataset manually or
    via ``partition_noniid`` per client)."""
    rng = np.random.default_rng(seed)
    base = synthetic_mnist(n=n_per_client * n_clients, n_classes=n_classes,
                           seed=seed, noise=noise)
    out = []
    for ci in range(n_clients):
        sl = slice(ci * n_per_client, (ci + 1) * n_per_client)
        x, y = base["x"][sl], base["y"][sl].copy()
        swap = rng.choice(n_classes, size=n_swap, replace=False)
        perm = swap[np.argsort(rng.random(n_swap))]
        lut = np.arange(n_classes)
        lut[swap] = perm
        out.append({"x": x, "y": lut[y].astype(np.int32)})
    return out


def synthetic_lm_corpus(n_tokens: int = 1 << 16, vocab: int = 512,
                        seed: int = 3) -> np.ndarray:
    """Zipfian bigram stream — enough structure for loss curves to move."""
    rng = np.random.default_rng(seed)
    # sparse bigram table: each token strongly prefers a few successors
    succ = rng.integers(0, vocab, size=(vocab, 4))
    zipf_p = 1.0 / np.arange(1, 5)
    zipf_p /= zipf_p.sum()
    stream = np.empty(n_tokens, dtype=np.int32)
    stream[0] = rng.integers(vocab)
    choices = rng.random(n_tokens)
    uniform = rng.integers(0, vocab, size=n_tokens)
    picks = rng.choice(4, p=zipf_p, size=n_tokens)
    for t in range(1, n_tokens):
        if choices[t] < 0.8:
            stream[t] = succ[stream[t - 1], picks[t]]
        else:
            stream[t] = uniform[t]
    return stream
