"""Traffic generation: token streams drawn from a seed.

One generator for every traffic file.  Each stream is a frozen copy of
the port's ``data/synthetic.synthetic_lm_corpus`` (a Zipfian bigram
stream, the LM examples' data), seeded by a sequence of whole numbers so
that any ``--seed`` (more than 32 bits included) and a purpose give their
own draws.  Many streams are walked side by side, each from its own
draws, so a batch of hundreds of streams is made in a fraction of a
second.  Every seed gives the same sizes; only the tokens differ.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

ZIPF_P = 1.0 / np.arange(1, 5)
ZIPF_P /= ZIPF_P.sum()


def lm_streams(n_tokens: int, vocab: int,
               seeds: Sequence[Sequence[int]]) -> np.ndarray:
    """[len(seeds), n_tokens] ids below ``vocab``: one Zipfian bigram
    stream a seed, each the stream ``synthetic_lm_corpus`` draws from a
    generator seeded so."""
    n = len(seeds)
    succ = np.empty((n, vocab, 4), dtype=np.int64)
    first = np.empty(n, dtype=np.int64)
    choices = np.empty((n, n_tokens))
    uniform = np.empty((n, n_tokens), dtype=np.int64)
    picks = np.empty((n, n_tokens), dtype=np.int64)
    for i, seed in enumerate(seeds):
        rng = np.random.default_rng(list(seed))
        # sparse bigram table: each token strongly prefers a few successors
        succ[i] = rng.integers(0, vocab, size=(vocab, 4))
        first[i] = rng.integers(vocab)
        choices[i] = rng.random(n_tokens)
        uniform[i] = rng.integers(0, vocab, size=n_tokens)
        picks[i] = rng.choice(4, p=ZIPF_P, size=n_tokens)
    stream = np.empty((n, n_tokens), dtype=np.int32)
    stream[:, 0] = first
    rows = np.arange(n)
    follow = choices < 0.8
    for t in range(1, n_tokens):
        stream[:, t] = np.where(follow[:, t],
                                succ[rows, stream[:, t - 1], picks[:, t]],
                                uniform[:, t])
    return stream


def score_batches(seed: int, traffic: Dict, vocab: int, codebooks: int
                  ) -> List[Dict[str, np.ndarray]]:
    """The pool of scoring calls: ``traffic["pool"]`` batches, each of
    ``traffic["users"]`` distinct users' streams of ``positions`` scored
    positions ({"tokens", "targets"}, [users, positions(, K)]); with K
    codebooks each is drawn on its own seed (as ``chip_smoke._score_batch``
    draws them)."""
    n, users = traffic["positions"], traffic["users"]
    out = []
    for i in range(traffic["pool"]):
        if codebooks:
            seeds = [(seed, 1, i, u, k) for u in range(users)
                     for k in range(codebooks)]
            toks = lm_streams(n + 1, vocab, seeds).reshape(
                users, codebooks, n + 1).transpose(0, 2, 1)
        else:
            toks = lm_streams(n + 1, vocab, [(seed, 1, i, u)
                                             for u in range(users)])
        toks = np.ascontiguousarray(toks)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def check_rows(seed: int, traffic: Dict) -> List[np.ndarray]:
    """For each batch of the pool, the ``check_users`` rows whose scores
    the check compares, drawn from the seed (sorted)."""
    return [np.sort(np.random.default_rng([seed, 2, i]).choice(
        traffic["users"], traffic["check_users"], replace=False))
        for i in range(traffic["pool"])]
