"""Serve a small model with batched requests — with per-user personalization.

Per-FedAvg's deployment story: the trained meta-initialisation is adapted
with ONE gradient step on each user's data before serving.  This example
serves two users whose "dialects" differ (different token statistics) and
shows the adapted models' losses beating the shared meta model on each
user's own stream.

    PYTHONPATH=src python -m repro_torch.examples.serve_personalized \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.perfed import adapt
from repro_torch.data.synthetic import synthetic_lm_corpus
from repro_torch.fl.engine import resolve_device
from repro_torch.models import build_model


def batch_from(corpus, device, n=8, sl=64, off=0):
    toks = np.stack([corpus[i * sl + off:(i + 1) * sl + off]
                     for i in range(n)])
    targ = np.stack([corpus[i * sl + 1 + off:(i + 1) * sl + 1 + off]
                     for i in range(n)])
    return {"tokens": torch.from_numpy(toks).to(device),
            "targets": torch.from_numpy(targ).to(device)}


def main(argv=None):
    """Returns {"meta_losses", "adapted_losses", "tokens" [4, 16]}."""
    ap = argparse.ArgumentParser(description="personalized serving")
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))

    cfg = dataclasses.replace(get_config("yi_6b").reduced(), vocab_size=512)
    model = build_model(cfg)
    # simlint: disable-next=SIM102 -- the example's one fixed draw
    params = model.init(torch.Generator(device=device).manual_seed(0))

    # two users with different bigram statistics
    users = [synthetic_lm_corpus(4096, vocab=cfg.vocab_size, seed=s)
             for s in (10, 11)]

    def loss_fn(p, b):
        return float(model.loss(p, b)[0])

    print(f"{'user':>4s} {'meta loss':>10s} {'adapted':>10s}")
    adapted_params, meta_losses, adapted_losses = [], [], []
    for ui, corpus in enumerate(users):
        support = batch_from(corpus, device, off=0)
        query = batch_from(corpus, device, off=2048)
        with torch.no_grad():
            l_meta = loss_fn(params, query)
        p_ad = adapt(model.loss, params, support, alpha=0.05)
        adapted_params.append(p_ad)
        with torch.no_grad():
            l_ad = loss_fn(p_ad, query)
        meta_losses.append(l_meta)
        adapted_losses.append(l_ad)
        print(f"{ui:4d} {l_meta:10.4f} {l_ad:10.4f}")

    # batched serving loop with the personalized weights
    prompts = batch_from(users[0], device, n=4, sl=32)["tokens"]
    sync()
    t0 = time.time()
    with torch.no_grad():
        logits, cache = model.prefill(adapted_params[0], prompts, 128)
        tok = logits.argmax(-1).reshape(4, 1).to(torch.int32)
        out = [tok]
        for i in range(15):
            logits, cache = model.decode_step(adapted_params[0], cache, tok,
                                              32 + i)
            tok = logits.argmax(-1).reshape(4, 1).to(torch.int32)
            out.append(tok)
    sync()
    gen = torch.cat(out, 1)
    print(f"\nbatched serve: 4 requests × 16 tokens in "
          f"{time.time() - t0:.2f}s")
    print("sample:", gen[0].tolist())
    return {"meta_losses": meta_losses, "adapted_losses": adapted_losses,
            "tokens": gen}


if __name__ == "__main__":
    main()
    sys.exit(0)
