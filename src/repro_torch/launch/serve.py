"""Serving launcher: batched prefill + decode with a (optionally personalized)
model, on the card unless ``--device cpu`` is given.

The port of the JAX package's ``launch/serve.py``, with the same CLI plus
``--device`` and ``--dtype`` (serve the config in another dtype, e.g.
``float32`` to hold decode against a teacher-forced forward at f32
rounding).  Weights are random, drawn from ``--seed``, and so are the
prompts (one ``torch.Generator`` for both).  The PFL twist:
``--personalize`` adapts the served weights with one inner SGD step on the
prompts (next-token targets) before serving, through ``core/perfed.adapt``
— the deployment story of Per-FedAvg.

Every LM family serves (``--arch`` yi_6b, mamba2_370m, recurrentgemma_2b,
mixtral_8x22b, llama32_vision_11b, musicgen_large, ...): the model's own
``init_cache``, ``prefill`` and ``decode_step`` carry the family's state.
The vlm family serves with the stub image embeddings; audio prompts and
generated tokens are [B, L, K], one token per codebook, and the logits
[B, gen, K, V].

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b --reduce \
      --batch 4 --prompt-len 32 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --full --batch 4 \
      --prompt-len 2048 --gen 32 --cache-len 4096          # one H100
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma_2b \
      --full --batch 4 --prompt-len 2048 --gen 32 --cache-len 4096
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
import types

import torch

from repro_torch.configs import get_config
from repro_torch.core.perfed import adapt
from repro_torch.fl.engine import resolve_device
from repro_torch.models import build_model


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="batched serving driver")
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--reduce", action="store_true", default=True)
    ap.add_argument("--full", dest="reduce", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--personalize", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="params and activations (default: the config's)")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv=None) -> types.SimpleNamespace:
    """Serve once and print what ``main`` prints; return the config,
    params, prompts, final cache, generated tokens, the logits each token
    was chosen from ([B, gen, V]) and timings for callers that check
    them."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen)
    b, lp = args.batch, args.prompt_len
    # audio streams carry one token per codebook: [B, L, K]
    audio = cfg.family == "audio"
    tok_shape = (b, lp, cfg.num_audio_codebooks) if audio else (b, lp)
    step_shape = (b, 1, -1) if audio else (b, 1)
    prompts = torch.randint(0, cfg.vocab_size, tok_shape, generator=gen,
                            device=device, dtype=torch.int32)

    if args.personalize:
        targ = torch.roll(prompts, -1, dims=1)
        user_batch = {"tokens": prompts, "targets": targ}
        params = adapt(model.loss, params, user_batch, alpha=0.01)
        print("personalized: one inner-SGD adaptation step applied")

    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompts, args.cache_len)
        toks = torch.argmax(logits, dim=-1).to(torch.int32) \
            .reshape(step_shape)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        out_tokens, out_logits = [toks], [logits]
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            logits, cache = model.decode_step(params, cache, toks, lp + i)
            toks = torch.argmax(logits, dim=-1).to(torch.int32) \
                .reshape(step_shape)
            out_tokens.append(toks)
            out_logits.append(logits)
        _sync(device)
        t_decode = time.perf_counter() - t0

    gen_tokens = torch.cat(out_tokens, dim=1)
    decode_ms = t_decode / max(args.gen - 1, 1) * 1e3
    print(f"arch={cfg.name} batch={b} prompt={lp} gen={args.gen} "
          f"device={device}")
    print(f"prefill: {t_prefill * 1e3:.1f} ms   decode: {decode_ms:.2f} "
          f"ms/token")
    print("sample tokens:", gen_tokens[0].tolist()[:12])
    return types.SimpleNamespace(
        cfg=cfg, params=params, cache=cache, tokens=gen_tokens,
        logits=torch.cat(out_logits, dim=1), prompts=prompts,
        prefill_ms=t_prefill * 1e3, decode_ms=decode_ms)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
