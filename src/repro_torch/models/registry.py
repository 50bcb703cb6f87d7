"""Model family registry: ``ModelConfig.family`` → builder.

Every family of the reference is ported: ``small`` (the paper's own
models), the ``dense`` and ``moe`` transformers, ``ssm`` (Mamba-2),
``hybrid`` (RecurrentGemma), ``vlm`` (Llama-3.2-Vision's cross-attention
decoder) and ``audio`` (MusicGen's multi-codebook decoder).  ``moe_impl``
is the reference's argument; the transformer and its vlm and audio
subclasses take it, the other families ignore it."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models import small
from repro_torch.models.audio import AudioLM
from repro_torch.models.hybrid import RecurrentGemmaLM
from repro_torch.models.ssm import Mamba2LM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.vlm import VisionLM

_SMALL = {"mnist_dnn": small.MnistDNN, "lenet5": small.LeNet5,
          "char_lstm": small.CharLSTM}


def _small(cfg, moe_impl="gather"):
    for k, builder in _SMALL.items():
        if cfg.name.startswith(k):
            return builder(cfg)
    raise ValueError(f"unknown small model {cfg.name!r}")


# the JAX package's family names
MODEL_FAMILIES = {
    "dense": TransformerLM,
    "moe": TransformerLM,
    "ssm": lambda cfg, moe_impl="gather": Mamba2LM(cfg),
    "hybrid": lambda cfg, moe_impl="gather": RecurrentGemmaLM(cfg),
    "vlm": VisionLM,
    "audio": AudioLM,
    "small": _small,
}


def build_model(cfg: ModelConfig, moe_impl: str = "gather"):
    if cfg.family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} "
                         f"(have {sorted(MODEL_FAMILIES)})")
    return MODEL_FAMILIES[cfg.family](cfg, moe_impl)
