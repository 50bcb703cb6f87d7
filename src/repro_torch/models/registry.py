"""Model family registry: ``ModelConfig.family`` → builder.

The ``small`` family (the paper's own models), the ``dense`` transformer,
the ``ssm`` family (Mamba-2) and the ``hybrid`` family (RecurrentGemma) are
ported; the other LM zoo families raise ``NotImplementedError`` (ROADMAP
queue 1, model zoo)."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models import small
from repro_torch.models.hybrid import RecurrentGemmaLM
from repro_torch.models.ssm import Mamba2LM
from repro_torch.models.transformer import TransformerLM

_SMALL = {"mnist_dnn": small.MnistDNN, "lenet5": small.LeNet5,
          "char_lstm": small.CharLSTM}


def _small(cfg):
    for k, builder in _SMALL.items():
        if cfg.name.startswith(k):
            return builder(cfg)
    raise ValueError(f"unknown small model {cfg.name!r}")


def _not_ported(cfg):
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet "
        f"(ROADMAP queue 1, model zoo)")


# the JAX package's family names; the unported ones raise when built
MODEL_FAMILIES = {
    "dense": TransformerLM,
    "moe": _not_ported,
    "ssm": Mamba2LM,
    "hybrid": RecurrentGemmaLM,
    "vlm": _not_ported,
    "audio": _not_ported,
    "small": _small,
}


def build_model(cfg: ModelConfig):
    if cfg.family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} "
                         f"(have {sorted(MODEL_FAMILIES)})")
    return MODEL_FAMILIES[cfg.family](cfg)
