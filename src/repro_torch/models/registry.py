"""Model family registry: ``ModelConfig.family`` → builder.

The ``small`` family (the paper's own models), the ``dense`` transformer and
the ``ssm`` family (Mamba-2) are ported; the other LM zoo families raise
``NotImplementedError`` (ROADMAP queue 1, model zoo)."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models import small
from repro_torch.models.ssm import Mamba2LM
from repro_torch.models.transformer import TransformerLM

_SMALL = {"mnist_dnn": small.MnistDNN, "lenet5": small.LeNet5,
          "char_lstm": small.CharLSTM}
_NOT_PORTED = ("moe", "hybrid", "vlm", "audio")


def build_model(cfg: ModelConfig):
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet "
            f"(ROADMAP queue 1, model zoo)")
    if cfg.family == "dense":
        return TransformerLM(cfg)
    if cfg.family == "ssm":
        return Mamba2LM(cfg)
    if cfg.family != "small":
        raise ValueError(f"unknown model family {cfg.family!r}")
    for k, builder in _SMALL.items():
        if cfg.name.startswith(k):
            return builder(cfg)
    raise ValueError(f"unknown small model {cfg.name!r}")
