"""Model family registry: ``ModelConfig.family`` → builder.

Only the ``small`` family (the paper's own models) is ported; the LM zoo
families raise ``NotImplementedError`` (ROADMAP queue 1, model zoo)."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models import small

_SMALL = {"mnist_dnn": small.MnistDNN, "lenet5": small.LeNet5,
          "char_lstm": small.CharLSTM}
_NOT_PORTED = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def build_model(cfg: ModelConfig):
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet "
            f"(ROADMAP queue 1, model zoo)")
    if cfg.family != "small":
        raise ValueError(f"unknown model family {cfg.family!r}")
    for k, builder in _SMALL.items():
        if cfg.name.startswith(k):
            return builder(cfg)
    raise ValueError(f"unknown small model {cfg.name!r}")
