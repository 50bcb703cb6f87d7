"""Model family registry: ``ModelConfig.family`` → builder.

The ``small`` family (the paper's own models), the ``dense`` and ``moe``
transformers, the ``ssm`` family (Mamba-2) and the ``hybrid`` family
(RecurrentGemma) are ported; ``vlm`` and ``audio`` raise
``NotImplementedError`` (ROADMAP queue 1, model zoo).  ``moe_impl`` is the
reference's argument; the transformer takes it, the other families ignore
it."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models import small
from repro_torch.models.hybrid import RecurrentGemmaLM
from repro_torch.models.ssm import Mamba2LM
from repro_torch.models.transformer import TransformerLM

_SMALL = {"mnist_dnn": small.MnistDNN, "lenet5": small.LeNet5,
          "char_lstm": small.CharLSTM}


def _small(cfg, moe_impl="gather"):
    for k, builder in _SMALL.items():
        if cfg.name.startswith(k):
            return builder(cfg)
    raise ValueError(f"unknown small model {cfg.name!r}")


def _transformer(cfg, moe_impl="gather"):
    return TransformerLM(cfg, moe_impl)


def _not_ported(cfg, moe_impl="gather"):
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet "
        f"(ROADMAP queue 1, model zoo)")


# the JAX package's family names; the unported ones raise when built
MODEL_FAMILIES = {
    "dense": _transformer,
    "moe": _transformer,
    "ssm": lambda cfg, moe_impl="gather": Mamba2LM(cfg),
    "hybrid": lambda cfg, moe_impl="gather": RecurrentGemmaLM(cfg),
    "vlm": _not_ported,
    "audio": _not_ported,
    "small": _small,
}


def build_model(cfg: ModelConfig, moe_impl: str = "gather"):
    if cfg.family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} "
                         f"(have {sorted(MODEL_FAMILIES)})")
    return MODEL_FAMILIES[cfg.family](cfg, moe_impl)
