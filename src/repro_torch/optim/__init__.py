from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    clip_by_global_norm,
    make_optimizer,
    momentum,
    sgd,
)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = [
    "Optimizer",
    "adam",
    "clip_by_global_norm",
    "constant",
    "make_optimizer",
    "momentum",
    "sgd",
    "warmup_cosine",
]
