"""Learning-rate schedules (plain callables step → lr), as f32 tensors.

The port of the JAX package's ``optim/schedule.py``.  ``step`` may be a
Python number or a tensor; the result lies on the step's device (the CPU
for a Python number).
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    def fn(step):
        device = step.device if torch.is_tensor(step) else None
        return torch.tensor(lr, dtype=torch.float32, device=device)
    return fn


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return fn
