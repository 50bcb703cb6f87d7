"""Pieces the plain references share: how a product is computed, the
norm, rotary positions and the loss.  Plain PyTorch; nothing of the
program is imported."""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0           # largest finite float8 e4m3fn


class Numerics:
    """How the reference multiplies.  Exact: float32 operands, products in
    float32 with TF32 off.  ``fp8=True`` is the control: both operands of
    every product rounded to float8 e4m3 with a per-tensor scale (the
    precision below the configurations' bfloat16), the derivative taken
    as if unrounded."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        d = x.detach()
        s = d.abs().amax().clamp(min=1e-30) / FP8_MAX
        y = (d / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return x + (y - d)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return torch.einsum(eq, self.q(a), self.q(b))


EXACT = Numerics()


def exact_matmuls():
    """TF32 off for the reference's float32 products (restored after)."""
    class _Ctx:
        def __enter__(self):
            self.saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        def __exit__(self, *exc):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self.saved
    return _Ctx()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions on x [B, L, H, D] at positions 0..L-1, the head
    dim split into halves."""
    d, sl = x.shape[-1], x.shape[1]
    freqs = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d * math.log(theta))
    ang = torch.arange(sl, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[target] at every position, in float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, targets.long()[..., None])[..., 0]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean over every position of -log softmax(logits)[target]."""
    return torch.mean(nll(logits, targets))
