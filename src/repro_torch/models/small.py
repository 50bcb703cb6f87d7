"""The paper's own experiment models (Section VI-A), functional in torch:

* ``mnist_dnn``  — 2-layer DNN, hidden 100 (MNIST)
* ``lenet5``     — 2 conv + 3 FC (CIFAR-100)
* ``char_lstm``  — LSTM next-character classifier (Shakespeare)

Parameters are nested dicts of tensors with the JAX package's names and
layouts (dense ``[in, out]``, conv HWIO on NHWC input, LSTM gates i, f, g,
o), so weights carry over one to one (``utils.tree.from_numpy_tree``).
``loss``/``predict`` are pure functions of (params, batch); ``torch.func``
differentiates and vmaps them.  Only ``init`` draws random numbers, from
the caller's ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig

Params = Dict[str, Any]


def _normal(gen: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, device=gen.device)


def _dense(gen: torch.Generator, n_in: int, n_out: int) -> Params:
    w = _normal(gen, n_in, n_out) * math.sqrt(2.0 / n_in)
    return {"dense_w": w, "dense_b": torch.zeros(n_out, device=gen.device)}


def _apply_dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["dense_w"] + p["dense_b"]


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def _acc(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((logits.argmax(-1) == y.long()).to(logits.dtype))


class MnistDNN:
    """784 → 100 → num_classes (paper: hidden layer of size 100)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.n_in = 784
        self.hidden = cfg.d_model or 100
        self.n_cls = cfg.vocab_size or 10

    def init(self, gen: torch.Generator) -> Params:
        return {"fc1": _dense(gen, self.n_in, self.hidden),
                "fc2": _dense(gen, self.hidden, self.n_cls)}

    def predict(self, params: Params, batch) -> torch.Tensor:
        x = batch["x"].reshape(batch["x"].shape[0], -1)
        h = torch.relu(_apply_dense(params["fc1"], x))
        return _apply_dense(params["fc2"], h)

    def loss(self, params: Params, batch):
        logits = self.predict(params, batch)
        ce = _xent(logits, batch["y"])
        return ce, {"ce": ce, "acc": _acc(logits, batch["y"])}


class LeNet5:
    """LeNet-5: two conv layers + three FC layers (paper's CIFAR-100 model).

    Weights stay HWIO and activations NHWC at the interface; each conv
    converts to torch's OIHW / NCHW at its boundary and back."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.n_cls = cfg.vocab_size or 100
        self.in_ch = 3
        self.in_hw = 32

    def init(self, gen: torch.Generator) -> Params:
        def conv(h, w, cin, cout):
            return {"conv_w": _normal(gen, h, w, cin, cout)
                    * math.sqrt(2.0 / (h * w * cin)),
                    "conv_b": torch.zeros(cout, device=gen.device)}
        flat = 5 * 5 * 16
        return {
            "c1": conv(5, 5, self.in_ch, 6),
            "c2": conv(5, 5, 6, 16),
            "f1": _dense(gen, flat, 120),
            "f2": _dense(gen, 120, 84),
            "f3": _dense(gen, 84, self.n_cls),
        }

    @staticmethod
    def _conv_relu_pool(p: Params, x: torch.Tensor) -> torch.Tensor:
        """NHWC in, NHWC out: VALID conv (HWIO weights), relu, 2×2 max-pool."""
        y = F.conv2d(x.permute(0, 3, 1, 2), p["conv_w"].permute(3, 2, 0, 1),
                     p["conv_b"])
        y = F.max_pool2d(torch.relu(y), 2, 2)
        return y.permute(0, 2, 3, 1)

    def predict(self, params: Params, batch) -> torch.Tensor:
        x = batch["x"]
        if x.ndim == 3:
            x = x[..., None]
        h = self._conv_relu_pool(params["c1"], x)
        h = self._conv_relu_pool(params["c2"], h)
        h = h.reshape(h.shape[0], -1)
        h = torch.relu(_apply_dense(params["f1"], h))
        h = torch.relu(_apply_dense(params["f2"], h))
        return _apply_dense(params["f3"], h)

    def loss(self, params: Params, batch):
        logits = self.predict(params, batch)
        ce = _xent(logits, batch["y"])
        return ce, {"ce": ce, "acc": _acc(logits, batch["y"])}


class CharLSTM:
    """LSTM next-character classifier (paper's Shakespeare model)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.vocab = cfg.vocab_size or 80
        self.hidden = cfg.d_model or 256
        self.embed_dim = 8

    def init(self, gen: torch.Generator) -> Params:
        h, e = self.hidden, self.embed_dim
        return {
            "embed": _normal(gen, self.vocab, e) * 0.1,
            "lstm_wx": _normal(gen, e, 4 * h) / math.sqrt(e),
            "lstm_wh": _normal(gen, h, 4 * h) / math.sqrt(h),
            "lstm_b": torch.zeros(4 * h, device=gen.device),
            "out": _dense(gen, h, self.vocab),
        }

    def _run(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        b, steps = tokens.shape
        x = params["embed"][tokens.long()]                          # [B,L,E]
        h = x.new_zeros(b, self.hidden)
        c = x.new_zeros(b, self.hidden)
        hs = []
        for t in range(steps):
            z = (x[:, t] @ params["lstm_wx"] + h @ params["lstm_wh"]
                 + params["lstm_b"])
            i, f, g, o = torch.chunk(z, 4, dim=-1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1)                               # [B,L,H]

    def predict(self, params: Params, batch) -> torch.Tensor:
        hs = self._run(params, batch["tokens"])
        return _apply_dense(params["out"], hs[:, -1, :])            # next char

    def loss(self, params: Params, batch):
        """Next-character prediction over the whole sequence."""
        hs = self._run(params, batch["tokens"])
        logits = _apply_dense(params["out"], hs)                    # [B,L,V]
        ce = _xent(logits.reshape(-1, self.vocab),
                   batch["targets"].reshape(-1))
        return ce, {"ce": ce}
