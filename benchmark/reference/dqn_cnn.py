"""The reference of ``dqn_cnn_ref``: the Q-network of Rocco9999/2048_Q-
Learning's ``Dqn8`` (``mainDQL_CNN_step2.py``) and its learner, in plain
PyTorch and float32 with TF32 off.

The network: a one-hot of each cell's exponent (16 channels), then
``num_blocks`` blocks of four parallel convolutions (kernel sizes 1 to 4,
``features / 4`` filters each, TensorFlow's SAME padding, concatenated,
ReLU), a channels-last flatten, a dense layer of ``hidden`` units with ReLU,
dropout in training, and a dense head of 4 actions. The learner takes one
Adam step on the mean squared TD error of the taken actions, divided by
the 4 actions (Keras' mean over the whole target matrix, whose other cells
carry no error), toward ``r + gamma * max Q_target(s') * (1 - done)``.

The parameters are a dict of float32 tensors under the names and shapes of
a PyTorch module of that network (``blocks.{i}.convs.{j}.weight`` in OIHW,
``dense.weight`` as ``(hidden, 16 * features)`` over the channels-last
flatten, ``head.weight``), which the benchmark makes from its seed and
hands to both sides.

``quant`` names a lower precision for the control: every convolution's and
matrix product's inputs and weights are rounded to it (``fp8``: float8
e4m3 with one scale a tensor, as fp8 inference scales them). The learner's
``half_batch`` is a fault planted in the reference: each update takes the
mean over the first half of its batch and leaves the rest out.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
from torch.nn import functional as F

KERNEL_SIZES = (1, 2, 3, 4)
CHANNELS = 16
# TensorFlow SAME padding on a 4-cell axis: (before, after) a kernel size.
SAME = {k: ((k - 1) // 2, k - 1 - (k - 1) // 2) for k in KERNEL_SIZES}
FP8_MAX = 448.0  # the largest float8 e4m3 value


def param_shapes(cfg) -> Dict[str, tuple]:
    """Every parameter's name and shape, in a fixed order."""
    d = cfg["features"] // 4
    shapes = {}
    for i in range(cfg["num_blocks"]):
        cin = CHANNELS if i == 0 else cfg["features"]
        for j, k in enumerate(KERNEL_SIZES):
            shapes[f"blocks.{i}.convs.{j}.weight"] = (d, cin, k, k)
            shapes[f"blocks.{i}.convs.{j}.bias"] = (d,)
    shapes["dense.weight"] = (cfg["hidden"], 16 * cfg["features"])
    shapes["dense.bias"] = (cfg["hidden"],)
    shapes["head.weight"] = (cfg["actions"], cfg["hidden"])
    shapes["head.bias"] = (cfg["actions"],)
    return shapes


def make_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights in one normal draw on ``device``: each weight
    scaled by ``1 / sqrt(fan_in)``, each bias by ``bias_scale``."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale = (cfg["bias_scale"] if name.endswith("bias")
                 else 1.0 / math.sqrt(n // shape[0]))
        out[name] = flat[at:at + n].view(shape).mul_(scale)
        at += n
    return out


@contextlib.contextmanager
def full_float32():
    """Matrix products and convolutions in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """``x`` rounded to ``quant`` and back to float32; the gradient passes
    straight through."""
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"unknown precision {quant!r}")
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def forward(cfg, w, boards: torch.Tensor, quant: Optional[str] = None,
            dropout_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Q-values ``(N, 4)`` of ``(N, 16)`` exponent boards. With
    ``dropout_u`` (``(N, hidden)`` uniforms) a hidden unit is kept where
    its uniform is below ``1 - dropout`` and scaled by ``1 / (1 -
    dropout)``."""
    n = boards.shape[0]
    x = (boards.view(n, 4, 4, 1) == torch.arange(CHANNELS,
                                                 device=boards.device))
    x = x.to(torch.float32).permute(0, 3, 1, 2)
    for i in range(cfg["num_blocks"]):
        outs = []
        for j, k in enumerate(KERNEL_SIZES):
            before, after = SAME[k]
            xp = F.pad(x, (before, after, before, after))
            weight = w[f"blocks.{i}.convs.{j}.weight"]
            y = F.conv2d(_round(xp, quant), _round(weight, quant))
            outs.append(y + w[f"blocks.{i}.convs.{j}.bias"][:, None, None])
        x = F.relu(torch.cat(outs, 1))
    x = x.permute(0, 2, 3, 1).reshape(n, -1)
    h = F.relu(_round(x, quant) @ _round(w["dense.weight"], quant).T
               + w["dense.bias"])
    if dropout_u is not None:
        keep = 1.0 - cfg["dropout"]
        h = torch.where(dropout_u < keep, h / keep, 0.0)
    return _round(h, quant) @ _round(w["head.weight"], quant).T + w["head.bias"]


def q_values(cfg, w, boards, quant=None, block: int = 2048) -> torch.Tensor:
    """:func:`forward` without gradients, in blocks of ``block`` boards."""
    with torch.no_grad(), full_float32():
        return torch.cat([forward(cfg, w, boards[i:i + block], quant)
                          for i in range(0, boards.shape[0], block)])


class Learner:
    """The online and target parameters and Adam's state of the reference
    learner (float32; Keras' Adam with its epsilon of 1e-7)."""

    def __init__(self, cfg, weights, quant: Optional[str] = None):
        self.cfg = cfg
        self.half = quant == "half_batch"
        self.quant = None if self.half else quant
        self.w = {k: v.clone() for k, v in weights.items()}
        self.target = {k: v.clone() for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.v = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.t = 0

    def update(self, batch, dropout_u):
        """One update on ``batch`` (``board``, ``action``, ``reward``,
        ``done``, ``next_board``); returns the loss, the gradients and the
        TD errors ``|target - Q(s, a)|`` of the batch's samples."""
        cfg = self.cfg
        if self.half:
            n = len(dropout_u) // 2
            batch = {k: v[:n] for k, v in batch.items()}
            dropout_u = dropout_u[:n]
        with full_float32():
            with torch.no_grad():
                boot = forward(cfg, self.target, batch["next_board"],
                               self.quant).amax(1)
                target = batch["reward"] + cfg["gamma"] * boot * (
                    1.0 - batch["done"].to(torch.float32))
            params = {k: v.clone().requires_grad_(True)
                      for k, v in self.w.items()}
            q = forward(cfg, params, batch["board"], self.quant, dropout_u)
            q_taken = q.gather(1, batch["action"].view(-1, 1))[:, 0]
            td = (target - q_taken).detach().abs()
            loss = ((target - q_taken) ** 2).mean() / q.shape[1]
            grads = torch.autograd.grad(loss, list(params.values()))
        b1, b2, lr, eps = 0.9, 0.999, cfg["learning_rate"], cfg["adam_eps"]
        self.t += 1
        out = {}
        with torch.no_grad():
            for (k, p), g in zip(self.w.items(), grads):
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[k] / (1 - b1 ** self.t)
                v_hat = self.v[k] / (1 - b2 ** self.t)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
                out[k] = g
        return float(loss.detach()), out, td
