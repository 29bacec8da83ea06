"""Multi-kernel CNN Q-network, the port of :mod:`tpu2048.models.dqn`.

Three blocks of four parallel convolutions (k = 1..4, ``features/4`` filters
each, SAME padding, concatenated, ReLU), then Flatten -> Dense(hidden, ReLU)
-> Dropout -> Dense(4). The input is ``(B, 4, 4)`` int8 exponent boards,
one-hot encoded inside the module. With ``fused=True`` a block keeps its
four kernels as parameters but computes them as one 4x4 convolution, the
smaller kernels zero-embedded at their SAME offsets, as the JAX module's
``fused=True`` does.

The module keeps the JAX package's numerics: the convolutions and the
hidden layer take their inputs and weights in ``dtype`` (bf16 by default)
and add the bias in ``dtype``; the head runs in float32 on float32
parameters. Flatten runs in NHWC order, as the flax module flattens, so the
dense weights carry over unpermuted. Convolutions and matrix products are
library calls (cuDNN/cuBLAS), as they are XLA ops in the JAX package.

In train mode dropout draws its mask from an explicit ``torch.Generator``
by flax's rule: keep with probability ``1 - rate``, scale the kept values
by ``1 / (1 - rate)`` in ``dtype``. The gradient flows through the ``dtype``
casts into the float32 parameters.

Tensor parallel (:func:`shard_module`), a model rank keeps its slice of the
output channels of each layer that
:func:`tpu2048_torch.parallel.mesh.param_partition_spec` slices: of each of
a block's four kernels, and of the dense layer's ``hidden``; the head stays
whole. A sliced layer takes its whole input through
:func:`~tpu2048_torch.parallel.mesh.copy_to_model_group` and gathers its
output slices (after the ReLU, which acts on each channel alone) in the
whole layer's channel order; a block's four kernels are gathered kernel
after kernel, so that the next block and the dense layer's NHWC flatten see
the unsliced module's order. Every model rank then holds the same
activations: dropout draws its ``(B, hidden)`` mask after the gather, and
the Q-values are the same on every rank. State dicts, the flax trees and
checkpoints hold the whole module (:func:`whole_state_dict`,
:func:`slice_state_dict`).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from tpu2048_torch.parallel import mesh
from tpu2048_torch.utils.device import resolve_device

NUM_TILE_CHANNELS = 16  # one-hot depth, Dqn8:274
KERNEL_SIZES = (1, 2, 3, 4)
# TF/XLA SAME padding on a size-4 axis: (before, after) for each kernel size.
SAME_PADS = {1: (0, 0), 2: (0, 1), 3: (1, 1), 4: (1, 2)}
# The fused block's 4x4 frame: each kernel's place in it as F.pad's
# (left, right, top, bottom), tap [1, 1] for k=1, [1:3, 1:3] for k=2,
# [0:3, 0:3] for k=3 (tpu2048/models/dqn.py:84-88); k=4 fills the frame,
# and the input is padded by k=4's SAME pads on each side.
FUSED_FRAME = {1: (1, 2, 1, 2), 2: (1, 1, 1, 1), 3: (0, 1, 0, 1)}
# flax's lecun_normal draws a normal truncated to [-2, 2] and divides by its
# standard deviation, this constant, so the weights have variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


class MultiKernelConvBlock(nn.Module):
    """Four parallel convs (k = 1..4), concat, ReLU
    (``tpu2048.models.dqn.MultiKernelConvBlock``).

    The parameters are the four logical kernels either way. ``fused=False``
    runs four convolutions, each on its SAME-padded input; ``fused=True``
    builds one OIHW 4x4 weight in each forward (each kernel padded into its
    place in the frame, the four concatenated along O, then cast to
    ``dtype``) and runs one convolution; autograd carries the gradient back
    into the four kernels. With a ``model_group`` (:func:`shard_module`)
    each kernel holds its slice of the ``features/4`` filters and the block
    its slice of the output, gathered over the group."""

    model_group: Optional[mesh.ModelGroup] = None

    def __init__(self, in_channels: int, features: int = 2048,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False):
        super().__init__()
        d = features // 4
        self.dtype = dtype
        self.fused = fused
        self.convs = nn.ModuleList(
            nn.Conv2d(in_channels, d, k) for k in KERNEL_SIZES
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, C, 4, 4)`` NCHW in ``dtype`` -> ``(B, features, 4, 4)``."""
        group = self.model_group
        if group is not None:
            x = mesh.copy_to_model_group(x, group)
        if self.fused:
            weight = torch.cat([
                F.pad(conv.weight, FUSED_FRAME[k]) if k in FUSED_FRAME
                else conv.weight
                for k, conv in zip(KERNEL_SIZES, self.convs)])
            bias = torch.cat([conv.bias for conv in self.convs])
            before, after = SAME_PADS[4]
            y = F.conv2d(F.pad(x, (before, after, before, after)),
                         weight.to(self.dtype))
            y = F.relu(y + bias.to(self.dtype)[:, None, None])
        else:
            outs = []
            for k, conv in zip(KERNEL_SIZES, self.convs):
                before, after = SAME_PADS[k]
                y = F.conv2d(F.pad(x, (before, after, before, after)),
                             conv.weight.to(self.dtype))
                outs.append(y + conv.bias.to(self.dtype)[:, None, None])
            y = F.relu(torch.cat(outs, dim=1))
        if group is None:
            return y
        return mesh.gather_from_model_group(y, group, len(KERNEL_SIZES))


class DQNCNN(nn.Module):
    """Q-network over ``(B, 4, 4)`` int8 exponent boards -> ``(B, 4)`` f32.
    ``model_group`` and ``dense_group`` are set by :func:`shard_module`."""

    model_group: Optional[mesh.ModelGroup] = None  # the module's slices'
    dense_group: Optional[mesh.ModelGroup] = None  # when ``dense`` is sliced
    sliced: frozenset = frozenset()  # the names of the sliced parameters

    def __init__(self, action_space: int = 4, features: int = 2048,
                 hidden: int = 1024, dropout_rate: float = 0.5,
                 num_blocks: int = 3, dtype: torch.dtype = torch.bfloat16,
                 fused: bool = False):
        super().__init__()
        self.dtype = dtype
        self.blocks = nn.ModuleList(
            MultiKernelConvBlock(NUM_TILE_CHANNELS if i == 0 else features,
                                 features, dtype, fused)
            for i in range(num_blocks)
        )
        self.dense = nn.Linear(16 * features, hidden)
        self.dropout_rate = dropout_rate
        self.head = nn.Linear(hidden, action_space)

    def forward(self, boards: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Q-values; in train mode with a nonzero dropout rate the mask is
        drawn from ``generator`` (required then)."""
        # One-hot by comparison: an exponent >= 16 gives a zero vector, as
        # jax.nn.one_hot does (F.one_hot would raise).
        channels = torch.arange(NUM_TILE_CHANNELS, device=boards.device)
        x = (boards.to(torch.int64).unsqueeze(-1) == channels).to(self.dtype)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for block in self.blocks:
            x = block(x)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flatten in NHWC order
        if self.dense_group is not None:
            x = mesh.copy_to_model_group(x, self.dense_group)
        x = F.relu(F.linear(x, self.dense.weight.to(self.dtype))
                   + self.dense.bias.to(self.dtype))
        if self.dense_group is not None:
            x = mesh.gather_from_model_group(x, self.dense_group)
        if self.training and self.dropout_rate > 0:
            if generator is None:
                raise ValueError("train-mode dropout needs a generator")
            keep_prob = 1.0 - self.dropout_rate
            keep = torch.rand(x.shape, generator=generator,
                              device=generator.device).to(x.device) < keep_prob
            x = torch.where(keep, x / keep_prob, 0.0)
        return self.head(x.to(torch.float32))


def create_model(config, device=None) -> DQNCNN:
    """Build the network from a DQNConfig-like object on ``device``:
    ``cuda`` unless another device is named (``"meta"`` allocates nothing).

    In float32 (``bf16=False``) this sets ``torch.backends.cudnn.allow_tf32``
    and ``torch.backends.cuda.matmul.allow_tf32`` to False, process-wide:
    cuDNN would otherwise run float32 convolutions in TF32, which keeps about
    three decimal digits where the JAX reference keeps float32.
    A config without ``fused_conv`` builds the four-convolution blocks, as
    the JAX package's ``create_model`` does.
    """
    dtype = torch.bfloat16 if config.bf16 else torch.float32
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    with resolve_device(device):
        return DQNCNN(
            action_space=4,
            features=config.features,
            hidden=config.hidden,
            dropout_rate=config.dropout,
            num_blocks=config.num_blocks,
            dtype=dtype,
            fused=getattr(config, "fused_conv", False),
        )


@torch.no_grad()
def init_params(module: DQNCNN, generator: torch.Generator) -> DQNCNN:
    """Lecun-normal weights (flax's initializer) and zero biases, drawn from
    ``generator`` (on the module's device), in place; returns ``module``."""
    for sub in module.modules():
        if isinstance(sub, (nn.Conv2d, nn.Linear)):
            w = sub.weight
            std = math.sqrt(1.0 / (w[0].numel())) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            nn.init.zeros_(sub.bias)
    return module


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


@torch.no_grad()
def shard_module(module: DQNCNN, group: Optional[mesh.ModelGroup]
                 ) -> DQNCNN:
    """Keep this model rank's slices of a whole module's parameters, in
    place, by :func:`tpu2048_torch.parallel.mesh.param_partition_spec` over
    ``group``; returns ``module``. With no group, ``module`` as it is."""
    if group is None:
        return module
    spec = mesh.param_partition_spec(module, group.size)
    for name, p in module.named_parameters():
        if spec[name] is not None:
            p.data = mesh.slice_rows(p.data, group).clone()
    module.model_group = group
    module.sliced = frozenset(n for n, axis in spec.items()
                              if axis is not None)
    for i, block in enumerate(module.blocks):
        if f"blocks.{i}.convs.0.weight" in module.sliced:
            block.model_group = group
    if "dense.weight" in module.sliced:
        module.dense_group = group
    return module


def whole_state_dict(module: DQNCNN):
    """``module.state_dict()`` of the whole module: each sliced parameter
    gathered over the model group (a collective of the group). Unsliced,
    the live state dict."""
    state = module.state_dict()
    for name in state:  # in one order on every rank
        if name in module.sliced:
            state[name] = mesh.gather_rows(state[name], module.model_group)
    return state


def slice_state_dict(module: DQNCNN, state):
    """This model rank's slices of a whole module's state dict (views), the
    inverse of :func:`whole_state_dict`."""
    return {k: mesh.slice_rows(v, module.model_group)
            if k in module.sliced else v for k, v in state.items()}


@torch.no_grad()
def load_flax_params(module: DQNCNN, params) -> DQNCNN:
    """Load the JAX package's parameter tree into ``module``, in place.

    ``params`` is the flax ``params`` dict as numpy arrays:
    ``block{i}/conv{k}x{k}_kernel|bias`` (HWIO kernels), ``dense/kernel|bias``
    and ``head/kernel|bias`` (``(in, out)`` kernels). Conv kernels go to
    OIHW and dense kernels are transposed. Raises on a missing, extra or
    misshapen entry.
    """
    own = module.state_dict()
    for key, value in slice_state_dict(
            module, flax_to_torch_layout(module, params)).items():
        own[key].copy_(value)
    return module


def flax_to_torch_layout(module: DQNCNN, tree):
    """A tree laid out like the flax parameters (the parameters, or Adam's
    moments of them) as ``{state-dict name: float32 CPU tensor}`` in the
    whole module's layout (a sliced module's slices are checked against
    it). Raises on a missing, extra or misshapen entry."""
    expected = {f"block{i}" for i in range(len(module.blocks))} | {"dense",
                                                                   "head"}
    if set(tree) != expected:
        raise ValueError(f"parameter tree has {sorted(tree)}, the module "
                         f"expects {sorted(expected)}")
    state = {}
    for i in range(len(module.blocks)):
        block = tree[f"block{i}"]
        for j, k in enumerate(KERNEL_SIZES):
            state[f"blocks.{i}.convs.{j}.weight"] = np.transpose(
                block[f"conv{k}x{k}_kernel"], (3, 2, 0, 1))
            state[f"blocks.{i}.convs.{j}.bias"] = block[f"conv{k}x{k}_bias"]
    for name in ("dense", "head"):
        state[f"{name}.weight"] = np.transpose(tree[name]["kernel"])
        state[f"{name}.bias"] = tree[name]["bias"]
    own = {k: tuple(p.shape) for k, p in module.named_parameters()}
    for key in module.sliced:
        own[key] = (own[key][0] * module.model_group.size, *own[key][1:])
    out = {}
    for key, value in state.items():
        if tuple(value.shape) != own[key]:
            raise ValueError(f"{key}: file has {tuple(value.shape)}, module "
                             f"has {own[key]}")
        out[key] = torch.from_numpy(np.array(value, np.float32, order="C"))
    return out


@torch.no_grad()
def to_flax_params(module: DQNCNN):
    """The inverse of :func:`load_flax_params`: the module's weights as the
    flax parameter tree of numpy float32 arrays; a sliced module's gathered
    over its model group (a collective of the group)."""
    state = whole_state_dict(module)

    def host(name):
        return state[name].detach().to("cpu", torch.float32).numpy().copy()

    params = {}
    for i in range(len(module.blocks)):
        params[f"block{i}"] = {}
        for j, k in enumerate(KERNEL_SIZES):
            conv = f"blocks.{i}.convs.{j}"
            params[f"block{i}"][f"conv{k}x{k}_kernel"] = np.transpose(
                host(conv + ".weight"), (2, 3, 1, 0))
            params[f"block{i}"][f"conv{k}x{k}_bias"] = host(conv + ".bias")
    for name in ("dense", "head"):
        params[name] = {"kernel": host(name + ".weight").T.copy(),
                        "bias": host(name + ".bias")}
    return params
