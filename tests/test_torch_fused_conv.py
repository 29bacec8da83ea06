"""The fused conv (``fused_conv=True``: one 4x4 convolution a block, the
k = 1..3 kernels zero-embedded at their SAME offsets) against JAX
``fused=True`` on the same ``.npz`` parameters and boards, and against the
port's four-convolution block on the same weights, gradients included.

Tolerances:
- float32, rtol = atol = 1e-5: what ``tests/test_dqn.py`` holds JAX's
  fused block to its four-conv block; the two compute the same products in
  another order of their sums (observed: ~1e-7).
- bf16: the ``TOL`` of ``test_torch_dqn_model.py`` (1e-2 of the largest
  |Q|, floored at 1).
- gradients, float32: 1e-5 of the largest |gradient| of the kernel
  (floored at 1e-3): the same sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dqn_model import (NARROW, assert_close, boards, flax_params,
                                  port_model)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048.agents.dqn import DQNConfig as JaxDQNConfig
from tpu2048.models import dqn as jdqn
from tpu2048_torch.agents.dqn import DQNConfig
from tpu2048_torch.models import dqn as tdqn

F32_TOL = 1e-5
GRAD_RTOL = 1e-5


def block_params(seed, features, in_ch):
    block = jdqn.MultiKernelConvBlock(features=features, dtype=jnp.float32,
                                      fused=True)
    x = jax.random.normal(jax.random.PRNGKey(seed), (3, 4, 4, in_ch))
    params = block.init(jax.random.PRNGKey(seed + 1), x)["params"]
    return np.array(x), jax.tree.map(np.array, params)


def port_block(params, features, in_ch, fused):
    block = tdqn.MultiKernelConvBlock(in_ch, features, torch.float32, fused)
    with torch.no_grad():
        for k, conv in zip(tdqn.KERNEL_SIZES, block.convs):
            conv.weight.copy_(torch.from_numpy(np.transpose(
                params[f"conv{k}x{k}_kernel"], (3, 2, 0, 1)).copy()))
            conv.bias.copy_(torch.from_numpy(params[f"conv{k}x{k}_bias"]))
    return block


@pytest.mark.parametrize("in_ch", [16, 32])
def test_fused_block_matches_jax_and_the_four_convs(in_ch):
    features = 32
    x, params = block_params(in_ch, features, in_ch)
    params["conv1x1_bias"] += 0.1  # nonzero biases reach the sum
    params["conv4x4_bias"] -= 0.2
    want = jdqn.MultiKernelConvBlock(
        features=features, dtype=jnp.float32, fused=True).apply(
            {"params": params}, jnp.asarray(x))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        fused = port_block(params, features, in_ch, True)(tx)
        four = port_block(params, features, in_ch, False)(tx)
    got = fused.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(fused.numpy(), four.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    assert (got > 0).any() and (got == 0).any()  # the ReLU cut some


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_q_network_matches_jax(bf16, tmp_path):
    widths = dict(NARROW, fused_conv=True)
    jmodel = jdqn.create_model(JaxDQNConfig(bf16=bf16, **widths))
    assert jmodel.fused
    _, params = flax_params(bf16, **NARROW)  # the tree does not depend on it
    tmodel = port_model(params, bf16, tmp_path, **widths)
    assert all(block.fused for block in tmodel.blocks)
    b = boards(3)
    q_jax = np.asarray(jmodel.apply({"params": params}, jnp.asarray(b),
                                    train=False))
    with torch.no_grad():
        q_port = tmodel(torch.from_numpy(b)).numpy()
    if bf16:
        assert_close(q_port, q_jax, True)
    else:
        np.testing.assert_allclose(q_port, q_jax, rtol=F32_TOL, atol=F32_TOL)
    four = port_model(params, bf16, tmp_path, **NARROW)
    with torch.no_grad():
        q_four = four(torch.from_numpy(b)).numpy()
    assert_close(q_port, q_four, bf16)


def test_fused_gradients_match_the_four_convs(tmp_path):
    _, params = flax_params(False, **NARROW)
    fused = port_model(params, False, tmp_path, fused_conv=True, **NARROW)
    four = port_model(params, False, tmp_path, **NARROW)
    b = torch.from_numpy(boards(4))
    weights = torch.from_numpy(
        np.random.default_rng(4).normal(size=(len(b), 4)).astype(np.float32))
    for model in (fused, four):
        model.train()
        (model(b, generator=torch.Generator().manual_seed(0))
         * weights).sum().backward()
    for (name, p), q in zip(fused.named_parameters(), four.parameters()):
        scale = max(float(q.grad.abs().max()), 1e-3)
        err = float((p.grad - q.grad).abs().max())
        assert err <= GRAD_RTOL * scale, f"{name}: {err:.3e} of {scale:.3e}"
    convs = [n for n, p in fused.named_parameters() if "convs" in n]
    assert len(convs) == 8 * NARROW["num_blocks"]
    assert all(p.grad.abs().max() > 0 for p in fused.parameters())


def test_fused_conv_trains_through_the_learner():
    """``DQNConfig(fused_conv=True)`` builds fused blocks and one learner
    update moves the same weights as the four-conv module's update."""
    from tpu2048_torch.agents import dqn as dqnlib

    cfg = DQNConfig(bf16=False, dropout=0.0, **NARROW)
    states = [dqnlib.create_train_state(c, "cpu", 0) for c in (
        cfg, DQNConfig(bf16=False, dropout=0.0, fused_conv=True, **NARROW))]
    assert states[1].model.blocks[0].fused and not states[0].model.blocks[
        0].fused
    rng = np.random.default_rng(5)
    batch = {
        "board": torch.from_numpy(rng.integers(0, 11, (16, 4, 4)).astype(
            np.int8)),
        "action": torch.from_numpy(rng.integers(0, 4, 16)),
        "reward": torch.from_numpy(rng.normal(size=16).astype(np.float32)),
        "done": torch.from_numpy(rng.random(16) < 0.2),
        "next_board": torch.from_numpy(rng.integers(0, 11, (16, 4, 4)).astype(
            np.int8)),
    }
    losses = [float(dqnlib.train_step(cfg, s, batch)[0]) for s in states]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for p, q in zip(states[1].model.parameters(),
                    states[0].model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=0, atol=1e-6)
