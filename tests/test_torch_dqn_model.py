"""The port's Q-network against ``tpu2048.models.dqn`` on the same weights.

Flax parameters go through the params ``.npz`` and ``load_flax_params``.
Tolerances, on the largest |Q| (floored at 1):
- float32: 1e-4. Both sides compute in float32; only the order of the sums
  differs (observed: ~1e-7).
- bf16: 1e-2, about 2.5 bf16 units in the last place (2**-8). Both sides
  round inputs, weights and every layer's output to bf16, so a different
  sum order can flip a rounding (observed: ~1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu2048.agents.dqn import DQNConfig as JaxDQNConfig
from tpu2048.models import dqn as jdqn
from tpu2048_torch.agents.dqn import DQNConfig
from tpu2048_torch.checkpoint.params import load_params, save_params
from tpu2048_torch.models import dqn as tdqn

NARROW = dict(features=32, hidden=16, num_blocks=2)
TOL = {False: 1e-4, True: 1e-2}  # by bf16


def flax_params(bf16, seed=0, **widths):
    model = jdqn.create_model(JaxDQNConfig(bf16=bf16, **widths))
    params = jdqn.init_params(model, jax.random.PRNGKey(seed))
    return model, jax.tree.map(np.asarray, params)


def port_model(params, bf16, tmp_path, **widths):
    path = tmp_path / "params.npz"
    save_params(path, params)
    model = tdqn.create_model(DQNConfig(bf16=bf16, **widths), "cpu")
    return tdqn.load_flax_params(model, load_params(path)).eval()


def boards(seed, n=128, high=16):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, high, (n, 4, 4))
    b[rng.random((n, 4, 4)) < 0.3] = 0
    return b.astype(np.int8)


def assert_close(q_port, q_jax, bf16):
    q_jax = np.asarray(q_jax)
    assert q_port.dtype == np.float32 and q_port.shape == q_jax.shape
    tol = TOL[bf16] * max(1.0, float(np.abs(q_jax).max()))
    np.testing.assert_allclose(q_port, q_jax, rtol=0, atol=tol)


@pytest.mark.parametrize("bf16", [False, True])
def test_q_values_match_jax(bf16, tmp_path):
    jmodel, params = flax_params(bf16, **NARROW)
    tmodel = port_model(params, bf16, tmp_path, **NARROW)
    b = boards(1)
    q_jax = jmodel.apply({"params": params}, jnp.asarray(b), train=False)
    with torch.no_grad():
        q_port = tmodel(torch.from_numpy(b)).numpy()
    assert_close(q_port, q_jax, bf16)


def test_exponent_16_gives_the_zero_one_hot(tmp_path):
    jmodel, params = flax_params(False, **NARROW)
    tmodel = port_model(params, False, tmp_path, **NARROW)
    b = boards(2, n=16)
    b[:, 0, 0] = 16
    b[:4] = 16
    q_jax = jmodel.apply({"params": params}, jnp.asarray(b), train=False)
    with torch.no_grad():
        q_port = tmodel(torch.from_numpy(b)).numpy()
    assert_close(q_port, q_jax, False)
    # An all-16 board encodes like an all-zero one-hot input: no channel set.
    x = (torch.from_numpy(b[:1]).long().unsqueeze(-1)
         == torch.arange(tdqn.NUM_TILE_CHANNELS))
    assert not x.any()


def test_full_width_parameter_count():
    model = tdqn.create_model(DQNConfig(), device="meta")
    jmodel = jdqn.create_model(JaxDQNConfig())
    shapes = jax.eval_shape(
        lambda k: jmodel.init({"params": k}, jnp.zeros((1, 4, 4), jnp.int8)),
        jax.random.PRNGKey(0),
    )["params"]
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert tdqn.param_count(model) == n_jax == 96_726_020


def test_params_file_round_trip(tmp_path):
    _, params = flax_params(True, **NARROW)
    save_params(tmp_path / "p.npz", params)
    back = load_params(tmp_path / "p.npz")
    assert set(back) == set(params)
    for name, group in params.items():
        assert set(back[name]) == set(group)
        for leaf, value in group.items():
            np.testing.assert_array_equal(back[name][leaf], value)


def test_to_flax_params_inverts_load_flax_params():
    _, params = flax_params(False, **NARROW)
    model = tdqn.load_flax_params(
        tdqn.create_model(DQNConfig(bf16=False, **NARROW), "cpu"), params)
    back = tdqn.to_flax_params(model)
    assert set(back) == set(params)
    for name, group in params.items():
        assert set(back[name]) == set(group)
        for leaf, value in group.items():
            np.testing.assert_array_equal(back[name][leaf], value)


def test_load_flax_params_rejects_a_wrong_tree():
    _, params = flax_params(False, **NARROW)
    model = tdqn.create_model(DQNConfig(bf16=False, **NARROW), "cpu")
    with pytest.raises(ValueError):
        tdqn.load_flax_params(model, {k: v for k, v in params.items()
                                      if k != "head"})
    wide = tdqn.create_model(DQNConfig(bf16=False, features=64, hidden=16,
                                       num_blocks=2), "cpu")
    with pytest.raises(ValueError):
        tdqn.load_flax_params(wide, params)


def test_init_params_is_lecun_normal():
    model = tdqn.create_model(DQNConfig(features=256, hidden=64,
                                        num_blocks=2), "cpu")
    tdqn.init_params(model, torch.Generator().manual_seed(0))
    w = model.dense.weight
    fan_in = w.shape[1]
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.02
    assert w.abs().max().item() <= 2 / 0.87962566103423978 / np.sqrt(fan_in)
    assert not model.dense.bias.any()


def test_float32_model_turns_tf32_off():
    torch.backends.cudnn.allow_tf32 = True
    tdqn.create_model(DQNConfig(bf16=False, **NARROW), "cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
