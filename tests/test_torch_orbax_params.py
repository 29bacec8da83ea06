"""``scripts/orbax_params_to_npz.py``: a narrow JAX run's Orbax checkpoints
(a step and a named one, written by ``tpu2048/checkpoint/ckpt.py`` with the
run's ``config.json``) convert to params ``.npz`` files whose weights equal
the checkpoint's, and the port's Q from them equals JAX's Q on the same
boards (float32, the ``TOL`` of ``test_torch_dqn_model.py``); ``eval
--policy model --params`` plays them."""

import contextlib
import importlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dqn_model import TOL, boards
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048.checkpoint.ckpt import CheckpointManager as JaxCheckpointManager
from tpu2048.models.dqn import create_model as jax_create_model
from tpu2048.training import dqn as jtrain
from tpu2048_torch.agents.dqn import DQNConfig
from tpu2048_torch.checkpoint.params import load_params
from tpu2048_torch.cli.main import main as port_main
from tpu2048_torch.models import dqn as tdqn

REPO = Path(__file__).resolve().parent.parent
# The module: ``tpu2048.cli`` binds the name ``main`` to its function.
jcli = importlib.import_module("tpu2048.cli.main")
WIDTHS = ["--features", "32", "--hidden", "16", "--blocks", "2", "--no-bf16",
          "--envs", "8", "--memory-size", "64"]


def load_script():
    spec = importlib.util.spec_from_file_location(
        "orbax_params_to_npz", REPO / "scripts" / "orbax_params_to_npz.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run directory: config.json, step 3 and ``tile_512_ep3`` (its
    weights scaled by 0.5); returns the directory, the config and both
    parameter trees."""
    directory = str(tmp_path_factory.mktemp("jax_run"))
    args = jcli.build_parser().parse_args(["train", "dqn", *WIDTHS])
    args._argv = ["train", "dqn", *WIDTHS]
    config = jcli._dqn_config(args)
    jcli._save_run_config(args, directory)
    state = jax.jit(lambda: jtrain.init_loop_state(config)[1])()
    named = state.replace(agent=state.agent.replace(
        params=jax.tree.map(lambda x: 0.5 * x, state.agent.params)))
    mgr = JaxCheckpointManager(directory)
    mgr.save(3, state, wait=True)
    mgr.save_named("tile_512_ep3", named)
    mgr.close()
    return directory, config, state.agent.params, named.agent.params


@pytest.mark.parametrize("which", ["step", "named"])
def test_converted_params_give_jax_q(which, jax_run, tmp_path):
    directory, config, step_params, named_params = jax_run
    out = str(tmp_path / "p.npz")
    script = load_script()
    if which == "step":
        tag = script.convert(directory, out)
        want_params = step_params
    else:
        tag = script.convert(directory, out, named="tile_512_ep3")
        want_params = named_params
    assert tag == (3 if which == "step" else "tile_512_ep3")
    got = load_params(out)
    want = jax.tree.map(np.asarray, want_params)
    assert set(got) == set(want)
    for name, group in want.items():
        for leaf, value in group.items():
            np.testing.assert_array_equal(got[name][leaf], value)

    model = tdqn.load_flax_params(tdqn.create_model(
        DQNConfig(features=32, hidden=16, num_blocks=2, bf16=False), "cpu"),
        got).eval()
    b = boards(9)
    q_jax = np.asarray(jax_create_model(config.agent).apply(
        {"params": want_params}, jnp.asarray(b), train=False))
    with torch.no_grad():
        q_port = model(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(q_port, q_jax, rtol=0,
                               atol=TOL[False] * max(1.0, np.abs(q_jax).max()))


def test_script_main_and_eval_of_the_file(jax_run, tmp_path, capsys):
    directory = jax_run[0]
    out = str(tmp_path / "p.npz")
    script = load_script()
    assert script.main(["--checkpoint-dir", directory, "--out", out,
                        "--step", "3"]) == 0
    assert "wrote" in capsys.readouterr().out
    assert script.main(["--checkpoint-dir", str(tmp_path / "none"),
                        "--out", out]) == 2
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = port_main(["eval", "--policy", "model", "--params", out,
                        "--features", "32", "--hidden", "16", "--blocks",
                        "2", "--no-bf16", "--games", "4", "--eval-batch",
                        "4", "--cpu"])
    assert rc == 0 and json.loads(text.getvalue())["games"] == 4
