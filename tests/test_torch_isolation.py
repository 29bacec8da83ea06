"""The port stands alone: it imports nothing of JAX or of ``tpu2048``, runs
on CUDA unless asked for the CPU, and sends only CPU tensors to the plain
version of its kernel."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu2048_torch
from tpu2048_torch.ops import step_kernel as sk
from tpu2048_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent


def test_importing_the_port_loads_no_jax_and_no_tpu2048():
    modules = [m.name for m in pkgutil.walk_packages(
        tpu2048_torch.__path__, "tpu2048_torch.")
        if m.name != "tpu2048_torch.__main__"]
    assert {
        "tpu2048_torch.ops.step_kernel", "tpu2048_torch.ops.table_kernel",
        "tpu2048_torch.ops._build", "tpu2048_torch.env.rewards",
        "tpu2048_torch.agents.tabular", "tpu2048_torch.agents.tabular_fast",
        "tpu2048_torch.metrics.logging", "tpu2048_torch.training.tabular",
        "tpu2048_torch.bench", "tpu2048_torch.eval.evaluate",
        "tpu2048_torch.env.fast", "tpu2048_torch.replay.buffer",
        "tpu2048_torch.agents.dqn", "tpu2048_torch.training.dqn",
        "tpu2048_torch.checkpoint.ckpt", "tpu2048_torch.models.dqn",
        "tpu2048_torch.metrics.analyze", "tpu2048_torch.metrics.profiling",
        "tpu2048_torch.utils.watchdog", "tpu2048_torch.utils.debug",
        "tpu2048_torch.env.env", "tpu2048_torch.env.parity",
        "tpu2048_torch.eval.demo", "tpu2048_torch.eval.gui",
        "tpu2048_torch.parallel.mesh", "tpu2048_torch.parallel.testkit",
        "tpu2048_torch.replay.sharded",
    } <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tpu2048'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    rng = np.random.default_rng(0)
    b = 64
    boards = torch.from_numpy(rng.integers(0, 5, (16, b)).astype(np.int8))
    actions = torch.from_numpy(rng.integers(-1, 4, b).astype(np.int32))
    bits = torch.from_numpy(rng.integers(-2**31, 2**31, (8, b),
                                         dtype=np.int64).astype(np.int32))
    before = sk.fused_env_step.launches
    got = sk.fused_env_step(boards, actions, bits, emit_legal=True)
    want = sk.plain_env_step(boards, actions, bits, emit_legal=True)
    assert sk.fused_env_step.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cpu_tensors_run_the_plain_rollout_without_a_launch():
    rng = np.random.default_rng(1)
    b, k = 32, 4
    boards = torch.from_numpy(rng.integers(0, 5, (16, b)).astype(np.int8))
    zero = torch.zeros(b, dtype=torch.int32)
    lanes = (boards, zero, zero, torch.zeros(b, dtype=torch.float32))
    before = sk.fused_env_rollout.launches
    got = sk.fused_env_rollout(*lanes, k, seed=3, step=0)
    want = sk.plain_env_rollout(*lanes, k, seed=3, step=0)
    assert sk.fused_env_rollout.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="not both"):
        sk.fused_env_rollout(*lanes, k, sk.philox_rows(3, 0, k, b, "cpu"),
                             seed=3, step=0)
    with pytest.raises(ValueError, match="seed and step"):
        sk.fused_env_rollout(*lanes, k)


@pytest.mark.parametrize("argv", [
    ["eval", "--policy", "random", "--games", "4", "--eval-batch", "4"],
    ["bench", "--batch", "4", "--steps", "16"],
    ["bench", "--tabular", "--batch", "4"],
    ["bench", "--learner", "--updates", "1"],
    ["bench", "--train-loop", "--envs", "4"],
    ["eval", "--policy", "random", "--engine", "lax", "--games", "4"],
    ["demo", "--mode", "random", "--delay", "0"],
], ids=["eval-random", "bench", "bench-tabular", "bench-learner",
        "bench-train-loop", "eval-random-lax", "demo-random"])
def test_rollout_entry_points_default_to_cuda(argv, monkeypatch):
    from tpu2048_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


def test_create_model_defaults_to_cuda(monkeypatch):
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.models.dqn import create_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(DQNConfig(features=32, hidden=16, num_blocks=1))


def test_train_tabular_defaults_to_cuda(monkeypatch):
    from tpu2048_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["train", "tabular", "--episodes", "1", "--batch", "4",
              "--capacity-log2", "8"])


def test_train_dqn_defaults_to_cuda(monkeypatch):
    from tpu2048_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["train", "dqn", "--episodes", "1", "--envs", "4",
              "--features", "8", "--hidden", "8", "--blocks", "1"])
