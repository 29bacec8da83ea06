"""The port's ``bench`` subcommand on the CPU, at a small size: one JSON
line with the rollout bench's keys (and no ``vs_baseline``, a ratio to a TPU
target), the single-step path (``--rollout-k 1``) against a hand loop of
``fast_step``, the tabular bench on either table, the learner and
train-loop benches' lines (narrow networks), ``--scale`` on gloo ranks, and
what the subcommand refuses."""

import functools
import json

import pytest
import torch

from tpu2048_torch import bench
from tpu2048_torch.agents.dqn import DQNConfig
from tpu2048_torch.cli import main as cli
from tpu2048_torch.cli.main import main
from tpu2048_torch.env.fast import GeneratorBits, fast_reset, fast_step


def test_bench_prints_one_json_line(capsys):
    assert main(["bench", "--cpu", "--batch", "64", "--steps", "32"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert {"env_steps_per_s", "batch", "steps", "rollout_k", "launches",
            "bits", "card"} <= set(row)
    assert "vs_baseline" not in row
    assert (row["batch"], row["steps"], row["rollout_k"]) == (64, 32, 16)
    assert row["windows"] == 2 and row["launches"] == 0  # no kernel on a CPU
    assert row["bits"] == "philox" and row["card"] == "cpu"
    assert row["env_steps_per_s"] > 0


def single_step_totals(batch, steps):
    """The summed reward and dones of the single-step bench's timed run,
    from a hand loop of ``fast_step`` on its bits: the reset, ``steps``
    warm steps, then ``steps`` timed ones."""
    bits = GeneratorBits(0, torch.device("cpu"))
    state = fast_reset(bits, batch, bench.ROLLOUT_ENV)
    for _ in range(2):
        reward = torch.zeros((), dtype=torch.float32)
        dones = 0
        for _ in range(steps):
            state, ts = fast_step(bench.ROLLOUT_ENV, state, bits)
            reward += ts.reward.sum(dtype=torch.float32)
            dones += int(ts.done.sum())
    return float(reward), dones


@pytest.mark.parametrize("k", [1, 8])
def test_bench_rollout_k(k, capsys):
    """``--rollout-k 1`` steps through ``fast_step`` on generator bits and
    sums what a hand loop sums; any other K is the rollout path's row."""
    argv = ["bench", "--cpu", "--batch", "64", "--steps", "32"]
    assert main([*argv, "--rollout-k", str(k)]) == 0
    row = json.loads(capsys.readouterr().out)
    assert (row["batch"], row["steps"], row["rollout_k"]) == (64, 32, k)
    assert row["windows"] == 32 // k and row["launches"] == 0
    if k == 1:
        assert row["bits"] == "generator"
        assert (row["reward"], row["episodes"]) == single_step_totals(64, 32)
        assert row["episodes"] > 0
        return
    want = bench.main(batch=64, steps=32, rollout_k=k, device="cpu")
    capsys.readouterr()
    timed = {"env_steps_per_s", "seconds"}
    assert {key: v for key, v in row.items() if key not in timed} == {
        key: v for key, v in want.items() if key not in timed}
    assert row["bits"] == "philox" and "reward" not in row


@pytest.mark.parametrize("flags, message", [
    (["--rollout-k", "3"], "not a whole number"),
    (["--rollout-k", "0"], "not a whole number"),
    (["--tabular", "--table-backend", "xla"], "names a JAX backend"),
    (["--tabular", "--table-backend", "interpret"], "names a JAX backend"),
])
def test_bench_refusals(flags, message, capsys):
    assert main(["bench", "--cpu", "--steps", "32", *flags]) == 2
    captured = capsys.readouterr()
    assert message in captured.err and captured.out == ""


@pytest.mark.parametrize("backend, resolved", [
    ("legacy", "legacy"), ("pallas", "packed")])
def test_tabular_bench_table_backend(backend, resolved, monkeypatch,
                                     capsys):
    """``bench --tabular --table-backend`` runs the trainer's table and
    names the one that ran."""
    monkeypatch.setattr(bench, "TABULAR_CAPACITY_LOG2", 10)
    monkeypatch.setattr(bench, "TABULAR_STEPS_PER_CHUNK", 8)
    monkeypatch.setattr(bench, "TABULAR_TIMED_CHUNKS", 2)
    assert main(["bench", "--cpu", "--tabular", "--batch", "32",
                 "--table-backend", backend]) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["bench"] == "tabular" and row["table_backend"] == resolved
    assert (row["batch"], row["capacity_log2"]) == (32, 10)
    assert row["env_steps_per_s"] > 0


def test_tabular_bench_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench, "TABULAR_CAPACITY_LOG2", 10)
    monkeypatch.setattr(bench, "TABULAR_STEPS_PER_CHUNK", 8)
    monkeypatch.setattr(bench, "TABULAR_TIMED_CHUNKS", 2)
    row = bench.tabular_main(batch=32, device="cpu")
    assert json.loads(capsys.readouterr().out) == row
    assert row["bench"] == "tabular" and row["card"] == "cpu"
    assert row["table_backend"] == "packed"
    assert (row["capacity_log2"], row["steps_per_chunk"], row["chunks"]) == (
        10, 8, 2)
    assert row["env_steps_per_s"] > 0
    assert row["ms_per_step"] == pytest.approx(1e3 * row["seconds"] / 16)


NARROW = DQNConfig(features=32, hidden=32, num_blocks=1, bf16=False,
                   memory_size=4096)


def test_learner_bench_on_the_cpu(capsys):
    row = bench.learner_main(batch=8, updates=5, device="cpu", agent=NARROW)
    assert json.loads(capsys.readouterr().out) == row
    assert row["metric"] == "dqn_updates_per_s_per_chip"
    assert {"value", "unit", "ms_per_update", "batch", "updates", "features",
            "loss", "seconds", "card"} <= set(row)
    assert (row["batch"], row["updates"], row["features"]) == (8, 5, 32)
    assert row["value"] > 0 and row["card"] == "cpu"
    assert row["ms_per_update"] == pytest.approx(1e3 / row["value"])


def test_train_loop_bench_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench, "TRAIN_LOOP_STEPS_PER_CHUNK", 8)
    row = bench.train_loop_main(envs=8, chunks=2, device="cpu", agent=NARROW)
    assert json.loads(capsys.readouterr().out) == row
    assert row["metric"] == "train_loop_env_steps_per_s_per_chip"
    assert (row["envs"], row["steps_per_chunk"], row["chunks"]) == (8, 8, 2)
    assert row["value"] > 0 and row["card"] == "cpu"
    assert row["launches"] == 0  # the plain version runs on a CPU tensor


@pytest.mark.parametrize("flags", [["--scale", "1,2"]])
def test_bench_modes_not_yet_ported(flags, monkeypatch, capsys):
    """Every bench mode of the JAX package runs: ``bench --scale`` on gloo
    ranks on the CPU prints a row a rank count, each stamped
    ``"simulated": true`` (JAX's ``tests/test_sharding.py:213``): its
    efficiency checks the program, not a card's scaling. On the card it
    needs a card a rank."""
    monkeypatch.setattr(bench, "scale_main", functools.partial(
        bench.scale_main, envs_per_rank=16, chunks=1, steps_per_chunk=4))
    assert main(["bench", "--cpu", *flags]) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert r["metric"] == "dp_scaling_env_steps_per_s_per_device"
        assert r["simulated"] is True and r["card"] == "cpu"
        assert r["value"] > 0 and r["launches"] == [0] * r["devices"]
        assert r["warm_launches"] == [0] * r["devices"]
        assert (r["envs_per_rank"], r["steps_per_chunk"]) == (16, 4)
    assert rows[0]["efficiency"] == 1.0
    monkeypatch.setattr(cli, "_cards", lambda: 1)
    assert main(["bench", *flags]) == 2
    assert "needs one card a rank" in capsys.readouterr().err


def test_bench_steps_must_fill_whole_windows():
    with pytest.raises(ValueError, match="not divisible"):
        bench.main(batch=8, steps=20, device="cpu")
