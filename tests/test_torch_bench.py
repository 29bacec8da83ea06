"""The port's ``bench`` subcommand on the CPU, at a small size: one JSON
line with the rollout bench's keys (and no ``vs_baseline``, a ratio to a TPU
target), the tabular bench's line, and the modes not yet ported."""

import json

import pytest

from tpu2048_torch import bench
from tpu2048_torch.cli.main import main


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


def test_tabular_bench_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench, "TABULAR_CAPACITY_LOG2", 10)
    monkeypatch.setattr(bench, "TABULAR_STEPS_PER_CHUNK", 8)
    monkeypatch.setattr(bench, "TABULAR_TIMED_CHUNKS", 2)
    row = bench.tabular_main(batch=32, device="cpu")
    assert json.loads(capsys.readouterr().out) == row
    assert row["bench"] == "tabular" and row["card"] == "cpu"
    assert (row["capacity_log2"], row["steps_per_chunk"], row["chunks"]) == (
        10, 8, 2)
    assert row["env_steps_per_s"] > 0
    assert row["ms_per_step"] == pytest.approx(1e3 * row["seconds"] / 16)


@pytest.mark.parametrize("flags", [["--learner"], ["--train-loop"],
                                   ["--scale", "1,2"]])
def test_bench_modes_not_yet_ported(flags, capsys):
    assert main(["bench", "--cpu", *flags]) == 2
    assert "not yet ported" in capsys.readouterr().err


def test_bench_steps_must_fill_whole_windows():
    with pytest.raises(ValueError, match="not divisible"):
        bench.main(batch=8, steps=20, device="cpu")
