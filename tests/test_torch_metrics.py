"""The port's metrics against :mod:`tpu2048.metrics` and the JAX trainer:
the ``--debug-csv`` trace of env 0 written by both trainers on the shared
draws of the DQN loop parity harness (``test_torch_dqn_train.py``), byte
for byte; ``analyze`` on the committed runs against JAX's ``analyze`` and
the committed ``analysis.json``; the plots; and the profiling helpers."""

import contextlib
import io
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_dqn_train import configs, start_both
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048.metrics import CSVLogger as JaxCSVLogger
from tpu2048.metrics.analyze import analyze as jax_analyze
from tpu2048.training import dqn as jtrain
from tpu2048_torch.cli.main import main
from tpu2048_torch.metrics import analyze as tanalyze
from tpu2048_torch.metrics import profiling
from tpu2048_torch.metrics.logging import (CSVLogger, plot_from_jsonl,
                                           read_jsonl)
from tpu2048_torch.training import dqn as ttrain

REPO = Path(__file__).resolve().parent.parent
HEADER = ["Episode", "Action", "Legal Moves", "Reward", "Total Reward",
          "State", "Done", "Ho salvato", "Mosse"]
RUNS = ("dqn_rollback", "dqn_r3", "per_ablation_3500")


def test_debug_csv_rows_match_jax(tmp_path):
    jcfg, tcfg = configs(trace_env0=True)
    model, _, js, ts = start_both(jcfg, tcfg)
    # Env 0 starts on an endgame board, so that its episode ends (and the
    # trace's episode column advances) within the chunk.
    last = ts.env_state.boards.shape[1] - 1
    js = js.replace(
        env_state=js.env_state.replace(
            boards=js.env_state.boards.at[:, 0].set(
                js.env_state.boards[:, last]),
            legal=js.env_state.legal.at[0].set(js.env_state.legal[last])),
        # JAX's train donates its state: the target may not share buffers.
        agent=js.agent.replace(target_params=jax.tree.map(
            jnp.copy, js.agent.target_params)))
    ts.env_state.boards[:, 0] = ts.env_state.boards[:, last]
    ts.env_state.legal[0] = ts.env_state.legal[last]
    j_csv, t_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    j_log, t_log = JaxCSVLogger(str(j_csv), HEADER), CSVLogger(str(t_csv),
                                                               HEADER)
    j_rows, t_rows = [], []

    def both(rows, log):
        return lambda row: (rows.append(row), log.log(row))

    # The port first: JAX's train donates the key its draws replay.
    ttrain.train(tcfg, 1, state=ts, trace_fn=both(t_rows, t_log))
    jtrain.train(jcfg, 1, state=js, model=model, trace_fn=both(j_rows, j_log))
    j_log.close()
    t_log.close()
    assert len(t_rows) == tcfg.steps_per_chunk and t_rows == j_rows
    assert t_csv.read_bytes() == j_csv.read_bytes()
    assert t_rows[-1][0] >= 1 and any(r[6] for r in t_rows)  # env 0 ended


def test_cli_debug_csv_has_a_row_a_vector_step(tmp_path):
    csv_path, log = tmp_path / "trace.csv", tmp_path / "m.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = main(["train", "dqn", "--cpu", "--features", "8", "--hidden",
                   "8", "--blocks", "1", "--no-bf16", "--envs", "8",
                   "--batch", "4", "--episodes", "2", "--steps-per-chunk",
                   "32", "--debug-csv", str(csv_path), "--log", str(log)])
    assert rc == 0
    lines = csv_path.read_text().splitlines()
    assert lines[0] == ",".join(HEADER)
    steps = read_jsonl(str(log))[-1]["env_steps"] // 8
    assert len(lines) == 1 + steps


@pytest.mark.parametrize("run", RUNS)
def test_analyze_matches_jax_and_the_committed_analysis(run):
    rel = f"runs/{run}/metrics.jsonl"
    path = str(REPO / rel)
    got = tanalyze.analyze(path)
    assert got == jax_analyze(path)
    committed = json.loads((REPO / "runs" / run / "analysis.json").read_text())
    assert committed.pop("log") == rel and got.pop("log") == path
    # The committed file of dqn_r3 predates the reference anchor.
    extra = set(got) - set(committed)
    assert extra == ({"reference_anchor"} if run == "dqn_r3" else set())
    assert {k: got[k] for k in committed} == committed
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["analyze", "--log", path]) == 0
    assert json.loads(out.getvalue()) == tanalyze.analyze(path)


def test_analyze_of_an_empty_log(tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    assert tanalyze.analyze(str(empty)) == jax_analyze(str(empty))


def test_plot_writes_a_png(tmp_path):
    out = tmp_path / "plots" / "run.png"
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["plot", "--log", str(REPO / "runs/dqn_r3/metrics.jsonl"),
                     "--out", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    rows = tmp_path / "rows.jsonl"
    rows.write_text("".join(json.dumps({"episodes": i, "best_tile": 2 ** i,
                                        "mean_score": 10.0 * i}) + "\n"
                            for i in range(1, 5)))
    plot_from_jsonl(str(rows), str(tmp_path / "direct.png"))
    assert (tmp_path / "direct.png").stat().st_size > 0


def test_plot_every_writes_the_log_png(tmp_path):
    log = tmp_path / "m.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["train", "tabular", "--cpu", "--episodes", "8",
                     "--batch", "8", "--capacity-log2", "8",
                     "--steps-per-chunk", "64", "--plot-every", "1",
                     "--log", str(log)]) == 0
    assert (tmp_path / "m.png").read_bytes()[:4] == b"\x89PNG"


def test_plot_every_without_log_is_ignored_as_jax_does(tmp_path, capsys):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert main(["--cpu", "train", "tabular", "--episodes", "4",
                     "--batch", "8", "--capacity-log2", "8",
                     "--steps-per-chunk", "32", "--plot-every", "1"]) == 0
    finally:
        os.chdir(cwd)
    assert "--plot-every requires --log" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())  # nothing drawn


def test_profiling_trace_and_time_fn(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("matmul_scope"):
            (x @ x).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert any(e.key == "matmul_scope" for e in prof.key_averages())
    calls = []
    seconds = profiling.time_fn(lambda: calls.append(x @ x), iters=4,
                                warmup=2)
    assert seconds > 0 and len(calls) == 6
