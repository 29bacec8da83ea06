"""The port's parity harness (``tpu2048_torch.env.parity``), terminal demo
(``tpu2048_torch.eval.demo``) and Tk GUI (``tpu2048_torch.eval.gui``)
against the JAX package's, on the CPU.

The parity harness drives the original reference envs, which this
repository does not hold: its test stands in an oracle built from JAX's
classic env (a ``game.board`` of face values and ``step(action) -> (obs,
reward, done, max)``, spawning from its own key chain), so that the
harness reads every spawn off the oracle's boards and replays it on the
port's env. The demo's sessions draw their spawns from a generator, so
they are checked by what they must do (moves counted, game over reached,
the HUD read once a move); ``render_board`` and the GUI's palette are held
to JAX's on the same inputs. The GUI runs on a stand-in ``tkinter`` whose
timer runs its callbacks at once.
"""

import contextlib
import io
import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048.env import env as jenv
from tpu2048.env import parity as jparity
from tpu2048.eval import demo as jdemo
from tpu2048.eval import gui as jgui
from tpu2048.ops import board as jboard
from tpu2048_torch.agents import tabular as ttab
from tpu2048_torch.cli.main import build_parser, main
from tpu2048_torch.env import parity as tparity
from tpu2048_torch.eval import demo as tdemo
from tpu2048_torch.eval import gui as tgui
from tpu2048_torch.eval.evaluate import greedy_tabular_policy

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# The parity harness
# ---------------------------------------------------------------------------


def jax_oracle(variant):
    """A stand-in for the reference's env class: JAX's classic env in the
    variant's semantics, keyed from ``np.random`` (which ``run_parity``
    seeds). v1 commits its own board; v2 leaves that to the driver."""
    cfg = jenv.EnvConfig(reward="shaped" if variant == "v1" else "simple",
                         quirk_compat=variant == "v2", auto_reset=False)
    step = jax.jit(lambda s, a: jenv.step(cfg, s, a))

    class Oracle:
        def __init__(self):
            key = jax.random.PRNGKey(np.random.randint(2**31))
            self.state = jenv.reset(cfg, key, 1)
            self.game = types.SimpleNamespace(
                board=np.asarray(jboard.board_values(self.state.board[0])))

        def step(self, action):
            board = jboard.values_to_exponents(jnp.asarray(self.game.board))
            self.state, ts = step(self.state.replace(board=board[None]),
                                  jnp.asarray([action], jnp.int32))
            obs = np.asarray(jboard.board_values(ts.obs[0]))
            if variant == "v1":
                self.game.board = obs.copy()
            return (obs, float(ts.reward[0]), bool(ts.done[0]),
                    int(ts.max_number[0]))

    return Oracle


@pytest.mark.parametrize("variant,seed", [("v1", 3), ("v1", 11), ("v2", 0),
                                          ("v2", 7)])
def test_run_parity_on_a_stand_in_oracle(variant, seed, monkeypatch):
    monkeypatch.setattr(tparity, "load_reference_env", jax_oracle)
    res = tparity.run_parity(variant, seed=seed, max_steps=400,
                             action_seed=seed + 100, device="cpu")
    assert res.ok, "\n".join(res.mismatches)
    assert res.done and res.steps > 30


def test_run_parity_reports_a_mismatch(monkeypatch):
    """An oracle whose reward is off by 1 on every step is caught."""
    oracle = jax_oracle("v2")

    class Off(oracle):
        def step(self, action):
            obs, reward, done, top = super().step(action)
            return obs, reward + 1.0, done, top

    monkeypatch.setattr(tparity, "load_reference_env", lambda v: Off)
    res = tparity.run_parity("v2", seed=1, max_steps=5, device="cpu")
    assert not res.ok and "reward" in res.mismatches[0]


def test_load_reference_env_needs_a_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv(tparity.REFERENCE_VAR, raising=False)
    with pytest.raises(FileNotFoundError, match=tparity.REFERENCE_VAR):
        tparity.load_reference_env("v1")
    with pytest.raises(ValueError):
        tparity.load_reference_env("v3", root=str(tmp_path))


@pytest.mark.parametrize("case", range(4))
def test_extract_spawn_matches_jax(case):
    rng = np.random.default_rng(case)
    merged = np.where(rng.random((4, 4)) < 0.5, 0,
                      2 ** rng.integers(1, 8, (4, 4)))
    post = merged.copy()
    if case:  # case 0: no spawn (an invalid move)
        empties = np.argwhere(merged == 0)
        r, c = empties[rng.integers(len(empties))]
        post[r, c] = 2 if case % 2 else 4
    assert tparity._extract_spawn(merged, post) == jparity._extract_spawn(
        merged, post)
    if case:
        bad = post.copy()
        bad[np.argwhere(merged == 0)[0][0], np.argwhere(merged == 0)[0][1]] = 8
        with pytest.raises((ValueError, AssertionError)):
            tparity._extract_spawn(merged, bad)


# ---------------------------------------------------------------------------
# The terminal demo
# ---------------------------------------------------------------------------


def test_render_board_matches_jax():
    values = [[2, 0, 0, 0], [0, 64, 0, 0], [0, 0, 1024, 0], [0, 0, 0, 8192]]
    board = np.array(jboard.values_to_exponents(jnp.asarray(values)))
    for last in (None, 2):
        want = jdemo.render_board(board, score=123, moves=7,
                                  last_action=last)
        assert tdemo.render_board(board, 123, 7, last) == want
        assert tdemo.render_board(torch.from_numpy(board), 123, 7,
                                  last) == want
    assert tdemo.TILE_COLORS == jdemo.TILE_COLORS
    assert tdemo.KEYMAP == jdemo.KEYMAP
    assert tdemo.ACTION_NAMES == jdemo.ACTION_NAMES


def test_demo_random_mode_runs_to_game_over():
    out = io.StringIO()
    stats = tdemo.play(mode="random", delay=0.0, seed=1, out=out,
                       device="cpu")
    text = out.getvalue()
    assert "GAME OVER" in text
    assert stats["score"] > 0 and stats["max_tile"] >= 16
    assert stats["moves"] > 20
    assert text.count("score") == stats["moves"] + 1  # a frame a move


def test_demo_manual_mode_scripted():
    """Four keys move (an illegal one counts as a move, as in JAX's
    session), "x" is ignored and "q" quits; the host copies match the
    session's device state."""
    out = io.StringIO()
    keys = iter(["a", "w", "d", "s", "x", "q"])
    stats = tdemo.play(mode="manual", seed=2, out=out,
                       input_fn=lambda: next(keys), device="cpu")
    assert stats["moves"] == 4
    session = tdemo.GameSession(mode="manual", seed=2, device="cpu")
    before = session.board.copy()
    for a in (0, 1, 2, 3):
        session.step_manual(a)
    assert session.last_action == 3 and session.moves == 4
    np.testing.assert_array_equal(session.board,
                                  session.state.board[0].numpy())
    assert session.score == int(session.state.score[0])
    assert stats == session.stats()  # same seed, same keys
    assert (session.board != before).any()
    np.testing.assert_array_equal(
        session.board_values(),
        np.asarray(jboard.board_values(jnp.asarray(session.board))))


def test_session_model_mode_plays_a_table(tmp_path):
    table = ttab.qtable_init(10, "cpu")
    session = tdemo.GameSession(mode="model",
                                policy=greedy_tabular_policy(table),
                                seed=3, device="cpu")
    while session.alive and session.moves < 2000:
        action = session.step_auto()
        assert action == session.last_action and 0 <= action < 4
    assert not session.alive and session.stats()["max_tile"] >= 16
    with pytest.raises(ValueError, match="needs a policy"):
        tdemo.GameSession(mode="model", device="cpu")


# ---------------------------------------------------------------------------
# The GUI
# ---------------------------------------------------------------------------


def test_gui_tile_style_and_headless_import():
    for v in (0, 2, 4, 8, 2048, 4096):
        assert tgui.tile_style(v) == jgui.tile_style(v)
    assert tgui.TILE_HEX == jgui.TILE_HEX
    assert tgui.DARK_TEXT_MAX == jgui.DARK_TEXT_MAX
    code = ("import sys, tpu2048_torch.eval.gui\n"
            "sys.exit('tkinter' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PATH": "/usr/bin:/bin"}, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def fake_tkinter():
    """A stand-in for tkinter: widgets keep their options, ``after`` queues
    its callback and ``mainloop`` runs the queue."""

    class Widget:
        def __init__(self, *args, **kw):
            self.options = dict(kw)

        def grid(self, **kw):
            pass

        def configure(self, **kw):
            self.options.update(kw)

    class Tk(Widget):
        last = None

        def __init__(self):
            super().__init__()
            self.queue, self.binds = [], {}
            Tk.last = self

        def title(self, text):
            pass

        def bind(self, seq, fn):
            self.binds[seq] = fn

        def after(self, ms, fn):
            self.queue.append(fn)

        def mainloop(self):
            while self.queue:
                self.queue.pop(0)()

        def destroy(self):
            self.queue.clear()

    font = types.ModuleType("tkinter.font")
    font.Font = lambda **kw: None
    tk = types.ModuleType("tkinter")
    tk.Tk, tk.Label, tk.font = Tk, Widget, font
    return tk, font


def test_run_gui_plays_random_mode_to_game_over(monkeypatch):
    tk, font = fake_tkinter()
    monkeypatch.setitem(sys.modules, "tkinter", tk)
    monkeypatch.setitem(sys.modules, "tkinter.font", font)
    stats = tgui.run_gui(mode="random", delay_ms=0, seed=4, device="cpu")
    assert stats["moves"] > 20 and stats["max_tile"] >= 16
    stats = tgui.run_gui(mode="manual", seed=4, device="cpu")
    assert stats["moves"] == 0
    root = tk.Tk.last
    root.binds["<Key>"](types.SimpleNamespace(keysym="Left"))
    root.binds["<Key>"](types.SimpleNamespace(keysym="Escape"))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_has_demo_and_gui_subcommands():
    parser = build_parser()
    args = parser.parse_args(["gui", "--mode", "random", "--delay", "0.1"])
    assert args.mode == "random" and args.fn.__name__ == "cmd_gui"
    args = parser.parse_args(["demo", "--mode", "model", "--table", "q.npz",
                              "--named", "tile_512_ep3", "--step", "2",
                              "--params", "p.npz", "--cpu"])
    assert args.fn.__name__ == "cmd_demo" and args.table == "q.npz"
    assert args.named == "tile_512_ep3" and args.step == 2 and args.cpu


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_cli_demo_random_and_model_on_cpu(tmp_path, capsys):
    rc, out = run_cli(["demo", "--mode", "random", "--delay", "0", "--cpu",
                       "--seed", "5"])
    assert rc == 0
    stats = json.loads(out.strip().splitlines()[-1])
    assert "GAME OVER" in out and stats["moves"] > 20
    table = str(tmp_path / "q.npz")
    ttab.save_qtable(table, ttab.qtable_init(8, "cpu"))
    rc, out = run_cli(["demo", "--mode", "model", "--table", table,
                       "--delay", "0", "--cpu"])
    assert rc == 0 and json.loads(out.strip().splitlines()[-1])["moves"] > 0
    capsys.readouterr()
    assert main(["demo", "--mode", "model", "--cpu"]) == 2
    assert "--table" in capsys.readouterr().err
    assert main(["gui", "--mode", "model", "--cpu", "--checkpoint-dir",
                 str(tmp_path / "none")]) == 2
