"""Interactive terminal demo: manual, random and model play, the port of
:mod:`tpu2048.eval.demo`.

The reference's Tkinter GUI (GameDemo.py:145-347) in the terminal: manual
arrow-key play (:258-269), random autoplay (:272-285) and trained-model play
restricted to the legal moves (:288-316), drawn with the official 2048 tile
palette (:323-330) as ANSI colours, with a score, moves and last-action HUD
(:212-256) and a game-over banner (:318-321).

A :class:`GameSession` is one board of the classic env
(:mod:`tpu2048_torch.env.env`, no auto-reset) on a device: the card unless
the caller names the CPU. Each move copies what the HUD needs (the board,
the score, whether the game goes on, the action) to the host in one
transfer.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np
import torch

from tpu2048_torch.env import env as envlib
from tpu2048_torch.env.env import SIMPLE, EnvConfig
from tpu2048_torch.ops import board as board_ops
from tpu2048_torch.utils.device import resolve_device

# Official 2048 tile colours (GameDemo.py:323-330) -> nearest ANSI-256.
TILE_COLORS = {
    0: 250, 2: 230, 4: 229, 8: 215, 16: 209,
    32: 203, 64: 196, 128: 221, 256: 220,
    512: 220, 1024: 178, 2048: 172,
}
ACTION_NAMES = ["Left", "Up", "Right", "Down"]  # mainDQL:189-196


def render_board(board_exp, score: int, moves: int,
                 last_action: Optional[int]) -> str:
    """The board (``(4, 4)`` exponents, a tensor or an array) and the HUD
    as ANSI text."""
    values = board_ops.board_values(torch.as_tensor(board_exp)).cpu().numpy()
    lines = [
        f"  2048 — score {score}  moves {moves}  "
        f"last {ACTION_NAMES[last_action] if last_action is not None else '-'}"
    ]
    lines.append("  ┌──────┬──────┬──────┬──────┐")
    for i, row in enumerate(values):
        cells = []
        for v in row:
            color = TILE_COLORS.get(int(v), 172)
            text = f"{v:^6d}" if v else "      "
            cells.append(f"\x1b[48;5;{color}m\x1b[30m{text}\x1b[0m")
        lines.append("  │" + "│".join(cells) + "│")
        if i < 3:
            lines.append("  ├──────┼──────┼──────┼──────┤")
    lines.append("  └──────┴──────┴──────┴──────┘")
    return "\n".join(lines)


KEYMAP = {
    "a": 0, "w": 1, "d": 2, "s": 3,
    "h": 0, "k": 1, "l": 2, "j": 3,
    "\x1b[D": 0, "\x1b[A": 1, "\x1b[C": 2, "\x1b[B": 3,
}


def _read_key() -> str:
    """One keypress (arrow escape sequences included), cbreak mode."""
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        ch = sys.stdin.read(1)
        if ch == "\x1b":
            ch += sys.stdin.read(2)
        return ch
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


class GameSession:
    """One interactive game, shared by the terminal and Tk front ends.

    ``mode`` "manual" takes moves from :meth:`step_manual`; "random" and
    "model" from :meth:`step_auto`, drawn by a random-legal policy on the
    session's generator or by ``policy`` (an
    :class:`~tpu2048_torch.eval.evaluate.Policy` whose weights lie on
    ``device``). The board lives on ``device`` (``cuda`` unless another is
    named); :attr:`board`, :attr:`score` and :attr:`alive` are host copies
    made once a move.
    """

    def __init__(self, mode: str = "manual", policy=None, seed: int = 0,
                 device=None):
        from tpu2048_torch.eval.evaluate import as_policy, random_legal_policy

        self.device = resolve_device(device)
        self.source = envlib.GeneratorSpawns(seed, self.device)
        if mode == "random":
            policy = random_legal_policy(self.source.generator)
        if mode in ("random", "model") and policy is None:
            raise ValueError("model mode needs a policy")
        self.mode = mode
        self.config = EnvConfig(reward=SIMPLE, auto_reset=False)
        self._policy = as_policy(policy) if policy is not None else None
        self.reset()

    def reset(self) -> None:
        self.state = envlib.reset(self.config, self.source, 1)
        self.moves = 0
        self.last_action: Optional[int] = None
        # Without auto-reset a step's legal mask of the new board is the
        # next move's: computed here, then carried.
        self._legal = board_ops.legal_moves_mask(self.state.board)
        self._read(self._legal[0].any(), torch.zeros(
            (), dtype=torch.bool, device=self.device))

    def _read(self, any_legal, done, action=None) -> None:
        """The one host transfer of a move: board, score, liveness and
        the action taken."""
        parts = [self.state.board[0].flatten().to(torch.int64),
                 self.state.score[:1].to(torch.int64),
                 any_legal.reshape(1).to(torch.int64),
                 done.reshape(1).to(torch.int64)]
        if action is not None:
            parts.append(action[:1].to(torch.int64))
        host = torch.cat(parts).cpu().numpy()
        self.board = host[:16].astype(np.int8).reshape(4, 4)
        self.score = int(host[16])
        self.alive = bool(host[17]) and not bool(host[18])
        if action is not None:
            self.last_action = int(host[19])

    def step_manual(self, action: int) -> None:
        """Apply one directional move (0=L 1=U 2=R 3=D)."""
        actions = torch.full((1,), action, dtype=torch.int32,
                             device=self.device)
        self.state, ts = envlib.step(self.config, self.state, actions,
                                     self.source)
        self.last_action = action
        self.moves += 1
        self._legal = ts.legal_mask
        self._read(ts.legal_mask[0].any(), ts.done[0])

    def step_auto(self) -> int:
        """One policy move (random and model modes); returns the action."""
        actions = self._policy(self.state.board, self._legal)
        self.state, ts = envlib.step(self.config, self.state, actions,
                                     self.source)
        self.moves += 1
        self._legal = ts.legal_mask
        self._read(ts.legal_mask[0].any(), ts.done[0], actions)
        return self.last_action

    def board_values(self) -> np.ndarray:
        """``(4, 4)`` int32 face values of the host copy."""
        return board_ops.board_values(torch.from_numpy(self.board)).numpy()

    def stats(self) -> dict:
        return {
            "score": self.score,
            "moves": self.moves,
            "max_tile": int(self.board_values().max()),
        }


def play(
    mode: str = "manual",
    policy=None,
    delay: float = 0.5,
    seed: int = 0,
    max_steps: int = 10_000,
    out=None,
    input_fn=None,
    device=None,
) -> dict:
    """Run one game on ``device`` (``cuda`` unless another is named).
    ``policy`` drives model mode; manual mode reads the keyboard, or
    ``input_fn()`` when given. Frames go to ``out`` (default: the
    standard output at the call). Returns the final stats (score, moves,
    max tile)."""
    out = sys.stdout if out is None else out
    session = GameSession(mode=mode, policy=policy, seed=seed, device=device)
    for _ in range(max_steps):
        print(render_board(session.board, session.score, session.moves,
                           session.last_action), file=out)
        if not session.alive:
            print("  GAME OVER", file=out)
            break
        if mode == "manual":
            raw = input_fn() if input_fn else _read_key()
            if raw in ("q", "\x03", "\x04", ""):
                break
            action = KEYMAP.get(raw)
            if action is None:
                continue
            session.step_manual(action)
        else:
            session.step_auto()
            if delay:
                time.sleep(delay)
    return session.stats()
