"""Tkinter GUI: manual, random and trained-model play, the port of
:mod:`tpu2048.eval.gui`.

The windowed counterpart of the terminal demo (:mod:`tpu2048_torch.eval.demo`)
and of the reference's ``Game2048_GUI`` (GameDemo.py:145-347): arrow-key
bindings (:258-269), timed autoplay (:272-285) with model moves restricted
to the legal actions (:288-316), the official tile palette (:323-330), a
score, moves and last-action HUD (:212-256) and a game-over banner
(:318-321).

All game logic lives in :class:`tpu2048_torch.eval.demo.GameSession`; this
module is presentation only, and imports tkinter only inside
:func:`run_gui`, so that it imports on machines without a display.
"""

from __future__ import annotations

from tpu2048_torch.eval.demo import ACTION_NAMES, GameSession

# Official 2048 hex palette (GameDemo.py:323-330 uses the same scheme).
TILE_HEX = {
    0: "#cdc1b4", 2: "#eee4da", 4: "#ede0c8", 8: "#f2b179",
    16: "#f59563", 32: "#f67c5f", 64: "#f65e3b", 128: "#edcf72",
    256: "#edcc61", 512: "#edc850", 1024: "#edc53f", 2048: "#edc22e",
}
DARK_TEXT_MAX = 4  # tiles <= 4 use dark text, larger use white


def tile_style(value: int) -> tuple[str, str]:
    """(background, foreground) hex colors for a tile value."""
    bg = TILE_HEX.get(value, "#3c3a32")  # >2048 tiles: the dark super style
    fg = "#776e65" if 0 < value <= DARK_TEXT_MAX else "#f9f6f2"
    return bg, fg


def run_gui(
    mode: str = "manual",
    policy=None,
    delay_ms: int = 500,
    seed: int = 0,
    device=None,
) -> dict:
    """Open the Tk window and play one session on ``device`` (``cuda``
    unless another is named); returns final stats.

    ``delay_ms`` is the autoplay timer period (the reference reschedules
    every 500 ms, GameDemo.py:285,316).
    """
    import tkinter as tk
    from tkinter import font as tkfont

    session = GameSession(mode=mode, policy=policy, seed=seed, device=device)

    root = tk.Tk()
    root.title("tpu2048_torch")
    root.configure(bg="#bbada0")
    tile_font = tkfont.Font(family="Helvetica", size=22, weight="bold")
    hud_font = tkfont.Font(family="Helvetica", size=12)

    hud = tk.Label(root, font=hud_font, bg="#bbada0", fg="#f9f6f2")
    hud.grid(row=0, column=0, columnspan=4, sticky="we", padx=8, pady=(8, 0))

    cells = []
    for r in range(4):
        row_cells = []
        for c in range(4):
            lbl = tk.Label(
                root, text="", width=5, height=2, font=tile_font,
                bg=TILE_HEX[0], fg="#776e65",
            )
            lbl.grid(row=r + 1, column=c, padx=4, pady=4)
            row_cells.append(lbl)
        cells.append(row_cells)

    banner = tk.Label(root, font=hud_font, bg="#bbada0", fg="#f9f6f2")
    banner.grid(row=5, column=0, columnspan=4, pady=(0, 8))

    def redraw() -> None:
        values = session.board_values()
        for r in range(4):
            for c in range(4):
                v = int(values[r, c])
                bg, fg = tile_style(v)
                cells[r][c].configure(
                    text=str(v) if v else "", bg=bg, fg=fg
                )
        last = (
            ACTION_NAMES[session.last_action]
            if session.last_action is not None
            else "-"
        )
        hud.configure(
            text=f"score {session.score}   moves {session.moves}   "
            f"last {last}   mode {mode}"
        )
        banner.configure(text="GAME OVER" if not session.alive else "")

    def on_key(event) -> None:
        if mode != "manual" or not session.alive:
            return
        action = {"Left": 0, "Up": 1, "Right": 2, "Down": 3}.get(event.keysym)
        if action is None:
            return
        session.step_manual(action)
        redraw()

    def autoplay() -> None:
        if not session.alive:
            redraw()
            return
        session.step_auto()
        redraw()
        root.after(delay_ms, autoplay)

    root.bind("<Key>", on_key)
    root.bind("q", lambda _e: root.destroy())
    redraw()
    if mode in ("random", "model"):
        root.after(delay_ms, autoplay)
    root.mainloop()
    return session.stats()
