"""The port's watchdog and debug check: a training loop whose heartbeat
stops is ended with exit code 70 (``os._exit``, so in a subprocess), one
that keeps beating ends normally, the start-up floor holds until the first
beat, the trainers run with the watchdog on, and ``checked`` raises on the
first NaN or Inf."""

import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048_torch.utils.debug import checked
from tpu2048_torch.utils.watchdog import (STARTUP_FLOOR, WATCHDOG_EXIT_CODE,
                                          Watchdog)

REPO = Path(__file__).resolve().parent.parent

LOOP = """
import time
from tpu2048_torch.utils.watchdog import Watchdog
wd = Watchdog(0.5, label="test", poll_interval=0.05).start()
for step in range({steps}):
    time.sleep(0.05)
    wd.beat()
time.sleep({stall})
wd.stop()
print("done")
"""


def run_loop(steps, stall):
    return subprocess.run(
        [sys.executable, "-c", LOOP.format(steps=steps, stall=stall)],
        cwd=REPO, capture_output=True, text=True, timeout=60)


def test_a_stalled_loop_exits_70():
    t0 = time.monotonic()
    proc = run_loop(steps=5, stall=30)
    assert proc.returncode == WATCHDOG_EXIT_CODE == 70
    assert time.monotonic() - t0 < 20
    assert "done" not in proc.stdout
    assert "[watchdog:test] no progress" in proc.stderr


def test_a_beating_loop_ends_normally():
    proc = run_loop(steps=20, stall=0)
    assert proc.returncode == 0 and proc.stdout.strip() == "done"


def test_the_startup_floor_holds_until_the_first_beat():
    fired = []
    wd = Watchdog(0.2, on_timeout=fired.append, poll_interval=0.02,
                  startup_floor=3.0).start()
    try:
        time.sleep(0.5)
        assert not fired  # inside the floor: no beat yet is no stall
        wd.beat()
        deadline = time.monotonic() + 10
        while not fired and time.monotonic() < deadline:
            time.sleep(0.05)
        assert fired and fired[0] > 0.2  # after a beat the timeout rules
    finally:
        wd.stop()
    assert STARTUP_FLOOR == 300.0
    with pytest.raises(ValueError):
        Watchdog(0)


def test_the_trainers_run_with_the_watchdog_on(tmp_path):
    from tpu2048_torch.cli.main import main

    assert main(["train", "tabular", "--cpu", "--episodes", "4", "--batch",
                 "8", "--capacity-log2", "8", "--steps-per-chunk", "32",
                 "--watchdog", "600"]) == 0
    assert main(["train", "dqn", "--cpu", "--features", "8", "--hidden",
                 "8", "--blocks", "1", "--no-bf16", "--envs", "8", "--batch",
                 "4", "--episodes", "1", "--steps-per-chunk", "16",
                 "--watchdog", "600", "--checkpoint-dir",
                 str(tmp_path / "ck")]) == 0


def test_checked_raises_on_the_first_non_finite_output():
    f = checked(lambda x: (torch.log(x), {"n": torch.arange(3)}))
    out = f(torch.tensor([1.0, 2.0]))
    assert torch.equal(out[1]["n"], torch.arange(3))
    with pytest.raises(FloatingPointError, match="/0"):
        f(torch.tensor([-1.0]))
    with pytest.raises(FloatingPointError):
        checked(lambda: torch.tensor([float("inf")]))()
