"""No-progress watchdog for long training runs, the port of
:mod:`tpu2048.utils.watchdog`.

A crash is the easy failure of a long run; the checkpoints and ``--resume``
handle it. The harder one is a hang: a device call that never returns (a
wedged driver, a lost card). The host loop then blocks inside a chunk with
no exception to catch, and the run stops making progress while it holds
the card.

The watchdog turns a hang into a crash that the checkpoint machinery can
handle: a daemon thread checks a heartbeat that the training loop feeds
after every chunk (and around checkpoint I/O); when none arrives within
``timeout`` seconds it prints a diagnostic and ends the process with
:data:`WATCHDOG_EXIT_CODE`, which a supervisor tells apart and answers with
``--resume``.

``os._exit`` (not ``sys.exit``) is deliberate: the main thread is blocked
in a call that Python exceptions cannot interrupt, and exit handlers could
themselves touch the wedged device.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional

#: Exit status meaning "no forward progress within the watchdog window":
#: distinct from 0 (done) and 1 (error), so that a supervisor can resume.
#: 70 = BSD EX_SOFTWARE ("internal software error").
WATCHDOG_EXIT_CODE = 70

#: The grace before the first beat that the trainers pass as
#: ``startup_floor``. The first chunk on the card pays the one-time nvcc
#: build of the kernels on first use, and a resumed DQN run the restore of
#: its whole loop state (1.55 GB at the full width, 9.7-12.0 s for the
#: resume's call on an H100, PERF.md section 6); 300 s leaves room for a
#: slow build and disk. A smaller --watchdog still applies once the first
#: chunk has ended.
STARTUP_FLOOR = 300.0


class Watchdog:
    """Calls ``on_timeout`` if :meth:`beat` isn't called for ``timeout`` s.

    The default ``on_timeout`` writes a diagnostic to stderr and calls
    ``os._exit(WATCHDOG_EXIT_CODE)``. Tests inject a callback instead.

    Usage::

        wd = Watchdog(timeout=900, label="dqn train").start()
        try:
            while ...:
                state = chunk(state)   # may block forever on a wedged card
                wd.beat()
        finally:
            wd.stop()
    """

    def __init__(
        self,
        timeout: float,
        label: str = "train",
        on_timeout: Optional[Callable[[float], None]] = None,
        poll_interval: Optional[float] = None,
        startup_floor: float = 0.0,
    ) -> None:
        if timeout <= 0:
            raise ValueError("watchdog timeout must be positive")
        self.timeout = float(timeout)
        self.label = label
        # Until the first beat the window is max(timeout, startup_floor):
        # the first chunk pays the one-time build and restore, and a
        # timeout sized for steady-state chunks must not kill it.
        self.startup_floor = float(startup_floor)
        self._beaten = False
        self._on_timeout = on_timeout or self._default_on_timeout
        self._poll = poll_interval or min(5.0, self.timeout / 4)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        self._last = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name=f"watchdog:{self.label}", daemon=True
        )
        self._thread.start()
        return self

    def beat(self) -> None:
        """Record forward progress (cheap; call after every chunk)."""
        self._beaten = True
        self._last = time.monotonic()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._poll)

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            stale = time.monotonic() - self._last
            window = (self.timeout if self._beaten
                      else max(self.timeout, self.startup_floor))
            if stale > window:
                self._on_timeout(stale)
                return

    def _default_on_timeout(self, stale: float) -> None:
        sys.stderr.write(
            f"[watchdog:{self.label}] no progress for {stale:.0f}s "
            f"(timeout {self.timeout:.0f}s); assuming a wedged device "
            f"call; exiting {WATCHDOG_EXIT_CODE} for the supervisor to "
            f"resume from the last checkpoint\n"
        )
        sys.stderr.flush()
        os._exit(WATCHDOG_EXIT_CODE)
