"""SIGTERM-triggered graceful checkpointing — port of
``movae_tpu/utils/preemption.py`` for one process.

The handler only sets a flag. The training loops poll it between steps,
write a resumable ``last_*`` checkpoint at the next safe point and exit
with code 143 (128 + SIGTERM), so a retry with ``--resume`` continues from
the interrupted epoch. The JAX package's multi-host OR of the flag is
``ROADMAP.md`` Queue 1 item 13.
"""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Installs handlers for ``signals`` (default SIGTERM) on the main
    thread and exposes the flag they set."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = False
        self._installed = []
        if threading.current_thread() is threading.main_thread():
            for s in signals:
                try:
                    prev = signal.signal(s, self._handle)
                    self._installed.append((s, prev))
                except (ValueError, OSError):  # pragma: no cover
                    pass

    def _handle(self, signum, frame):
        self._flag = True
        print(f"[movae_tpu_torch] received signal {signum}: will write a "
              "resumable checkpoint at the next safe point and exit",
              flush=True)

    @property
    def triggered(self) -> bool:
        return self._flag

    def uninstall(self) -> None:
        for s, prev in self._installed:
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._installed = []
