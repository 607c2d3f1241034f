"""SIGTERM-triggered graceful checkpointing — port of
``movae_tpu/utils/preemption.py``.

The handler only sets a flag. The training loops poll it between steps
(one process) or at each epoch's end (a data-parallel run:
:meth:`PreemptionGuard.globally_triggered`, an all-reduce of the flag, so
every rank stops at the same step), write a resumable ``last_*``
checkpoint at the next safe point and exit with code 143 (128 +
SIGTERM), so a retry with ``--resume`` continues from the interrupted
epoch.
"""

from __future__ import annotations

import signal
import threading

import torch

from movae_tpu_torch.parallel import mesh as mesh_lib


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

    def globally_triggered(self) -> bool:
        """True when ANY rank has been signalled (a collective: every rank
        calls it at the same point, so all agree before leaving the
        step cadence)."""
        if mesh_lib.process_count() == 1:
            return self._flag
        flag = torch.tensor([int(self._flag)], dtype=torch.int32)
        return bool(mesh_lib.all_reduce_(flag, "max", axis=None).item())

    def uninstall(self) -> None:
        for s, prev in self._installed:
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._installed = []
