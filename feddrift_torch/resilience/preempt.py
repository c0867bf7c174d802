"""Cooperative SIGTERM/SIGINT preemption for long runs.

A copy of ``feddrift_tpu/resilience/preempt.py``. Preemptible cloud
machines get a SIGTERM and a short grace window before the machine
disappears. The reference FedDrift had no story here (termination
is MPI_Abort, SURVEY.md §5); this handler turns the signal into a flag the
runner polls at iteration boundaries: finish the in-flight iteration,
write the atomic checkpoint, emit ``preempt_checkpoint``, exit cleanly.
``--auto_resume`` (cli.py) then continues the run on the replacement
machine.

Semantics:

- installing is a no-op off the main thread (``signal.signal`` is
  main-thread-only; worker-thread runs — tests, notebooks — simply run
  without preemption handling);
- the FIRST signal sets the flag and logs; a SECOND signal restores the
  original disposition and re-raises it, so a stuck run can still be
  killed interactively with a double Ctrl-C;
- original handlers are always restored on exit (context manager).
"""

from __future__ import annotations

import logging
import os
import signal
import threading
from typing import Optional

log = logging.getLogger("feddrift_torch")

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionHandler:
    """Signal -> checkpoint-at-next-boundary flag (see module docstring)."""

    def __init__(self, signals=_DEFAULT_SIGNALS, enabled: bool = True) -> None:
        self.signals = tuple(signals)
        self.enabled = enabled
        self.requested = False
        self.signal_name: Optional[str] = None
        self._old: dict[int, object] = {}
        self._installed = False

    def install(self) -> "PreemptionHandler":
        if (not self.enabled
                or threading.current_thread() is not threading.main_thread()):
            return self
        for sig in self.signals:
            self._old[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, old in self._old.items():
            try:
                signal.signal(sig, old)
            except (ValueError, TypeError):
                pass
        self._old.clear()
        self._installed = False

    def _on_signal(self, signum, frame) -> None:
        name = signal.Signals(signum).name
        if self.requested:
            # second signal: the operator really means it — restore the
            # original disposition and let it take effect immediately
            log.warning("second %s: restoring default handling", name)
            self.uninstall()
            os.kill(os.getpid(), signum)
            return
        self.requested = True
        self.signal_name = name
        log.warning("%s received: will checkpoint at the next iteration "
                    "boundary and exit (send again to force)", name)

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
