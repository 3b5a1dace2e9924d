"""Structured event log (the OOMAO `logBook` equivalent; port of
``mpc_sensorlessao_tpu/utils/logbook.py``).

The reference attaches a singleton logger to every object and appends
timestamped strings (reference: OOMAO-master/logBook.m, used at e.g.
telescopeAbstract.m:830).  Here: a process-wide singleton with leveled,
timestamped entries, stdlib-logging interop, and a capture context for
tests.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Tuple

_LOGGER = logging.getLogger("mpc_sensorlessao_tpu_torch")


@dataclass
class LogBook:
    entries: List[Tuple[float, str, str, str]] = field(default_factory=list)
    echo: bool = False

    def add(self, sender, message: str, level: str = "info") -> None:
        name = type(sender).__name__ if not isinstance(sender, str) else sender
        self.entries.append((time.time(), level, name, message))
        getattr(_LOGGER, level, _LOGGER.info)(f"[{name}] {message}")
        if self.echo:
            print(f"[{name}] {message}")

    def tail(self, n: int = 10):
        return self.entries[-n:]

    def clear(self) -> None:
        self.entries.clear()


_SINGLETON = LogBook()


def logbook() -> LogBook:
    """The process-wide log book (logBook.m singleton pattern)."""
    return _SINGLETON


def add(sender, message: str, level: str = "info") -> None:
    _SINGLETON.add(sender, message, level)


@contextmanager
def capture():
    """Capture entries appended inside the context (for tests)."""
    start = len(_SINGLETON.entries)
    yield lambda: _SINGLETON.entries[start:]
