"""Logging + profiling utilities.

Equivalents of the reference util layer: TinyLogger leveled stream macros
(util/tiny_logger.hpp:13-68, settable from Python via set_megaverse_log_level,
megaverse.cpp:29-32) and TinyProfiler named timers (util/tiny_profiler.hpp:9-41,
used for FPS windows in megaverse_test_app.cpp:156-171). A copy of
megaverse_tpu/utils/logging.py under the logger name "megaverse_tpu_torch".
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

_logger = logging.getLogger("megaverse_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "[%(asctime)s.%(msecs)03d %(levelname).1s %(name)s] %(message)s",
        datefmt="%H:%M:%S"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)

# reference levels (tiny_logger.hpp): FATAL=0, ERROR, WARNING, INFO, DEBUG, VERBOSE
_LEVELS = [logging.CRITICAL, logging.ERROR, logging.WARNING, logging.INFO,
           logging.DEBUG, logging.DEBUG]


def set_log_level(level: int) -> None:
    """0=FATAL .. 5=VERBOSE (reference numbering)."""
    _logger.setLevel(_LEVELS[max(0, min(level, 5))])


def log() -> logging.Logger:
    return _logger


class Profiler:
    """Name-keyed start/stop microsecond timers (ref TinyProfiler)."""

    def __init__(self):
        self._acc: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)
        self._open: Dict[str, float] = {}

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._open.pop(name)
        self._acc[name] += dt
        self._count[name] += 1
        return dt

    @contextmanager
    def timed(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def summary(self) -> str:
        rows = []
        for name, total in sorted(self._acc.items(), key=lambda kv: -kv[1]):
            n = self._count[name]
            rows.append(f"{name}: {total*1000:.2f} ms total, {n} calls, "
                        f"{total/n*1000:.3f} ms avg")
        return "\n".join(rows)

    def reset(self) -> None:
        self._acc.clear()
        self._count.clear()
        self._open.clear()


_global_profiler = Profiler()


def tprof() -> Profiler:
    """Global profiler singleton (ref tprof())."""
    return _global_profiler


class FpsCounter:
    """Sliding steps/s counter (ref megaverse_test_app FPS windows)."""

    def __init__(self, window_sec: float = 5.0):
        self.window = window_sec
        self._events = []

    def add(self, n: int) -> None:
        self._events.append((time.perf_counter(), n))
        cutoff = time.perf_counter() - self.window
        while self._events and self._events[0][0] < cutoff:
            self._events.pop(0)

    def fps(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        total = sum(n for _, n in self._events[1:])
        return total / dt if dt > 0 else 0.0
