"""Logging, spans and timers.

Equivalents of the reference util layer: TinyLogger leveled stream macros
(util/tiny_logger.hpp:13-68, settable from Python via set_megaverse_log_level,
megaverse.cpp:29-32) and TinyProfiler named timers (util/tiny_profiler.hpp:9-41),
under the logger name "megaverse_tpu_torch".

`span(name)` is the program's one tracing primitive: every layer boundary of
the port opens one (names start with "megaverse."). It adds its host seconds
and a call count to `tprof()`; while a `torch.profiler` records, it also
opens a `record_function` range of the same name, so the span lands in the
profiler's trace beside the kernels, on the same clock, nested in its parent
span by time. Spans open only on the thread that drives the device.
`IntervalTimer` times stretches of the device's stream with CUDA events (the
host clock on the CPU) without synchronising.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

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
    """Name-keyed timers (ref TinyProfiler): host seconds and calls by name."""

    def __init__(self):
        self._acc: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    def span(self, name: str) -> "_Span":
        """A context manager adding its body's host seconds and one call to
        `name` (re-entrant); a `record_function` range of the same name while
        a torch.profiler records."""
        return _Span(self, name)

    def totals(self, since: Optional[Dict[str, Tuple[float, int]]] = None
               ) -> Dict[str, Tuple[float, int]]:
        """{name: (host seconds, calls)}: all so far, or those added after
        `since`, an earlier `totals()` (names with no call since left out)."""
        since = since or {}
        out = {}
        for name, total in self._acc.items():
            s0, n0 = since.get(name, (0.0, 0))
            if self._count[name] > n0:
                out[name] = (total - s0, self._count[name] - n0)
        return out

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


_global_profiler = Profiler()


def tprof() -> Profiler:
    """Global profiler singleton (ref tprof())."""
    return _global_profiler


def span(name: str) -> "_Span":
    """`tprof().span(name)`: the span of one layer boundary of the port."""
    return _global_profiler.span(name)


class _Span:
    """`Profiler.span`'s context manager. With no profiler recording it costs
    one bool read, two clock reads and a dict add."""

    __slots__ = ("_prof", "_name", "_t0", "_range")

    def __init__(self, prof: Profiler, name: str):
        self._prof = prof
        self._name = name
        self._range = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._prof._acc[self._name] += dt
        self._prof._count[self._name] += 1
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


class IntervalTimer:
    """Milliseconds of named stretches of the device's stream: CUDA events
    on a CUDA device, read only by `read` (which waits for the last event
    recorded), the host clock on the CPU. Nothing here synchronises."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._pending: List[tuple] = []
        self.ms: Dict[str, List[float]] = defaultdict(list)

    def stamp(self):
        """A point on the stream (an event recorded on the current stream),
        or on the host clock."""
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def add(self, name: str, start, end) -> None:
        self._pending.append((name, start, end))

    def read(self) -> Dict[str, List[float]]:
        """Every stretch added so far, in ms by name, in order of adding."""
        if self.cuda and self._pending:
            self._pending[-1][2].synchronize()
        for name, a, b in self._pending:
            self.ms[name].append(a.elapsed_time(b) if self.cuda else 1e3 * (b - a))
        self._pending.clear()
        return self.ms
