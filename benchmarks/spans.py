"""What the per-layer readers take from the program's own marks in a traced
stretch (`harness.TraceSummary`): the stages of the captured tick, cut by the
program's marker kernels, and the device's idle time, given to the program's
innermost open span.

The tick (`megaverse_tpu_torch.capture.tick`) launches `megaverse_mark_tick`
at its start, `megaverse_mark_reset` after the write-back (the deferred reset
begins) and `megaverse_mark_cull` before the render's cull prologue; the
render kernel ends it. The program's spans are host ranges named
"megaverse.*" (`megaverse_tpu_torch.utils.logging.span`), which a
torch.profiler records on the clock of the device trace. A program without
the marks or the spans (an older commit) gives None here, never an error.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Sequence, Tuple

MARK_PREFIX = "megaverse_mark_"
SPAN_PREFIX = "megaverse."
RENDER = "render_kernel"
# the tick's stages, each opened by its marker kernel, in order
STAGES = ("tick", "reset", "cull")
NEXT = {None: "tick", "tick": "reset", "reset": "cull"}   # the marker each stage awaits
# the profiler's own host ranges (CUPTI's buffer requests and flushes), in
# any spelling: their stretches of idle are the tracer's, not the program's
PROFILER_RANGES = ("activity_buffer_request", "buffer_flush")
PROFILER = "profiler"
OUTSIDE = "outside"


def _is_profiler_range(name: str) -> bool:
    key = re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")
    return any(p in key for p in PROFILER_RANGES)


def tick_stages(trace) -> Optional[Tuple[Dict[str, float], int]]:
    """({stage: device seconds}, ticks) over the stretch: for each tick the
    kernels after its stage's marker and before the next marker (the render
    kernel after "cull"), the markers left out. None unless there is at
    least one tick and every tick shows the three markers in order, closed
    by a render kernel."""
    sums = {s: 0.0 for s in STAGES}
    stage, ticks = None, 0
    for name, s, e in sorted(trace.kernels, key=lambda k: k[1]):
        if name.startswith(MARK_PREFIX):
            which = name[len(MARK_PREFIX):]
            if NEXT.get(stage) != which:
                return None
            stage = which
        elif RENDER in name:          # ends the tick (a render outside one is no tick's)
            if stage not in (None, STAGES[-1]):
                return None
            ticks += stage is not None
            stage = None
        elif stage is not None:
            sums[stage] += e - s
    if stage is not None or ticks == 0:
        return None
    return sums, ticks


class _Busy:
    """The union of the kernels' intervals, for the busy seconds inside any
    stretch."""

    def __init__(self, kernels: Sequence[Tuple[float, float]]):
        self.starts: List[float] = []
        self.ends: List[float] = []
        for s, e in sorted(kernels):
            if self.ends and s <= self.ends[-1]:
                self.ends[-1] = max(self.ends[-1], e)
            else:
                self.starts.append(s)
                self.ends.append(e)
        self.cum = [0.0]
        for s, e in zip(self.starts, self.ends):
            self.cum.append(self.cum[-1] + e - s)

    def _upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        return self.cum[i - 1] + min(t, self.ends[i - 1]) - self.starts[i - 1]

    def within(self, a: float, b: float) -> float:
        return self._upto(b) - self._upto(a)


def idle_by_span(trace) -> Dict[str, float]:
    """The stretch's device-idle seconds by where the host was: each idle
    instant goes to PROFILER where one of the profiler's own ranges is open,
    else to the innermost open program span (the shortest "megaverse.*"
    range holding it), else to OUTSIDE. The parts add up to the stretch's
    idle time."""
    lo, hi = trace.window
    busy = _Busy([(s, e) for _, s, e in trace.kernels])
    spans = [(max(s, lo), min(e, hi), n) for s, e, n in trace.labels
             if n.startswith(SPAN_PREFIX) and e > lo and s < hi]
    tracer = [(max(s, lo), min(e, hi)) for s, e, n in trace.labels
              if _is_profiler_range(n) and e > lo and s < hi]
    cuts = sorted({lo, hi, *(t for s, e, _ in spans for t in (s, e)),
                   *(t for s, e in tracer for t in (s, e))})
    out: Dict[str, float] = {}
    for a, b in zip(cuts, cuts[1:]):
        idle = (b - a) - busy.within(a, b)
        if idle <= 0:
            continue
        mid = 0.5 * (a + b)
        if any(s <= mid <= e for s, e in tracer):
            key = PROFILER
        else:
            inner = [(e - s, n) for s, e, n in spans if s <= mid <= e]
            key = min(inner)[1] if inner else OUTSIDE
        out[key] = out.get(key, 0.0) + idle
    return out


def idle_ms_per_iteration(result, span: str) -> Optional[float]:
    """Device-idle ms per traced iteration while `span` was the innermost
    open program span (the profiler's own stretches left out); None where
    the trace holds no such span."""
    tr = result.get("trace")
    n = result.get("trace_iterations")
    if tr is None or not n or not tr.kernel_count():
        return None
    if not any(name == span for _, _, name in tr.labels):
        return None
    return 1e3 * idle_by_span(tr).get(span, 0.0) / n


def stage_ms_per_step(result, stage: str) -> Optional[float]:
    """Device ms per traced step of the kernels of one stage of the tick;
    None unless every traced step's tick shows its three markers in order."""
    tr = result.get("trace")
    steps = result.get("trace_steps")
    if tr is None or not steps:
        return None
    got = tick_stages(tr)
    if got is None or got[1] != steps:
        return None
    return 1e3 * got[0][stage] / steps
