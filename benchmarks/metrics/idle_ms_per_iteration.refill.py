"""idle_ms_per_iteration.refill: device-idle ms in the traced iteration (rank
0) while the innermost open program span was `megaverse.refill` or one of
its parts (`.poll`, `.wait`, `.upload`): the trainer's layout refill;
stretches under the profiler's own ranges left out (spans.py). None where
the trace holds no refill span."""

import spans

REFILL = "megaverse.refill"


def read(result):
    tr = result.get("trace")
    n = result.get("trace_iterations")
    if tr is None or not n or not tr.kernel_count():
        return None
    if not any(name == REFILL or name.startswith(REFILL + ".") for _, _, name in tr.labels):
        return None
    idle = spans.idle_by_span(tr)
    return 1e3 * sum(v for k, v in idle.items()
                     if k == REFILL or k.startswith(REFILL + ".")) / n
