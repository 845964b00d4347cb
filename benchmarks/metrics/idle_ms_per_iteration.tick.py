"""idle_ms_per_iteration.tick: device-idle ms in the traced iteration (rank 0)
while the innermost open program span was `megaverse.tick`, the env tick
(action copy and graph replay); stretches under the profiler's own ranges
left out (spans.py)."""

import spans


def read(result):
    return spans.idle_ms_per_iteration(result, "megaverse.tick")
