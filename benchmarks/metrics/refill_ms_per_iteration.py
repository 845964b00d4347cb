"""refill_ms_per_iteration: host milliseconds per traced iteration (rank 0)
inside the program's outermost `megaverse.refill` span: the trainer's layout
refill after the update (`rl/train._Task.refill`: the poll of the envs that
reset, which waits for the device to drain, the wait for the layouts made
on its thread, their upload). Read from the profiler's host ranges; None
where the trace holds no such span."""

REFILL = "megaverse.refill"


def read(result):
    tr = result.get("trace")
    n = result.get("trace_iterations")
    if tr is None or not n:
        return None
    lo, hi = tr.window
    spans = sorted((max(s, lo), min(e, hi)) for s, e, name in tr.labels
                   if name == REFILL and e > lo and s < hi)
    if not spans:
        return None
    total, end = 0.0, lo
    for s, e in spans:         # a span inside another counts once
        if e > end:
            total += e - max(s, end)
            end = e
    return 1e3 * total / n
