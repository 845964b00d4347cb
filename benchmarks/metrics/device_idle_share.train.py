"""device_idle_share.train: the share, in %, of the traced iterations' wall
time (rollout, update and refill; rank 0) in which no operation ran on the
device."""

import harness as H


def read(result):
    tr = result.get("trace")
    if tr is None or not tr.kernel_count() or "trace_iterations" not in result:
        return None
    return H.idle_share(tr.busy_s, tr.window_s)
