"""device_idle_share.sample: the share, in %, of the traced chunks' wall time
(from the first chunk's call to the read of the last checksum) in which no
operation ran on the device."""

import harness as H


def read(result):
    tr = result.get("trace")
    if tr is None or not tr.kernel_count() or "trace_chunks" not in result:
        return None
    return H.idle_share(tr.busy_s, tr.window_s)
