"""chunk_ms_p95: the 95th percentile (nearest rank) of the window's chunk
times, each from the `step_many` call to the read of its checksum, in ms:
the stall a learner that waits on rollouts feels (refills that stop
overlapping, re-captures, host waits). The chunks that ran under the
profiler are left out."""

import harness as H


def read(result):
    c = result.get("counters")
    if not c or not c.get("chunk_ms"):
        return None
    skip = set(c.get("profiled_chunks", ()))
    times = [t for i, t in enumerate(c["chunk_ms"]) if i not in skip]
    return H.percentile(times, 95) if times else None
