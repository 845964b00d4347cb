"""allreduce_ms: device time of NCCL's kernels per update in rank 0's traced
iterations, in ms."""


def read(result):
    tr = result.get("trace")
    if tr is None or not result.get("trace_iterations"):
        return None
    match = lambda name: "nccl" in name.lower()
    if not tr.kernel_count(match):
        return None
    return 1e3 * tr.kernel_seconds(match) / result["trace_iterations"]
