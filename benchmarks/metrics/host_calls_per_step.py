"""host_calls_per_step: the host's launch calls (cudaGraphLaunch,
cudaLaunchKernel, copies, fills) per env step in the traced chunks, from the
profiler's CPU events."""


def read(result):
    tr = result.get("trace")
    if tr is None or not tr.kernel_count():
        return None
    return tr.host_call_count() / result["trace_steps"]
