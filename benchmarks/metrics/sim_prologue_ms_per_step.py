"""sim_prologue_ms_per_step: device time of every operation but the render
kernel per env step in the traced chunks, in ms: the sim step, the deferred
reset's masked copy and the render's cull prologue."""


def read(result):
    tr = result.get("trace")
    if tr is None or not tr.kernel_count():
        return None
    other = tr.kernel_seconds(lambda name: "render_kernel" not in name)
    return 1e3 * other / result["trace_steps"]
