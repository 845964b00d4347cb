"""render_ms_per_step: the render kernel's device time per env step in the
traced chunks, in ms."""


def read(result):
    tr = result.get("trace")
    if tr is None:
        return None
    match = lambda name: "render_kernel" in name
    if not tr.kernel_count(match):
        return None
    return 1e3 * tr.kernel_seconds(match) / result["trace_steps"]
