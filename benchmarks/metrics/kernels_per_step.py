"""kernels_per_step: device kernels (and device copies and fills) per env
step in the traced chunks."""


def read(result):
    tr = result.get("trace")
    if tr is None or not tr.kernel_count():
        return None
    return tr.kernel_count() / result["trace_steps"]
