"""render_roofline: the render kernel's share, in %, of the least time the
card could take for the frames of the traced window's last tick.

Least time = max(bytes / HBM peak, f32 operations / f32 peak), counted by
`reference.roofline` from the scene as the reference describes it (never the
kernel's own visit counter or the program's padded tables); kernel time =
the render kernel's device time per launch in the traced chunks."""

import harness as H
from reference import roofline


def read(result):
    tr, scene = result.get("trace"), result.get("scene")
    if tr is None or scene is None:
        return None
    match = lambda name: "render_kernel" in name
    launches = tr.kernel_count(match)
    if not launches:
        return None
    per_launch = tr.kernel_seconds(match) / launches
    least = roofline.least_seconds(result["traffic"]["scenario"],
                                   result["traffic"]["num_agents_per_env"], scene,
                                   H.HBM_BYTES_PER_S, H.F32_FLOP_PER_S)
    return 100.0 * least / per_launch
