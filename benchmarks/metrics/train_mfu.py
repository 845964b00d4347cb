"""train_mfu: the model FLOPs that the window's completed iterations needed
(counted from the configuration's shapes by `reference.flops`: the policy's
forward in the rollout, forward and backward in the update) over the
window's seconds x chips x the bf16 dense peak, in %. The iterations that
ran under the profiler, and their seconds, are left out."""

import harness as H
from reference import flops


def read(result):
    c = result.get("counters")
    if not c or not c.get("unprofiled_samples"):
        return None
    need = flops.train_flops(result["config"], c["unprofiled_samples"])
    return 100.0 * need / (c["unprofiled_window_s"] * c["chips"] * H.BF16_FLOP_PER_S)
