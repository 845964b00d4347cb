"""rollout_ms: mean device-clock milliseconds of `Learner.collect_rollout`
per iteration of the window (CUDA events around the call, rank 0)."""


def read(result):
    ms = result.get("rollout_ms")
    return sum(ms) / len(ms) if ms else None
