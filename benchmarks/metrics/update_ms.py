"""update_ms: mean device-clock milliseconds of the PPO update
(`_update_from_batch`) per iteration of the window (CUDA events around the
call, rank 0)."""


def read(result):
    ms = result.get("update_ms")
    return sum(ms) / len(ms) if ms else None
