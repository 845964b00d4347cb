"""refill_host_ms_per_chunk: host milliseconds per chunk that the program's
counter `VectorEnv.layout_seconds` charged to waiting for layouts, stacking
them and starting their upload, over the whole window."""


def read(result):
    c = result.get("counters")
    if not c or not c.get("chunks"):
        return None
    return 1e3 * c["layout_seconds"] / c["chunks"]
