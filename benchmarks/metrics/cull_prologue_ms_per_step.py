"""cull_prologue_ms_per_step: device ms per env step in the traced chunks of
the render's cull prologue (`env.render_tables`): the kernels between the
program's marker `megaverse_mark_cull` and the render kernel (spans.py)."""

import spans


def read(result):
    return spans.stage_ms_per_step(result, "cull")
