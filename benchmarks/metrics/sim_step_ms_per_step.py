"""sim_step_ms_per_step: device ms per env step in the traced chunks of the
captured tick's sim step (`env.env_step` and the write-back): the kernels
between the program's markers `megaverse_mark_tick` and
`megaverse_mark_reset`, the markers left out (spans.py)."""

import spans


def read(result):
    return spans.stage_ms_per_step(result, "tick")
