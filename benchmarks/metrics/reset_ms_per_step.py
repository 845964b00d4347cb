"""reset_ms_per_step: device ms per env step in the traced chunks of the
captured tick's deferred reset (the masked copy and `pending |= done`): the
kernels between the program's markers `megaverse_mark_reset` and
`megaverse_mark_cull`, the markers left out (spans.py)."""

import spans


def read(result):
    return spans.stage_ms_per_step(result, "reset")
