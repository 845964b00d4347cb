"""Frozen plain copy of the sim: layouts, env step, table renderer (numpy
and plain torch only; no native library, no CUDA kernel)."""
