"""Test settings of the benchmark's own tests (`python -m pytest
benchmarks/tests -q`): the benchmark's folder on the import path, and the
`card` marker of tests that need an NVIDIA GPU (each decides inside the test
whether one is there, and skips where none is)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.append(ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
