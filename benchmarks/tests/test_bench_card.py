"""On the card, at the cells' own sizes: the sound program passes and the
lower-precision control fails (`python -m pytest benchmarks/tests -m card`
on a machine with an NVIDIA GPU; skips elsewhere)."""

import pytest
import torch

import harness as H
import run as R

SEED = 2 ** 31 + 4242


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("name", ["sampler.collect_1024x1", "appo.collect_1024x1"])
def test_control_fails_at_full_size(name):
    _card()
    cell = H.Cell(H.load_benchmark(), name)
    # the window reaches the checked chunk or iteration in which episodes end
    assert H.is_correct(R.run_cell(cell, SEED, 25.0, 0)["checks"])
    assert not H.is_correct(R.run_cell(cell, SEED, 25.0, 0, control=True)["checks"])
