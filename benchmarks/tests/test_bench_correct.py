"""What decides `correct` on the CPU at a small size: a sound run of every
cell passes; the lower-precision control and every fault a cell can have
fail it. The run goes through the harness as on the card (the driver, the
program's timed path, the reference after the window), with only the chip
check skipped."""

import pytest

import harness as H
from bench_helpers import run_small

SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("name, ranks", [("sampler.collect_1024x1", 1),
                                         ("sampler.collect_1024x1", 2),
                                         ("appo.collect_1024x1", 1)])
def test_sound_run_is_correct(name, ranks):
    res = run_small(name, SEED, ranks=ranks)
    assert H.is_correct(res["checks"]), res["checks"]
    # a reset was among what was compared
    assert res["checks"]["resets_unchecked"][0] == 0


@pytest.mark.parametrize("name", ["sampler.collect_1024x1", "appo.collect_1024x1"])
def test_control_is_not_correct(name):
    res = run_small(name, SEED + 1, control=True)
    assert not H.is_correct(res["checks"]), res["checks"]


@pytest.mark.parametrize("name, fault, ranks", [
    ("sampler.collect_1024x1", "state_unchanged", 0),
    ("sampler.collect_1024x1", "half_batch", 0),
    ("sampler.collect_1024x1", "answer_altered", 0),
    ("appo.collect_1024x1", "state_unchanged", 0),
    ("appo.collect_1024x1", "half_batch", 0),
    ("appo.collect_1024x1", "answer_altered", 0),
    ("appo.collect_1024x1", "exchange_left_out", 2),
    ("sampler.collect_1024x1", "reset_skipped", 0),
    ("appo.collect_1024x1", "reset_skipped", 0),
])
def test_fault_is_not_correct(name, fault, ranks):
    res = run_small(name, SEED + 2, fault=fault, ranks=ranks)
    assert not H.is_correct(res["checks"]), res["checks"]
