"""The native host-generation paths of the port (utils/native.py) against its
numpy paths and against the JAX package, on the CPU.

`scenarios/base.py::greedy_merge_boxes` merges voxels into boxes through the
C++ library (`native.greedy_merge`) and Collect's terrain noise comes from
`native.perlin_octave_0_1`; both fall back to numpy when the library is
missing or MEGAVERSE_NO_NATIVE is set, as in the reference. Every scenario's
layouts must be EQUAL leaf for leaf with and without the library, and equal
to the JAX package's `generate` (which loads the library too). The noise
itself is float64 in both paths and may differ in the last place (a
different summation order in C++); a layout differing because a voxel's
height flipped at a rounding threshold would fail here and belongs in
ROADMAP.md section C.
"""

import numpy as np
import pytest

from megaverse_tpu.scenarios import make_scenario as j_make_scenario

from megaverse_tpu_torch.scenarios import make_scenario as t_make_scenario
from megaverse_tpu_torch.scenarios import registered_scenarios
from megaverse_tpu_torch.utils import native
from megaverse_tpu_torch.utils.perlin import PerlinNoise2D

import torch_port_checks as K


def _numpy_paths(monkeypatch):
    """The two entry points behave as without the library (what
    MEGAVERSE_NO_NATIVE gives them); the hex scenes keep the native portal
    search, which tests/test_torch_pvs.py holds against its numpy twin."""
    monkeypatch.setattr(native, "greedy_merge", lambda *a, **k: None)
    monkeypatch.setattr(native, "perlin_octave_0_1", lambda *a, **k: None)


def _layouts(sc, seeds):
    return [K.convert.tree_to_numpy(sc.generate_checked(np.random.default_rng(s)))
            for s in seeds]


@pytest.mark.parametrize("name", registered_scenarios())
def test_layouts_equal_with_and_without_the_library(name, monkeypatch):
    assert native.have_native()   # else both paths below are the numpy ones
    agents = 2
    seeds = range(8) if name == "collect" else range(2)
    tsc = t_make_scenario(name, num_agents=agents)
    with_lib = _layouts(tsc, seeds)
    jax_lib = _layouts(j_make_scenario(name, num_agents=agents), seeds)
    _numpy_paths(monkeypatch)
    without = _layouts(tsc, seeds)
    for a, b, j in zip(with_lib, without, jax_lib):
        K.assert_trees_equal(a, b)
        K.assert_trees_equal(a, j)


def test_no_native_variable_selects_the_numpy_paths(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("MEGAVERSE_NO_NATIVE", "1")
    assert native.greedy_merge(np.zeros((2, 2, 2), np.uint8), np.zeros((2, 2, 2), np.uint8)) is None
    assert native.perlin_octave_0_1(np.arange(512), np.zeros(3), np.zeros(3), 2) is None


def test_octave_noise_native_matches_numpy(monkeypatch):
    """Collect's noise grid (scenarios/collect.py) from both paths: float64,
    within a few ulps of [0, 1]."""
    gx, gz = np.meshgrid(np.arange(1, 79), np.arange(1, 79), indexing="ij")
    outs = []
    for use_lib in (True, False):
        if not use_lib:
            _numpy_paths(monkeypatch)
        outs.append([PerlinNoise2D(s * 7919).octave_noise_0_1(gx / 3.7, gz / 5.1, s % 9 + 1)
                     for s in range(6)])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape == gx.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
