"""2D Perlin gradient noise with octave accumulation (vectorized numpy).

Functional equivalent of the vendored siv::PerlinNoise used by the Collect
scenario's landscape generator (util/include/util/perlin_noise.hpp;
scenario_collect.cpp:62-77: accumulatedOctaveNoise2D_0_1 with randomized
frequency/octaves/seed). Classic Ken Perlin improved noise: shuffled 256-entry
permutation table, quintic fade, gradient dot products.
"""

from __future__ import annotations

import numpy as np


class PerlinNoise2D:
    def __init__(self, seed: int):
        rng = np.random.Generator(np.random.PCG64(seed))
        p = np.arange(256, dtype=np.int64)
        rng.shuffle(p)
        self._perm = np.concatenate([p, p])

    @staticmethod
    def _fade(t):
        return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)

    @staticmethod
    def _grad(h, x, y):
        # 8 gradient directions from the low hash bits.
        h = h & 7
        u = np.where(h < 4, x, y)
        v = np.where(h < 4, y, x)
        return np.where(h & 1, -u, u) + 2.0 * np.where(h & 2, -v, v)

    def noise(self, x, y):
        """Raw noise in ~[-1, 1]; x/y arrays broadcast."""
        xi = np.floor(x).astype(np.int64) & 255
        yi = np.floor(y).astype(np.int64) & 255
        xf = x - np.floor(x)
        yf = y - np.floor(y)
        u = self._fade(xf)
        v = self._fade(yf)
        p = self._perm
        aa = p[p[xi] + yi]
        ab = p[p[xi] + yi + 1]
        ba = p[p[xi + 1] + yi]
        bb = p[p[xi + 1] + yi + 1]
        x1 = self._grad(aa, xf, yf) + u * (self._grad(ba, xf - 1, yf) - self._grad(aa, xf, yf))
        x2 = self._grad(ab, xf, yf - 1) + u * (
            self._grad(bb, xf - 1, yf - 1) - self._grad(ab, xf, yf - 1)
        )
        return (x1 + v * (x2 - x1)) / 2.0

    def octave_noise_0_1(self, x, y, octaves: int):
        """Accumulated octave noise mapped to [0, 1]
        (siv accumulatedOctaveNoise2D_0_1 semantics); numpy alone."""
        shape = np.broadcast(x, y).shape
        total = np.zeros(shape)
        amp = 1.0
        fx, fy = np.asarray(x, float), np.asarray(y, float)
        for _ in range(max(1, int(octaves))):
            total = total + self.noise(fx, fy) * amp
            fx = fx * 2.0
            fy = fy * 2.0
            amp *= 0.5
        return np.clip(total * 0.5 + 0.5, 0.0, 1.0)
