"""Bit-exact siv::PerlinNoise (double) replica for reference-stream layouts.

The Collect scenario's terrain heights come from
`siv::PerlinNoise(seed).accumulatedOctaveNoise2D_0_1(x/fx, z/fz, octaves)`
(scenario_collect.cpp:62-86, util/perlin_noise.hpp). Heights are ROUNDED
(lround) and thresholded, so layout parity needs the noise bit-exact in
float64: the permutation table is shuffled with std::default_random_engine
(= minstd_rand0) via std::shuffle (perlin_noise.hpp:118-126,
utils/refrng.MinstdRand0), and noise3D's fade/grad/lerp tree is mirrored
operation-for-operation (perlin_noise.hpp:169-194; x86-64 baseline has no
FMA contraction, so numpy float64 reproduces the C++ arithmetic exactly).
Golden: tests/golden/refperlin_golden.cpp.
"""

from __future__ import annotations

import numpy as np

from reference.sim.utils.refrng import MinstdRand0


class SivPerlin:
    def __init__(self, seed: int):
        g = MinstdRand0(seed)
        p = list(range(256))
        g.shuffle(p)
        self.p = np.asarray(p + p, np.int64)

    @staticmethod
    def _fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    @staticmethod
    def _grad(h, x, y, z):
        # Grad (perlin_noise.hpp:72-78): h = hash & 15;
        # u = h<8 ? x : y;  v = h<4 ? y : (h==12||h==14 ? x : z)
        h = h & 15
        u = np.where(h < 8, x, y)
        v = np.where(h < 4, y, np.where((h == 12) | (h == 14), x, z))
        return np.where(h & 1, -u, u) + np.where(h & 2, -v, v)

    def noise3d(self, x, y, z):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        z = np.asarray(z, np.float64)
        X = np.floor(x).astype(np.int64) & 255
        Y = np.floor(y).astype(np.int64) & 255
        Z = np.floor(z).astype(np.int64) & 255
        x = x - np.floor(x)
        y = y - np.floor(y)
        z = z - np.floor(z)
        u = self._fade(x)
        v = self._fade(y)
        w = self._fade(z)
        p = self.p
        A = p[X] + Y
        AA = p[A] + Z
        AB = p[A + 1] + Z
        B = p[X + 1] + Y
        BA = p[B] + Z
        BB = p[B + 1] + Z

        lerp = lambda t, a, b: a + t * (b - a)
        g = self._grad
        return lerp(w, lerp(v, lerp(u, g(p[AA], x, y, z),
                                    g(p[BA], x - 1, y, z)),
                            lerp(u, g(p[AB], x, y - 1, z),
                                 g(p[BB], x - 1, y - 1, z))),
                    lerp(v, lerp(u, g(p[AA + 1], x, y, z - 1),
                                 g(p[BA + 1], x - 1, y, z - 1)),
                         lerp(u, g(p[AB + 1], x, y - 1, z - 1),
                              g(p[BB + 1], x - 1, y - 1, z - 1))))

    def noise2d(self, x, y):
        return self.noise3d(x, y, np.float64(0.0))

    def accumulated_octave_2d_0_1(self, x, y, octaves: int):
        """accumulatedOctaveNoise2D_0_1 (perlin_noise.hpp:240-256, 314-319):
        unnormalized octave sum, then clamp(r*0.5 + 0.5, 0, 1)."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        result = np.zeros(np.broadcast(x, y).shape, np.float64)
        amp = np.float64(1.0)
        for _ in range(int(octaves)):
            result = result + self.noise2d(x, y) * amp
            x = x * 2
            y = y * 2
            amp = amp / 2
        return np.clip(result * 0.5 + 0.5, 0.0, 1.0)
