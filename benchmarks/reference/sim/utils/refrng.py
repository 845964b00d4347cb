"""Reference-stream RNG: bit-exact libstdc++ mt19937 + distributions.

The reference engine draws every layout decision from `Rng = std::mt19937`
through three helpers (util/include/util/util.hpp:25-49): `randRange(lo, hi)`
= `std::uniform_int_distribution<int>{lo, hi-1}`, `frand` =
`std::uniform_real_distribution<float>{0,1}`, `randomBool` = randRange(0,2),
plus `std::shuffle`. The seed chain is master -> per-env noise
(bindings/megaverse.cpp:60-69: `noise = randRange(0, 1<<30, rng)`) -> per-
episode reseed (env/src/env.cpp:61-63: `seed = randRange(0, 1<<30, state.rng);
state.rng.seed(seed)`).

This module reproduces those streams bit-exactly against libstdc++ of GCC
>= 11 (verified by golden vectors generated with the in-container g++ 12, see
tests/test_refrng.py and tests/golden/refrng_golden.cpp):

- mt19937: the standard MT19937 engine (seed init, twist, temper).
- uniform_int_distribution: Lemire's nearly-divisionless downscaling
  (uniform_int_dist.h _S_nd — the path taken for 32-bit generators since
  GCC 11; GCC <= 10 used modulo-scaling and produces different streams).
- uniform_real_distribution<float>{0,1}: one 32-bit draw x, result
  float(x) / 2^32 in f32 arithmetic, clamped below 1
  (std::generate_canonical with b=24, k=1).
- std::shuffle: libstdc++'s pair-swap variant — for n with n^2 <= 2^32-1 it
  draws ONE uniform int over swap_range*(swap_range+1) per element PAIR
  (stl_algo.h __gen_two_uniform_ints), not one per element.

Pure Python/numpy: generation-side only (layouts are built on the host; the
device step consumes arrays). ~1M draws/s — episode generation uses a few
hundred draws, so the parity path adds negligible host cost.
"""

from __future__ import annotations

from typing import List, MutableSequence, Sequence

import numpy as np

_U32 = 0xFFFFFFFF


class MT19937:
    """std::mt19937 (32-bit Mersenne Twister, standard parameters)."""

    N = 624
    M = 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int = 5489):
        self.seed(seed)

    def seed(self, s: int) -> None:
        # mt19937::seed: state[0] = s mod 2^32; state[i] =
        # 1812433253 * (state[i-1] ^ (state[i-1] >> 30)) + i.
        mt = np.empty(self.N, np.uint64)
        mt[0] = s & _U32
        for i in range(1, self.N):
            prev = int(mt[i - 1])
            mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & _U32
        self._mt = mt.astype(np.uint32)
        self._idx = self.N

    def _twist(self) -> None:
        # The standard twist updates in place and REUSES already-updated
        # words (mt[i] reads mt[(i+M)%N], which for i >= N-M was overwritten
        # earlier in the same pass; mt[N-1] reads the new mt[0]'s low bits).
        # Split into chunks of N-M so each vector step only reads values that
        # are already final.
        N, M = self.N, self.M
        buf = self._mt.astype(np.uint64)

        def mix(cur, nxt, src):
            y = (cur & self.UPPER) | (nxt & self.LOWER)
            mag = np.where((y & 1).astype(bool), self.MATRIX_A, 0).astype(np.uint64)
            return (src ^ (y >> np.uint64(1)) ^ mag) & _U32

        k = N - M  # 227
        buf[0:k] = mix(buf[0:k], buf[1:k + 1], buf[M:N])
        buf[k:2 * k] = mix(buf[k:2 * k], buf[k + 1:2 * k + 1], buf[0:k])
        buf[2 * k:N - 1] = mix(buf[2 * k:N - 1], buf[2 * k + 1:N], buf[k:k + (N - 1 - 2 * k)])
        buf[N - 1:] = mix(buf[N - 1:], buf[0:1], buf[M - 1:M])
        self._mt = buf.astype(np.uint32)
        self._idx = 0

    def next_u32(self) -> int:
        if self._idx >= self.N:
            self._twist()
        y = int(self._mt[self._idx])
        self._idx += 1
        # temper
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _U32


class Rng(MT19937):
    """`Megaverse::Rng` + the util.hpp helpers, libstdc++-exact."""

    # -- uniform_int_distribution (Lemire _S_nd, uniform_int_dist.h:240-269) --
    def _lemire(self, erange: int) -> int:
        """Unbiased integer in [0, erange) via nearly-divisionless scaling."""
        product = self.next_u32() * erange
        low = product & _U32
        if low < erange:
            threshold = ((1 << 32) - erange) % erange
            while low < threshold:
                product = self.next_u32() * erange
                low = product & _U32
        return product >> 32

    def uniform_int(self, a: int, b: int) -> int:
        """std::uniform_int_distribution{a, b} — CLOSED range [a, b]."""
        urange = b - a
        if urange >= _U32:
            return (self.next_u32() + a) & _U32 if urange == _U32 else 0
        return a + self._lemire(urange + 1)

    # -- util.hpp helpers ----------------------------------------------------
    def rand_range(self, low: int, high: int) -> int:
        """randRange: integer in [low, high) (util.hpp:31-35)."""
        return self.uniform_int(low, high - 1)

    def random_bool(self) -> bool:
        return bool(self.rand_range(0, 2))

    def frand(self) -> float:
        """uniform_real_distribution<float>{0,1}: float(x)/2^32 (f32 math),
        clamped to nextafter(1, 0) (std::generate_canonical, b=24, k=1)."""
        x = np.float32(self.next_u32()) / np.float32(4294967296.0)
        if x >= np.float32(1.0):
            x = np.nextafter(np.float32(1.0), np.float32(0.0))
        return float(x)

    def random_sample(self, container: Sequence):
        """randomSample (util.hpp:51-55)."""
        return container[self.rand_range(0, len(container))]

    # -- std::shuffle (stl_algo.h:3693-3762) ---------------------------------
    def shuffle(self, seq: MutableSequence) -> None:
        """In-place libstdc++ std::shuffle over this mt19937.

        For n*n <= 2^32-1 (every megaverse use), libstdc++ swaps elements in
        PAIRS, drawing one uniform_int over swap_range*(swap_range+1) per
        pair (__gen_two_uniform_ints); an even n does element 1 up front with
        a {0,1} draw."""
        _shuffle_impl(seq, self.uniform_int, _U32)


# ---------------------------------------------------------------------------
# The reference seed chain.
# ---------------------------------------------------------------------------

def ref_spawn_yaw(rng: Rng) -> float:
    """Agent spawn rotation: frand * pi * 2 in f32 arithmetic
    (scenario_default.hpp:86: float * Magnum::Constants::pi() * 2)."""
    return float(np.float32(np.float32(rng.frand()) * np.float32(np.pi))
                 * np.float32(2.0))


def fan_out_env_seeds(master_seed: int, num_envs: int) -> List[int]:
    """Master rng -> per-env seeds (bindings/megaverse.cpp:60-69)."""
    rng = Rng(master_seed)
    return [rng.rand_range(0, 1 << 30) for _ in range(num_envs)]


def episode_reseed(rng: Rng) -> int:
    """Per-episode reseed (env.cpp:61-63): draw then reseed in place."""
    seed = rng.rand_range(0, 1 << 30)
    rng.seed(seed)
    return seed


def _shuffle_impl(seq: MutableSequence, uniform_int, urngrange: int) -> None:
    """libstdc++ std::shuffle element-move sequence, generator-agnostic:
    `uniform_int(a, b)` must replicate std::uniform_int_distribution over the
    target engine; `urngrange` selects the paired-draw fast path exactly as
    stl_algo.h does (__urngrange / n >= n)."""
    n = len(seq)
    if n <= 1:
        return
    if urngrange // n >= n:
        i = 1
        if n % 2 == 0:
            j = uniform_int(0, 1)
            seq[i], seq[j] = seq[j], seq[i]
            i += 1
        while i < n:
            swap_range = i + 1
            b0, b1 = swap_range, swap_range + 1
            x = uniform_int(0, b0 * b1 - 1)
            p0, p1 = x // b1, x % b1
            seq[i], seq[p0] = seq[p0], seq[i]
            i += 1
            seq[i], seq[p1] = seq[p1], seq[i]
            i += 1
    else:  # pragma: no cover — n > 65535 never occurs in megaverse
        for i in range(1, n):
            j = uniform_int(0, i)
            seq[i], seq[j] = seq[j], seq[i]


class MinstdRand0:
    """std::minstd_rand0 — libstdc++'s std::default_random_engine, used by
    siv::PerlinNoise::reseed (util/perlin_noise.hpp:118-126). Schrage-free
    form: x' = 16807 * x mod (2^31 - 1); a zero seed maps to 1."""

    M = 2147483647
    MIN, MAX = 1, 2147483646

    def __init__(self, seed: int = 1):
        s = seed % self.M
        self._x = s if s else 1

    def next(self) -> int:
        self._x = (16807 * self._x) % self.M
        return self._x

    # std::uniform_int_distribution over a NON-full-width engine takes the
    # scaling-rejection branch of uniform_int_dist.h (the Lemire multiply
    # path requires a full-width engine like mt19937).
    def uniform_int(self, a: int, b: int) -> int:
        urngrange = self.MAX - self.MIN
        urange = b - a
        assert urngrange > urange, "downscaling branch only"
        uerange = urange + 1
        scaling = urngrange // uerange
        past = uerange * scaling
        while True:
            r = self.next() - self.MIN
            if r < past:
                return a + r // scaling

    def shuffle(self, seq: MutableSequence) -> None:
        _shuffle_impl(seq, self.uniform_int, self.MAX - self.MIN)
