"""The comparisons that decide a run's `correct`, and their limits.

Every number here compares what the program's timed path produced with the
plain reference (`reference/`); nothing imports the program. States are
dataclasses of tensors in both (the reference keeps the port's field names),
so leaves are matched by their path of field names.

The limits are set in `LIMITS` from readings on the card (PERF.md gives, for
each, the sound runs' largest reading over a dozen seeds or more, the
control's smallest, and the limit between them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

# name -> limit, each set between the sound program's largest reading over
# a dozen seeds or more and the smallest that the lower-precision control
# (and, for the training cells, a planted fault) gives, on the card at the
# cells' own sizes; PERF.md gives the readings. Exact comparisons have the
# limit 0.
LIMITS = {
    # (env, leaf) pairs of the sampled envs' layouts that differ from the
    # reference's, at reset and after the window's refills
    "layout_mismatch": 0.0,
    # widest gap |program - reference| over every leaf of the sampled envs'
    # states after each checked chunk or rollout, the done flags included
    "state_gap": 0.35,
    # share of the sampled frames' pixels off by more than one level in a
    # channel
    "frame_px_off": 0.04,
    # APPO: widest gap of the rollout's stored log-probabilities and values
    # from the reference policy's on the same observations, relative to the
    # reference's largest value
    "policy_gap": 4.5e-5,
    # APPO: worst step's |loss gap| / max(|reference loss|, 1e-3)
    "loss_gap": 1.2e-4,
    # APPO: worst leaf's |norm gap| of a clipped gradient (the first
    # update's, and the checked window iteration's), over max(the leaf's
    # reference norm, the median leaf's)
    "grad_gap": 4.5e-4,
    # APPO: the same of the parameters' change over the first three updates
    "change3_gap": 7e-4,
    # APPO on several ranks: widest gap of a rank's parameters from rank 0's
    "rank_param_gap": 0.0,
    # 1 where no checked env finished within a checked stretch, so that the
    # deferred reset went unchecked; else 0
    "resets_unchecked": 0.0,
}


# ------------------------------------------------------------------ trees
def leaves(tree, prefix: str = "") -> Dict[str, object]:
    """{path: leaf} of a dataclass tree of tensors or arrays."""
    if tree is None or (isinstance(tree, tuple) and not tree):
        return {}
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(leaves(getattr(tree, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix.rstrip("."): tree}


def rebuild(template, values: Dict[str, object], prefix: str = ""):
    """A tree shaped like `template` whose leaves are `values[path]`."""
    if template is None or (isinstance(template, tuple) and not template):
        return template
    if dataclasses.is_dataclass(template):
        return type(template)(**{f.name: rebuild(getattr(template, f.name), values,
                                                 f"{prefix}{f.name}.")
                                 for f in dataclasses.fields(template)})
    return values[prefix.rstrip(".")]


def gather(tree, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Copies of the rows `idx` (a device index tensor) of every leaf, queued
    on the current stream."""
    return {k: v.index_select(0, idx) for k, v in leaves(tree).items()}


def to_host(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in d.items()}


# ------------------------------------------------------------ comparisons
def mismatches(a: Dict[str, object], b: Dict[str, object]) -> int:
    """Number of (env, leaf) pairs that differ anywhere: rows of one leaf
    compared env by env; a leaf missing on one side counts each env."""
    n = 0
    for k in set(a) | set(b):
        if k not in a or k not in b:
            n += len(a.get(k, b.get(k)))
            continue
        x, y = torch.as_tensor(np.asarray(a[k])), torch.as_tensor(np.asarray(b[k]))
        if x.shape != y.shape:
            n += x.shape[0] if x.dim() else 1
            continue
        if x.dim() == 0:
            n += int(not torch.equal(x, y))
            continue
        n += int((x.reshape(x.shape[0], -1) != y.reshape(y.shape[0], -1)).any(dim=1).sum())
    return n


def tree_gap(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    """Widest |a - b| over the leaves both hold (in float64; booleans as 0/1;
    a missing leaf or a shape that differs reads +inf)."""
    worst = 0.0
    for k in set(a) | set(b):
        if k not in a or k not in b or a[k].shape != b[k].shape:
            return float("inf")
        x, y = a[k].to(torch.float64), b[k].to(torch.float64)
        if x.numel():
            d = (x - y).abs()
            if bool(torch.isnan(d).any()):
                return float("inf")
            worst = max(worst, float(d.max()))
    return worst


def lower(x):
    """The lower-precision control's rounding: a float32 tensor or array
    rounded to bfloat16 (and held in float32); anything else as it is."""
    if torch.is_tensor(x) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    if isinstance(x, np.ndarray) and x.dtype == np.float32:
        return lower(torch.from_numpy(x)).numpy()
    return x


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """Packed int32 frames [..., H, W] -> int16 channels [..., H, W, 3]."""
    p = packed.to(torch.int32)
    return torch.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], dim=-1).to(torch.int16)


def frame_px_off(prog: torch.Tensor, ref: torch.Tensor, levels: int = 1) -> float:
    """Share of pixels with a channel more than `levels` apart (frames that
    differ in shape read 1)."""
    if prog.shape != ref.shape:
        return 1.0
    d = (unpack(prog) - unpack(ref)).abs().amax(dim=-1)
    return float((d > levels).to(torch.float64).mean())


def leaf_norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  keep: Iterable[str]) -> float:
    """Worst leaf of `keep`: |norm(prog) - norm(ref)| over max(norm(ref),
    the median leaf's reference norm)."""
    keep = list(keep)
    if not keep:
        return float("inf")
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keep}
    median = float(np.median(list(norms.values())))
    worst = 0.0
    for k in keep:
        p = float(torch.linalg.vector_norm(prog[k].double()))
        if not np.isfinite(p):
            return float("inf")
        worst = max(worst, abs(p - norms[k]) / max(norms[k], median, 1e-30))
    return worst


def moved_leaves(ref_grads: Dict[str, torch.Tensor], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient norm is at least `share` of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_grads.items()}
    median = float(np.median(list(norms.values())))
    return sorted(k for k, n in norms.items() if n >= share * median)


# ---------------------------------------------------------------- samples
def stratified(seed: int, n: int, k: int, salt: int = 11) -> List[int]:
    """k indices of range(n), one from each of k equal strata, drawn from
    `seed`: every part of the batch is represented."""
    k = max(1, min(k, n))
    rng = np.random.default_rng(np.random.SeedSequence([seed, salt]))
    edges = np.linspace(0, n, k + 1).astype(int)
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]


def picks(seed: int, lo: int, hi: int, k: int, salt: int = 13) -> List[int]:
    """k distinct sorted integers of [lo, hi) drawn from `seed`."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, salt]))
    k = max(0, min(k, hi - lo))
    return sorted(int(x) for x in rng.choice(np.arange(lo, hi), size=k, replace=False))


def first_done_steps(len_sec, dt: float) -> np.ndarray:
    """Each env's first done, as the number of steps after its reset: the
    step at which its float32 timer, advanced by `dt` a step, reaches its
    episode length (an episode solved early ends before)."""
    length = np.asarray(len_sec, np.float32).reshape(-1)
    dt = np.float32(dt)
    timer = np.zeros_like(length)
    ends = np.zeros(length.shape, np.int64)
    step = 0
    while (ends == 0).any():
        step += 1
        timer = timer + dt
        ends[(ends == 0) & (timer >= length)] = step
    return ends


def ending_stretches(ends: Sequence[int], first_step: int, stretch: int,
                     within: int) -> Dict[int, List[int]]:
    """{s: envs whose first done falls inside stretch s}, for s in [0,
    within); stretch s covers steps first_step + s * stretch + 1 ..
    first_step + (s + 1) * stretch after the reset, less a step at either
    end where it has 8 steps or more (room for the timer's rounding)."""
    margin = 1 if stretch >= 8 else 0
    out: Dict[int, List[int]] = {}
    for env, k in enumerate(ends):
        s, pos = divmod(int(k) - first_step - 1, stretch)
        if 0 <= s < within and margin <= pos < stretch - margin:
            out.setdefault(s, []).append(env)
    return out


def pick_ending(seed: int, enders: Dict[int, List[int]], k: int,
                allowed: Iterable[int] = None):
    """(a stretch of `enders` drawn from `seed`, among `allowed` if given;
    up to k of the envs that end in it, drawn likewise); (None, []) where
    there is none."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 19]))
    allowed = None if allowed is None else set(allowed)
    keys = sorted(s for s in enders if allowed is None or s in allowed)
    if not keys:
        return None, []
    s = keys[int(rng.integers(len(keys)))]
    envs = enders[s]
    return s, sorted(int(e) for e in rng.choice(envs, size=min(k, len(envs)), replace=False))


def action_pool(seed: int, num_envs: int, num_agents: int, n_pool: int,
                sizes: Sequence[int], head_bits: Sequence[Sequence[int]]) -> np.ndarray:
    """int32 bitmask actions [n_pool, num_envs, num_agents]: a uniform choice
    per action head, drawn from `seed`, packed head by head."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 17]))
    md = np.stack([rng.integers(0, s, size=(n_pool, num_envs, num_agents)) for s in sizes],
                  axis=-1)
    pool = np.zeros(md.shape[:-1], np.int32)
    for h, bits in enumerate(head_bits):
        pool |= np.asarray(bits, np.int32)[md[..., h]]
    return pool


# ---------------------------------------------------------------- layouts
class ReferenceLayouts:
    """Each sampled env's layout stream as the reference makes it: a numpy
    PCG64 generator per env, spawned from the layout seed over the whole
    batch, the reference scenario's generator drawing one layout per
    episode."""

    def __init__(self, scenario, seed: int, num_envs: int, env_ids: Sequence[int]):
        self.scenario = scenario
        every = np.random.SeedSequence(seed).spawn(num_envs)
        self.gens = {i: np.random.Generator(np.random.PCG64(every[i])) for i in env_ids}
        self.made: Dict[int, list] = {i: [] for i in env_ids}

    def layout(self, env: int, k: int):
        """Env `env`'s k-th layout (0 = the first episode's)."""
        while len(self.made[env]) <= k:
            self.made[env].append(self.scenario.generate_checked(self.gens[env]))
        return self.made[env][k]

    def stacked(self, env_ids: Sequence[int], ks: Sequence[int]) -> Dict[str, np.ndarray]:
        """{path: leaf [len(env_ids), ...]} of layout ks[j] of env env_ids[j]."""
        per = [leaves(self.layout(i, k)) for i, k in zip(env_ids, ks)]
        return {p: np.stack([np.asarray(d[p]) for d in per]) for p in per[0]}
