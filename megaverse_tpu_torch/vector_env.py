"""Vectorized environment: batched step + device-side auto-reset buffer
(counterpart of megaverse_tpu/vector_env.py).

Replacement for the reference VectorEnv thread pool
(env/src/vector_env.cpp:6-127): instead of N CPU threads stepping N envs behind
a spin barrier, the whole batch steps in lockstep as batched tensor code, and
observations for all env x agent cameras come out of one kernel launch (the
analogue of the single v4r cmdStream.render, v4r_env_renderer.cpp:338-355).

Auto-reset: the step consumes a per-env "next episode layout" buffer by masked
select when an env finishes (replacing the serial reset of done envs,
vector_env.cpp:89-108). The host refills consumed slots from numpy procedural
generation between steps; each env's layout stream is keyed by its own seed
chain (mirroring megaverse.cpp:60-69 master->per-env seeding), so results are
deterministic regardless of refill timing.

One tick (`capture.tick`: the sim step, the reference's deferred auto-reset
where `should_defer_reset` holds, the render) advances the state in fixed
buffers, in place: the counterpart of the reference's donated state. On a CUDA
device the tick is captured once per render bucket and form into a CUDA graph
and `step` / `step_many` replay it, as the reference runs a chunk as one
jitted `lax.scan` (`VectorEnv(capture=False)` keeps the eager tick, as the
reference's MEGAVERSE_SCAN_STEPS=0 keeps its loop; the CPU runs the same tick
eagerly). A tick makes no device-to-host synchronisation; refills scatter into
the bound layout buffer in place between ticks, in stream order. Every tensor
`step` and `step_many` hand out is a copy, never a graph's static output.

Render size classes (`_render_classes`, as the reference's): envs are grouped
by the live row counts of their layouts into up to six classes, each class
renders through its own table size, and one inverse-permutation gather puts
the frames back in env order. They are OFF unless MEGAVERSE_CLASSES=1
(MEGAVERSE_NO_CLASSES=1 turns them off whatever else is set), the
reference's rule on the TPU, for the reason it gives there: the bit-walk (B2)
culls a padded row at the cost of one bit, so padding costs little, while on
this launch-bound step every class adds its own cull prologue and B2 launch.
Turning them on by default waits for a benchmark cell that shows a gain. With
classes on the tick stays eager: the class groups change shape at every
refill.

Spans (`utils/logging.span`, on the stepping thread only): "megaverse.step_many"
(a chunk's queueing, its ticks' "megaverse.tick" inside), "megaverse.refill"
(a refill, before or after the chunk) with "megaverse.refill.poll" (the wait
for the done bits), "megaverse.refill.wait" (the layouts from the prefetch
threads, or made inline), "megaverse.refill.stack" and two
"megaverse.refill.upload" (the host-to-device copy, then the scatter into
the bound buffer). `layout_seconds` counts wait, stack and the first upload.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from megaverse_tpu_torch import constants as C
from megaverse_tpu_torch.capture import TickGraphs
from megaverse_tpu_torch.env import (
    RenderMode,
    render_batch,
    render_view,
    render_view_index,
)
from megaverse_tpu_torch.ops.raycast_cuda import unpack_rgb
from megaverse_tpu_torch.scenarios import make_scenario
from megaverse_tpu_torch.scenarios.base import Scenario
from megaverse_tpu_torch.types import (
    EnvState,
    SceneData,
    multidiscrete_to_bitmask,
    scene_to_device,
    stack_scenes,
    state_from_scene,
    tree_scatter_,
)
from megaverse_tpu_torch.utils.logging import span
from megaverse_tpu_torch.utils.refrng import Rng, episode_reseed, fan_out_env_seeds

# How many steps may elapse between done-flag inspections on the host. Must be
# much smaller than the shortest episode (>= 6 s = 90 steps) so a slot is never
# consumed twice before refill.
DONE_POLL_INTERVAL = 16


def refill_slot_rung(n: int, num_envs: int) -> int:
    """Padded slot count for a refill of `n` envs: 1.5x rungs
    (64/96/128/192/...), so refill uploads and scatters come in a few fixed
    shapes; the padded rows are real upload bytes, hence not pure doubling."""
    slots = 64
    for rung in (64, 96, 128, 192, 256, 384, 512, 768, 1024):
        slots = rung
        if rung >= n:
            break
    while slots < n:  # num_envs can exceed the ladder tail
        slots *= 2
    return min(slots, num_envs)


class VectorEnv:
    """Batched auto-resetting environment.

    `device=None` means "cuda" and raises if no GPU is present; pass
    device="cpu" to run on the CPU (the renderer then takes the kernel's plain
    PyTorch version).

    `shard=(rank, world_size)`: this object holds and steps only its share of
    a `num_envs`-env batch split over `world_size` processes (the reference's
    `device=NamedSharding(mesh, P("data"))`): envs `env_offset` to
    `env_offset + num_envs // world_size`, each seeded from its GLOBAL index,
    so the ranks' observations, gathered in rank order, equal one process's
    bit for bit. `self.num_envs` is then the envs held here and
    `self.global_num_envs` the whole batch; actions are this shard's rows.

    `capture` (default True): on a CUDA device, replay each tick from a CUDA
    graph (`capture.TickGraphs`); False steps eagerly. `self.state`,
    `self.next_scenes` and `self.shaping` are the bound buffers the tick
    advances in place: read them freely, and write into them in place (a
    leaf or tree assigned anew is copied into new buffers at the next tick,
    and the graphs are captured again)."""

    def __init__(
        self,
        scenario_name: str,
        num_envs: int,
        num_agents_per_env: int = 1,
        params: Optional[Dict[str, float]] = None,
        seed: int = 42,
        render: bool = True,
        obs_format: str = "auto",
        device=None,
        rng_mode: str = "numpy",
        shard: Optional[tuple] = None,
        capture: bool = True,
    ):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "VectorEnv runs on a CUDA device by default and none is "
                    "available; pass device='cpu' to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.scenario: Scenario = make_scenario(
            scenario_name, num_agents=num_agents_per_env, params=params
        )
        rank, world_size = shard if shard is not None else (0, 1)
        if world_size < 1 or not 0 <= rank < world_size or num_envs % world_size:
            raise ValueError(f"shard {shard}: num_envs {num_envs} must divide into "
                             "world_size shards and 0 <= rank < world_size")
        self.global_num_envs = num_envs
        self.num_envs = num_envs // world_size
        self.env_offset = rank * self.num_envs
        self.num_agents_per_env = num_agents_per_env
        self.render_obs = render
        # "packed" int32 [B,A,H,W] is the on-device obs format: one word per
        # pixel, written once by the kernel.
        if obs_format == "auto":
            obs_format = "packed" if self.device.type == "cuda" else "rgb"
        self.obs_format = obs_format

        # rng_mode="reference": layouts draw from bit-exact libstdc++ mt19937
        # streams through the reference's master->env->episode seed chain
        # (utils/refrng.py; megaverse.cpp:60-69, env.cpp:61-63), so generated
        # geometry matches the C++ engine's under the same seed. Only
        # scenarios with supports_ref_stream implement it.
        if rng_mode not in ("numpy", "reference"):
            raise ValueError(f"unknown rng_mode {rng_mode!r}")
        if rng_mode == "reference" and not self.scenario.supports_ref_stream:
            raise ValueError(
                f"{self.scenario.name}: reference-stream generation not "
                "implemented (supports_ref_stream=False)")
        self.rng_mode = rng_mode
        self._gens: List = []
        self._master_seed = seed
        self._prefetch_pool = None
        self._prefetch_q = None
        self.seed(seed)

        self.shaping = torch.from_numpy(
            np.tile(self.scenario.shaping_array()[None], (self.num_envs, 1, 1))
        ).to(self.device)

        # Render-table bucket: (max live boxes, max live props) across the
        # batch, tracked as a high-water mark over every layout generated so
        # far. Scenario capacities are worst-case, so rendering only the live
        # prefix keeps the primitive and cull tables short.
        self._bucket: Optional[tuple] = None
        # Which form of the render kernel draws the observations: read from
        # the environment (MEGAVERSE_RENDER_MODE, MEGAVERSE_NO_CLUSTER_CULL,
        # ..., see env.RenderMode) once, here. Every form gives the same image.
        self.render_mode = RenderMode.from_env()
        self._hw_boxes = 0
        segs = self.scenario.cfg.prop_segments
        self._hw_props = [0] * len(segs) if segs else 0
        self._init_render_classes()

        self.state: Optional[EnvState] = None
        self.next_scenes: Optional[SceneData] = None
        self._ticks = TickGraphs(self.scenario, self.device, capture=capture)
        self._steps_since_poll = 0
        # Running OR of done flags since the last refill (bool [B], bound in
        # the tick) and whether any tick ran since.
        self._pending_dones = torch.zeros((self.num_envs,), dtype=torch.bool,
                                          device=self.device)
        self._pending_any = False
        self._deferred_refill = None
        # counters a caller can read: auto-resets noticed by the host,
        # layouts uploaded into the buffer, and the host seconds spent waiting
        # for generated layouts, stacking them and starting their upload
        self.num_refills = 0
        self.num_refilled_envs = 0
        self.layout_seconds = 0.0

    # ---------------------------------------------------------------- renderer
    def _render(self, state: EnvState) -> torch.Tensor:
        if self._use_classes:
            return self._render_classes(state)
        return render_batch(self.scenario, state, fmt=self.obs_format,
                            bucket=self._bucket, mode=self.render_mode)

    # -------------------------------------------------- render size classes
    # One outlier layout must not set the whole batch's table size: the
    # renderer's cost grows with the table's rows and row counts are heavy-
    # tailed (Collect: p50 = 44 merged boxes, max ~550). Envs are partitioned
    # by their CURRENT layout's live row counts into a few fixed classes;
    # each class renders through its own table size and the frames are
    # reassembled by one inverse-permutation gather. Class membership is host
    # bookkeeping, exact and conservative: an env's rows are max(current
    # episode, buffered next layout), covering auto-resets that consume the
    # buffer between refills. (megaverse_tpu/vector_env.py:330-481.)
    _CLASS_MIN_ROWS = 256       # only partition genuinely large scenarios
    _CLASS_MIN_ENVS = 64
    _NUM_CLASSES = 6

    def _init_render_classes(self) -> None:
        want = (os.environ.get("MEGAVERSE_CLASSES") == "1"
                and not os.environ.get("MEGAVERSE_NO_CLASSES"))
        self._use_classes = (self.render_obs and want
                             and sum(self._class_dims()) >= self._CLASS_MIN_ROWS
                             and self.num_envs >= self._CLASS_MIN_ENVS)
        if self._use_classes:
            self._build_class_ladder()

    def _class_dims(self) -> list:
        """Row capacities: boxes, then each prop segment (or all props)."""
        cfg = self.scenario.cfg
        seg_caps = [cap for _, _, cap in cfg.prop_segments] or [int(cfg.max_props)]
        return [int(self.scenario.max_boxes)] + seg_caps

    def _build_class_ladder(self) -> None:
        K = self._NUM_CLASSES
        box_cap, *seg_caps = self._class_dims()
        roundup = lambda n, q: ((max(int(n), 1) + q - 1) // q) * q

        def levels(cap):
            # Geometric ladder (ratio 1.6: padding an env one class up costs
            # ratio - 1 extra work); every level gets at least min(cap, 48)
            # rows, so small tables never drag envs into costly classes.
            out = []
            for k in range(K):
                frac = max(cap / (1.6 ** (K - 1 - k)), min(cap, 48))
                out.append(min(cap, roundup(frac, 8)))
            return out

        # ladder[k] = (box_rows, (segment rows, ...))
        box_lv = levels(box_cap)
        seg_lv = [levels(c) for c in seg_caps]
        self._class_ladder = [(box_lv[k], tuple(lv[k] for lv in seg_lv)) for k in range(K)]
        self._cls_rows_cur: Optional[np.ndarray] = None  # [B, D]
        self._cls_rows_buf: Optional[np.ndarray] = None
        self._cls_groups: list = []     # [(class k, padded env indices on the device)]
        self._cls_inv: Optional[torch.Tensor] = None    # inverse permutation [B]

    def set_render_classes(self, on: bool) -> None:
        """Turn render size classes on or off for this env from now on,
        whatever the environment variables and size thresholds say. The
        class rows are read from the current states and the buffered layouts
        on the device (one device-to-host copy)."""
        self._use_classes = bool(on and self.render_obs)
        if not self._use_classes:
            return
        self._build_class_ladder()
        if self.state is not None:
            self._cls_rows_cur = self._layout_rows(self.state.box_color, self.state.props.type)
            self._cls_rows_buf = self._layout_rows(self.next_scenes.box_color,
                                                   self.next_scenes.props.type)
            self._rebuild_class_groups()

    def _layout_rows(self, box_color, types) -> np.ndarray:
        """Live render-row counts [N, 1 + num_segments] of N layouts (boxes,
        then the props of each segment), from their box colours [N, boxes]
        and prop types [N, props] (numpy or tensors)."""
        box_color, types = (torch.as_tensor(x) for x in (box_color, types))
        rows = [(box_color > 0).sum(dim=1)]
        segments = self.scenario.cfg.prop_segments
        if segments:
            rows += [(types[:, start:start + cap] != C.PROP_NONE).sum(dim=1)
                     for _, start, cap in segments]
        else:
            rows.append((types != C.PROP_NONE).sum(dim=1))
        return torch.stack(rows, dim=1).cpu().numpy().astype(np.int32)

    def _class_of(self, rows: np.ndarray) -> np.ndarray:
        """Smallest ladder class covering each env's rows. rows [B, D]."""
        cls = np.full((rows.shape[0],), len(self._class_ladder) - 1, np.int32)
        for k in reversed(range(len(self._class_ladder) - 1)):
            mb, pb = self._class_ladder[k]
            lim = np.asarray([mb, *pb], np.int32)
            cls = np.where((rows <= lim[None, :]).all(axis=1), k, cls)
        return cls

    def _rebuild_class_groups(self) -> None:
        cls = self._class_of(np.maximum(self._cls_rows_cur, self._cls_rows_buf))
        n = self.num_envs
        # Group padding: 32, 64, then multiples of 128: a padded entry renders
        # at its group's full table size.
        pad_sizes = sorted({32, 64, *range(128, n + 1, 128), n})
        groups, order_parts = [], []
        for k in range(len(self._class_ladder)):
            idx = np.nonzero(cls == k)[0]
            if idx.size == 0:
                continue
            padded = next(p for p in pad_sizes if p >= idx.size)
            full = np.full((padded,), idx[0], np.int64)
            full[:idx.size] = idx
            groups.append((k, torch.from_numpy(full).to(self.device)))
            order_parts.append(full)
        order = np.concatenate(order_parts)
        # inverse permutation: each env's FIRST place in the concatenation
        # (padding repeats an env index after its real place)
        first = np.unique(order, return_index=True)[1]
        self._cls_groups = groups
        self._cls_inv = torch.from_numpy(first.astype(np.int64)).to(self.device)

    def _render_classes(self, state: EnvState) -> torch.Tensor:
        """Per-class gather -> render, then one inverse-permutation gather."""
        segmented = bool(self.scenario.cfg.prop_segments)
        view = render_view(state)
        parts = []
        for k, idx in self._cls_groups:
            box_rows, seg_rows = self._class_ladder[k]
            bucket = (box_rows, seg_rows if segmented else seg_rows[0])
            parts.append(render_batch(self.scenario, render_view_index(view, idx),
                                      fmt=self.obs_format, bucket=bucket,
                                      mode=self.render_mode))
        return torch.cat(parts, dim=0)[self._cls_inv]

    def _note_layout_counts(self, scenes) -> None:
        segments = self.scenario.cfg.prop_segments
        for sc in scenes:
            self._hw_boxes = max(
                self._hw_boxes, int((np.asarray(sc.box_color) > 0).sum()))
            types = np.asarray(sc.props.type)
            if segments:
                for i, (ptype, start, cap) in enumerate(segments):
                    n = int((types[start:start + cap] != C.PROP_NONE).sum())
                    self._hw_props[i] = max(self._hw_props[i], n)
            else:
                self._hw_props = max(
                    self._hw_props, int((types != C.PROP_NONE).sum()))

    def _update_bucket(self) -> None:
        # render_batch clips the bucket to the table capacities. Bucket sizes
        # live on a coarse GEOMETRIC ladder with generous headroom: reset
        # samples 2*B layouts, so the observed high-water estimates the
        # maximum well and later creep almost never crosses the next rung,
        # which keeps the table shapes (and everything sized by them) stable.
        # Padded rows cost next to nothing in the bit-walk kernel (dead
        # clusters never pass the cull bits).
        def quantize(n):
            n = int(n)
            if n <= 0:
                return 0
            if n <= 8:
                return n + (n & 1)
            v = 8
            while v < n:
                v = (v * 3 + 1) // 2  # ratio 1.5 ladder: 8,12,18,27,...
            return v

        mb = max(1, quantize(self._hw_boxes * 1.25))
        if isinstance(self._hw_props, list):
            pb = tuple(quantize(n * 1.25) for n in self._hw_props)
            grew = (self._bucket is None or mb > self._bucket[0]
                    or any(a > b for a, b in zip(pb, self._bucket[1])))
        else:
            pb = quantize(self._hw_props * 1.25)
            grew = (self._bucket is None or mb > self._bucket[0]
                    or pb > self._bucket[1])
        if grew:
            self._bucket = (mb, pb)

    # ------------------------------------------------------------------ seeds
    def seed(self, seed: int) -> None:
        """Master seed fans out per-env generation streams (megaverse.cpp:60-69)."""
        self._master_seed = seed
        # Drain the prefetch worker BEFORE swapping generators: a pending task
        # resolves self._gens[i] at run time and must not touch the new streams.
        self._reset_prefetch()
        # every env's stream is keyed by its global index: a shard takes its
        # slice of the whole batch's seeds, never seeds of its own
        mine = slice(self.env_offset, self.env_offset + self.num_envs)
        if self.rng_mode == "reference":
            self._gens = [Rng(s) for s in fan_out_env_seeds(seed, self.global_num_envs)[mine]]
        else:
            ss = np.random.SeedSequence(seed)
            self._gens = [np.random.Generator(np.random.PCG64(s))
                          for s in ss.spawn(self.global_num_envs)[mine]]

    # --------------------------------------------------------------- prefetch
    # Layout generation is host-side numpy; at high throughput the synchronous
    # refill serializes it between device chunks. A small worker pool
    # pre-generates each env's NEXT layouts while the device runs. Determinism
    # does not depend on scheduling: each env owns its generator stream, and at
    # most one task per env is ever in flight (_pop_scene resolves the queued
    # future before submitting the next), so every env's layouts are produced
    # in consumption order, bit-identical to synchronous generation.
    def _reset_prefetch(self) -> None:
        if self._prefetch_pool is not None:
            self._prefetch_pool.shutdown(wait=True, cancel_futures=True)
        self._prefetch_pool = None
        workers = int(os.environ.get(
            "MEGAVERSE_GEN_THREADS", min(4, os.cpu_count() or 1)))
        self._prefetch_pool = ThreadPoolExecutor(
            workers, thread_name_prefix="megaverse-gen")
        self._prefetch_q = [deque() for _ in range(self.num_envs)]

    def _gen_scene(self, i: int):
        if self.rng_mode == "reference":
            # per-episode reseed (env.cpp:61-63) then reference-order draws
            episode_reseed(self._gens[i])
            return self.scenario.generate_checked(self._gens[i], ref_stream=True)
        return self.scenario.generate_checked(self._gens[i])

    def _pop_scene(self, i: int):
        """Next layout for env i: prefetched if available, inline otherwise
        (also after `close`). Tops the env's queue back up afterwards."""
        if self._prefetch_pool is None:
            return self._gen_scene(i)
        q = self._prefetch_q[i]
        fut = q.popleft() if q else self._prefetch_pool.submit(self._gen_scene, i)
        scene = fut.result()
        q.append(self._prefetch_pool.submit(self._gen_scene, i))
        return scene

    def close(self) -> None:
        if self._prefetch_pool is not None:
            self._prefetch_pool.shutdown(wait=True, cancel_futures=True)
            self._prefetch_pool = None

    # ------------------------------------------------------------------ reset
    def _generate_batch(self, env_indices, pad_to: int = 0) -> SceneData:
        """Generate + stack layouts for env_indices and ship them to the
        device, one buffer per leaf; `pad_to` repeats the first layout
        host-side up to a fixed row count so refills come in few shapes."""
        t0 = time.perf_counter()
        with span("megaverse.refill.wait"):
            scenes = [self._pop_scene(i) for i in env_indices]
        with span("megaverse.refill.stack"):
            self._note_layout_counts(scenes)
            if self._use_classes:
                self._last_gen_rows = self._layout_rows(
                    np.stack([sc.box_color for sc in scenes]),
                    np.stack([sc.props.type for sc in scenes]))
            stacked = stack_scenes(scenes, pad_to=pad_to)
        with span("megaverse.refill.upload"):
            batch = scene_to_device(stacked, self.device, non_blocking=True)
        self.layout_seconds += time.perf_counter() - t0
        return batch

    def reset(self) -> torch.Tensor:
        all_idx = range(self.num_envs)
        first = self._generate_batch(all_idx)
        if self._use_classes:
            self._cls_rows_cur = self._last_gen_rows
        self.next_scenes = self._generate_batch(all_idx)
        if self._use_classes:
            self._cls_rows_buf = self._last_gen_rows
            self._rebuild_class_groups()
        rng = torch.arange(self.env_offset, self.env_offset + self.num_envs,
                           dtype=torch.int64, device=self.device) \
            + (int(self._master_seed) << 20)
        self._pending_dones.zero_()
        self._pending_any = False
        self.state = self._ticks.bind(state_from_scene(first, self.num_agents_per_env, rng),
                                      self.next_scenes, self.shaping, self._pending_dones)
        self._steps_since_poll = 0
        self._deferred_refill = None
        self._update_bucket()
        return self._render(self.state)

    # ------------------------------------------------------------------- step
    def _to_actions(self, actions) -> torch.Tensor:
        actions = torch.as_tensor(actions)
        if actions.dim() == 3:
            actions = multidiscrete_to_bitmask(actions)
        return actions.to(device=self.device, dtype=torch.int32)

    @property
    def captures(self) -> int:
        """CUDA graphs of the tick captured so far (one per render bucket and
        form since the last binding)."""
        return self._ticks.captures

    def _advance(self, actions: torch.Tensor):
        """One tick on the bound buffers on the current stream, no host sync:
        replayed from its graph (capture on a CUDA device, no size classes)
        or eager. Returns (obs or None, reward, done, true_objective), which
        may be the graph's static outputs."""
        if not self._ticks.is_bound(self.state, self.next_scenes, self.shaping):
            self.state = self._ticks.bind(self.state, self.next_scenes, self.shaping,
                                          self._pending_dones)
        self._pending_any = True
        if self._use_classes:
            _, reward, done, tobj = self._ticks.run(actions, render=False, eager=True)
            obs = self._render_classes(self.state) if self.render_obs else None
            return obs, reward, done, tobj
        return self._ticks.run(actions, render=self.render_obs, fmt=self.obs_format,
                               bucket=self._bucket, mode=self.render_mode)

    def _fresh(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """A tensor to hand out: a copy where the tick may be a replay."""
        return x.clone() if x is not None and self._ticks.capture else x

    def _empty_obs(self) -> torch.Tensor:
        cfg = self.scenario.cfg
        shape = (self.num_envs, self.num_agents_per_env, cfg.obs_height, cfg.obs_width)
        if self.obs_format == "packed":
            return torch.zeros(shape, dtype=torch.int32, device=self.device)
        return torch.zeros(shape + (3,), dtype=torch.uint8, device=self.device)

    def step(self, actions):
        """actions: int bitmask [B, A] or multidiscrete [B, A, 6].

        Returns (obs, rewards [B,A] f32, dones [B] bool, true_objective
        [B,A] f32), all device tensors; obs is packed int32 [B,A,H,W] or
        uint8 [B,A,H,W,3] by `obs_format`."""
        if self.state is None:
            self.reset()
        obs, reward, done, tobj = (self._fresh(x) for x in
                                   self._advance(self._to_actions(actions)))
        if obs is None:
            obs = self._empty_obs()
        self._steps_since_poll += 1
        if self._steps_since_poll >= DONE_POLL_INTERVAL:
            self._refill_consumed_slots()
        return obs, reward, done, tobj

    def step_many(self, action_pool, n_steps: int):
        """Run `n_steps` env steps back-to-back (throughput path).

        `action_pool` is an array [K, B, A] of int32 bitmasks; step i uses
        pool[i % K]. Returns (last_obs, dones: list of n [B] tensors,
        checksums) where checksums is a one-element list whose entry depends
        on the last frame (synchronise on it to wait for the chunk). The chunk
        is a loop of ticks queued on the current stream (graph replays where
        capture is on) with no device-to-host synchronisation inside it.

        n_steps must stay below the shortest episode length in steps so a
        layout-buffer slot cannot be consumed twice within one chunk (asserted
        against the scenario's base episode_length_sec; per-episode
        extensions like TowerBuilding's +4 s/box only lengthen episodes)."""
        if self.state is None:
            self.reset()
        min_ep_steps = int(
            float(self.scenario.cfg.params.get(C.P_EPISODE_LENGTH_SEC, 60.0))
            / self.scenario.cfg.dt)
        if n_steps >= min_ep_steps:
            raise ValueError(
                f"step_many(n_steps={n_steps}) >= shortest episode "
                f"({min_ep_steps} steps): a layout-buffer slot could be "
                f"consumed twice before refill; use smaller chunks")

        # Refill overlap: instead of refilling consumed slots synchronously
        # BEFORE the chunk (which serializes host generation + upload +
        # scatter between device chunks), snapshot the pending dones, queue
        # the whole chunk first, then refill from the PREVIOUS chunk's
        # snapshot while this chunk executes. Correctness window: a slot
        # consumed in chunk N is refilled before chunk N+2 executes (the
        # scatter is queued during N+1, ahead of N+2's steps on the same
        # stream), so the shortest episode must span TWO chunks. Scenarios
        # with shorter episodes keep the synchronous pre-chunk refill.
        overlap = 2 * n_steps < min_ep_steps
        if not overlap:
            self._refill_consumed_slots()

        with span("megaverse.step_many"):
            if torch.is_tensor(action_pool):
                pool = action_pool.to(device=self.device, dtype=torch.int32)
            else:
                pool = torch.from_numpy(np.ascontiguousarray(action_pool, np.int32))
                if self.device.type == "cuda":
                    pool = pool.pin_memory().to(self.device, non_blocking=True)
            dones = []
            obs = None
            for i in range(n_steps):
                obs, _, done, _ = self._advance(pool[i % pool.shape[0]])
                dones.append(self._fresh(done))
            obs = self._empty_obs() if obs is None else self._fresh(obs)
            self._steps_since_poll = 0  # refilled at next step_many/flush
            # One checksum per chunk; it depends on the final obs, whose chain
            # covers every step in the chunk.
            csum = obs.sum(dtype=torch.int64)
        if overlap:
            self._overlap_refill_tick()
        return obs, dones, [csum]

    def flush(self) -> None:
        """Force buffer refill bookkeeping (call before relying on layouts)."""
        self._refill_consumed_slots()

    def render(self) -> torch.Tensor:
        """Re-render the current state (all env x agent views)."""
        if self.state is None:
            return self.reset()
        return self._render(self.state)

    def _take_pending(self) -> Optional[torch.Tensor]:
        """The packed done bits of the ticks since the last refill (None if
        none ran), and a cleared running OR, both queued on the stream."""
        if not self._pending_any:
            return None
        self._pending_any = False
        packed = self._pack_mask(self._pending_dones)
        self._pending_dones.zero_()
        return packed

    def _refill_consumed_slots(self) -> None:
        with span("megaverse.refill"):
            self._steps_since_poll = 0
            self._apply_refill_bits(self._take_refill_stash())
            packed = self._take_pending()
            if packed is not None:
                self._apply_refill_bits(self._fetch_bits(packed))

    # -- refill overlap machinery --------------------------------------------
    # The packed done-bits of chunk N are computed as a device op queued right
    # AFTER chunk N's steps and copied to a pinned host buffer asynchronously;
    # they are resolved (host layout generation + upload + scatter) at the end
    # of chunk N+1's queueing, so the device rolls from chunk N straight into
    # N+1 while the host prepares the refill, and the scatter lands in the
    # stream ahead of chunk N+2, the first chunk that could consume a slot
    # freed in chunk N (the 2-chunk episode window asserted in step_many).
    def _pack_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """bool [B] -> uint8 [ceil(B/8)], little bit order."""
        pad = (-mask.shape[0]) % 8
        if pad:
            mask = torch.cat([mask, torch.zeros((pad,), dtype=torch.bool,
                                                device=mask.device)])
        weights = (1 << torch.arange(8, dtype=torch.int32, device=mask.device))
        return (mask.reshape(-1, 8).to(torch.int32) * weights).sum(dim=-1).to(torch.uint8)

    def _fetch_bits(self, packed: torch.Tensor):
        """Start the device-to-host copy of packed done bits. Returns
        (host tensor, event or None); the event marks the copy's completion."""
        if packed.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def _overlap_refill_tick(self) -> None:
        """End-of-chunk overlap step: stash THIS chunk's done-bits (pack queued
        right behind its steps + asynchronous host copy), then resolve the
        PREVIOUS chunk's stash into generation + upload + scatter while this
        chunk runs on the device."""
        with span("megaverse.refill"):
            deferred = self._take_refill_stash()
            packed = self._take_pending()
            if packed is not None:
                self._deferred_refill = self._fetch_bits(packed)
            self._apply_refill_bits(deferred)
            self._steps_since_poll = 0

    def _take_refill_stash(self):
        stash = self._deferred_refill
        self._deferred_refill = None
        return stash

    def _apply_refill_bits(self, stash) -> None:
        if stash is None:
            return
        host, event = stash
        with span("megaverse.refill.poll"):
            if event is not None:
                event.synchronize()   # waits for that copy only, not for the stream
            dones = np.unpackbits(host.numpy(), bitorder="little")[: self.num_envs]
        idx = np.nonzero(dones)[0]
        if idx.size == 0:
            return
        # Fixed slot ladder for the refill upload + scatter, padded HOST-side;
        # sentinel coords == num_envs are dropped by the scatter.
        n = idx.size
        slots = refill_slot_rung(n, self.num_envs)
        new_scenes = self._generate_batch(idx.tolist(), pad_to=slots)
        slot_idx = np.concatenate([idx.astype(np.int64),
                                   np.full((slots - n,), self.num_envs, np.int64)])
        # in place, into the bound buffer: the scatter is queued behind the
        # ticks already on the stream, which read the slots before it lands
        with span("megaverse.refill.upload"):
            tree_scatter_(self.next_scenes, slot_idx, new_scenes)
        if self._use_classes:
            # done envs consumed their buffered layout; the new one is buffered
            self._cls_rows_cur[idx] = self._cls_rows_buf[idx]
            self._cls_rows_buf[idx] = self._last_gen_rows
            self._rebuild_class_groups()
        self.num_refills += 1
        self.num_refilled_envs += int(n)
        self._update_bucket()

    # -------------------------------------------------------------- shaping
    def get_reward_shaping(self, env_idx: int, agent_idx: int) -> Dict[str, float]:
        row = self.shaping[env_idx, agent_idx].cpu().numpy()
        return dict(zip(self.scenario.all_shaping_keys, row.tolist()))

    def set_reward_shaping(self, env_idx: int, agent_idx: int, rs: Dict[str, float]) -> None:
        keys = self.scenario.all_shaping_keys
        row = self.shaping[env_idx, agent_idx].cpu().numpy().copy()
        for k, v in rs.items():
            if k in keys:
                row[keys.index(k)] = v
        # into the bound buffer: ticks already queued read it before
        self.shaping[env_idx, agent_idx].copy_(torch.from_numpy(row))

    @property
    def action_space_sizes(self):
        return list(C.ACTION_SPACE_SIZES)

    @staticmethod
    def unpack_obs(obs: torch.Tensor) -> torch.Tensor:
        """packed int32 [..., H, W] -> uint8 [..., H, W, 3]."""
        if obs.dtype == torch.uint8:
            return obs
        return unpack_rgb(obs)
