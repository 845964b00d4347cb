"""One env tick (sim step, deferred reset, render) as one device program.

The reference runs a `step_many` chunk and the learner's rollout as one
jitted `lax.scan` with the state donated (megaverse_tpu/vector_env.py
`_step_many_scan`, `_donate_state`; megaverse_tpu/rl/learner.py
`collect_rollout`). Here the state lives in fixed buffers that every tick
advances in place, and the tick (`tick`: `env_step`, the deferred reset's
masked copy where the scenario takes it, the write-back, `render_batch` with
its cull prologue and one render launch) is captured once into a CUDA graph
and replayed: one host call per step instead of thousands of eager ops.

`TickGraphs` owns the bound buffers of one env batch: the state (copied in at
`bind`, so no leaf aliases another or the caller's), the caller's
`next_scenes` and `shaping` (which the caller must update in place), the
action row and the running OR of dones. It keeps one graph per key (render
bucket, render form, output format, frame size) and captures on the second
tick of a key: the first runs eagerly on a side stream, which builds the
kernels and makes the cached constants outside capture. A failed capture or
replay raises; nothing falls back to the eager tick. Graph outputs are
static: a caller hands out copies.

Launch counts (`raycast_cuda.LAUNCHES`) are kept on
the host where each wrapper launches: a capture counts nothing, and each
replay adds the launches its graph holds. The tick's three marker kernels
(ops/marks.py) are captured with it and counted nowhere; `TickGraphs.run`
is the span "megaverse.tick" (action copy and replay, or the eager tick).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from megaverse_tpu_torch.env import (
    RenderMode,
    apply_deferred_resets,
    env_step,
    render_batch,
    should_defer_reset,
)
from megaverse_tpu_torch.ops import raycast_cuda as RC
from megaverse_tpu_torch.ops.marks import mark
from megaverse_tpu_torch.scenarios.base import Scenario
from megaverse_tpu_torch.types import EnvState, SceneData, tree_copy_, tree_leaves, tree_map
from megaverse_tpu_torch.utils.logging import span


def tick(scenario: Scenario, state: EnvState, next_scenes: SceneData, action: torch.Tensor,
         shaping: torch.Tensor, render: bool = True, fmt: str = "packed",
         bucket: Optional[tuple] = None, mode: Optional[RenderMode] = None,
         pending: Optional[torch.Tensor] = None):
    """One tick of a bound env batch, IN PLACE: `env_step`, every state leaf
    it rewrote copied back into `state`'s own tensor, then (where
    `should_defer_reset` holds, as in the reference) the deferred reset's
    masked copy into those tensors, `pending |= done`, and the new state
    rendered. On CUDA the marker kernels (ops/marks.py) open the three
    stages: "tick" before `env_step`, "reset" after the write-back, "cull"
    before the render's cull prologue. Returns (obs or None, reward, done,
    true_objective)."""
    dev = action.device
    mark("tick", dev)
    defer = should_defer_reset(scenario)
    res = env_step(scenario, state, next_scenes, action, shaping, defer_reset=defer)
    # an output that is a state leaf the step passed through (a scenario's
    # true objective) is read before the write-back changes it
    bound = {id(x) for x in tree_leaves(state)}
    reward, done, true_objective = (x.clone() if id(x) in bound else x
                                    for x in (res.reward, res.done, res.true_objective))
    tree_copy_(state, res.state)
    mark("reset", dev)
    if defer:
        apply_deferred_resets(state, next_scenes, done,
                              scen_fields=scenario.deferred_scen_fields)
    if pending is not None:
        pending.logical_or_(done)
    obs = None
    if render:
        mark("cull", dev)
        obs = render_batch(scenario, state, fmt=fmt, bucket=bucket, mode=mode)
    return obs, reward, done, true_objective


class TickGraphs:
    """The tick of one env batch on one device, over bound buffers; on CUDA
    replayed from CUDA graphs (`capture=True`), else eager.

    `pool`: a graph memory pool (`torch.cuda.graph_pool_handle()`) to share
    with other `TickGraphs` whose ticks never run concurrently (the tasks of
    a multitask learner); None makes one for this batch."""

    def __init__(self, scenario: Scenario, device, capture: bool = True, pool=None):
        self.scenario = scenario
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self.pool = pool
        self.state: Optional[EnvState] = None
        self.next_scenes: Optional[SceneData] = None
        self.shaping: Optional[torch.Tensor] = None
        self.action: Optional[torch.Tensor] = None
        self.pending: Optional[torch.Tensor] = None
        self._graphs: Dict[tuple, Tuple] = {}
        self._warm: set = set()
        self._side: Optional[torch.cuda.Stream] = None
        self.captures = 0        # graphs captured since construction
        self.replays = 0         # replays since construction

    # ------------------------------------------------------------- buffers
    def bind(self, state: EnvState, next_scenes: SceneData, shaping: torch.Tensor,
             pending: Optional[torch.Tensor] = None) -> EnvState:
        """Drop every graph and bind new buffers: a contiguous copy of `state`
        (returned: the caller keeps it as its state, the tick advances it in
        place), the
        caller's `next_scenes`, `shaping` and `pending` (bool [B], the running
        OR of dones; None keeps none) as they are."""
        self.drop()
        self.state = tree_map(lambda x: x.clone(memory_format=torch.contiguous_format), state)
        self.next_scenes = next_scenes
        self.shaping = shaping
        self.pending = pending
        bsz, num_agents = state.agents.yaw.shape
        self.action = torch.zeros((bsz, num_agents), dtype=torch.int32, device=self.device)
        return self.state

    def is_bound(self, state, next_scenes, shaping) -> bool:
        """Whether these are the bound buffers (a caller that replaced one
        rebinds)."""
        return (self.state is not None and state is self.state
                and next_scenes is self.next_scenes and shaping is self.shaping)

    def drop(self) -> None:
        """Forget every captured graph (their memory returns to the pool)."""
        self._graphs.clear()
        self._warm.clear()

    # ---------------------------------------------------------------- tick
    def run(self, action: torch.Tensor, render: bool = True, fmt: str = "packed",
            bucket: Optional[tuple] = None, mode: Optional[RenderMode] = None,
            eager: bool = False):
        """One tick with `action` (int32 [B, A]) copied into the bound action
        row; `eager` runs it without a graph even where capture is on.
        Returns (obs or None, reward, done, true_objective): fresh tensors
        when eager, the graph's static outputs when replayed (valid until the
        next tick of this batch)."""
        with span("megaverse.tick"):
            self.action.copy_(action)
            args = dict(render=render, fmt=fmt, bucket=bucket, mode=mode)
            if eager or not self.capture:
                return self._tick(**args)
            cfg = self.scenario.cfg
            key = (render, fmt, bucket, mode, cfg.obs_height, cfg.obs_width)
            entry = self._graphs.get(key)
            if entry is None:
                if key not in self._warm:
                    self._warm.add(key)
                    return self._warm_tick(args)
                entry = self._capture(key, args)
            graph, out, delta = entry
            graph.replay()
            self.replays += 1
            for k, v in delta.items():
                RC.LAUNCHES[k] += v
            return out

    def _tick(self, **args):
        return tick(self.scenario, self.state, self.next_scenes, self.action, self.shaping,
                    pending=self.pending, **args)

    def _warm_tick(self, args):
        """A real tick, eagerly on a side stream (kernel builds and cached
        constants happen here, outside any capture); outputs copied on the
        current stream."""
        main = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            out = self._tick(**args)
        main.wait_stream(self._side)
        return tuple(None if x is None else x.clone() for x in out)

    def _capture(self, key, args):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = dict(RC.LAUNCHES)
        try:
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                out = self._tick(**args)
        finally:
            after = dict(RC.LAUNCHES)
            RC.LAUNCHES.update(before)
        delta = {k: n - before[k] for k, n in after.items() if n != before[k]}
        self.captures += 1
        entry = (graph, out, delta)
        self._graphs[key] = entry
        return entry
