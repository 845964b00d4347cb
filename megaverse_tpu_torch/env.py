"""Batched environment step assembly (counterpart of megaverse_tpu/env.py).

The reference's Env::step (env.cpp:83-152): action decode, scenario preStep,
KCC physics, scenario step, timers, reward accumulation, becomes one function
`env_step` over a batched EnvState, plus a masked auto-reset that consumes a
pre-generated episode layout per env (replacing VectorEnv's serial reset of
done envs, vector_env.cpp:89-108). `render_batch` turns a batch of states into
observations through the render kernel (ops/raycast_cuda.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, NamedTuple, Optional

import torch

from megaverse_tpu_torch import constants as C
from megaverse_tpu_torch.ops import kcc as K
from megaverse_tpu_torch.ops import masked_copy as MC
from megaverse_tpu_torch.ops import physics as P
from megaverse_tpu_torch.ops import raycast_cuda as RC
from megaverse_tpu_torch.scenarios.base import Scenario
from megaverse_tpu_torch.types import (
    AgentState,
    EnvState,
    PropState,
    SceneData,
    state_from_scene,
    tree_index,
    tree_leaves,
    tree_map,
    tree_select,
)


class StepResult(NamedTuple):
    state: EnvState
    reward: torch.Tensor          # f32 [B, A]
    done: torch.Tensor            # bool [B] (pre-reset, ref bindings semantics)
    true_objective: torch.Tensor  # f32 [B, A] captured pre-reset (vector_env.cpp:96-103)


DEFERRED_RESET_FIELDS = (
    "cols", "vterrain", "vobj", "box_lo", "box_hi", "box_color", "props")


def env_step(
    scenario: Scenario,
    state: EnvState,
    next_scene: SceneData,
    action: torch.Tensor,     # int32 [B, A] bitmask
    shaping: torch.Tensor,    # f32 [B, A, K]
    defer_reset: bool = False,
) -> StepResult:
    """One tick of every env of the batch. No host synchronisation: every
    data-dependent choice is a masked select.

    The tick advances the state's voxel grids (`vobj`, `cols`) IN PLACE, as
    the reference's donated state does: `state` is consumed (pass a copy to
    keep it). With `defer_reset` the layout-copy leaves of the returned state
    are the input state's own tensors, for apply_deferred_resets to patch."""
    cfg = scenario.cfg
    dt = cfg.dt
    vlimit = cfg.param(C.P_VERTICAL_LOOK_LIMIT)

    # Controls (env.cpp:89-122).
    agents = P.apply_look(state.agents, action, dt, vlimit)
    agents = P.apply_acceleration(agents, action, dt)
    state = state.replace(agents=agents)

    # Scenario preStep (env.cpp:124).
    state = scenario.pre_physics(state, action)

    # Physics (env.cpp:126: bWorld.stepSimulation -> KCC playerStep per agent).
    # The packed solid-column grid is the state's canonical collision
    # representation (packed at generation time, updated incrementally by the
    # voxel-mutating scenarios).
    cols = state.cols
    obbs = scenario.collision_obbs(state)
    agents = K.physics_step(cfg.grid, state.agents, dt, cols, obbs)
    state = state.replace(agents=agents)

    # Scenario logic + rewards (env.cpp:131).
    state, reward = scenario.scen_step(state, action, shaping)

    # Timers (env.cpp:133-151). scen_step may have bumped episode_sec via
    # doneWithTimer semantics before the += dt.
    episode_sec = state.episode_sec + dt
    done = state.done | (episode_sec >= state.episode_len_sec)
    state = state.replace(
        episode_sec=episode_sec,
        done=done,
        last_reward=reward,
        total_reward=state.total_reward + reward,
        num_frames=state.num_frames + 1,
    )

    # Capture trueObjective before auto-reset (vector_env.cpp:94-103).
    true_objective = state.true_objective

    # Masked auto-reset from the pre-generated layout. With defer_reset the
    # leaves that are PURE COPIES of the layout (grids, box/prop tables) are
    # excluded from this per-env select: they pass through as the state's own
    # tensors, and the caller patches the done envs' rows afterwards with
    # apply_deferred_resets.
    rng = state.rng + 1
    fresh = state_from_scene(next_scene, cfg.num_agents, rng)
    if defer_reset:
        fresh = fresh.replace(
            **{f: getattr(state, f) for f in DEFERRED_RESET_FIELDS})
        dsf = scenario.deferred_scen_fields
        if dsf:
            fresh = fresh.replace(scen=fresh.scen.replace(
                **{k: getattr(state.scen, k) for k in dsf}))
    state = tree_select(done, fresh, state.replace(rng=rng))

    return StepResult(state, reward, done, true_objective)


def should_defer_reset(scenario) -> bool:
    """Whether a scenario takes the deferred auto-reset (the reference's
    rule): its layout-copy leaves are big enough (grids dominate; above 32 KB
    per env, estimated from static capacities) that copying only the done
    envs' rows beats the per-step full select."""
    cfg = scenario.cfg
    x, y, z = cfg.grid.dims
    cells = x * y * z
    approx = 4 * x * (-(-y // 32)) * z            # packed cols
    if cfg.needs_terrain_grid:
        approx += cells                            # vterrain u8
    if cfg.needs_object_grid:
        approx += 2 * cells                        # vobj i16
    approx += int(scenario.max_boxes) * 28         # box_lo/hi f32 + color
    approx += int(cfg.max_props) * 44              # PropState rows
    return approx > 32 * 1024


def deferred_leaves(tree, scen_fields: tuple = ()) -> list:
    """The layout-copy leaves of a state or of a SceneData, in a fixed
    order: those of DEFERRED_RESET_FIELDS, then of the scenario fields
    `scen_fields`."""
    out = []
    for f in DEFERRED_RESET_FIELDS:
        out += tree_leaves(getattr(tree, f))
    for k in scen_fields:
        out += tree_leaves(getattr(tree.scen, k))
    return out


def apply_deferred_resets(state, next_scenes, done, scen_fields: tuple = ()):
    """Completion of env_step(defer_reset=True): copy the layout-copy leaves
    (DEFERRED_RESET_FIELDS and the scenario's `scen_fields`) of the done envs
    from next_scenes INTO the state's tensors, and return the state.

    On a CUDA device one launch of the masked-copy kernel does it (the rows of
    envs that did not finish are never read, and nothing is read on the
    host); on the CPU its plain version, the inline select. Either way the
    result equals env_step's inline select: the copied values are exactly
    state_from_scene's passthrough of the scene fields."""
    MC.masked_copy_(deferred_leaves(state, scen_fields),
                    deferred_leaves(next_scenes, scen_fields), done)
    return state


class RenderView(NamedTuple):
    """The subset of EnvState the batched renderer reads (`scen`: for a
    scenario's render row mask, `Scenario.render_row_mask`)."""
    box_lo: torch.Tensor
    box_hi: torch.Tensor
    box_color: torch.Tensor
    props: PropState
    agents: AgentState
    episode_sec: torch.Tensor
    episode_len_sec: torch.Tensor
    last_reward: torch.Tensor
    scen: object = None

    def replace(self, **kw) -> "RenderView":
        return self._replace(**kw)


def render_view(states: EnvState) -> RenderView:
    return RenderView(
        box_lo=states.box_lo, box_hi=states.box_hi, box_color=states.box_color,
        props=states.props, agents=states.agents,
        episode_sec=states.episode_sec, episode_len_sec=states.episode_len_sec,
        last_reward=states.last_reward, scen=states.scen,
    )


def render_view_index(view: RenderView, idx: torch.Tensor) -> RenderView:
    """The envs `idx` (rows of the leading axis, repeats allowed) of a view."""
    return RenderView(*(tree_index(x, idx) for x in view))


@dataclasses.dataclass(frozen=True)
class RenderMode:
    """Which form of the render kernel `render_tables` prepares: the switches
    the reference reads from the environment in its `render_batch`, with the
    same meaning and defaults. An environment variable counts as set when it
    is non-empty."""
    mode: str = "bits"            # MEGAVERSE_RENDER_MODE: "bits" = bit-walk (B2)
    cluster_cull: bool = True     # MEGAVERSE_NO_CLUSTER_CULL clears it: unculled (B1)
    cluster_sort: bool = True     # MEGAVERSE_NO_CLUSTER_SORT: clusters in table order (B3)
    tile_cull: bool = True        # MEGAVERSE_NO_TILE_CULL: per-agent lists (B4)
    early_exit: bool = True       # MEGAVERSE_NO_EARLY_EXIT: per-agent lists, no dist (B4)
    superclusters: bool = True    # MEGAVERSE_NO_SUPERCLUSTERS: per-tile cluster lists (B4)
    merge_tiles: bool = False     # MEGAVERSE_MERGE_TILES: one block per frame (B6)
    pvs: bool = True              # MEGAVERSE_NO_PVS clears it: no scenario row mask in B2's cull

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "RenderMode":
        env = os.environ if environ is None else environ
        off = lambda name: not env.get(name)
        return cls(
            mode=env.get("MEGAVERSE_RENDER_MODE", "bits"),
            cluster_cull=off("MEGAVERSE_NO_CLUSTER_CULL"),
            cluster_sort=off("MEGAVERSE_NO_CLUSTER_SORT"),
            tile_cull=off("MEGAVERSE_NO_TILE_CULL"),
            early_exit=off("MEGAVERSE_NO_EARLY_EXIT"),
            superclusters=off("MEGAVERSE_NO_SUPERCLUSTERS"),
            merge_tiles=not off("MEGAVERSE_MERGE_TILES"),
            pvs=off("MEGAVERSE_NO_PVS"),
        )


UNCULLED = RenderMode(cluster_cull=False)


def row_cluster_mask(row_bits: torch.Tensor, keep, num_boxes: int,
                     num_rows: int) -> torch.Tensor:
    """A scenario's per-prop-row visibility bits bool [B, A, prop_cap] ->
    per-cluster bits bool [B, A, num_rows // CLUSTER_K] of a prim table of
    `num_rows` rows (padded to whole clusters). The bits are aligned with the
    table's rows: the box rows (always visible), the `keep` slices
    ((start, count), None for all rows) the prop tables got, then the agent
    rows and the cluster padding (visible)."""
    bsz, na = row_bits.shape[:2]
    ones = lambda n: torch.ones((bsz, na, n), dtype=torch.bool, device=row_bits.device)
    parts = [ones(num_boxes)]
    parts += ([row_bits] if keep is None else [row_bits[:, :, s:s + k] for s, k in keep])
    rb = torch.cat(parts, dim=2)
    rb = torch.cat([rb, ones(num_rows - rb.shape[2])], dim=2)
    return rb.reshape(bsz, na, -1, RC.CLUSTER_K).any(dim=-1)


def prim_rows(scenario: Scenario, states, bucket: Optional[tuple] = None):
    """The first stage of `render_tables`: (cams, prim table, the `keep`
    slices of the prop rows the table holds, box rows). See render_tables for
    `bucket`."""
    cfg = scenario.cfg
    segments = cfg.prop_segments
    box_lo, box_hi, box_color = states.box_lo, states.box_hi, states.box_color
    props = states.props
    # (start, count) slices of the full-capacity prop rows that the table
    # keeps; the scenario's per-row visibility bits get the same slices
    keep = None
    if bucket is not None:
        mb = max(1, min(int(bucket[0]), box_color.shape[1]))
        pb = bucket[1]
        if segments:
            # Per-segment live-prefix slicing: each typed region keeps only
            # its bucketed prefix.
            counts = [min(int(k), cap) for k, (_, _, cap) in zip(pb, segments)]
            keep = [(start, k) for (_, start, cap), k in zip(segments, counts) if k]
            if keep:
                props = tree_map(
                    lambda x: torch.cat([x[:, s:s + k] for s, k in keep], dim=1), props)
            else:
                props = tree_map(lambda x: x[:, :0], props)
        else:
            # pb == 0 is allowed: a scenario whose layouts never contain props
            # (Empty) renders zero prop rows.
            pb = max(0, min(int(pb), props.type.shape[1]))
            keep = [(0, pb)] if pb else []
            props = tree_map(lambda x: x[:, :pb], props)
        box_lo, box_hi, box_color = box_lo[:, :mb], box_hi[:, :mb], box_color[:, :mb]
    remaining = torch.clamp(
        (states.episode_len_sec - states.episode_sec) / states.episode_len_sec,
        min=0.0)  # [B]
    # Single-agent first-person views can never see the own body/eyes (camera
    # inside, inside hits culled): drop those rows from the table.
    include_agents = cfg.num_agents > 1
    cams = RC.build_cams(cfg, states.agents, remaining, states.last_reward)
    prims = RC.build_prim_table(cfg, box_lo, box_hi, box_color, props,
                                states.agents, include_agent_rows=include_agents)
    return cams, prims, keep, box_color.shape[1]


def bitwalk_clusters(scenario: Scenario, states, prims: torch.Tensor, keep, num_boxes: int,
                     pvs: bool = True):
    """The bit-walk's (B2's) tables before its per-tile cull, from
    `prim_rows`' output: (prims padded to whole superclusters, clusters with
    their superclusters, the PVS cluster mask or None)."""
    prims, clusters = RC.build_clusters(prims)
    clusters, _ = RC.build_superclusters(clusters)
    prims = RC.pad_prims_to_clusters(prims, clusters)
    row_bits = scenario.render_row_mask(states) if pvs else None
    cluster_mask = (None if row_bits is None else
                    row_cluster_mask(row_bits, keep, num_boxes, prims.shape[1]))
    return prims, clusters, cluster_mask


def render_tables(scenario: Scenario, states, bucket: Optional[tuple] = None,
                  mode: Optional[RenderMode] = None) -> dict:
    """Everything `raycast_cuda.render_packed` takes for a batch of states, as
    keyword arguments: cams, prims and the cull tables of the form that `mode`
    selects (default: `RenderMode.from_env()`, i.e. the bit-walk unless the
    environment says otherwise).

    bucket=(max_boxes, max_props): slice the per-env box/prop tables to the
    actual batch usage before building the table. Scenario capacities are
    worst-case, so rendering only the live prefix keeps the tables short.
    Correct because generation packs live rows first and padding rows are
    never activated at runtime (pos/scale/flags mutate; type never does)."""
    if mode is None:
        mode = RenderMode.from_env()
    cfg = scenario.cfg
    cams, prims, keep, num_boxes = prim_rows(scenario, states, bucket)
    ui_ind = float(cfg.params.get(C.P_USE_UI_REWARD_INDICATORS, 0.0)) > 0
    height, width = cfg.obs_height, cfg.obs_width
    tables = dict(cams=cams, ui_indicators=ui_ind, merge_tiles=mode.merge_tiles)
    if not mode.cluster_cull:
        return dict(tables, prims=prims)
    if mode.mode == "bits":
        # Bit-walk prologue: plain elementwise tensor code plus one small sort.
        prims, clusters, cluster_mask = bitwalk_clusters(scenario, states, prims, keep,
                                                         num_boxes, mode.pvs)
        sclist, clbits, scdist, cdist = RC.cull_bits(cams, clusters, height, width,
                                                     cluster_mask=cluster_mask)
        tables.update(sclist=sclist, clbits=clbits, scdist=scdist, cdist=cdist)
        return dict(tables, prims=prims.contiguous(), clusters=clusters.contiguous())
    prims, clusters = RC.build_clusters(prims)
    if not mode.cluster_sort:
        pass                                    # clusters in table order
    elif not (mode.tile_cull and mode.early_exit):
        # per-agent front-to-back order (per-tile lists require the early-exit
        # distance bounds)
        order, dist = RC.sort_clusters(cams, clusters)
        tables.update(order=order, dist=dist if mode.early_exit else None)
    elif not mode.superclusters or clusters.shape[1] < 2 * RC.SUPER_K:
        # per-tile frustum-culled front-to-back cluster lists: the kernel loop
        # only ever visits clusters that can affect its 8x128 pixel tile
        order, dist = RC.frustum_cull(cams, clusters, height, width)
        tables.update(order=order, dist=dist)
    else:
        # two-level: per-tile lists over SUPERclusters; the sorted lists
        # shrink by SUPER_K and the kernel prunes SUPER_K*CLUSTER_K rows per
        # slab test. Only the cluster table is padded, not the prim table.
        clusters, sclusters = RC.build_superclusters(clusters)
        order, dist = RC.frustum_cull(cams, sclusters, height, width)
        tables.update(order=order, dist=dist, sclusters=sclusters.contiguous())
    return dict(tables, prims=prims.contiguous(), clusters=clusters.contiguous())


def custom_camera_tables(scenario: Scenario, state, eye, yaw: float, pitch: float,
                         width: int = 2 * C.OBS_WIDTH, height: int = 2 * C.OBS_HEIGHT,
                         env: int = 0) -> dict:
    """The render kernel's inputs for `render_custom_camera` (cams [1, 1, 8],
    prims [1, M, 12], height, width), as keyword arguments of
    `raycast_cuda.render_packed`."""
    cfg = dataclasses.replace(scenario.cfg, obs_width=width, obs_height=height)
    one = lambda x: x[env:env + 1]
    dev = state.box_lo.device
    f32 = torch.float32
    prims = RC.build_prim_table(cfg, one(state.box_lo), one(state.box_hi),
                                one(state.box_color), tree_map(one, state.props),
                                tree_map(one, state.agents))
    eye = torch.as_tensor(eye, dtype=f32, device=dev).reshape(1, 1, 3)
    offset = torch.tensor([0.0, C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y, 0.0],
                          dtype=f32, device=dev)
    cam_agent = AgentState.create(1, 1, device=dev).replace(
        pos=eye - offset,
        yaw=torch.full((1, 1), float(yaw), dtype=f32, device=dev),
        pitch=torch.full((1, 1), float(pitch), dtype=f32, device=dev))
    cams = RC.build_cams(cfg, cam_agent, torch.ones((1,), dtype=f32, device=dev))
    return dict(cams=cams, prims=prims.contiguous(), height=height, width=width)


def render_custom_camera(scenario: Scenario, state, eye, yaw: float, pitch: float,
                         width: int = 2 * C.OBS_WIDTH, height: int = 2 * C.OBS_HEIGHT,
                         env: int = 0) -> torch.Tensor:
    """Free-camera / hires render of ONE env -> uint8 [height, width, 3] on
    the state's device (counterpart of megaverse_tpu/env.py
    render_custom_camera; the reference's overview camera and hires chained
    renderer, render_utils.cpp Overview, megaverse.cpp:154-201): the same
    scene content, any camera, any resolution. `state` is a batched EnvState
    and `env` the index of the env to draw.

    The table keeps the agents' rows (the camera is outside them), the HUD
    time bar is full (remaining 1.0) and no reward indicator is drawn, as in
    the reference. On a CUDA device the image comes from the render kernel's
    unculled form B1 (no cull tables; any H x W); on the CPU from its plain
    version."""
    tables = custom_camera_tables(scenario, state, eye, yaw, pitch, width, height, env)
    return RC.unpack_rgb(RC.render_packed(**tables))[0, 0]


def render_batch(scenario: Scenario, states, fmt: str = "rgb",
                 bucket: Optional[tuple] = None,
                 mode: Optional[RenderMode] = None) -> torch.Tensor:
    """Observations for a BATCH of envs (post-reset frame for done envs,
    matching vector_env.cpp:94-107 draw ordering).

    fmt="rgb": uint8 [B, A, H, W, 3]. fmt="packed": int32 [B, A, H, W] with
    RGB in the low 24 bits, the on-device format. The whole env x agent camera
    batch renders in ONE kernel launch (the analogue of the reference's single
    batched Vulkan submission, v4r_env_renderer.cpp:338-355): the bit-walk form
    by default, any other form by `mode` (see RenderMode; every form gives the
    same image). Every scenario goes through the kernel on a CUDA device and
    through its plain PyTorch version on the CPU."""
    cfg = scenario.cfg
    tables = render_tables(scenario, states, bucket=bucket, mode=mode)
    packed = RC.render_packed(height=cfg.obs_height, width=cfg.obs_width, **tables)
    if fmt == "packed":
        return packed
    return RC.unpack_rgb(packed)
