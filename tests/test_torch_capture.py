"""The one-program tick of the port (megaverse_tpu_torch/capture.py) on the
CPU: what a CUDA graph needs of it, and the in-place pieces it is built from,
held against the JAX package.

- A tick (`capture.tick`: env_step, the deferred reset, the write-back;
  then `render_tables`, the cull prologue in front of the render kernel,
  whose plain CPU stand-in is not what the card runs) of every one of the 16
  scenes, after two warm ticks, issues
  no host-made tensor and no scalar read (no `lift_fresh`,
  `_local_scalar_dense`, `item`, `nonzero`, `is_nonzero`): on a CUDA device
  each would be a blocking copy, and none is allowed inside a capture.
- `set_voxel` / `update_cols` write only the cells they name, in the grid
  they are given, and equal megaverse_tpu.ops.grid's on kept, dropped,
  out-of-bounds and colliding rows (a dropped row whose clamped cell is a
  kept row's cell).
- The in-place refill (`types.tree_scatter_`) equals the out-of-place
  `tree_scatter` of the same slots, sentinel padding included.
- The deferred reset's masked copy (its plain version, the CPU path of
  `env.apply_deferred_resets`) equals megaverse_tpu.env.apply_deferred_resets
  on the same TowerBuilding states, for none, some and all envs done.
- `VectorEnv` keeps its state in buffers whose addresses stay across ticks
  and refills, hands out tensors that alias none of them, and copies a state
  assigned anew into fresh buffers.
- The render's cached device constants keep their tensors while 20 other
  frame sizes are made: a captured graph holds their addresses.

2 envs, 2 agents, 24 px. The scene walk uses no JAX; one module-scoped
fixture holds the JAX side of the deferred reset. Equal means bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import megaverse_tpu.constants as C
from megaverse_tpu.env import apply_deferred_resets as j_apply_deferred_resets
from megaverse_tpu.ops import grid as JG
from megaverse_tpu.types import GridConfig as JGridConfig
from megaverse_tpu.types import PropState as JPropState
from megaverse_tpu.types import SceneData as JSceneData

from megaverse_tpu_torch import VectorEnv as TVectorEnv
from megaverse_tpu_torch import capture, convert
from megaverse_tpu_torch import env as TE
from megaverse_tpu_torch.ops import grid as TG
from megaverse_tpu_torch.ops import raycast_cuda as TRC
from megaverse_tpu_torch.scenarios import registered_scenarios
from megaverse_tpu_torch.types import (GridConfig as TGridConfig, tree_leaves, tree_map,
                                       tree_scatter, tree_scatter_)
from megaverse_tpu_torch.vector_env import refill_slot_rung

import torch_port_checks  # noqa: F401  (one intra-op torch thread)

B, A, H = 2, 2, 24
BANNED = {"lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "item", "nonzero",
          "is_nonzero"}


class Banned(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in BANNED:
            self.seen.append(func.__name__)
        return func(*args, **(kwargs or {}))


def small_env(name, num_envs=B, seed=3, render=True):
    env = TVectorEnv(name, num_envs=num_envs, num_agents_per_env=A, seed=seed,
                     render=render, device="cpu")
    env.scenario.cfg = dataclasses.replace(env.scenario.cfg, obs_height=H)
    env.reset()
    return env


def test_tick_issues_no_host_round_trip():
    """Every scene: a tick, after two warm ones (the cached constants are
    made on the first), dispatches none of the banned ops."""
    rng = np.random.default_rng(0)
    names = registered_scenarios()
    assert len(names) == 16
    found = {}
    for name in names:
        env = small_env(name)
        try:
            for _ in range(2):
                env.step(rng.integers(0, 2048, size=(B, A)).astype(np.int32))
            act = torch.from_numpy(rng.integers(0, 2048, size=(B, A)).astype(np.int32))
            with Banned() as mode:
                capture.tick(env.scenario, env.state, env.next_scenes, act, env.shaping,
                             render=False)
                TE.render_tables(env.scenario, env.state, bucket=env._bucket,
                                 mode=env.render_mode)
            if mode.seen:
                found[name] = sorted(set(mode.seen))
        finally:
            env.close()
    assert not found, found


def grid_case(seed):
    """A [2, 12, 40, 12] world and coords [2, 8, 3]: kept rows (one at the
    top bit of a word, one at the far corner), rows dropped below (-1, which
    clamps onto the kept corner (0, 0, 0)) and above the grid (clamping onto
    the far corner), all kept cells distinct."""
    dims, origin = (12, 40, 12), (-2.0, -3.0, -2.0)
    rng = np.random.default_rng(seed)
    vt = (rng.random((2,) + dims) < 0.3).astype(np.uint8) * C.VOXEL_SOLID
    ii = np.array([[[0, 0, 0], [3, 31, 4], [3, 30, 4], [11, 39, 11],
                    [-1, -1, -1], [12, 40, 12], [5, 2, 7], [-1, 5, 6]]] * 2, np.int32)
    ii[1, 6] = [6, 33, 1]
    return (JGridConfig(dims=dims, voxel_size=1.0, origin=origin),
            TGridConfig(dims=dims, voxel_size=1.0, origin=origin), vt, ii)


@pytest.mark.parametrize("grid", ["vobj", "vterrain"])
def test_set_voxel_in_place_matches_jax(grid):
    jcfg, tcfg, vt, ii = grid_case(1)
    dtype = np.int16 if grid == "vobj" else np.uint8
    field = (vt.astype(dtype) * 3) + 1
    value = (np.arange(16, dtype=dtype).reshape(2, 8) + 7)
    want = np.stack([np.asarray(JG.set_voxel(jcfg, jnp.asarray(field[b]), jnp.asarray(ii[b]),
                                             jnp.asarray(value[b]))) for b in range(2)])
    t = torch.from_numpy(field.copy())
    ptr = t.data_ptr()
    got = TG.set_voxel(tcfg, t, torch.from_numpy(ii), torch.from_numpy(value))
    assert got is t and got.data_ptr() == ptr
    np.testing.assert_array_equal(got.numpy(), want)
    # kept cells took their row's value; the dropped rows changed nothing
    assert got[0, 0, 0, 0] == value[0, 0] and got[0, 11, 39, 11] == value[0, 3]
    assert int((got.numpy() != field).sum()) <= 2 * 5
    # a scalar value
    t2 = torch.from_numpy(field.copy())
    want2 = np.stack([np.asarray(JG.set_voxel(jcfg, jnp.asarray(field[b]), jnp.asarray(ii[b]), 0))
                      for b in range(2)])
    np.testing.assert_array_equal(TG.set_voxel(tcfg, t2, torch.from_numpy(ii), 0).numpy(), want2)


@pytest.mark.parametrize("solid", [True, False])
def test_update_cols_in_place_matches_jax(solid):
    jcfg, tcfg, vt, ii = grid_case(2)
    cols = np.stack([TG.pack_solid_columns_np(v) for v in vt])
    want = np.stack([np.asarray(JG.update_cols(jcfg, jnp.asarray(cols[b].view(np.uint32)),
                                               jnp.asarray(ii[b]), solid)) for b in range(2)])
    t = torch.from_numpy(cols.copy())
    got = TG.update_cols(tcfg, t, torch.from_numpy(ii), solid)
    assert got is t
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_in_place_refill_equals_tree_scatter():
    """The refill's slot ladder: 3 real slots padded with a sentinel (index
    num_envs) to the ladder's 4, scattered in place into the bound buffer and
    out of place into a copy."""
    env = small_env("TowerBuilding", num_envs=4, render=False)
    try:
        idx = np.array([2, 0, 3])
        slots = refill_slot_rung(idx.size, env.num_envs)
        new = env._generate_batch(idx.tolist(), pad_to=slots)
        slot_idx = np.concatenate([idx, np.full((slots - idx.size,), env.num_envs)])
        want = tree_scatter(tree_map(torch.clone, env.next_scenes),
                            torch.from_numpy(slot_idx), new)
        before = [x.data_ptr() for x in tree_leaves(env.next_scenes)]
        out = tree_scatter_(env.next_scenes, slot_idx, new)
        assert out is env.next_scenes
        assert [x.data_ptr() for x in tree_leaves(env.next_scenes)] == before
        for a, b in zip(tree_leaves(env.next_scenes), tree_leaves(want)):
            assert torch.equal(a, b)
        assert torch.equal(env.next_scenes.vobj[1], want.vobj[1])
    finally:
        env.close()


@pytest.fixture(scope="module")
def deferred_case():
    """A TowerBuilding batch of 6 after 4 random ticks, its buffered layouts,
    and the JAX package's apply_deferred_resets for three done patterns."""
    env = small_env("TowerBuilding", num_envs=6, seed=5, render=False)
    rng = np.random.default_rng(1)
    for _ in range(4):
        env.step(rng.integers(0, 2048, size=(6, A)).astype(np.int32))

    def jscene(tree):
        t = convert.tree_to_numpy(tree)
        props = JPropState(**{k: jnp.asarray(v) for k, v in t["props"].items()})
        fields = {f: jnp.asarray(t[f]) for f in TE.DEFERRED_RESET_FIELDS if f != "props"}
        zeros = jnp.zeros((6,), jnp.float32)
        return JSceneData(props=props, agent_spawn=zeros, agent_yaw=zeros,
                          episode_len_sec=zeros, scen=None, **fields)

    dones = {"none": np.zeros(6, bool), "some": np.array([0, 1, 0, 0, 1, 1], bool),
             "all": np.ones(6, bool)}
    jstate, jnext = jscene(env.state), jscene(env.next_scenes)
    # 4 slots: the JAX package's K-slot scatter for "some", its full
    # select for "all"
    want = {k: convert.to_numpy_tree(j_apply_deferred_resets(jstate, jnext, jnp.asarray(d),
                                                              max_slots=4))
            for k, d in dones.items()}
    yield env, dones, want
    env.close()


@pytest.mark.parametrize("pattern", ["none", "some", "all"])
def test_deferred_reset_matches_jax(deferred_case, pattern):
    env, dones, want = deferred_case
    state = tree_map(torch.clone, env.state)
    out = TE.apply_deferred_resets(state, env.next_scenes, torch.from_numpy(dones[pattern]))
    assert out is state
    got = convert.tree_to_numpy(state)
    for f in TE.DEFERRED_RESET_FIELDS:
        torch_port_checks.assert_trees_equal(got[f], want[pattern][f], f)


def test_vector_env_keeps_its_buffers():
    env = small_env("Collect", render=True)
    try:
        ptrs = lambda: [x.data_ptr() for x in tree_leaves(env.state)]
        leaves = tree_leaves(env.state)
        # no two leaves of the bound state share storage
        assert len({x.untyped_storage().data_ptr() for x in leaves}) == len(leaves)
        before = ptrs()
        act = np.full((B, A), C.ACTION_FORWARD | C.ACTION_INTERACT, np.int32)
        obs, rew, done, tobj = env.step(act)
        pool = np.random.default_rng(2).integers(0, 2048, (4, B, A)).astype(np.int32)
        last, dones, _ = env.step_many(pool, 3)
        env.flush()
        assert ptrs() == before
        held = {x.untyped_storage().data_ptr() for x in leaves}
        for x in (obs, rew, done, tobj, last, *dones):
            assert x.untyped_storage().data_ptr() not in held
        # a state assigned anew is copied into new buffers at the next tick,
        # and the assigned tensors are left as they were
        pos = env.state.agents.pos.clone()
        env.state = env.state.replace(agents=env.state.agents.replace(pos=pos))
        kept = pos.clone()
        env.step(act)
        assert env.state.agents.pos is not pos and torch.equal(pos, kept)
    finally:
        env.close()


def test_render_constants_outlive_other_frame_sizes():
    """A replay reads the render constants of its frame size by address and
    never calls the cache, so no number of other sizes (the free camera
    renders at any) may evict them."""
    def held():
        return (TRC._device_constants(H, 128, "cpu"),
                *TRC._tile_dir_bounds_on(H, 128, TRC.TILE_H, TRC.TILE_W, "cpu"),
                TRC._packed_palette("cpu"))

    first = held()
    for i in range(1, 21):
        h, w = H + 8 * i, 128 + 32 * i
        TRC._device_constants(h, w, "cpu")
        TRC._tile_dir_bounds_on(h, w, TRC.TILE_H, TRC.TILE_W, "cpu")
    assert all(a is b for a, b in zip(first, held()))
