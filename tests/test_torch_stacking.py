"""The object-stacking kernel's wrapper (ops/stacking.py) and its plain version.

The kernel (csrc/stacking.cu) runs only on the card, where chip_smoke.py holds
it bit for bit against its plain version. Here: on the CPU
`object_stacking_step` is the plain version and loads no library; the plain
batched loop equals a scalar walk of one env at a time and one agent at a
time (the kernel's own order); the place zone reproduces both scenes' old
placement tests; the wrapper refuses what the kernel does not take; the
launch counter has the kernel; the source exports what the wrapper binds,
and its constant table matches the wrapper's field for field. No JAX: the
plain version is held against the JAX package by the scenes' port tests.
"""

import inspect
import re

import numpy as np
import pytest
import torch

import megaverse_tpu_torch.constants as C
from megaverse_tpu_torch.ops import grid as G
from megaverse_tpu_torch.ops import raycast_cuda as RC
from megaverse_tpu_torch.ops import stacking as S
from megaverse_tpu_torch.scenarios import components as SC
from megaverse_tpu_torch.scenarios import make_scenario
from megaverse_tpu_torch.scenarios.rearrange import PLACE_ZONE, RIGHT
from megaverse_tpu_torch.types import (
    PROP_FLAG_SOLID, scene_to_device, stack_scenes, state_from_scene)

torch.set_num_threads(1)

B = 3


def tower(num_agents: int, seed: int):
    """TowerBuilding layouts of B envs, each agent put in front of a box with
    nothing on top of it (a pick), the last agent of env 0 where the first
    one's box would land again (a blocked place), some agents turned away."""
    sc = make_scenario("TowerBuilding", num_agents=num_agents)
    rng = np.random.default_rng(seed)
    scene = stack_scenes([sc.generate(np.random.default_rng(seed + b)) for b in range(B)])
    state = state_from_scene(scene_to_device(scene, "cpu"), num_agents,
                             torch.zeros((B,), dtype=torch.int64))
    vobj = state.vobj.numpy()
    pos = state.agents.pos.numpy().copy()
    yaw = np.where(rng.random((B, num_agents)) < 0.2, 1.3, 0.0).astype(np.float32)
    for b in range(B):
        free = np.argwhere((vobj[b] != 0) & (np.roll(vobj[b], -1, axis=1) == 0))
        for a, i in enumerate(rng.choice(len(free), num_agents, replace=False)):
            x, y, z = free[i]
            # the pickup spot (0, 0.02, -1) from the body at yaw 0, pitch 0
            pos[b, a] = (x + 0.5, y + 0.48, z + 1.5)
    if num_agents > 1:
        pos[0, -1] = pos[0, 0] + (0.0, 0.0, -1.0)
    agents = state.agents.replace(pos=torch.from_numpy(pos), yaw=torch.from_numpy(yaw),
                                  pitch=torch.zeros_like(state.agents.pitch))
    return sc, state.replace(agents=agents)


def one_at_a_time(cfg, state, action, zone, max_drop=16):
    """The kernel's walk in plain Python: env by env, agent by agent, each
    agent's place (tests, gravity settle), pick (two voxels up) and the
    carried props' move, on numpy copies. The float anchors and voxels are
    the batched functions' (the agents do not move during stacking)."""
    body = torch.tensor([0.0, C.AGENT_BODY_OFFSET_Y, 0.0])
    standing = G.world_to_voxel(cfg, state.agents.pos + body).numpy()
    spot = G.world_to_voxel(cfg, SC.pickup_spot(state.agents)).numpy()
    anchor = SC.carry_anchor(state.agents).numpy()
    vobj = state.vobj.numpy().copy()
    nx, ny, nz = cfg.dims
    words = state.cols.numpy().view(np.uint32)
    solid = ((words[:, :, np.arange(ny) // 32, :] >> (np.arange(ny) % 32)[:, None]) & 1) != 0
    pos, scale = state.props.pos.numpy().copy(), state.props.scale.numpy().copy()
    flags, carried = state.props.flags.numpy().copy(), state.agents.carried.numpy().copy()
    b_, a_ = carried.shape
    picked, placed = np.zeros((b_, a_), bool), np.zeros((b_, a_), bool)
    place_voxel = np.zeros((b_, a_, 3), np.int32)
    inside = lambda x, y, z: 0 <= x < nx and 0 <= y < ny and 0 <= z < nz
    empty = lambda b, x, y, z: not inside(x, y, z) or (not solid[b, x, y, z]
                                                         and vobj[b, x, y, z] == 0)
    for b in range(b_):
        for a in range(a_):
            interact = (action[b, a] & C.ACTION_INTERACT) != 0
            held = int(carried[b, a])
            if held >= 0 or a_ == 1:
                pv = G.world_to_voxel(cfg, torch.from_numpy(pos[b, max(held, 0)])).numpy()
                x, y, z = (int(v) for v in pv)
                ok = (interact and held >= 0 and inside(x, y, z) and empty(b, x, y, z)
                      and not any((standing[b, j] == pv).all() for j in range(a_) if j != a)
                      and (zone is None or zone[b, 0] <= x < zone[b, 1]
                           and zone[b, 2] <= z < zone[b, 3]))
                fall = 0
                while fall < max_drop and y - fall - 1 >= 0 and empty(b, x, y - fall - 1, z):
                    fall += 1
                if ok or a_ == 1:
                    place_voxel[b, a] = (x, y - fall, z)
                if ok:
                    y -= fall
                    pos[b, held] = G.voxel_center(cfg, torch.tensor([x, y, z])).numpy()
                    scale[b, held] = scale[b, held] / np.float32(C.CARRYING_SCALE)
                    flags[b, held] |= PROP_FLAG_SOLID
                    vobj[b, x, y, z], solid[b, x, y, z] = held + 1, True
                    carried[b, a], placed[b, a] = -1, True
            if interact and held < 0:
                x, y, z = (int(v) for v in spot[b, a])
                slot = lambda y: vobj[b, x, y, z] if inside(x, y, z) else 0
                for h in (0, 1):
                    if slot(y + h) != 0 and slot(y + h + 1) == 0:
                        got = int(slot(y + h)) - 1
                        scale[b, got] = scale[b, got] * np.float32(C.CARRYING_SCALE)
                        flags[b, got] &= 0xFF ^ PROP_FLAG_SOLID
                        vobj[b, x, y + h, z], solid[b, x, y + h, z] = 0, False
                        carried[b, a], picked[b, a] = got, True
                        break
            for j in range(a_):
                if carried[b, j] >= 0:
                    pos[b, carried[b, j]] = anchor[b, j]
    vtype = np.where(solid, C.VOXEL_SOLID, 0).astype(np.uint8)
    cols = np.stack([G.pack_solid_columns_np(v) for v in vtype])
    return dict(vobj=vobj, cols=cols, pos=pos, scale=scale, flags=flags, carried=carried,
                picked=picked, placed=placed, place_voxel=place_voxel)


@pytest.mark.parametrize("num_agents", [1, 4])
def test_plain_loop_equals_the_agents_one_at_a_time(monkeypatch, num_agents):
    def refuse():
        raise AssertionError("the stacking library was loaded for a CPU tick")

    monkeypatch.setattr(S, "load_library", refuse)
    sc, state = tower(num_agents, seed=7 + num_agents)
    cfg = sc.cfg.grid
    rng = np.random.default_rng(num_agents)
    # one agent a world: a zone repeated over the batch (Rearrange's form);
    # four: the scene's zones, but env 1's spans the grid
    wide = torch.tensor([[0, 1000, 0, 1000]], dtype=torch.int32)
    zone = torch.cat([state.scen.zone[:1], wide, state.scen.zone[2:]]) if num_agents > 1 \
        else wide.expand(B, 4)
    seen = np.zeros(2, int)
    for tick in range(3):
        action = np.where(rng.random((B, num_agents)) < 0.85, C.ACTION_INTERACT, 0)
        action = torch.from_numpy(action.astype(np.int32))
        want = one_at_a_time(cfg, state, action.numpy(), zone.numpy())
        launches = dict(RC.LAUNCHES)
        res = SC.object_stacking_step(cfg, state, action, place_zone=zone)
        assert RC.LAUNCHES == launches
        st = res.state
        got = dict(vobj=st.vobj, cols=st.cols, pos=st.props.pos, scale=st.props.scale,
                   flags=st.props.flags, carried=st.agents.carried, picked=res.picked,
                   placed=res.placed, place_voxel=res.place_voxel)
        for k, v in want.items():
            g = got[k].numpy()
            np.testing.assert_array_equal(g.view(np.uint32) if k == "cols" else g, v,
                                          err_msg=f"tick {tick} {k}")
        seen += (int(res.picked.sum()), int(res.placed.sum()))
        state = st
    assert seen.min() > 0, seen   # both picks and places happened


def test_place_zone_reproduces_the_scenes_placement_tests():
    grid = np.stack(np.meshgrid(np.arange(-4, 24), [0, 3], np.arange(-4, 24), indexing="ij"),
                    -1).reshape(1, -1, 3)
    voxel = torch.from_numpy(grid.astype(np.int32))
    zone = torch.tensor([[5, 12, 4, 11]], dtype=torch.int32)
    z = zone[:, None, :]
    building = ((voxel[..., 0] >= z[..., 0]) & (voxel[..., 0] < z[..., 1])
                & (voxel[..., 2] >= z[..., 2]) & (voxel[..., 2] < z[..., 3]))
    assert torch.equal(SC.in_zone_xz(zone, voxel), building) and building.any()
    delta = voxel - torch.from_numpy(RIGHT.astype(np.int32))
    pedestal = (delta[..., 0].abs() <= 2) & (delta[..., 2].abs() <= 2)
    rows = torch.tensor([PLACE_ZONE], dtype=torch.int32)
    assert torch.equal(SC.in_zone_xz(rows, voxel), pedestal) and pedestal.sum() == 25 * 2


def _bad_inputs(case: str):
    sc, state = tower(2, seed=3)
    action = torch.full((B, 2), C.ACTION_INTERACT, dtype=torch.int32)
    zone = state.scen.zone
    if case == "dtype":
        return sc, state, action.long(), zone, "action"
    if case == "shape":
        return sc, state.replace(cols=state.cols[:, :, :, :-1]), action, zone, "cols"
    if case == "device":
        return sc, state.replace(vobj=state.vobj.to("meta")), action, zone, "vobj"
    if case == "none":
        return sc, state, action, zone, ""
    scale = state.props.scale.transpose(0, 1).contiguous().transpose(0, 1)
    return sc, state.replace(props=state.props.replace(scale=scale)), action, zone, "scale"


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "non_contiguous"])
def test_stacking_step_refuses_what_the_kernel_does_not_take(case):
    sc, state, action, zone, name = _bad_inputs(case)
    launches = dict(RC.LAUNCHES)
    with pytest.raises(ValueError, match=name):
        S.stacking_step(sc.cfg.grid, state, action, zone)
    if case == "device":    # right in every other way, but not on the card
        sc, state, action, zone, _ = _bad_inputs("none")
        with pytest.raises(ValueError, match="CUDA"):
            S.stacking_step(sc.cfg.grid, state, action, zone)
    if case == "non_contiguous":    # a zone of rows 8 ints apart
        sc, state, action, _, _ = _bad_inputs("none")
        wide = torch.zeros((B, 8), dtype=torch.int32)[:, :4]
        with pytest.raises(ValueError, match="place_zone"):
            S.stacking_step(sc.cfg.grid, state, action, wide)
    assert RC.LAUNCHES == launches


def test_launch_counter_and_the_bound_symbols():
    assert "stacking" in RC.LAUNCHES and "stacking" not in RC.FORMS
    saved = dict(RC.LAUNCHES)
    try:
        RC.LAUNCHES["stacking"] = 5
        RC.reset_launch_counts()
        assert RC.LAUNCHES["stacking"] == 0
    finally:
        RC.LAUNCHES.update(saved)
    source = (RC.CSRC_DIR / "stacking.cu").read_text()
    exported = source[source.index('extern "C" {'):]
    names = set(re.findall(r"^int (mv_\w+)\(", exported, flags=re.M))
    bound = set(re.findall(r"\blib\.(mv_\w+)", inspect.getsource(S.load_library)))
    assert bound and bound == names
    # the Consts struct, field for field and type for type
    body = source[source.index("struct Consts {"):]
    body = re.sub(r"//[^\n]*", "", body[:body.index("};")])
    fields = [(name, ctype) for ctype, group in re.findall(r"\b(int|float) ([\w, ]+);", body)
              for name in re.split(r",\s*", group)]
    kind = {ctypes_t: c for c, ctypes_t in (("int", "c_int"), ("float", "c_float"))}
    assert fields == [(n, kind[t.__name__]) for n, t in S.Consts._fields_]
