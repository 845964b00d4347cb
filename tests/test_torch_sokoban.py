"""Sokoban through the port vs the JAX package on the CPU.

Layouts from the same seed are EQUAL leaf for leaf in both rng modes (the
procedural Boxoban generator; the dataset is not needed). The reference-stream
golden trace of tests/test_refrng_scenarios.py (SOKO_GOLD: level-cache refill,
back-pop order, floor colour, spawn yaws on an injected fake level source) is
held against the port. A 30-tick scripted run (2 envs x 2 agents; env 0
pushes a box, env 1 pushes the last box onto its goal and solves; env 0
forced through an auto-reset) is stepped through both `VectorEnv`s with the
tolerances of tests/torch_port_checks.py. The behaviour tests mirror
tests/test_scenarios.py's push of one cell and same-tick sequential pushes on
the port's own step.
"""

import numpy as np
import pytest
import torch

import megaverse_tpu.constants as C

from megaverse_tpu_torch import VectorEnv as TVectorEnv
from megaverse_tpu_torch import convert
from megaverse_tpu_torch.ops import grid as G
from megaverse_tpu_torch.scenarios import make_scenario as t_make_scenario
from megaverse_tpu_torch.scenarios.components import pickup_spot
from megaverse_tpu_torch.scenarios.sokoban import (
    _FLOOR_COLORS, MAX_SOKO_BOXES, SIZE, VOXEL, SokobanState)
from megaverse_tpu_torch.utils.boxoban import LevelSource
from megaverse_tpu_torch.utils.refrng import (
    Rng as TRng, episode_reseed as t_episode_reseed, fan_out_env_seeds,
    ref_spawn_yaw as t_ref_spawn_yaw)

import torch_port_checks as K
from test_refrng_scenarios import SOKO_GOLD, _SOKO_LEVELS

SEED = 3
PUSHED = {}   # env -> (prop row, x, z) of the box that prepare() sets up


@pytest.mark.parametrize("mode", ["numpy", "reference"])
@pytest.mark.parametrize("agents", [1, 2])
def test_layouts_equal_leaf_for_leaf(agents, mode):
    K.assert_layouts_equal("Sokoban", agents, mode, n=4)


def _fake_source():
    """The port's LevelSource with tests/test_refrng_scenarios.py's injected
    parse hook: 1000 file names, each parsing to the three synthetic levels."""
    src = LevelSource.__new__(LevelSource)
    src.files = [f"{i:03d}.txt" for i in range(1000)]
    picked = []

    def parse(path):
        picked.append(path)
        return [list(lv) for lv in _SOKO_LEVELS]

    src._parse = parse
    return src, picked


def test_sokoban_reference_stream_draws():
    """tests/test_refrng_scenarios.py::test_sokoban_reference_stream_draws
    against the port: cache refill, back-pop order, floor colour and yaws
    across 4 resets with a mid-stream refill."""
    src, picked = _fake_source()
    rng = TRng(7)
    for seed, file_idx, level_id, floor_idx, yaws in SOKO_GOLD:
        assert t_episode_reseed(rng) == seed
        rows = src.sample_ref(rng)
        if file_idx is not None:
            assert picked.pop() == f"{file_idx:03d}.txt"
        assert not picked
        assert rows == _SOKO_LEVELS[level_id]
        assert rng.rand_range(0, 5) == floor_idx
        got = [t_ref_spawn_yaw(rng) for _ in range(2)]
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(yaws, np.float32))


def test_sokoban_reference_stream_layout():
    """generate_ref end to end on the fake source: golden floor colour, yaws
    and box count; the second reset pops the next level of the cache that
    hangs off the same Rng object."""
    sc = t_make_scenario("Sokoban", num_agents=2)
    sc._levels, _ = _fake_source()
    rng = TRng(7)
    for k in range(2):
        seed, _file, level_id, floor_idx, yaws = SOKO_GOLD[k]
        assert t_episode_reseed(rng) == seed
        scene = sc.generate_ref(rng)
        assert int(scene.scen.num_boxes) == level_id + 1
        assert _FLOOR_COLORS[floor_idx] in scene.box_color
        np.testing.assert_array_equal(np.asarray(scene.agent_yaw, np.float32),
                                      np.asarray(yaws, np.float32))
    assert len(rng.soko_level_cache) == 1


def test_vector_env_reference_mode_pops_successive_levels():
    """In reference mode each env's level cache hangs off that env's own
    persistent Rng, so its successive resets pop successive levels of one
    shuffled file (scenario_sokoban.cpp:104-118) instead of drawing a new
    file each time: the state's and the layout buffer's levels are the
    first two pops of a by-hand replay of the env's seed chain."""
    env = TVectorEnv("Sokoban", num_envs=2, num_agents_per_env=1, seed=42, render=False,
                     device="cpu", rng_mode="reference")
    env.scenario._levels, picked = _fake_source()
    env.reset()
    env.close()
    for i, seed in enumerate(fan_out_env_seeds(42, 2)):
        rng = TRng(seed)
        boxes = []
        for _ in range(2):
            t_episode_reseed(rng)
            boxes.append(int(env.scenario.generate_ref(rng).scen.num_boxes))
        assert hasattr(env._gens[i], "soko_level_cache")
        assert int(env.state.scen.num_boxes[i]) == boxes[0]
        assert int(env.next_scenes.scen.num_boxes[i]) == boxes[1]
    assert len(picked) == 2 * 2, "one file drawn per env and replay, none per reset"


def _pushable(st, b):
    """(prop row, box cell x, z) of the first box of env b that an agent on
    its -x side can push one cell along +x."""
    vobj, wall = st["vobj"][b], st["scen"]["wall"][b]
    for p in range(MAX_SOKO_BOXES):
        cells = np.argwhere(vobj == p + 1)
        if not len(cells):
            break
        x, _, z = cells[0]
        if 1 <= x < SIZE - 1 and not (wall[x - 1, z] or wall[x + 1, z]) \
                and vobj[x - 1, 1, z] == 0 and vobj[x + 1, 1, z] == 0:
            return p, x, z
    raise AssertionError(f"env {b}: no box pushable along +x")


def prepare(jenv, tenv):
    """Agent 0 of each env stands on the -x side of a pushable box facing +x
    (its tick-0 Interact pushes it). In env 1 the goals are rewritten so that
    every other box already stands on one and the pushed box's destination is
    the last: that push solves the level."""
    st = convert.to_numpy_tree(jenv.state)
    pos, yaw = st["agents"]["pos"].copy(), st["agents"]["yaw"].copy()
    goal = st["scen"]["goal"].copy()
    on_goal = st["scen"]["boxes_on_goal"].copy()
    for b in range(2):
        p, x, z = PUSHED[b] = _pushable(st, b)
        pos[b, 0] = [(x - 1 + 0.5) * VOXEL, VOXEL + C.AGENT_HALF_HEIGHT, (z + 0.5) * VOXEL]
        yaw[b, 0] = -np.pi / 2
        if b == 1:
            goal[1] = False
            for cx, _, cz in np.argwhere(st["vobj"][1] > 0):
                goal[1, cx, cz] = (cx, cz) != (x, z)
            goal[1, x + 1, z] = True
            on_goal[1] = st["scen"]["num_boxes"][1] - 1
    K.set_agents(jenv, tenv, pos=pos, yaw=yaw)
    K.set_scen(jenv, tenv, goal=goal, boxes_on_goal=on_goal)


@pytest.fixture(scope="module")
def scripted():
    run = K.scripted_pair("Sokoban", SEED, prepare)
    yield run
    run["jenv"].close()
    run["tenv"].close()


def test_scripted_run_matches_tick_by_tick(scripted):
    # env 0's forced time-out, env 1's solve (doneWithTimer: 0.3 s later)
    assert K.assert_logs_match(scripted) == 2


def test_scripted_run_exercises_the_scenario(scripted):
    """The run pushed a box in each env at tick 0, paid the goal and solve
    rewards in env 1 and ended its episode (so the equalities are not
    vacuous)."""
    tlog = scripted["tlog"]
    first = tlog[0]
    assert first["reward"][0].sum() == 0.0
    # env 1: box onto the last goal (+1) and the level solved (+10)
    np.testing.assert_allclose(first["reward"][1], [11.0, 0.0])
    assert first["state"]["scen"]["solved"][1] and first["tobj"][1].tolist() == [1.0, 1.0]
    assert first["state"]["scen"]["boxes_on_goal"][1] == first["state"]["scen"]["num_boxes"][1]
    for b, (p, x, z) in PUSHED.items():
        vobj = first["state"]["vobj"][b]
        assert vobj[x, 1, z] == 0 and vobj[x + 1, 1, z] == p + 1, f"env {b}: box pushed +x"
        np.testing.assert_allclose(first["state"]["props"]["pos"][b, p],
                                   [(x + 1.5) * VOXEL, 1.2 * VOXEL, (z + 0.5) * VOXEL])
    dones = [t for t, p in enumerate(tlog) if p["done"][1]]
    assert dones and dones[0] < 8, "env 1 finishes 0.3 s after the solve"


def test_convert_carries_sokoban_state(scripted):
    assert convert.scen_class("Sokoban") is SokobanState
    jst = convert.to_numpy_tree(scripted["jenv"].state)
    tst = convert.state_from_numpy(jst, scen_cls=SokobanState)
    K.assert_trees_equal(convert.tree_to_numpy(tst.scen), jst["scen"], "scen")
    K.assert_trees_equal(convert.tree_to_numpy(tst)["cols"], jst["cols"], "cols")


# ---------------------------------------------------------------------------
# Mirrors of tests/test_scenarios.py on the port's own step (B = 1).
# ---------------------------------------------------------------------------

def test_sokoban_push_box():
    """Pushing a box with Interact moves it one cell (cpp:168-233):
    tests/test_scenarios.py::test_sokoban_push_box."""
    s, state, shaping = K.single_env("Sokoban", seed=1)
    cfg = s.cfg.grid
    vobj = state.vobj[0].numpy()
    bx, by, bz = [int(v[0]) for v in np.nonzero(vobj)]
    box_idx = int(vobj[bx, by, bz])
    apos = torch.tensor([[[(bx - 1 + 0.5) * 2.0, 2.0 + C.AGENT_HALF_HEIGHT,
                           (bz + 0.5) * 2.0]]])
    state = state.replace(agents=state.agents.replace(
        pos=apos, yaw=torch.tensor([[-np.pi / 2]], dtype=torch.float32)))
    state2, rew = s.scen_step(state, torch.tensor([[C.ACTION_INTERACT]], dtype=torch.int32),
                              shaping)
    vobj2 = state2.vobj[0].numpy()
    wall = state.scen.wall[0].numpy()
    if bx + 1 < cfg.dims[0] and not wall[bx + 1, bz] and vobj[bx + 1, by, bz] == 0:
        assert vobj2[bx, by, bz] == 0 and vobj2[bx + 1, by, bz] == box_idx
        moved = (state2.props.pos - state.props.pos)[0, box_idx - 1].numpy()
        np.testing.assert_allclose(moved, [2.0, 0.0, 0.0], atol=1e-5)
        assert not G.solid_from_cols(cfg, state2.cols, torch.tensor([[bx, by, bz]]))[0]
        assert G.solid_from_cols(cfg, state2.cols, torch.tensor([[bx + 1, by, bz]]))[0]
    else:
        np.testing.assert_array_equal(vobj2, vobj)
    # nothing else in the prop table moved (the zero rows of the accumulate)
    others = np.delete(np.arange(state.props.pos.shape[1]), box_idx - 1)
    assert torch.equal(state2.props.pos[0, others], state.props.pos[0, others])


def test_sokoban_sequential_same_tick_visibility():
    """Pushes resolve in agent order within one tick (scenario_sokoban.cpp:
    168-233): tests/test_scenarios.py::test_sokoban_sequential_same_tick_visibility."""
    s, state, shaping = K.single_env("Sokoban", seed=1, num_agents=2)
    cfg = s.cfg.grid

    def clean_board(state):
        sc = state.scen.replace(
            wall=torch.zeros_like(state.scen.wall), goal=torch.zeros_like(state.scen.goal),
            num_boxes=torch.tensor([2], dtype=torch.int32),
            boxes_on_goal=torch.tensor([0], dtype=torch.int32))
        return state.replace(vobj=torch.zeros_like(state.vobj), scen=sc)

    def place_box(state, prop_idx, cell):
        x, y, z = cell
        vobj = state.vobj.clone()
        vobj[0, x, y, z] = prop_idx + 1
        pos = state.props.pos.clone()
        pos[0, prop_idx] = torch.tensor([(x + 0.5) * 2.0, (y + 0.2) * 2.0, (z + 0.5) * 2.0])
        return state.replace(vobj=vobj, props=state.props.replace(pos=pos))

    def agents_at(state, cells, yaws):
        apos = torch.tensor([[[(c[0] + 0.5) * 2.0, 2.0 + C.AGENT_HALF_HEIGHT,
                               (c[2] + 0.5) * 2.0] for c in cells]])
        return state.replace(agents=state.agents.replace(
            pos=apos, yaw=torch.tensor([yaws], dtype=torch.float32)))

    action = torch.tensor([[C.ACTION_INTERACT, C.ACTION_INTERACT]], dtype=torch.int32)

    # Case 1: agent 0 pushes box A (5,1,5)->(5,1,6) [+z]; agent 1 pushes box B
    # (4,1,5)->(5,1,5) [+x] into A's just-freed cell: both succeed.
    st = place_box(place_box(clean_board(state), 0, (5, 1, 5)), 1, (4, 1, 5))
    st = agents_at(st, [(5, 1, 4), (3, 1, 5)], [np.pi, -np.pi / 2])
    spot = G.world_to_voxel(cfg, pickup_spot(st.agents))
    np.testing.assert_array_equal(spot[0].numpy(), [[5, 1, 5], [4, 1, 5]])
    vobj2 = s.scen_step(st, action, shaping)[0].vobj[0].numpy()
    assert vobj2[5, 1, 6] == 1 and vobj2[5, 1, 5] == 2 and vobj2[4, 1, 5] == 0

    # Case 2: agent 0 pushes box A (5,1,4)->(5,1,5) [+z]; agent 1's push of
    # box B (4,1,5)->(5,1,5) is then BLOCKED by A in the same tick.
    st = place_box(place_box(clean_board(state), 0, (5, 1, 4)), 1, (4, 1, 5))
    st = agents_at(st, [(5, 1, 3), (3, 1, 5)], [np.pi, -np.pi / 2])
    st2 = s.scen_step(st, action, shaping)[0]
    vobj2 = st2.vobj[0].numpy()
    assert vobj2[5, 1, 5] == 1 and vobj2[4, 1, 5] == 2 and vobj2[5, 1, 6] == 0
    # box A moved 2 m along +z, box B stayed
    np.testing.assert_allclose((st2.props.pos - st.props.pos)[0, :2].numpy(),
                               [[0.0, 0.0, 2.0], [0.0, 0.0, 0.0]], atol=1e-6)
