"""BoxAGone through the port vs the JAX package on the CPU.

Layouts from the same seed are EQUAL leaf for leaf in both rng modes (the
static packed columns `base_cols` come back as uint32 through
`convert.tree_to_numpy`), and the reference-stream golden trace
tests/golden/boxagone_golden.txt is held against the port as
tests/test_refrng_scenarios.py holds it against the JAX package. A 30-tick
scripted run (2 envs x 2 agents standing on the top level's tiles, which they
arm, and which expire under them; env 1 agent 0 on the floor; env 0 forced
through an auto-reset) is stepped through both `VectorEnv`s with the
tolerances of tests/torch_port_checks.py: tile grids, timers, the packed
columns rebuilt every tick, the inflating tiles' scales and the
winner-take-all true objective (ties to the lowest agent index) agree. The
behaviour tests mirror tests/test_scenarios.py's tile expiry, tile-height
deviation and same-tick sequential arming on the port's own step.
"""

import os
import types

import numpy as np
import pytest
import torch

import megaverse_tpu.constants as C

from megaverse_tpu_torch import convert
from megaverse_tpu_torch.scenarios import make_scenario as t_make_scenario
from megaverse_tpu_torch.scenarios.box_a_gone import (
    VOXEL, BoxAGoneState, num_tiles, tile_cell)
from megaverse_tpu_torch.types import PROP_FLAG_VISIBLE
from megaverse_tpu_torch.utils.refrng import Rng as TRng, episode_reseed as t_episode_reseed

import torch_port_checks as K

SEED = 3
FLOOR_CELL = (2, 0, 2)   # outside every level (levels span x, z >= 3)


@pytest.mark.parametrize("mode", ["numpy", "reference"])
@pytest.mark.parametrize("agents", [1, 2])
def test_layouts_equal_leaf_for_leaf(agents, mode):
    K.assert_layouts_equal("BoxAGone", agents, mode, n=3)


def test_boxagone_reference_stream_layout():
    """tests/test_refrng_scenarios.py::test_boxagone_reference_stream_layout
    against the port: tile voxels in generation order, shuffled spawn cells
    and yaws."""
    path = os.path.join(os.path.dirname(__file__), "golden", "boxagone_golden.txt")
    lines = open(path).read().strip().split("\n")
    epseed = int(lines[0].split()[1])
    num_levels = int(lines[1].split()[1])
    level_tiles, level_h = [], []
    for i in range(num_levels):
        head, _, tiles = lines[2 + i].partition("tiles:")
        level_h.append(int(head.split()[3]))
        level_tiles.append([tuple(map(int, t.split(","))) for t in tiles.split()])
    spawns = np.array(lines[2 + num_levels].split()[1:], np.int64).reshape(2, 3)
    yaws = np.array(lines[3 + num_levels].split()[1:], np.float32)

    sc = t_make_scenario("BoxAGone", num_agents=2)
    rng = TRng(7)
    assert t_episode_reseed(rng) == epseed
    scene = sc.generate_ref(rng)
    exp = np.concatenate([np.array([(x, h, z) for (x, z) in tiles], np.int64)
                          for h, tiles in zip(level_h, level_tiles)])
    n = exp.shape[0]
    np.testing.assert_array_equal(scene.scen.tile_voxel[:n], exp)
    assert int(scene.scen.tile_active.sum()) == n == num_tiles(scene.scen)
    np.testing.assert_allclose(scene.agent_spawn[:, 0], (spawns[:, 0] + 0.5) * VOXEL, atol=1e-6)
    np.testing.assert_allclose(scene.agent_spawn[:, 2], (spawns[:, 2] + 0.5) * VOXEL, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(scene.agent_yaw, np.float32), yaws)


def prepare(jenv, tenv):
    """Env 1 agent 0 stands on the floor (it pays the floor penalty every
    tick and loses the true objective to agent 1); the others stay on their
    spawn tiles."""
    st = convert.to_numpy_tree(jenv.state)
    pos = st["agents"]["pos"].copy()
    pos[1, 0] = [(FLOOR_CELL[0] + 0.5) * VOXEL, VOXEL + C.AGENT_HALF_HEIGHT + 0.01,
                 (FLOOR_CELL[2] + 0.5) * VOXEL]
    K.set_agents(jenv, tenv, pos=pos)


@pytest.fixture(scope="module")
def scripted():
    run = K.scripted_pair("BoxAGone", SEED, prepare)
    yield run
    run["jenv"].close()
    run["tenv"].close()


def test_scripted_run_matches_tick_by_tick(scripted):
    assert K.assert_logs_match(scripted) == 1, "exactly the forced time-out of env 0"


def test_scripted_run_exercises_the_scenario(scripted):
    """The run armed tiles (green, inflated), let some expire (hidden, their
    solid bit cleared), paid the floor penalty and the per-step reward, and
    took the true objective both through a tie and through a lead (so the
    equalities are not vacuous)."""
    tlog = scripted["tlog"]
    green = C.COLOR_IDX["GREEN"]
    s0 = tlog[0]["state"]
    armed = [(p["state"]["scen"]["tile_ticks"] >= 0).sum() for p in tlog]
    assert armed[0] >= 1 and max(armed) >= 5
    assert (s0["props"]["color"] == green).sum() >= 1
    expired = [t for t, p in enumerate(tlog)
               if (~p["state"]["scen"]["tile_active"][1]).sum()
               > (~s0["scen"]["tile_active"][1]).sum()]
    assert expired, "a tile of env 1 expires"
    st = tlog[expired[0]]["state"]
    gone = np.argwhere(s0["scen"]["tile_active"][1] & ~st["scen"]["tile_active"][1])[0]
    prop = st["scen"]["tile_prop"][1][tuple(gone)]
    assert st["props"]["flags"][1, prop] & PROP_FLAG_VISIBLE == 0
    x, h, z = gone[1], st["scen"]["level_h"][1, gone[0]], gone[2]
    assert not (st["cols"][1, x, 0, z] >> h) & 1
    assert st["cols"].dtype == st["scen"]["base_cols"].dtype == np.uint32
    # rewards: env 1 agent 0 on the floor, the others above it
    np.testing.assert_allclose(tlog[0]["reward"], [[0.01, 0.01], [-0.1, 0.01]], atol=1e-7)
    # env 0: both off the floor since the start, equal seconds: the tie goes
    # to agent 0; env 1: agent 1 leads
    assert tlog[5]["state"]["scen"]["seconds_off_floor"][0, 0] \
        == tlog[5]["state"]["scen"]["seconds_off_floor"][0, 1]
    assert tlog[5]["tobj"].tolist() == [[1.0, 0.0], [0.0, 1.0]]


def test_convert_carries_boxagone_state(scripted):
    """Port -> numpy gives the packed columns of the state and of the
    scenario's static base (`base_cols`) as uint32, equal to the JAX
    package's; numpy -> port -> numpy is the identity."""
    assert convert.scen_class("BoxAGone") is BoxAGoneState
    jst = convert.to_numpy_tree(scripted["jenv"].state)
    got = convert.tree_to_numpy(scripted["tenv"].state)
    assert got["scen"]["base_cols"].dtype == np.uint32 == jst["scen"]["base_cols"].dtype
    np.testing.assert_array_equal(got["scen"]["base_cols"], jst["scen"]["base_cols"])
    np.testing.assert_array_equal(got["cols"], jst["cols"])
    tst = convert.state_from_numpy(jst, scen_cls=BoxAGoneState)
    assert tst.scen.base_cols.dtype == torch.int32
    K.assert_trees_equal(convert.tree_to_numpy(tst.scen), jst["scen"], "scen")
    K.assert_trees_equal(convert.tree_to_numpy(tst)["cols"], jst["cols"], "cols")


# ---------------------------------------------------------------------------
# Mirrors of tests/test_scenarios.py on the port's own step (B = 1).
# ---------------------------------------------------------------------------

def _layout(state):
    """The scenario state of env 0 as numpy attributes (for tile_cell)."""
    tree = convert.tree_to_numpy(state.scen)
    return types.SimpleNamespace(**{k: v[0] for k, v in tree.items()})


def _on_tile(voxel):
    return [(voxel[0] + 0.5) * VOXEL, (voxel[1] + 1) * VOXEL + C.AGENT_HALF_HEIGHT,
            (voxel[2] + 0.5) * VOXEL]


def test_boxagone_tile_expires():
    """Standing on a tile arms it; it disappears after 15 ticks:
    tests/test_scenarios.py::test_boxagone_tile_expires."""
    s, state, shaping = K.single_env("BoxAGone", seed=4)
    lay = _layout(state)
    cell0 = tile_cell(lay, 0)
    voxel = lay.tile_voxel[0]
    state = state.replace(agents=state.agents.replace(
        pos=torch.tensor([[_on_tile(voxel)]]), on_ground=torch.tensor([[True]])))
    act = torch.zeros((1, 1), dtype=torch.int32)
    for i in range(16):
        state, rew = s.scen_step(state, act, shaping)
        state = state.replace(agents=state.agents.replace(on_ground=torch.tensor([[True]])))
        if i == 0:
            assert state.scen.tile_ticks.reshape(-1)[cell0] == 14
            prop = lay.tile_prop.reshape(-1)[cell0]
            assert state.props.color[0, prop] == C.COLOR_IDX["GREEN"]
    assert not bool(state.scen.tile_active.reshape(-1)[cell0])
    x, y, z = voxel
    assert not ((int(state.cols[0, x, y >> 5, z]) >> (y & 31)) & 1)


def test_boxagone_tile_height_deviation_is_reward_neutral():
    """PARITY deviation (tests/test_scenarios.py::
    test_boxagone_tile_height_deviation_is_reward_neutral): tiles here are
    full voxels, so agents stand one voxel higher than on the reference's
    thin mid-voxel tiles. For every reachable level height the touches-floor
    classification and the armed tile agree between the two geometries; and
    the port's step, with an agent standing on a tile of each level of two
    layouts, arms exactly that tile and pays the reward of that
    classification."""
    for h in [1, 3, 4, 5, 6, 7]:
        ref_agent_voxel = int(np.floor((2 * h + 1 + 0.855) / 2.0))   # thin tile
        my_agent_voxel = int(np.floor((2 * h + 2 + 0.855) / 2.0))    # voxel top
        assert (ref_agent_voxel < 3) == (my_agent_voxel < 3), h
        assert my_agent_voxel - 1 == ref_agent_voxel == h
    assert int(np.floor((2 + 0.855) / 2)) < 3
    assert all(1 + d >= 3 for d in (2, 3))

    seen = set()
    for seed in (3, 4):
        s, state, shaping = K.single_env("BoxAGone", seed=seed)
        lay = _layout(state)
        for t in range(num_tiles(lay)):
            h = int(lay.tile_voxel[t][1])
            if h in seen:
                continue
            seen.add(h)
            st = state.replace(agents=state.agents.replace(
                pos=torch.tensor([[_on_tile(lay.tile_voxel[t])]]),
                on_ground=torch.tensor([[True]])))
            st2, rew = s.scen_step(st, torch.zeros((1, 1), dtype=torch.int32), shaping)
            assert int(st2.scen.last_tile[0, 0]) == tile_cell(lay, t)
            touches = int(np.floor((2 * h + 2 + 0.855) / 2.0)) < 3
            assert float(rew[0, 0]) == pytest.approx(-0.1 if touches else 0.01)
    assert len(seen) >= 3


def test_boxagone_sequential_same_tick_arming():
    """Agent 0 arms tile T (15 ticks) and agent 1 LEAVES T in the same tick:
    agent 1's previous-tile acceleration clips the fresh timer to 3
    (scenario_box_a_gone.cpp:100-148):
    tests/test_scenarios.py::test_boxagone_sequential_same_tick_arming."""
    s, state, shaping = K.single_env("BoxAGone", seed=3, num_agents=2)
    lay = _layout(state)
    tv = lay.tile_voxel
    n = num_tiles(lay)
    cells = np.asarray([tile_cell(lay, t) for t in range(n)])
    active = lay.tile_active.reshape(-1)[cells]
    t_T = t_U = None
    for i in np.nonzero(active)[0]:
        j = np.nonzero(active & (tv[:n, 1] == tv[i, 1])
                       & (np.abs(tv[:n, 0] - tv[i, 0]) + np.abs(tv[:n, 2] - tv[i, 2]) == 1))[0]
        if j.size:
            t_T, t_U = int(i), int(j[0])
            break
    assert t_T is not None
    cell_T, cell_U = int(cells[t_T]), int(cells[t_U])
    sc = state.scen.replace(last_tile=torch.tensor([[-1, cell_T]], dtype=torch.int32),
                            tile_ticks=torch.full_like(state.scen.tile_ticks, -1))
    state = state.replace(scen=sc, agents=state.agents.replace(
        pos=torch.tensor([[_on_tile(tv[t_T]), _on_tile(tv[t_U])]]),
        on_ground=torch.tensor([[True, True]])))
    st2, _ = s.scen_step(state, torch.zeros((1, 2), dtype=torch.int32), shaping)
    ticks2 = st2.scen.tile_ticks.reshape(-1)
    assert ticks2[cell_T] == 2 and ticks2[cell_U] == 14
    assert st2.scen.last_tile[0].tolist() == [cell_T, cell_U]


def test_boxagone_true_objective_ties_go_to_the_first_agent():
    """Winner-take-all true objective (hpp:56-71) on equal seconds off the
    floor: agent 0 wins, as jnp.argmax picks the first maximum; with agent 1
    ahead, agent 1 wins."""
    s, state, shaping = K.single_env("BoxAGone", seed=3, num_agents=3)
    act = torch.zeros((1, 3), dtype=torch.int32)
    for secs, want in (([2.0, 2.0, 2.0], [1.0, 0.0, 0.0]), ([1.0, 3.0, 3.0], [0.0, 1.0, 0.0])):
        # all three on the floor: seconds_off_floor keeps its values
        floor = [(FLOOR_CELL[0] + 0.5 + i) * VOXEL for i in range(3)]
        st = state.replace(
            agents=state.agents.replace(pos=torch.tensor(
                [[[x, VOXEL + C.AGENT_HALF_HEIGHT, (FLOOR_CELL[2] + 0.5) * VOXEL]
                  for x in floor]])),
            scen=state.scen.replace(seconds_off_floor=torch.tensor([secs])))
        st2, _ = s.scen_step(st, act, shaping)
        assert st2.true_objective[0].tolist() == want
