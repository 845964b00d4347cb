"""Rearrange through the port vs the JAX package on the CPU.

Layouts from the same seed are EQUAL leaf for leaf in both rng modes, and the
reference-stream golden trace tests/golden/rearrange_golden.txt is held
against the port as tests/test_refrng_scenarios.py holds it against the JAX
package. A 30-tick scripted run (2 envs x 2 agents; in env 0 agent 0 picks an
item up, carries it and puts it down on the cell its target has been moved
to, which completes the arrangement; in env 1 it picks up the cylinder at
prop row 1; env 0 also forced through an auto-reset) is stepped through both
`VectorEnv`s with the tolerances of tests/torch_port_checks.py. No test picks
up prop row 0 (the JAX package's scatter race, ROADMAP section C).

One image of the run's end state, whose prim table holds ellipsoid
(sphere, capsule) and cylinder rows, is rendered by the port's plain B1 and by
the JAX package's XLA table renderer from the same cams and prims: at most 1
per colour channel on fewer than 1e-4 of the pixels.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import megaverse_tpu.constants as C
from megaverse_tpu.ops import raycast as JR
from megaverse_tpu.scenarios import make_scenario as j_make_scenario
from megaverse_tpu.types import AgentState as JAgentState

from megaverse_tpu_torch import convert
from megaverse_tpu_torch.env import UNCULLED, render_tables
from megaverse_tpu_torch.ops import raycast_cuda as TRC
from megaverse_tpu_torch.scenarios import make_scenario as t_make_scenario
from megaverse_tpu_torch.scenarios.rearrange import RIGHT, RearrangeState
from megaverse_tpu_torch.utils.refrng import Rng as TRng, episode_reseed as t_episode_reseed

import torch_port_checks as K

SEED = 3
H, W = 24, 128


@pytest.mark.parametrize("mode", ["numpy", "reference"])
@pytest.mark.parametrize("agents", [1, 2])
def test_layouts_equal_leaf_for_leaf(agents, mode):
    K.assert_layouts_equal("Rearrange", agents, mode, n=4)


def test_rearrange_reference_stream_layout():
    """tests/test_refrng_scenarios.py::test_rearrange_reference_stream_layout
    against the port: BFS items (shape, colour, offset), interactive-copy
    offsets, spawn cells, yaws and the wall draw."""
    path = os.path.join(os.path.dirname(__file__), "golden", "rearrange_golden.txt")
    lines = open(path).read().strip().split("\n")
    head = lines[0].split()
    epseed, height, walls = int(head[1]), int(head[3]), int(head[5])
    items = np.array(lines[1].split()[2:], np.int64).reshape(-1, 5)
    spawns = np.array(lines[2].split()[1:], np.int64).reshape(-1, 2)
    yaws = np.array(lines[3].split()[1:], np.float32)
    offs = np.array(lines[4].split()[3:], np.int64).reshape(-1, 3)

    sc = t_make_scenario("Rearrange", num_agents=2)
    rng = TRng(7)
    assert t_episode_reseed(rng) == epseed
    scene = sc.generate_ref(rng)
    scen = scene.scen
    n = items.shape[0]
    assert scen.arr_valid.sum() == n
    np.testing.assert_array_equal(scen.arr_shape[:n], items[:, 0])
    np.testing.assert_array_equal(scen.arr_color[:n], C.OBJECT_COLORS[items[:, 1]])
    np.testing.assert_array_equal(scen.arr_offset[:n], items[:, 2:])
    for i in range(n):
        np.testing.assert_allclose(scene.props.pos[int(scen.obj_prop[i])],
                                   (RIGHT + offs[i]).astype(float) + 0.5, atol=1e-6)
    exp = np.stack([spawns[:, 0] + 0.5, np.full(2, 2.0 + C.AGENT_HEIGHT),
                    spawns[:, 1] + 0.5], 1)
    np.testing.assert_allclose(scene.agent_spawn, exp, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(scene.agent_yaw, np.float32), yaws)
    assert bool((scene.host_vtype[0, 1:height, 1] & C.VOXEL_OPAQUE).any()) == bool(walls)


def face_from_plus_x(item_pos):
    """World position from which an agent with yaw pi/2 (facing -x), standing
    on the item's floor level one cell +x of it, has its pickup spot inside
    the item's voxel."""
    b = np.asarray(item_pos, np.float32)
    return np.asarray([b[0] + 1.0, np.floor(b[1]) + C.AGENT_HALF_HEIGHT + 0.01, b[2]],
                      np.float32)


# In env 0 the item agent 0 picks up is put down, by its tick-12 Interact, on
# the right pedestal at this offset from its centre (the run's own
# trajectory); prepare() moves that item's target there.
PLACED_OFFSET = (0, 0, 2)


def prepare(jenv, tenv):
    """Agent 0 of each env faces item 1 from its +x side (env 0: a capsule;
    env 1: the cylinder at prop row 1) and picks it up at tick 0. Env 0's
    target for item 1 moves to PLACED_OFFSET, so the put-down matches every
    item."""
    st = convert.to_numpy_tree(jenv.state)
    pos, yaw = st["agents"]["pos"].copy(), st["agents"]["yaw"].copy()
    for b in range(2):
        prop = st["scen"]["obj_prop"][b, 1]
        assert prop != 0
        pos[b, 0] = face_from_plus_x(st["props"]["pos"][b, prop])
        yaw[b, 0] = np.pi / 2
    K.set_agents(jenv, tenv, pos=pos, yaw=yaw)
    arr_offset = st["scen"]["arr_offset"].copy()
    arr_offset[0, 1] = PLACED_OFFSET
    K.set_scen(jenv, tenv, arr_offset=arr_offset)


@pytest.fixture(scope="module")
def scripted():
    run = K.scripted_pair("Rearrange", SEED, prepare)
    yield run
    run["jenv"].close()
    run["tenv"].close()


def test_scripted_run_matches_tick_by_tick(scripted):
    # env 0 ends once, 0.3 s after its solve (before its forced time-out)
    assert K.assert_logs_match(scripted) == 1


def test_scripted_run_exercises_the_scenario(scripted):
    """Both envs picked item 1 up at tick 0; env 0 put it down at tick 12 on
    its target, completing the arrangement (+1 for the new maximum, +10 for
    all), and ended its episode (so the equalities are not vacuous)."""
    tlog = scripted["tlog"]
    carried = np.stack([p["state"]["agents"]["carried"] for p in tlog])     # [T,B,A]
    obj_prop = tlog[0]["state"]["scen"]["obj_prop"]
    assert carried[0, 0, 0] == obj_prop[0, 1] and carried[0, 1, 0] == obj_prop[1, 1] == 1
    assert (carried[:12, 0, 0] >= 0).all() and carried[12, 0, 0] == -1
    at12 = tlog[12]
    np.testing.assert_allclose(at12["reward"][0], [11.0, 0.0])
    assert at12["state"]["scen"]["solved"][0] and at12["state"]["scen"]["max_matching"][0] == 2
    prop = obj_prop[0, 1]
    placed = np.floor(at12["state"]["props"]["pos"][0, prop]).astype(int)
    np.testing.assert_array_equal(placed - RIGHT, PLACED_OFFSET)
    assert at12["state"]["vobj"][0][tuple(placed)] == prop + 1
    assert (carried[:, 1, 0] == 1).all(), "env 1 carries the cylinder to the end"
    assert any(p["done"][0] for p in tlog[12:20])


def test_convert_carries_rearrange_state(scripted):
    assert convert.scen_class("Rearrange") is RearrangeState
    jst = convert.to_numpy_tree(scripted["jenv"].state)
    tst = convert.state_from_numpy(jst, scen_cls=RearrangeState)
    K.assert_trees_equal(convert.tree_to_numpy(tst.scen), jst["scen"], "scen")


def test_b1_matches_jax_image(scripted):
    """The run's end state through the port's plain B1 and the JAX package's
    XLA table renderer, from the same cams and prims (24 px)."""
    tenv = scripted["tenv"]
    scenario = copy.copy(tenv.scenario)
    scenario.cfg = dataclasses.replace(scenario.cfg, obs_height=H)
    tabs = render_tables(scenario, tenv.state, bucket=tenv._bucket, mode=UNCULLED)
    cams, prims = tabs["cams"], tabs["prims"]
    kinds = set(prims[..., 0].flatten().tolist())
    assert {TRC.PRIM_ELLIPSOID, TRC.PRIM_CYLINDER} <= kinds, kinds
    got = TRC.render_packed(cams, prims, H, W, ui_indicators=False).numpy()

    cfg = dataclasses.replace(j_make_scenario("Empty", num_agents=2).cfg, obs_height=H)

    def one(p, cam, ps):
        agents = JAgentState.create(ps.shape[0]).replace(pos=ps, yaw=cam[:, 3], pitch=cam[:, 4])
        return JR.render_table_packed(cfg, agents, p, cam[:, 5], last_reward=cam[:, 6])

    want = np.asarray(jax.jit(jax.vmap(one))(
        jnp.asarray(prims.numpy()), jnp.asarray(cams.numpy()),
        jnp.asarray(tenv.state.agents.pos.numpy())))
    unpack = lambda p: np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], -1).astype(np.int64)
    delta = np.abs(unpack(got) - unpack(want))
    assert len(np.unique(got)) > 8, "the image is not (nearly) constant"
    assert delta.max() <= 1, f"max channel delta {delta.max()}"
    assert (delta != 0).any(-1).mean() < 1e-4
