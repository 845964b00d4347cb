"""Football through the port vs the JAX package on the CPU.

Layouts from the same seed are EQUAL leaf for leaf in both rng modes, and the
reference-stream golden trace tests/golden/football_golden.txt is held
against the port as tests/test_refrng_scenarios.py holds it against the JAX
package. A 30-tick scripted run (2 envs x 2 agents; env 0 agent 0 kicks the
ball resting on the floor, env 1 agent 1 stands in it and pushes it out; env
0 forced through an auto-reset) is stepped through both `VectorEnv`s with the
tolerances of tests/torch_port_checks.py; the ball's position, velocity and
angular velocity, integrated by six sequential contact passes per tick,
agree to atol 1e-4. The behaviour tests mirror tests/test_scenarios.py's kick
and push and roll-without-bounce on the port's own step.
"""

import os

import numpy as np
import pytest
import torch

import megaverse_tpu.constants as C

from megaverse_tpu_torch import convert
from megaverse_tpu_torch.scenarios import make_scenario as t_make_scenario
from megaverse_tpu_torch.scenarios.football import FootballState
from megaverse_tpu_torch.utils.refrng import Rng as TRng, episode_reseed as t_episode_reseed

import torch_port_checks as K

SEED = 3
BALL_ATOL = {"ball_pos": 1e-4, "ball_vel": 1e-4, "ball_omega": 1e-4}
REST = np.asarray([7.5, 2.0, 6.5], np.float32)   # ball centre resting on the floor


@pytest.mark.parametrize("mode", ["numpy", "reference"])
@pytest.mark.parametrize("agents", [1, 2])
def test_layouts_equal_leaf_for_leaf(agents, mode):
    K.assert_layouts_equal("Football", agents, mode, n=4)


def test_football_reference_stream_layout():
    """tests/test_refrng_scenarios.py::test_football_reference_stream_layout
    against the port: room size and wall height, spawn cells and yaws."""
    path = os.path.join(os.path.dirname(__file__), "golden", "football_golden.txt")
    lines = open(path).read().strip().split("\n")
    head = lines[0].split()
    epseed, length, width, height = int(head[1]), int(head[3]), int(head[4]), int(head[5])
    spawns = np.array(lines[1].split()[1:], np.float64).reshape(2, 3)
    yaws = np.array(lines[2].split()[1:], np.float32)

    sc = t_make_scenario("Football", num_agents=2)
    rng = TRng(7)
    assert t_episode_reseed(rng) == epseed
    scene = sc.generate_ref(rng)
    vt = scene.host_vtype
    floor = (vt[:, 0, :] & C.VOXEL_SOLID) != 0
    assert floor[:length, :width].all()
    assert not floor[length:, :].any() and not floor[:, width:].any()
    assert ((vt[0, :height, :width] & C.VOXEL_SOLID) != 0).all()
    assert not (vt[0, height:, :width] & C.VOXEL_SOLID).any()
    np.testing.assert_allclose(scene.agent_spawn, spawns + [0.5, C.AGENT_HEIGHT, 0.5], atol=1e-6)
    np.testing.assert_array_equal(np.asarray(scene.agent_yaw, np.float32), yaws)


def prepare(jenv, tenv):
    """The ball rests on the floor at REST in both envs. Env 0 agent 0
    stands 1.2 m -x of it (its tick-0 Interact kicks it); env 1 agent 1
    stands 1.1 m +x of it, inside it (the contact pushes it out along -x)."""
    st = convert.to_numpy_tree(jenv.state)
    pos = st["agents"]["pos"].copy()
    stand_y = 1.0 + C.AGENT_HALF_HEIGHT + 0.01
    pos[0, 0] = [REST[0] - 1.2, stand_y, REST[2]]
    pos[1, 1] = [REST[0] + 1.1, stand_y, REST[2]]
    K.set_agents(jenv, tenv, pos=pos)
    ball = np.tile(REST, (2, 1))
    zero = np.zeros((2, 3), np.float32)
    K.set_scen(jenv, tenv, ball_pos=ball, ball_vel=zero, ball_omega=zero)
    ppos = st["props"]["pos"].copy()
    ppos[np.arange(2), st["scen"]["ball_prop"]] = ball
    K.set_props(jenv, tenv, pos=ppos)


@pytest.fixture(scope="module")
def scripted():
    run = K.scripted_pair("Football", SEED, prepare)
    yield run
    run["jenv"].close()
    run["tenv"].close()


def test_scripted_run_matches_tick_by_tick(scripted):
    assert K.assert_logs_match(scripted, scen_atol=BALL_ATOL) == 1, \
        "exactly the forced time-out of env 0"


def test_scripted_run_exercises_the_scenario(scripted):
    """Env 0's ball was kicked away and up at tick 0, env 1's pushed out
    along -x; both came back to rest or roll on the floor, spinning (so the
    equalities are not vacuous)."""
    tlog = scripted["tlog"]
    sc0 = tlog[0]["state"]["scen"]
    assert sc0["ball_vel"][0, 0] > 1.0 and sc0["ball_vel"][0, 1] > 0.5
    assert sc0["ball_pos"][1, 0] < REST[0] - 0.01
    prop = sc0["ball_prop"]
    np.testing.assert_array_equal(tlog[0]["state"]["props"]["pos"][np.arange(2), prop],
                                  sc0["ball_pos"])
    omega = np.stack([p["state"]["scen"]["ball_omega"] for p in tlog[:19]])
    assert np.abs(omega).max() > 0.1, "floor friction spins the ball"
    ys = np.stack([p["state"]["scen"]["ball_pos"][:, 1] for p in tlog])
    assert ys.min() > 2.0 - 0.06, "the ball never sinks into the floor"
    assert (tlog[-1]["reward"] == 0).all() and (tlog[-1]["tobj"] == 0).all()


def test_convert_carries_football_state(scripted):
    assert convert.scen_class("Football") is FootballState
    jst = convert.to_numpy_tree(scripted["jenv"].state)
    tst = convert.state_from_numpy(jst, scen_cls=FootballState)
    K.assert_trees_equal(convert.tree_to_numpy(tst.scen), jst["scen"], "scen")


# ---------------------------------------------------------------------------
# Mirrors of tests/test_scenarios.py on the port's own step (B = 1).
# ---------------------------------------------------------------------------

def test_football_kick_and_push():
    """Interact within 1.8 m kicks the ball away (70 N, up-bias,
    scenario_football.cpp:143-164); walking contact pushes it out of
    penetration: tests/test_scenarios.py::test_football_kick_and_push."""
    s, state, shaping = K.single_env("Football", seed=6)
    ball0 = state.scen.ball_pos[0].numpy()
    apos = torch.tensor([[[ball0[0] - 1.0, ball0[1] - C.AGENT_BODY_OFFSET_Y, ball0[2]]]])
    st = state.replace(agents=state.agents.replace(pos=apos))
    st2, _ = s.scen_step(st, torch.tensor([[C.ACTION_INTERACT]], dtype=torch.int32), shaping)
    v = st2.scen.ball_vel[0].numpy()
    assert v[0] > 1.0 and v[1] > 0.5, v

    rest = state.scen.replace(ball_pos=torch.tensor([[6.0, 2.0, 6.0]]),
                              ball_vel=torch.zeros((1, 3)))
    apos = torch.tensor([[[6.0 + 1.1, 2.0 - C.AGENT_HALF_HEIGHT, 6.0]]])
    st = state.replace(scen=rest, agents=state.agents.replace(pos=apos))
    st2, _ = s.scen_step(st, torch.zeros((1, 1), dtype=torch.int32), shaping)
    moved = (st2.scen.ball_pos - rest.ball_pos)[0].numpy()
    assert moved[0] < -0.01, moved


def test_football_rigid_body_roll_and_no_bounce():
    """Restitution 0: a dropped ball settles without rebounding; sliding
    friction spins it up (slide -> roll) and slows the slide:
    tests/test_scenarios.py::test_football_rigid_body_roll_and_no_bounce."""
    s, state, shaping = K.single_env("Football", seed=6)
    act = torch.zeros((1, 1), dtype=torch.int32)
    far = state.agents.replace(pos=torch.tensor([[[2.0, 0.855, 2.0]]]))
    sc = state.scen.replace(ball_pos=torch.tensor([[8.0, 4.0, 8.0]]),
                            ball_vel=torch.zeros((1, 3)), ball_omega=torch.zeros((1, 3)))
    st = state.replace(scen=sc, agents=far)
    ys = []
    for _ in range(40):
        st, _ = s.scen_step(st, act, shaping)
        ys.append(float(st.scen.ball_pos[0, 1]))
    assert abs(ys[-1] - 2.0) < 0.06, ys[-1]
    assert max(ys[15:]) < 2.1, "restitution-0 ball must not bounce"

    sc = st.scen.replace(ball_pos=torch.tensor([[8.0, 2.0, 8.0]]),
                         ball_vel=torch.tensor([[6.0, 0.0, 0.0]]),
                         ball_omega=torch.zeros((1, 3)))
    st = st.replace(scen=sc)
    for _ in range(10):
        st, _ = s.scen_step(st, act, shaping)
    v = st.scen.ball_vel[0].numpy()
    w = st.scen.ball_omega[0].numpy()
    assert 0.0 < v[0] < 6.0, v
    assert w[2] < -0.1, w
    assert abs(v[0] + w[2] * 1.0) < 0.6 * v[0] + 0.3, (v[0], w[2])
