"""The Obstacles family (and Test) through the port vs the JAX package on the
CPU.

Layouts of all eight registered variants from the same seed are EQUAL leaf for
leaf in both rng modes. A 30-tick scripted run of ObstaclesEasy (2 envs x 2
agents: walk, look, jump, pick up a box, put it down, stand on the exit pad,
stand on lava and get carried back; env 0 forced through an auto-reset) is
stepped through both `VectorEnv`s (the same ticks through ObstaclesHard and
ObstaclesWalls: tests/test_torch_obstacles_variants.py) with the tolerances of
tests/torch_port_checks.py: pos / yaw / pitch / vvel atol 1e-4, hvel 2e-3,
rewards 1e-5; dones, true objective, prop flags, grids and ObstaclesState
equal. The reference-stream golden trace tests/golden/obstacles_golden.txt is
held against the port as tests/test_refrng_scenarios.py holds it against the
JAX package.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import megaverse_tpu.constants as C

from megaverse_tpu_torch import VectorEnv as TVectorEnv
from megaverse_tpu_torch import convert
from megaverse_tpu_torch.scenarios import make_scenario as t_make_scenario
from megaverse_tpu_torch.scenarios import registered_scenarios
from megaverse_tpu_torch.scenarios.obstacles import ObstaclesState
from megaverse_tpu_torch.utils.refrng import Rng as TRng, episode_reseed as t_episode_reseed

import torch_port_checks as K

VARIANTS = ["Test", "ObstaclesEasy", "ObstaclesMedium", "ObstaclesHard",
            "ObstaclesWalls", "ObstaclesSteps", "ObstaclesLava"]
SEED = 31   # env 0 has two boxes, env 1 lava; the run picks up and puts down
H = 24


def test_all_variants_are_registered():
    names = set(registered_scenarios())
    assert {v.casefold() for v in VARIANTS} <= names
    assert convert.scen_class("ObstaclesHard") is ObstaclesState
    assert convert.scen_class("Test") is ObstaclesState


@pytest.mark.parametrize("mode", ["numpy", "reference"])
@pytest.mark.parametrize("name", VARIANTS)
def test_layouts_equal_leaf_for_leaf(name, mode):
    K.assert_layouts_equal(name, 2, mode, n=3)


@pytest.mark.parametrize("mode", ["numpy", "reference"])
def test_layouts_equal_single_agent_and_params(mode):
    K.assert_layouts_equal("ObstaclesEasy", 1, mode, n=3)
    K.assert_layouts_equal("ObstaclesMedium", 1, mode, n=2,
                           params={"obstaclesMaxNumPlatforms": 3, "obstaclesMaxLava": 6})


def test_obstacles_reference_stream_draws():
    """tests/test_refrng_scenarios.py::test_obstacles_reference_stream_draws
    against the port: the whole draw stream (platform chain, colours, spawn
    sampling, box budget, object and reward positions, yaws) consumes the
    mt19937 stream as the C++ does; the probe draws after generation can only
    match if every draw before them did."""
    path = os.path.join(os.path.dirname(__file__), "golden", "obstacles_golden.txt")
    lines = open(path).read().strip().split("\n")
    epseed = int(lines[0].split()[1])
    walls, nplat = int(lines[1].split()[1]), int(lines[1].split()[3])
    plats = [t.split(",") for t in lines[2].split()[1:]]
    colors = tuple(map(int, lines[3].split()[1:]))
    n_obj, n_rew = int(lines[5].split()[1]), int(lines[5].split()[3])
    yaws = np.array(lines[6].split()[1:], np.float32)
    probe = list(map(int, lines[7].split()[1:]))
    kind = {"StartPlatform": "S", "WallPlatform": "W", "LavaPlatform": "L",
            "StepPlatform": "T", "GapPlatform": "G", "TransitionPlatform": "A",
            "ExitPlatform": "E"}

    sc = t_make_scenario("ObstaclesEasy", num_agents=2)
    rng = TRng(7)
    assert t_episode_reseed(rng) == epseed
    scene = sc.generate_ref(rng)
    dbg = sc._dbg
    assert dbg["attempt"] == 0
    assert dbg["walls"] == bool(walls) and dbg["n_platforms"] == nplat
    assert [(kind[n], l, w, h) for (n, l, w, h) in dbg["plats"]] == \
        [(k, int(l), int(w), int(h)) for (k, l, w, h) in plats]
    assert dbg["colors"] == colors
    assert int(scene.scen.reward_active.sum()) == n_rew
    assert int((scene.props.type[:sc.BOX_MAX] != C.PROP_NONE).sum()) == n_obj
    np.testing.assert_array_equal(np.asarray(scene.agent_yaw, np.float32), yaws)
    assert [rng.rand_range(0, 1000000) for _ in range(3)] == probe


def prepare(jenv, tenv):
    """Env 0 agent 0 faces the second movable box from the next cell; env 1
    agent 0 stands on the exit pad, env 1 agent 1 on lava."""
    st = convert.to_numpy_tree(jenv.state)
    pos, yaw = st["agents"]["pos"].copy(), st["agents"]["yaw"].copy()
    exit_cells = np.argwhere((st["vterrain"][1] & C.TERRAIN_EXIT) != 0)
    lava_cells = np.argwhere((st["vterrain"][1] & C.TERRAIN_LAVA) != 0)
    assert len(exit_cells) and len(lava_cells)
    pos[0, 0] = K.face_box(st["props"]["pos"][0, 1])
    yaw[0, 0] = 0.0
    pos[1, 0] = K.stand_on(exit_cells[0])
    pos[1, 1] = K.stand_on(lava_cells[0])
    K.set_agents(jenv, tenv, pos=pos, yaw=yaw)


@pytest.fixture(scope="module")
def scripted():
    run = K.scripted_pair("ObstaclesEasy", SEED, prepare)
    yield run
    run["jenv"].close()
    run["tenv"].close()


def test_scripted_run_matches_tick_by_tick(scripted):
    assert K.assert_logs_match(scripted) == 1, "exactly the forced time-out of env 0"
    tlog = scripted["tlog"]
    assert tlog[-1]["state"]["num_frames"][0] < tlog[-1]["state"]["num_frames"][1]


def test_scripted_run_exercises_the_scenario(scripted):
    """The run the comparison above rests on did pick up, put down, reach the
    exit and touch lava (so the equalities are not vacuous)."""
    tlog = scripted["tlog"]
    carried = np.stack([p["state"]["agents"]["carried"] for p in tlog])[:20, 0, 0]
    assert (carried >= 0).any(), "env 0 agent 0 must pick the box up"
    assert ((carried[:-1] >= 0) & (carried[1:] < 0)).any(), "and put it down again"
    assert tlog[0]["state"]["scen"]["reached_exit"][1, 0]
    assert tlog[0]["reward"][1, 0] > 0.0                    # obstaclesAgentAtExit
    pos = np.stack([p["state"]["agents"]["pos"][1, 1] for p in tlog])
    jumps = np.linalg.norm(np.diff(pos, axis=0), axis=-1)
    assert (jumps > 2.0).any(), "the agent on lava is carried back to its spawn"
    assert not tlog[-1]["state"]["scen"]["solved"][1]       # not all agents at the exit
    assert tlog[-1]["state"]["vterrain"].shape[1:] == (96, 24, 96)


def test_all_agents_at_exit_solves(scripted):
    """Both agents of an env on the exit pad: obstaclesAllAgentsAtExit is paid
    once, the episode ends 0.3 s later (doneWithTimer), true objective 1."""
    tenv = scripted["tenv"]
    st = tenv.state
    exit_cells = np.argwhere(((st.vterrain[1] & C.TERRAIN_EXIT) != 0).numpy())
    pos = st.agents.pos.clone()
    pos[1, 0] = torch.from_numpy(K.stand_on(exit_cells[0]))
    pos[1, 1] = torch.from_numpy(K.stand_on(exit_cells[-1]))
    from megaverse_tpu_torch.env import env_step
    res = env_step(tenv.scenario, st.replace(agents=st.agents.replace(pos=pos)),
                   tenv.next_scenes, torch.zeros((2, 2), dtype=torch.int32), tenv.shaping)
    assert bool(res.state.scen.solved[1]) and not bool(res.state.scen.solved[0])
    assert torch.equal(res.true_objective[1], torch.ones(2))
    # agent 0 had reached the exit before: agent 1 gets 1.0, both get 5.0
    np.testing.assert_allclose(res.reward[1].numpy(), [5.0, 6.0], atol=1e-5)
    remaining = res.state.episode_len_sec[1] - res.state.episode_sec[1]
    assert 0.0 < float(remaining) <= 0.3


def test_vector_env_determinism_and_auto_reset():
    """Same seed => identical observations across instances; Test episodes
    last 6 s = 90 ticks, so 100 ticks see every env restart from the layout
    buffer and get its slot refilled (step_many with the synchronous refill)."""
    def run(seed):
        env = TVectorEnv("Test", num_envs=3, num_agents_per_env=1, seed=seed, device="cpu")
        env.scenario.cfg = dataclasses.replace(env.scenario.cfg, obs_height=H)
        obs = [env.reset()]
        pool = np.random.default_rng(5).integers(0, 2048, size=(7, 3, 1)).astype(np.int32)
        seen = 0
        for n in (50, 50):
            o, dones, _ = env.step_many(pool, n)
            obs.append(o)
            seen += int(torch.stack(dones).sum())
        env.flush()
        out = (torch.stack(obs), seen, env.num_refilled_envs, int(env.state.num_frames.max()))
        env.close()
        return out

    a, b, c = run(11), run(11), run(12)
    assert a[0].shape == (3, 3, 1, H, 128, 3) and a[0].dtype == torch.uint8
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    # every env times out at tick 90; one may also walk onto the exit before that
    assert a[1] >= 3 and a[2] == a[1] and a[3] < 90
