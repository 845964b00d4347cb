"""Collect through the port vs the JAX package on the CPU.

Layouts from the same seed are EQUAL leaf for leaf in both rng modes. A
30-tick scripted run (2 envs x 2 agents: walk, look, jump, pick up a box, put
it down, walk into a reward diamond, fall off the world; env 0 forced through
an auto-reset) is stepped through both `VectorEnv`s with the tolerances of
tests/torch_port_checks.py: pos / yaw / pitch / vvel atol 1e-4, hvel 2e-3,
rewards 1e-5; dones, true objective, prop flags, grids and CollectState equal.
The reference-stream golden trace tests/golden/collect_golden.txt is held
against the port as tests/test_refrng_scenarios.py holds it against the JAX
package.
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
from megaverse_tpu_torch.scenarios.collect import OBJ_MAX, CollectState
from megaverse_tpu_torch.types import PROP_FLAG_VISIBLE
from megaverse_tpu_torch.utils.refrng import Rng as TRng, episode_reseed as t_episode_reseed

import torch_port_checks as K

SEED = 3    # with this seed the prepared run picks a box up and puts it down
H = 24


@pytest.mark.parametrize("mode", ["numpy", "reference"])
@pytest.mark.parametrize("agents", [1, 2])
def test_layouts_equal_leaf_for_leaf(agents, mode):
    K.assert_layouts_equal("Collect", agents, mode, n=4)


def test_collect_reference_stream_layout():
    """tests/test_refrng_scenarios.py::test_collect_reference_stream_layout
    against the port: terrain heights, spawn cells, yaws, reward voxels with
    their good/bad flags and movable boxes of the draw-for-draw C++ replica."""
    gold = {}
    with open(os.path.join(os.path.dirname(__file__), "golden", "collect_golden.txt")) as f:
        for line in f:
            key, _, rest = line.partition(" ")
            gold[key.rstrip(":")] = rest.strip()
    width, length = (int(v) for v in gold["cfg"].split()[2:4])
    heights = np.array(gold["heights"].rstrip(":").split(), np.int64)

    sc = t_make_scenario("Collect", num_agents=2)
    rng = TRng(7)
    assert t_episode_reseed(rng) == int(gold["epseed"])
    scene = sc.generate_ref(rng)

    vt = np.asarray(scene.host_vtype)
    got_h = ((vt[1:length - 1, 1:, 1:width - 1] & C.VOXEL_OPAQUE) != 0).sum(1)
    np.testing.assert_array_equal(got_h.ravel(), heights)
    agl = np.array(gold["agents"].split(), np.float64).reshape(2, 3)
    np.testing.assert_allclose(scene.agent_spawn, agl + [0.5, C.AGENT_HEIGHT, 0.5], atol=1e-6)
    np.testing.assert_array_equal(np.asarray(scene.agent_yaw, np.float32),
                                  np.array(gold["yaws"].split(), np.float32))
    rew = np.array(gold["rewards"].split()[1:], np.int64).reshape(-1, 3)
    good = np.array(gold["good"].split(), np.int64)
    n = rew.shape[0]
    np.testing.assert_array_equal(scene.scen.reward_voxel[:n], rew)
    np.testing.assert_array_equal(scene.scen.reward_val[:n], np.where(good, 1.0, -1.0))
    assert not scene.scen.reward_active[n:].any()
    obj = np.array(gold["objects"].split()[1:], np.float64).reshape(-1, 3)
    assert (scene.props.type[:OBJ_MAX] != C.PROP_NONE).sum() == obj.shape[0]
    np.testing.assert_allclose(scene.props.pos[:obj.shape[0]], obj + 0.5, atol=1e-6)


def prepare(jenv, tenv):
    """Env 0 agent 0 faces the second movable box from the next cell, its
    pickup spot inside the box's voxel; env 1 agent 0
    stands on the first reward diamond; env 1 agent 1 is just above the fall
    threshold. (Not the first box: when one agent picks prop 0 up while
    another idles, the JAX package's scatter names row 0 twice and which
    write lands is undefined; the port routes idle agents to a scratch row.)"""
    st = convert.to_numpy_tree(jenv.state)
    pos, yaw = st["agents"]["pos"].copy(), st["agents"]["yaw"].copy()
    pos[0, 0] = K.face_box(st["props"]["pos"][0, 1])
    yaw[0, 0] = 0.0
    pos[1, 0] = K.spawn_pos(st["scen"]["reward_voxel"][1, 0])
    pos[1, 1, 1] = -19.9
    K.set_agents(jenv, tenv, pos=pos, yaw=yaw)


@pytest.fixture(scope="module")
def scripted():
    run = K.scripted_pair("Collect", SEED, prepare)
    yield run
    run["jenv"].close()
    run["tenv"].close()


def test_scripted_run_matches_tick_by_tick(scripted):
    assert K.assert_logs_match(scripted) == 1, "exactly the forced time-out of env 0"
    tlog = scripted["tlog"]
    assert tlog[-1]["state"]["num_frames"][0] < tlog[-1]["state"]["num_frames"][1]


def test_scripted_run_exercises_the_scenario(scripted):
    """The run the comparison above rests on did pick up, put down, collect
    and fall (so the equalities are not vacuous)."""
    tlog = scripted["tlog"]
    carried = np.stack([p["state"]["agents"]["carried"] for p in tlog])     # [T,B,A]
    assert (carried[:, 0, 0] >= 0).any(), "env 0 agent 0 must pick the box up"
    c00 = carried[:20, 0, 0]                      # before env 0's auto-reset
    assert ((c00[:-1] >= 0) & (c00[1:] < 0)).any(), "and put it down again"
    # env 1 agent 0 drops onto diamond 0 and collects it within a few ticks
    gone = [t for t, p in enumerate(tlog) if not p["state"]["scen"]["reward_active"][1, 0]]
    assert gone and gone[0] < 8, "diamond 0 must be collected"
    hit = tlog[gone[0]]
    top = hit["state"]["scen"]["reward_prop"][1, 0]
    flags = hit["state"]["props"]["flags"][1]
    assert flags[top] & PROP_FLAG_VISIBLE == 0 and flags[top + 1] & PROP_FLAG_VISIBLE == 0
    assert flags.dtype == np.uint8 and (flags[:OBJ_MAX] & PROP_FLAG_VISIBLE).any()
    assert abs(hit["reward"][1, 0]) == 1.0                  # +-1 for the diamond
    fell = [t for t, p in enumerate(tlog) if p["reward"][1, 1] < 0.0]
    assert fell, "env 1 agent 1 must fall and pay the penalty"
    assert tlog[fell[0]]["state"]["agents"]["pos"][1, 1, 1] > 0.0, "teleported back"


def test_convert_carries_collect_state(scripted):
    """A JAX Collect state converted into the port steps like the port's own."""
    assert convert.scen_class("Collect") is CollectState
    jst = convert.to_numpy_tree(scripted["jenv"].state)
    tenv = scripted["tenv"]
    tst = convert.state_from_numpy(jst, scen_cls=CollectState, rng=tenv.state.rng)
    K.assert_trees_equal(convert.tree_to_numpy(tst.scen), jst["scen"], "scen")
    K.assert_trees_equal(convert.tree_to_numpy(tst.props), jst["props"], "props")
    np.testing.assert_allclose(tst.agents.pos.numpy(), tenv.state.agents.pos.numpy(), atol=1e-4)


def test_vector_env_determinism_and_auto_reset():
    """Same seed => identical observations and rewards across instances; with
    short episodes every env finishes, restarts from the layout buffer and its
    slot is refilled (episodes last episodeLengthSec + 2 s per diamond)."""
    def run(seed):
        env = TVectorEnv("Collect", num_envs=3, num_agents_per_env=1, seed=seed,
                         device="cpu", params={C.P_EPISODE_LENGTH_SEC: 0.5})
        env.scenario.cfg = dataclasses.replace(env.scenario.cfg, obs_height=H)
        obs = [env.reset()]
        rng = np.random.default_rng(5)
        rew, seen = [], 0
        for _ in range(4):
            o, r, d, _ = env.step(rng.integers(0, 2048, size=(3, 1)).astype(np.int32))
            obs.append(o)
            rew.append(r)
        # shorten what is left so that the run sees every env finish
        env.state = env.state.replace(episode_len_sec=torch.full((3,), 0.6))
        for _ in range(20):
            o, r, d, _ = env.step(rng.integers(0, 2048, size=(3, 1)).astype(np.int32))
            seen += int(d.sum())
            rew.append(r)
        env.flush()
        out = (torch.stack(obs), torch.stack(rew), seen, env.num_refilled_envs,
               int(env.state.num_frames.max()))
        env.close()
        return out

    a, b, c = run(11), run(11), run(12)
    assert a[0].shape == (5, 3, 1, H, 128, 3) and a[0].dtype == torch.uint8
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert a[2] == 3 and a[3] == 3, "every env finished once and was refilled"
    assert a[4] < 24
