"""The port's Gym surface (megaverse_tpu_torch.gym_env, rl.wrappers): mirrors
of tests/test_gym_env.py on the CPU (device="cpu"), plus the reference's
Sokoban random-step smoke run (tests/test_integration.py:74) cut to 60 steps."""

import numpy as np
import pytest

import torch_port_checks  # noqa: F401  (one torch thread)
import megaverse_tpu_torch.constants as C
from megaverse_tpu_torch.gym_env import (
    MEGAVERSE8,
    OBSTACLES_MULTITASK,
    MegaverseEnv,
    make_env_multitask,
    set_megaverse_log_level,
)


def test_task_lists():
    assert MEGAVERSE8 == ["TowerBuilding", "ObstaclesEasy", "ObstaclesHard",
                          "Collect", "Sokoban", "HexMemory", "HexExplore",
                          "Rearrange"]
    assert OBSTACLES_MULTITASK == ["ObstaclesWalls", "ObstaclesSteps", "ObstaclesLava",
                                   "ObstaclesEasy", "ObstaclesHard"]


def test_lifecycle_and_shapes():
    set_megaverse_log_level(2)
    env = MegaverseEnv("Empty", num_envs=2, num_agents_per_env=2, device="cpu")
    env.seed(3)
    obs = env.reset()
    assert len(obs) == 4
    assert obs[0].shape == (3, 72, 128)
    assert obs[0].dtype == np.uint8

    acts = [np.zeros(6, np.int64) for _ in range(4)]
    obs, rewards, dones, infos = env.step(acts)
    assert len(obs) == len(rewards) == len(dones) == len(infos) == 4
    assert all(isinstance(r, float) for r in rewards)
    env.close()


def test_true_reward_in_info_on_done():
    env = MegaverseEnv("Empty", num_envs=1, num_agents_per_env=1,
                       params={C.P_EPISODE_LENGTH_SEC: 0.5}, device="cpu")
    env.reset()
    acts = [np.zeros(6, np.int64)]
    saw_done = False
    for _ in range(10):
        obs, rew, dones, infos = env.step(acts)
        if dones[0]:
            saw_done = True
            assert "true_reward" in infos[0]
            break
        assert infos[0] == {}
    assert saw_done
    env.close()


def test_reward_shaping_passthrough():
    env = MegaverseEnv("Collect", num_envs=1, num_agents_per_env=2, device="cpu")
    default = env.get_default_reward_shaping()
    assert "collectSingleGood" in default
    rs = dict(default)
    rs["collectSingleGood"] = 2.5
    env.set_reward_shaping(rs, actor_idx=1)
    assert env.get_current_reward_shaping(1)["collectSingleGood"] == 2.5
    assert env.get_current_reward_shaping(0)["collectSingleGood"] == 1.0
    env.close()


def test_params_must_be_floats():
    with pytest.raises(Exception, match="not supported"):
        MegaverseEnv("Empty", 1, 1, params={C.P_EPISODE_LENGTH_SEC: 5}, device="cpu")


def test_multitask_factory_rotation():
    names = []
    for i in range(len(MEGAVERSE8) + 1):
        env = make_env_multitask("multitask_megaverse8", i, 1, 1, device="cpu")
        names.append(env.scenario_name)
        env.close()
    assert names == [n.casefold() for n in MEGAVERSE8 + MEGAVERSE8[:1]]
    env = make_env_multitask("multitask_obstacles", 2, 1, 1, device="cpu")
    assert env.scenario_name == "obstacleslava"
    env.close()


def test_render_returns_tiled_image():
    env = MegaverseEnv("Empty", num_envs=1, num_agents_per_env=2, device="cpu")
    env.reset()
    img = env.render()
    assert img.shape == (72, 2 * 128, 3) and img.dtype == np.uint8
    env.close()


def test_external_trainer_wrapper():
    """MegaverseWrapper: SF-style shaping/training-info interfaces + episode
    stats + team-spirit annealing (ref megaverse_utils.py:30-90)."""
    from megaverse_tpu_torch.rl.wrappers import MegaverseWrapper

    env = MegaverseEnv("Empty", num_envs=1, num_agents_per_env=2,
                       params={C.P_EPISODE_LENGTH_SEC: 0.5}, device="cpu")
    w = MegaverseWrapper(env, increase_team_spirit=True, max_team_spirit_steps=100.0)
    w.set_training_info({"approx_total_training_steps": 50})
    obs, info0 = w.reset()
    assert len(obs) == 2 and info0 == {}

    acts = [np.zeros(6, np.int64)] * 2
    saw_done = False
    for _ in range(12):
        obs, rew, dones, trunc, infos = w.step(acts)
        assert trunc == [False, False]
        if dones[0]:
            saw_done = True
            extra = infos[0]["episode_extra_stats"]
            assert "true_objective" in infos[0]
            assert "z_empty_reward" in extra
            assert extra["z_approx_total_training_steps"] == 50
            # annealed teamSpirit = 50/100
            assert abs(w.get_current_reward_shaping(0)["teamSpirit"] - 0.5) < 1e-6
            break
    assert saw_done
    # episode reward accumulator resets on done
    assert w.episode_rewards == [0.0, 0.0]
    w.close()


def test_make_megaverse_factory():
    from megaverse_tpu_torch.rl.wrappers import make_megaverse

    w = make_megaverse("Empty", device="cpu")
    obs, _ = w.reset()
    assert len(obs) == 1 and obs[0].shape == (3, 72, 128)
    w.close()

    class Cfg:
        megaverse_num_envs_per_instance = 1
        megaverse_num_agents_per_env = 2

    w = make_megaverse("multitask_obstacles", cfg=Cfg(), env_config={"worker_index": 1},
                       device="cpu")
    assert w.unwrapped.scenario_name == "obstaclessteps" and w.num_agents == 2
    w.close()


def test_sokoban_random_steps():
    """Random steps through the gym API without error (ref
    megaverse_rl/tests/test_megaverse_env.py:9-25; the JAX package's run takes
    1000 steps and is marked slow, this one 60)."""
    env = MegaverseEnv("Sokoban", num_envs=2, num_agents_per_env=1, device="cpu")
    env.seed(0)
    env.reset()
    rng = np.random.default_rng(0)
    for _ in range(60):
        acts = [rng.integers(0, [3, 3, 3, 2, 2, 3]) for _ in range(2)]
        obs, rewards, dones, infos = env.step(acts)
    assert len(obs) == 2 and len(rewards) == 2
    assert all(np.isfinite(r) for r in rewards)
    env.close()


def test_default_device_is_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        MegaverseEnv("Empty", 1, 1)
