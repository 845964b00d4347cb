"""Reference-compatible Gym-style environment API.

Mirrors megaverse/megaverse_env.py (MegaverseEnv + make_env_multitask): fixed
128x72 RGB CHW uint8 observations as a flat list over num_envs x
num_agents_per_env actors, Tuple-of-Discrete action space, (obs, rewards,
dones, infos) step returns with true_reward in info on done, and the
reward-shaping passthrough keyed by flat actor index.

This is the drop-in compatibility surface (it copies observations to the
host per step, like the reference bindings do); high-throughput consumers
should use megaverse_tpu_torch.VectorEnv directly, which keeps everything on
the device. Counterpart of megaverse_tpu/gym_env.py; it runs on the GPU
unless the caller passes device="cpu".
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from megaverse_tpu_torch import constants as C
from megaverse_tpu_torch.vector_env import VectorEnv

# ref megaverse_env.py:11-24
MEGAVERSE8 = [
    "TowerBuilding",
    "ObstaclesEasy",
    "ObstaclesHard",
    "Collect",
    "Sokoban",
    "HexMemory",
    "HexExplore",
    "Rearrange",
]

OBSTACLES_MULTITASK = [
    "ObstaclesWalls", "ObstaclesSteps", "ObstaclesLava", "ObstaclesEasy", "ObstaclesHard",
]

_LOG_LEVEL = 2


def set_megaverse_log_level(level: int) -> None:
    """ref bindings set_megaverse_log_level (megaverse.cpp:271)."""
    global _LOG_LEVEL
    _LOG_LEVEL = level


def make_env_multitask(multitask_name, task_idx, num_envs, num_agents_per_env,
                       num_simulation_threads=1, use_vulkan=False, params=None,
                       device=None):
    """ref megaverse_env.py:27-39: task chosen by worker_index % len(tasks)."""
    assert "multitask" in multitask_name
    if multitask_name.endswith("megaverse8"):
        tasks = MEGAVERSE8
    elif multitask_name.endswith("obstacles"):
        tasks = OBSTACLES_MULTITASK
    else:
        raise NotImplementedError(multitask_name)
    scenario = tasks[task_idx % len(tasks)]
    return MegaverseEnv(scenario, num_envs, num_agents_per_env,
                        num_simulation_threads, use_vulkan, params, device=device)


class MegaverseEnv:
    """gym.Env-compatible wrapper (ref megaverse_env.py:42-201).

    `num_simulation_threads` and `use_vulkan` are accepted for signature
    compatibility; simulation is batched on the device and renders through
    the CUDA kernel. `device=None` means CUDA (raising without a GPU), as
    for VectorEnv.
    """

    is_multiagent = True

    def __init__(self, scenario_name: str, num_envs: int, num_agents_per_env: int,
                 num_simulation_threads: int = 1, use_vulkan: bool = False,
                 params: Optional[Dict[str, float]] = None, device=None):
        self.scenario_name = scenario_name.casefold()
        self.img_w = C.OBS_WIDTH
        self.img_h = C.OBS_HEIGHT
        self.channels = 3
        self.num_agents = num_envs * num_agents_per_env
        self.num_envs = num_envs
        self.num_agents_per_env = num_agents_per_env

        float_params = {}
        if params is not None:
            for k, v in params.items():
                if isinstance(v, float):
                    float_params[k] = v
                else:
                    raise Exception("Params of type %r not supported" % type(v))

        self.env = VectorEnv(
            self.scenario_name, num_envs=num_envs,
            num_agents_per_env=num_agents_per_env, params=float_params or None,
            device=device,
        )
        self.default_shaping_scheme = self.env.get_reward_shaping(0, 0)
        self.action_space = self.generate_action_space(self.env.action_space_sizes)
        self.observation_space = self._box_space()

    @staticmethod
    def _box_space():
        try:
            import gym

            return gym.spaces.Box(0, 255, (3, C.OBS_HEIGHT, C.OBS_WIDTH), dtype=np.uint8)
        except ImportError:
            return ("box", 0, 255, (3, C.OBS_HEIGHT, C.OBS_WIDTH), np.uint8)

    @staticmethod
    def generate_action_space(action_space_sizes):
        try:
            import gym
            from gym.spaces import Discrete

            return gym.spaces.Tuple([Discrete(sz) for sz in action_space_sizes])
        except ImportError:
            return tuple(action_space_sizes)

    def seed(self, seed=None):
        if seed is None:
            return
        assert isinstance(seed, int), "Expect seed to be an integer"
        self.env.seed(seed)

    def _observations(self, obs) -> List[np.ndarray]:
        """Device obs -> flat list of CHW uint8 (ref megaverse_env.py:121-130)."""
        arr = self.env.unpack_obs(obs).cpu().numpy()  # [B, A, H, W, 3]
        out = []
        for env_i in range(self.num_envs):
            for agent_i in range(self.num_agents_per_env):
                out.append(np.transpose(arr[env_i, agent_i], (2, 0, 1)))
        return out

    def reset(self):
        obs = self.env.reset()
        return self._observations(obs)

    def step(self, actions):
        md = np.asarray(actions, np.int64).reshape(
            self.num_envs, self.num_agents_per_env, 6)
        obs, rewards, dones, tobj = self.env.step(md)

        rewards_np = rewards.cpu().numpy().reshape(-1).tolist()
        dones_np = dones.cpu().numpy()
        tobj_np = tobj.cpu().numpy()

        done_list, infos = [], []
        for env_i in range(self.num_envs):
            done = bool(dones_np[env_i])
            done_list.extend([done] * self.num_agents_per_env)
            if done:
                infos.extend([
                    dict(true_reward=float(tobj_np[env_i, j]))
                    for j in range(self.num_agents_per_env)
                ])
            else:
                infos.extend([{} for _ in range(self.num_agents_per_env)])

        return self._observations(obs), rewards_np, done_list, infos

    def render(self, mode="human"):
        """Tiled grid of agent views (ref render, megaverse_env.py:170-184);
        returns the composed image instead of opening a window."""
        obs = self.env.unpack_obs(self.env.render()).cpu().numpy()
        rows = [np.concatenate(list(obs[e]), axis=1) for e in range(self.num_envs)]
        return np.concatenate(rows, axis=0)

    # reward shaping passthrough (ref megaverse_env.py:186-197)
    def get_default_reward_shaping(self):
        return self.default_shaping_scheme

    def get_current_reward_shaping(self, actor_idx: int):
        env_idx = actor_idx // self.num_agents_per_env
        agent_idx = actor_idx % self.num_agents_per_env
        return self.env.get_reward_shaping(env_idx, agent_idx)

    def set_reward_shaping(self, reward_shaping: dict, actor_idx: int):
        env_idx = actor_idx // self.num_agents_per_env
        agent_idx = actor_idx % self.num_agents_per_env
        return self.env.set_reward_shaping(env_idx, agent_idx, reward_shaping)

    def close(self):
        if self.env is not None:
            self.env.close()
        self.env = None
