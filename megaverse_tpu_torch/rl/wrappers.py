"""External-trainer environment wrapper (Sample-Factory-style interfaces).

Counterpart of the JAX package's megaverse_tpu/rl/wrappers.py and of the
reference's `megaverse_rl/megaverse_utils.py:30-122` Wrapper: it exposes the
PBT reward-shaping interface, per-episode true-objective and reward stats,
and optional team-spirit annealing over training progress, so any SF-style
trainer (or the in-repo one) can drive a MegaverseEnv without knowing
anything about its internals.

No hard dependency on `sample_factory` or `gym`: if sample_factory is
installed, `MegaverseWrapper` satisfies its RewardShapingInterface /
TrainingInfoInterface protocols structurally (same method names/semantics);
otherwise it works standalone. Step returns the 5-tuple
(obs, rewards, terminated, truncated, infos) gymnasium convention like the
reference wrapper does.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from megaverse_tpu_torch.gym_env import MegaverseEnv, make_env_multitask


class MegaverseSpec:
    def __init__(self, name: str):
        self.name = name


MEGAVERSE_ENVS = [
    MegaverseSpec("TowerBuilding"),
    MegaverseSpec("ObstaclesEasy"),
    MegaverseSpec("ObstaclesHard"),
    MegaverseSpec("Collect"),
    MegaverseSpec("Sokoban"),
    MegaverseSpec("HexMemory"),
    MegaverseSpec("HexExplore"),
    MegaverseSpec("Rearrange"),
    MegaverseSpec("multitask_obstacles"),
    MegaverseSpec("multitask_megaverse8"),
]


class MegaverseWrapper:
    """Reward-shaping + training-info wrapper over MegaverseEnv.

    Mirrors megaverse_utils.Wrapper (megaverse_utils.py:30-90): accumulates
    per-actor episode rewards, attaches `true_objective` and
    `episode_extra_stats` to infos on done, and anneals teamSpirit 0 -> 1
    over `max_team_spirit_steps` using the trainer-provided
    `training_info["approx_total_training_steps"]`.
    """

    def __init__(self, env: MegaverseEnv, increase_team_spirit: bool = False,
                 max_team_spirit_steps: float = 1e9):
        self.env = env
        self.num_agents = env.num_agents
        self.is_multiagent = env.is_multiagent
        self.episode_rewards: List[float] = [0.0] * self.num_agents
        self.increase_team_spirit = increase_team_spirit
        self.max_team_spirit_steps = max_team_spirit_steps
        # TrainingInfoInterface: the trainer deposits progress info here.
        self.training_info: Dict = {}

    # -- passthrough ---------------------------------------------------------
    @property
    def unwrapped(self) -> MegaverseEnv:
        return self.env

    @property
    def action_space(self):
        return self.env.action_space

    @property
    def observation_space(self):
        return self.env.observation_space

    def seed(self, seed=None):
        return self.env.seed(seed)

    def render(self, mode="human"):
        return self.env.render(mode)

    def close(self):
        return self.env.close()

    # -- RewardShapingInterface ---------------------------------------------
    def get_default_reward_shaping(self) -> Dict[str, float]:
        return self.env.get_default_reward_shaping()

    def get_current_reward_shaping(self, agent_idx: int) -> Dict[str, float]:
        return self.env.get_current_reward_shaping(agent_idx)

    def set_reward_shaping(self, reward_shaping: dict, agent_idx: int) -> None:
        return self.env.set_reward_shaping(reward_shaping, agent_idx)

    # -- TrainingInfoInterface ----------------------------------------------
    def set_training_info(self, training_info: Dict) -> None:
        self.training_info = training_info

    # -- env API -------------------------------------------------------------
    def reset(self, **kwargs):
        self.episode_rewards = [0.0] * self.num_agents
        return self.env.reset(), {}

    def step(self, action):
        obs, rewards, dones, infos = self.env.step(action)
        scen = self.env.scenario_name.casefold()

        for i, info in enumerate(infos):
            self.episode_rewards[i] += rewards[i]
            if not dones[i]:
                continue
            extra = info.setdefault("episode_extra_stats", {})
            info["true_objective"] = info.get("true_reward", 0.0)
            extra[f"z_{scen}_true_objective"] = info["true_objective"]
            extra[f"z_{scen}_reward"] = self.episode_rewards[i]
            steps = self.training_info.get("approx_total_training_steps", 0)
            extra["z_approx_total_training_steps"] = steps
            self.episode_rewards[i] = 0.0

            if self.increase_team_spirit:
                rs = self.get_current_reward_shaping(i)
                rs["teamSpirit"] = min(steps / self.max_team_spirit_steps, 1.0)
                self.set_reward_shaping(rs, i)
                extra["teamSpirit"] = rs["teamSpirit"]

        truncated = [False] * len(dones)
        return obs, rewards, dones, truncated, infos


def make_megaverse(env_name: str, cfg=None, env_config=None,
                   render_mode: Optional[str] = None, device=None, **kwargs):
    """Env factory in the reference's register_env shape
    (megaverse_utils.py:92-122). `cfg` needs the megaverse_* attributes the
    reference adds via add_megaverse_args; missing ones take its defaults.
    `device` is the env's device (None: CUDA, as for VectorEnv)."""
    scenario_name = env_name.casefold()
    get = lambda k, d: getattr(cfg, k, d) if cfg is not None else d
    num_envs = get("megaverse_num_envs_per_instance", 1)
    num_agents = get("megaverse_num_agents_per_env", 1)
    threads = get("megaverse_num_simulation_threads", 1)
    use_vulkan = get("megaverse_use_vulkan", False)

    if "multitask" in scenario_name:
        task_idx = (env_config or {}).get("worker_index", 0)
        env = make_env_multitask(
            scenario_name, task_idx, num_envs=num_envs,
            num_agents_per_env=num_agents,
            num_simulation_threads=threads, use_vulkan=use_vulkan, device=device)
    else:
        env = MegaverseEnv(
            scenario_name=scenario_name, num_envs=num_envs,
            num_agents_per_env=num_agents,
            num_simulation_threads=threads, use_vulkan=use_vulkan, device=device)

    return MegaverseWrapper(
        env,
        increase_team_spirit=get("megaverse_increase_team_spirit", False),
        max_team_spirit_steps=get("megaverse_max_team_spirit_steps", 1e9),
    )
