"""Helpers of the CPU tests of the four-agent TowerBuilding and the Empty
cells: their small sizes, layouts that put the agents' collisions and the
team reward inside a few ticks, and the program and the frozen reference
stepped side by side.

Every patch of the layouts here goes to the program and the reference
alike, through pytest's `monkeypatch`, so both still make the same layouts
and the test takes it out again; the episodes are shortened as
`bench_helpers.short_episodes` shortens them."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import judge as J
from reference.sim import constants as RC
from reference.sim import env as RE
from reference.sim.scenarios import make_scenario as make_reference_scenario
from reference.sim.types import state_from_scene

SMALL = {
    "appo.towerbuilding_256x4": {
        "traffic": dict(num_envs=2, check_envs=2, layout_workers=0, check_frames=1,
                        check_done_envs=1, check_done_within_iterations=1,
                        warmup_iterations=3, profile_from_iteration=0),
        "config": dict(hidden_size=32, rollout=4)},
    "sampler.empty_4096x1": {
        "traffic": dict(num_envs=2, check_envs=2, warmup_chunks=3, chunk_steps=4,
                        check_within_chunks=1, check_chunks=1, check_done_envs=1,
                        check_done_within_chunks=1, profile_from_chunk=0, profile_chunks=1)},
}

# a small walled platform whose building zone holds the materials, so that
# a pickup is a visit of the zone with an object (a team reward)
CROWDED = dict(height=5, length=14, width=14, bz_l=10, bz_w=10, bz_x=2, bz_z=2,
               mat_l=6, mat_w=6, mat_x=4, mat_z=4)
# the agents' spawn offsets along x inside agent 0's cell: 0.2 m apart,
# closer than two capsule radii (0.66 m), so they collide at once
SPREAD = (-0.3, -0.1, 0.1, 0.3)


def crowded_towers(monkeypatch) -> None:
    """TowerBuilding's layouts on the CROWDED platform, every agent spawned
    in agent 0's cell at the SPREAD offsets (once: a second call leaves
    them as they are)."""
    import megaverse_tpu_torch.scenarios.tower_building as program
    from reference.sim.scenarios import tower_building as reference

    for mod in (program, reference):
        cls = mod.TowerBuildingScenario
        if getattr(cls.generate, "crowded", False):
            continue

        def draw(rr, _real=cls._draw_platform):
            return dict(_real(rr), **CROWDED)

        def generate(self, rng, _real=cls.generate):
            scene = _real(self, rng)
            spawn = np.repeat(np.asarray(scene.agent_spawn[:1], np.float32),
                              len(scene.agent_spawn), axis=0)
            spawn[:, 0] += np.asarray(SPREAD[:len(spawn)], np.float32)
            return scene.replace(agent_spawn=spawn)
        generate.crowded = True
        monkeypatch.setattr(cls, "_draw_platform", staticmethod(draw))
        monkeypatch.setattr(cls, "generate", generate)


def side_by_side(name: str, num_agents: int, seed: int, ticks: int = 20,
                 num_envs: int = 2, height: int = 24):
    """The program's `VectorEnv` (CPU, packed frames of `height` rows) and
    the frozen reference from the same layout seed, under the same random
    actions for `ticks` ticks. Returns the per-tick readings of both:
    [(program, reference)], each {"state": leaves, "reward", "done",
    "frame"}, and the layout gap at reset ((env, leaf) pairs)."""
    from megaverse_tpu_torch.vector_env import VectorEnv

    env = VectorEnv(name, num_envs, num_agents_per_env=num_agents, seed=seed, device="cpu",
                    obs_format="packed")
    env.scenario.cfg = dataclasses.replace(env.scenario.cfg, obs_height=height)
    scenario = make_reference_scenario(name, num_agents=num_agents)
    scenario.cfg = dataclasses.replace(scenario.cfg, obs_height=height)
    try:
        env.reset()
        ids = list(range(num_envs))
        lay = J.ReferenceLayouts(scenario, seed, num_envs, ids)
        template = lay.layout(0, 0)
        first = J.rebuild(template, {k: torch.as_tensor(np.asarray(v))
                                     for k, v in lay.stacked(ids, [0] * num_envs).items()})
        nxt = J.rebuild(template, {k: torch.as_tensor(np.asarray(v))
                                   for k, v in lay.stacked(ids, [1] * num_envs).items()})
        rng = torch.arange(num_envs, dtype=torch.int64) + (int(seed) << 20)
        state = state_from_scene(first, num_agents, rng)
        layout_gap = J.mismatches(J.to_host(J.leaves(env.state)), J.leaves(state))
        shaping = torch.from_numpy(np.tile(scenario.shaping_array()[None], (num_envs, 1, 1)))
        pool = J.action_pool(seed, num_envs, num_agents, ticks, RC.ACTION_SPACE_SIZES,
                             RC.ACTION_HEAD_BITS)
        out = []
        for t in range(ticks):
            obs, reward, done, _ = env.step(pool[t])
            prog = {"state": {k: v.clone() for k, v in J.leaves(env.state).items()},
                    "reward": reward.clone(), "done": done.clone(), "frame": obs.clone()}
            with torch.no_grad():
                res = RE.env_step(scenario, state, nxt, torch.from_numpy(pool[t]), shaping)
                state = res.state
                ref = {"state": {k: v.clone() for k, v in J.leaves(state).items()},
                       "reward": res.reward, "done": res.done,
                       "frame": RE.render(scenario, state)}
            out.append((prog, ref))
        return out, layout_gap
    finally:
        env.close()


def skip_agent_collisions(monkeypatch) -> None:
    """Planted in the program: the agents' collision phase of the physics
    step is left out (on the CPU the physics runs `player_step`, then
    `resolve_agent_collisions`; the card's KCC kernel holds both)."""
    import megaverse_tpu_torch.ops.physics as P

    monkeypatch.setattr(P, "resolve_agent_collisions", lambda agents, *args, **kw: agents)


def drop_team_spirit(monkeypatch) -> None:
    """Planted in the program: the team reward is paid as if team spirit
    were 0, so the acting agent keeps all of it and its teammates get
    nothing."""
    import megaverse_tpu_torch.scenarios.base as B
    from megaverse_tpu_torch import constants as C

    real = B.Scenario.reward_team

    def reward_team(self, rewards, shaping, key, agent_idx_mask, multiplier):
        shaping = shaping.clone()
        shaping[..., self.all_shaping_keys.index(C.P_TEAM_SPIRIT)] = 0.0
        return real(self, rewards, shaping, key, agent_idx_mask, multiplier)
    monkeypatch.setattr(B.Scenario, "reward_team", reward_team)


FAULTS = {"agent_collisions_skipped": skip_agent_collisions,
          "team_spirit_dropped": drop_team_spirit}


def team_reward_ticks(readings) -> list:
    """Ticks at which every agent of some env was paid by the reference:
    a team reward shared over the team."""
    return [t for t, (_, ref) in enumerate(readings)
            if bool((ref["reward"] != 0).all(dim=1).any())]


def first_disagreement(readings):
    """(tick, what) of the first reading in which the program and the
    reference differ at all; None where they agree exactly throughout."""
    for t, (prog, ref) in enumerate(readings):
        if J.tree_gap(prog["state"], ref["state"]) != 0.0:
            return t, "state"
        for key in ("reward", "done", "frame"):
            if not torch.equal(prog[key], ref[key]):
                return t, key
    return None
