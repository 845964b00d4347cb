"""Multitask and team-spirit training of the port (megaverse_tpu_torch.rl.train)
on the CPU, and the render-stage profiler.

One module-scoped run of `train.main` on `multitask_obstacles` (the five
Obstacles tasks, 2 envs each, hidden 32, rollout 2, 5 updates, the tasks'
first layouts made by setup worker processes, ObstaclesHard's object grid
sparse-packed on the way back), watched through its `observer`:
- the updates run the tasks in gym_env.OBSTACLES_MULTITASK order, the shared
  Adam count equals the number of updates, and the parameters after it are
  EQUAL, bit for bit, to the same updates composed by hand through each
  task's own `collect_rollout` and `Learner._update_from_batch` in turn, on
  tasks set up in this process (serial layouts);
- each task's first layouts (the state it starts from and its next-layout
  buffer) EQUAL those the JAX package's scenarios generate from
  `seed + 1000 * i` with the JAX trainer's per-env streams
  (megaverse_tpu/rl/train.py:107-111, :277): both generators are numpy, so
  no JAX step compiles here.
Team spirit: TowerBuilding 2 envs x 4 agents with annealing over two
updates' env steps: the shaping column after each update is
min(1, steps done / max steps), the reference's formula
(megaverse_tpu/rl/train.py:326-330). scripts/profile_render_stages_torch.py
prints its stages on the CPU at a tiny size.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import torch_port_checks as K
from megaverse_tpu.scenarios import make_scenario as j_make_scenario
from megaverse_tpu_torch import convert
from megaverse_tpu_torch.gym_env import OBSTACLES_MULTITASK
from megaverse_tpu_torch.rl import train
from megaverse_tpu_torch.rl.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS, ROLLOUT, UPDATES, SEED = 2, 2, 5, 42
ARGS = ["--env", "multitask_obstacles", "--num_envs", str(ENVS), "--hidden_size", "32",
        "--rollout", str(ROLLOUT), "--seed", str(SEED), "--device", "cpu",
        "--train_for_env_steps", str(UPDATES * ROLLOUT * ENVS)]


@pytest.fixture(scope="module")
def multitask(tmp_path_factory):
    """train.main on multitask_obstacles (setup workers); what the
    observer saw: each task's state and next layouts as set up (numpy), its
    generators' states, the task each update ran, the last parameters."""
    out = tmp_path_factory.mktemp("multitask")
    seen = {"stepped": []}

    def observer(it, tasks, metrics):
        if it == 0:
            seen["state"] = [convert.tree_to_numpy(t.ls.env_state) for t in tasks]
            seen["next"] = [convert.tree_to_numpy(t.next_scenes) for t in tasks]
            seen["gens"] = [[g.bit_generator.state for g in t.gens] for t in tasks]
            return
        task = tasks[(it - 1) % len(tasks)]
        seen["stepped"].append(task.name)
        seen["params"] = {k: v.clone() for k, v in task.ls.params.items()}

    assert train.main(ARGS + ["--train_dir", str(out)], observer=observer) == 0
    seen["summary"] = json.loads((out / "default" / "train_summary.json").read_text())
    seen["ckpt"] = load_checkpoint(out / "default" / "checkpoint.pkl")
    return seen


def test_multitask_round_robin_equals_the_updates_composed_by_hand(multitask):
    names = list(OBSTACLES_MULTITASK)
    assert multitask["stepped"] == names and multitask["summary"]["tasks"] == names
    assert set(multitask["summary"]["task_metrics"]) == set(names)
    assert multitask["ckpt"]["opt_state"]["count"] == UPDATES
    assert multitask["ckpt"]["steps"] == UPDATES * ROLLOUT * ENVS

    args = train.parse_args(ARGS)
    cfg = train.TrainConfig(rollout=ROLLOUT, hidden_size=32,
                            total_env_steps=float(args.train_for_env_steps))
    tasks, _ = train._make_tasks(train.resolve_task_list(args.env), args, cfg,
                                 torch.device("cpu"), workers=0)
    try:
        # the setup workers' generators stand where the serial setup's do
        assert [[g.bit_generator.state for g in t.gens] for t in tasks] == multitask["gens"]
        params, opt_state = tasks[0].ls.params, tasks[0].ls.opt_state
        for it in range(UPDATES):
            task = tasks[it % len(tasks)]
            ls = task.ls._replace(params=params, opt_state=opt_state)
            ls, batch = task.learner.collect_rollout(ls, task.next_scenes, task.shaping)
            ls, _ = task.learner._update_from_batch(ls, batch)
            task.ls = ls
            params, opt_state = ls.params, ls.opt_state
            task.refill()
    finally:
        for t in tasks:
            t.close()
    assert opt_state["count"] == UPDATES
    for k, v in params.items():
        assert torch.equal(multitask["params"][k], v), k
    saved = convert.actor_critic_from_flax(multitask["ckpt"]["params"])
    for k, v in params.items():
        assert torch.equal(saved[k], v), k


def stacked(trees):
    """Per-env numpy trees (nested dicts) -> one tree with a leading env axis."""
    if isinstance(trees[0], dict):
        return {k: stacked([t[k] for t in trees]) for k in trees[0]}
    return None if trees[0] is None else np.stack(trees)


@pytest.mark.parametrize("i", range(len(OBSTACLES_MULTITASK)))
def test_task_first_layouts_equal_the_jax_generators(multitask, i):
    name = OBSTACLES_MULTITASK[i]
    scenario = j_make_scenario(name, num_agents=1)
    gens = [np.random.Generator(np.random.PCG64(s))
            for s in np.random.SeedSequence(SEED + 1000 * i).spawn(ENVS)]
    first = stacked([convert.to_numpy_tree(scenario.generate_checked(g)) for g in gens])
    following = stacked([convert.to_numpy_tree(scenario.generate_checked(g)) for g in gens])
    K.assert_trees_equal(multitask["next"][i], following, f"{name} next")
    state = multitask["state"][i]
    shared = sorted(set(first) & set(state))
    assert {"box_lo", "box_hi", "box_color", "vobj", "vterrain", "props"} <= set(shared)
    for key in shared:
        K.assert_trees_equal(state[key], first[key], f"{name} {key}")
    np.testing.assert_array_equal(state["agents"]["pos"], first["agent_spawn"])
    np.testing.assert_array_equal(state["agents"]["yaw"], first["agent_yaw"])


def test_team_spirit_anneals_by_the_reference_formula(tmp_path):
    per_update = ROLLOUT * ENVS
    max_steps = 2 * per_update
    column, default = [], []

    def observer(it, tasks, metrics):
        t = tasks[0]
        column.append(t.shaping[:, :, t.spirit_col].clone())
        default.append(torch.from_numpy(t.scenario.shaping_array()[:, t.spirit_col]))

    argv = ["--env", "TowerBuilding", "--num_envs", str(ENVS), "--num_agents_per_env", "4",
            "--hidden_size", "32", "--rollout", str(ROLLOUT), "--device", "cpu",
            "--train_for_env_steps", str(3 * per_update), "--train_dir", str(tmp_path),
            "--megaverse_increase_team_spirit", "1",
            "--megaverse_max_team_spirit_steps", str(max_steps)]
    assert train.main(argv, observer=observer) == 0
    assert len(column) == 4 and column[0].shape == (ENVS, 4)
    assert bool((column[0] == default[0]).all())     # the scenario's default
    for it, col in enumerate(column[1:], start=1):
        want = min(1.0, it * per_update / max_steps)
        assert bool((col == want).all()), (it, col, want)


def test_profile_render_stages_prints_every_stage(capsys):
    path = os.path.join(ROOT, "scripts", "profile_render_stages_torch.py")
    spec = importlib.util.spec_from_file_location("profile_render_stages_torch", path)
    P = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(P)
    assert P.main(["--num_envs", "2", "--steps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    for stage in P.STAGES:
        assert any(line.startswith(stage + " ") for line in out), stage
    res = json.loads(out[-1])
    assert set(res["ms"]) == set(P.STAGES) and all(v > 0 for v in res["ms"].values())
    assert res["scenario"] == "Collect" and res["pvs_mask"] is False
