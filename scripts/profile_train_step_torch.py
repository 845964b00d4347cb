#!/usr/bin/env python
"""Attribute the training step's time on the card (twin of
scripts/profile_train_step.py).

Usage: python3 scripts/profile_train_step_torch.py [--scenario Collect]
       [--num_envs 1024] [--num_agents 1] [--rollout 32] [--iters 3]
       [--device cuda]

Sets up the trainer's own task (`rl.train._Task`: layouts, render bucket,
learner, hidden 512), runs one rollout (which binds the env state in the
learner's tick buffers and, on the card, captures the tick's graph), and
then times each part on its own, warmed, `--iters` repeats, with CUDA events
(the host clock on the CPU):
  sim            one eager tick of the bound batch, no render (env_step,
                 write-back, deferred reset: physics + logic)
  render         `render_batch` of the bound state: the bit-walk's cull
                 prologue and one B2 launch
  b2 kernel      the B2 launch alone, on a fixed state's tables
  tick           one tick as the rollout runs it (sim + render; on the card
                 a replay of its CUDA graph)
  policy fwd     the ActorCritic forward (conv + GRU + heads) on one obs batch
  rollout step   the learner's `collect_rollout` over the rollout, per step
                 (policy + sampling + tick)
  forward-seq    the update's forward over the whole rollout
  update         `_update_from_batch`: GAE, forward + backward, clip, Adam

and derives train env-steps/s against pure-sampling env-steps/s (the tick
alone), and the shares of the update and of B2 in a train step. The last line is the same
numbers as one JSON object, beside the card's name and power limit.
"""

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PARTS = ("sim", "render", "b2_kernel", "tick", "policy_fwd", "rollout_step", "forward_seq",
         "update")


def timer(device: torch.device, reps: int):
    """timeit(fn) -> seconds per call of fn, after one warm call: CUDA
    events around `reps` calls on the card, the host clock on the CPU."""
    def timeit(fn):
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    return timeit


def profile(scenario: str, num_envs: int, num_agents: int, rollout: int, iters: int,
            device: str) -> dict:
    """Seconds per call of each of PARTS, and what derives from them."""
    from megaverse_tpu_torch.env import render_batch, render_tables
    from megaverse_tpu_torch.ops import raycast_cuda as RC
    from megaverse_tpu_torch.rl import train as T
    from megaverse_tpu_torch.rl.learner import TrainConfig

    dev = T.resolve_device(device)
    args = T.parse_args(["--env", scenario, "--num_envs", str(num_envs),
                         "--num_agents_per_env", str(num_agents), "--rollout", str(rollout)])
    cfg = TrainConfig(rollout=rollout, hidden_size=args.hidden_size)
    task = T._Task(scenario, args, cfg, args.seed, dev)
    try:
        learner, ticks, scen = task.learner, task.learner.ticks, task.scenario
        timeit = timer(dev, max(iters, 3))
        act0 = torch.zeros((num_envs, num_agents), dtype=torch.int32, device=dev)
        tabs = render_tables(scen, task.ls.env_state, bucket=task.bucket,
                             mode=learner.render_mode)
        h, w = scen.cfg.obs_height, scen.cfg.obs_width
        # the first rollout binds the state (later ones advance that copy in
        # place) and warms and captures the tick
        ls, batch = learner.collect_rollout(task.ls, task.next_scenes, task.shaping)
        tick = dict(fmt="packed", bucket=learner.render_bucket, mode=learner.render_mode)

        def roll():
            nonlocal ls
            ls, _ = learner.collect_rollout(ls, task.next_scenes, task.shaping)

        with torch.no_grad():
            sec = {
                "sim": timeit(lambda: ticks.run(act0, render=False, eager=True)),
                "render": timeit(lambda: render_batch(scen, ls.env_state, fmt="packed",
                                                      bucket=learner.render_bucket,
                                                      mode=learner.render_mode)),
                "b2_kernel": timeit(lambda: RC.render_packed(height=h, width=w, **tabs)),
                "tick": timeit(lambda: ticks.run(act0, **tick)),
                "policy_fwd": timeit(lambda: learner._policy(ls.params, ls.obs, ls.carry)),
                "rollout_step": timeit(roll) / rollout,
                "forward_seq": timeit(lambda: learner._forward_sequence(ls.params, batch)),
            }
        sec["update"] = timeit(lambda: learner._update_from_batch(ls, batch))
    finally:
        task.close()
    n = rollout * num_envs * num_agents
    t_train = rollout * sec["rollout_step"] + sec["update"]
    t_sample = rollout * sec["tick"]
    return {"ms": {k: 1e3 * v for k, v in sec.items()},
            "train_step_ms": 1e3 * t_train,
            "train_env_steps_per_s": n / t_train,
            "sampling_env_steps_per_s": n / t_sample,
            "train_over_sampling": t_sample / t_train,
            "update_share": sec["update"] / t_train,
            "render_share": rollout * sec["render"] / t_train,
            "b2_share": rollout * sec["b2_kernel"] / t_train,
            "b2_share_of_rollout_step": sec["b2_kernel"] / sec["rollout_step"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenario", default="Collect")
    p.add_argument("--num_envs", type=int, default=1024)
    p.add_argument("--num_agents", type=int, default=1)
    p.add_argument("--rollout", type=int, default=32)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    res = profile(args.scenario, args.num_envs, args.num_agents, args.rollout, args.iters,
                  args.device)
    for k in PARTS:
        print(f"{k:26s} {res['ms'][k]:10.2f} ms", flush=True)
    ms = res["ms"]
    print(f"\nrollout {args.rollout} x {ms['rollout_step']:.1f} ms "
          f"+ update {ms['update']:.1f} ms = {res['train_step_ms']:.1f} ms/train-step")
    print(f"train      {res['train_env_steps_per_s']:10.0f} env-steps/s")
    print(f"sampling   {res['sampling_env_steps_per_s']:10.0f} env-steps/s  (the tick only)")
    print(f"train/sampling ratio {res['train_over_sampling']:6.1%}")
    print(f"update share {res['update_share']:6.1%}; render share {res['render_share']:6.1%}; "
          f"B2 kernel share {res['b2_share']:6.1%} "
          f"({res['b2_share_of_rollout_step']:6.1%} of a rollout step)")
    import bench_torch

    print(json.dumps({"scenario": args.scenario, "envs": args.num_envs,
                      "agents": args.num_agents, "rollout": args.rollout, **res,
                      "device": args.device,
                      "gpu": bench_torch.card() if args.device != "cpu" else "cpu"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
