#!/usr/bin/env python
"""Batched greedy evaluation of a checkpoint by the port (counterpart of
scripts/eval_policy.py).

Rolls N envs for a fixed horizon with the ARGMAX policy (no exploration
noise) and reports the per-step reward mean and the per-episode return mean:
the exploit-mode counterpart of the sampled reward_mean printed during
training. The checkpoint may come from megaverse_tpu_torch.rl.train or from
the JAX package's megaverse_tpu.rl.train (read without JAX by
megaverse_tpu_torch/rl/checkpoint.py).

  python scripts/eval_policy_torch.py --env Collect \\
      --checkpoint runs/collect_demo_r3/checkpoint.pkl --num_envs 512 --steps 900

Runs on the card; `--device cpu` runs it on the CPU.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env", default="Collect")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--num_envs", type=int, default=512)
    p.add_argument("--num_agents_per_env", type=int, default=1)
    p.add_argument("--steps", type=int, default=900)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--hidden_size", type=int, default=512)
    p.add_argument("--rnn_num_layers", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from megaverse_tpu_torch.convert import actor_critic_from_flax
    from megaverse_tpu_torch.models.actor_critic import ActorCritic
    from megaverse_tpu_torch.rl.checkpoint import load_checkpoint
    from megaverse_tpu_torch.rl.train import resolve_device
    from megaverse_tpu_torch.types import multidiscrete_to_bitmask
    from megaverse_tpu_torch.vector_env import VectorEnv

    device = resolve_device(args.device)
    ckpt = load_checkpoint(args.checkpoint)
    env = VectorEnv(args.env, num_envs=args.num_envs,
                    num_agents_per_env=args.num_agents_per_env, seed=args.seed,
                    device=device)
    model = ActorCritic(hidden_size=args.hidden_size, use_rnn=True,
                        rnn_num_layers=args.rnn_num_layers).to(device)
    model.load_state_dict(actor_critic_from_flax(ckpt["params"]))
    model.eval()
    b, a = args.num_envs, args.num_agents_per_env
    tot_reward, tot_done = 0.0, 0
    ep_return = np.zeros((b, a), np.float64)
    finished_returns = []
    try:
        obs = env.reset()
        carry = model.initial_carry((b, a), device)
        for _ in range(args.steps):
            with torch.no_grad():
                logits, _, carry = model(obs, carry)
                acts = torch.stack([torch.argmax(lg, dim=-1) for lg in logits], dim=-1)
            obs, rew, done, _ = env.step(multidiscrete_to_bitmask(acts))
            r = rew.double().cpu().numpy()
            d = done.cpu().numpy()
            tot_reward += float(r.sum())
            ep_return += r
            if d.any():
                finished_returns.extend(ep_return[d].ravel().tolist())
                ep_return[d] = 0.0
                tot_done += int(d.sum())
            carry = torch.where(done[:, None, None], 0.0, carry)
    finally:
        env.close()

    n = b * a * args.steps
    print(f"greedy reward/step mean: {tot_reward / n:+.5f} over {n} agent-steps")
    if finished_returns:
        fr = np.asarray(finished_returns)
        print(f"episodes finished: {len(fr)}  return mean {fr.mean():+.4f} "
              f"median {np.median(fr):+.4f}  frac>0 {float((fr > 0).mean()):.2%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
