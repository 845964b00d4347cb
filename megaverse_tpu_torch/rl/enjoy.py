"""Policy playback (counterpart of megaverse_tpu/rl/enjoy.py and of
megaverse_rl/enjoy_megaverse.py).

Loads a checkpoint written by megaverse_tpu_torch.rl.train or by the JAX
package's megaverse_tpu.rl.train (its params only, read without JAX: see
rl/checkpoint.py), rolls episodes with the sampled policy on one env,
reports per-episode reward and true objective, and can record frames.

  python -m megaverse_tpu_torch.rl.enjoy --env Empty \\
      --checkpoint /tmp/megaverse_tpu_torch_train/default/checkpoint.pkl --episodes 3

Runs on the GPU; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from megaverse_tpu_torch.convert import actor_critic_from_flax
from megaverse_tpu_torch.models.actor_critic import ActorCritic, sample_actions
from megaverse_tpu_torch.rl.checkpoint import load_checkpoint
from megaverse_tpu_torch.rl.train import resolve_device
from megaverse_tpu_torch.types import multidiscrete_to_bitmask
from megaverse_tpu_torch.vector_env import VectorEnv


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env", default="Empty")
    p.add_argument("--checkpoint", required=False, default=None)
    p.add_argument("--num_agents_per_env", type=int, default=1)
    p.add_argument("--episodes", type=int, default=2)
    p.add_argument("--max_steps", type=int, default=450)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hidden_size", type=int, default=512)
    p.add_argument("--use_rnn", type=int, default=1)
    p.add_argument("--rnn_num_layers", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--record_dir", default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    env = VectorEnv(args.env, num_envs=1, num_agents_per_env=args.num_agents_per_env,
                    seed=args.seed, device=device, obs_format="packed")
    model = ActorCritic(hidden_size=args.hidden_size, use_rnn=bool(args.use_rnn),
                        rnn_num_layers=args.rnn_num_layers).to(device)
    if args.checkpoint:
        ckpt = load_checkpoint(args.checkpoint)
        model.load_state_dict(actor_critic_from_flax(ckpt["params"]))
        print(f"loaded checkpoint at {ckpt.get('steps', '?')} steps")
    else:
        model.reset_parameters(torch.Generator(device).manual_seed(args.seed))
        print("no checkpoint given: random policy weights")
    model.eval()
    gen = torch.Generator(device).manual_seed(args.seed)
    frames = []
    try:
        obs = env.reset()
        for ep in range(args.episodes):
            carry = model.initial_carry((1, args.num_agents_per_env), device)
            total = np.zeros(args.num_agents_per_env)
            for step in range(args.max_steps):
                with torch.no_grad():
                    logits, _, carry = model(obs, carry)
                    actions, _ = sample_actions(logits, gen)
                obs, rew, done, tobj = env.step(multidiscrete_to_bitmask(actions))
                total += rew[0].cpu().numpy()
                if args.record_dir:
                    frames.append(np.concatenate(
                        list(env.unpack_obs(obs)[0].cpu().numpy()), axis=1))
                if bool(done[0]):
                    print(f"episode {ep}: {step + 1} steps, reward {total.round(3)}, "
                          f"true_objective {tobj[0].cpu().numpy().round(3)}")
                    break
            else:
                print(f"episode {ep}: truncated at {args.max_steps} steps, "
                      f"reward {total.round(3)}")
    finally:
        env.close()

    if args.record_dir and frames:
        from PIL import Image

        out = Path(args.record_dir)
        out.mkdir(parents=True, exist_ok=True)
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(out / "enjoy.gif", save_all=True, append_images=imgs[1:],
                     duration=66, loop=0)
        print(f"wrote {len(frames)} frames to {out}/enjoy.gif")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
