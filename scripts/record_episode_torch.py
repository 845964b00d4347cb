#!/usr/bin/env python
"""Headless episode recorder of the port (counterpart of
scripts/record_episode.py): rolls one environment with random actions and
writes the agents' views, side by side, plus optionally a free overview
camera (`env.render_custom_camera`: on the card, the render kernel's form
B1 at any size) to PNG files and an animated GIF.

  python scripts/record_episode_torch.py --env Collect --steps 120 --out ep --overview --gif

Runs on the card; `--device cpu` runs it on the CPU.
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def overview_camera(grid):
    """(eye, yaw, pitch) above and behind the middle of the scene's grid,
    looking down at it."""
    import numpy as np

    center = np.asarray(grid.origin) + np.asarray(grid.dims) * grid.voxel_size / 2
    return (center[0], center[1] + np.max(grid.dims) * 0.7, center[2] + 6), 0.0, -1.1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env", default="Collect")
    p.add_argument("--num_agents", type=int, default=2)
    p.add_argument("--steps", type=int, default=90)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "megaverse_episode"))
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--obs_height", type=int, default=None,
                   help="agent view height (default: the scenario's 72)")
    p.add_argument("--overview", action="store_true", help="also render overview frames")
    p.add_argument("--gif", action="store_true", help="write animated gif")
    args = p.parse_args(argv)

    import dataclasses

    import numpy as np
    from PIL import Image

    import megaverse_tpu_torch.constants as C
    from megaverse_tpu_torch import VectorEnv
    from megaverse_tpu_torch.env import render_custom_camera
    from megaverse_tpu_torch.rl.train import resolve_device

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    env = VectorEnv(args.env, num_envs=1, num_agents_per_env=args.num_agents,
                    seed=args.seed, obs_format="rgb", device=resolve_device(args.device))
    if args.obs_height:
        env.scenario.cfg = dataclasses.replace(env.scenario.cfg, obs_height=args.obs_height)
    rng = np.random.default_rng(args.seed)
    frames = []
    try:
        env.reset()
        for step in range(args.steps):
            md = np.stack([rng.integers(0, s, size=(1, args.num_agents))
                           for s in C.ACTION_SPACE_SIZES], -1)
            obs, rew, done, tobj = env.step(md)
            row = np.concatenate(list(obs[0].cpu().numpy()), axis=1)  # agents side by side
            if args.overview:
                eye, yaw, pitch = overview_camera(env.scenario.cfg.grid)
                ov = render_custom_camera(env.scenario, env.state, eye, yaw, pitch,
                                          width=row.shape[1], height=128)
                row = np.concatenate([row, ov.cpu().numpy()], axis=0)
            frames.append(row)
            if step % 30 == 0:
                Image.fromarray(row).save(out / f"frame_{step:04d}.png")
    finally:
        env.close()

    if args.gif:
        imgs = [Image.fromarray(f).resize((f.shape[1] * 2, f.shape[0] * 2), Image.NEAREST)
                for f in frames]
        imgs[0].save(out / "episode.gif", save_all=True, append_images=imgs[1:],
                     duration=66, loop=0)
    print(f"wrote {len(frames)} frames to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
