#!/usr/bin/env python
"""Renderer culling diagnostics of the port (twin of scripts/profile_culling.py):
per-tile frustum survivors and the early-exit potential for a scenario's
real states.

Reports, for B envs after a few random steps:
- live rows and clusters per env,
- frustum survivors per 8x128 tile (mean / p50 / p90 / max) of the per-tile
  front-to-back lists (`raycast_cuda.frustum_cull`), and their mean by tile
  row,
- the bit-walk's (B2's) survivors per tile: the clusters with a live row
  that `cull_bits` keeps, with the hex scenes' PVS row mask ANDed in as
  `env.render_tables` does,
- the clusters B2's early exit would visit given the final depths (a kept
  cluster whose eye distance is within the tile's deepest final depth +
  0.01; the final depths as scripts/analyze_culling_torch.py takes them),
- the share of tiles at which the frustum test keeps every cluster, those
  without a live row included: its direction intervals then straddle zero
  on all three axes (a tile across the horizon whose 100-degree span
  crosses two axis planes), so no axis bounds the boxes,
computed on the port's own tables. The counting is `cull_counts`, for any
batched state.

  python3 scripts/profile_culling_torch.py --scenario Collect --num_envs 1024
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import analyze_culling_torch as A  # noqa: E402

from megaverse_tpu_torch.env import RenderMode, render_tables  # noqa: E402
from megaverse_tpu_torch.ops import raycast_cuda as RC  # noqa: E402

COUNTS = ("survivors", "b2_survivors", "b2_visits")
DEAD = 1e29     # a cluster without a live row is a point box at 1e30


def popcount(words: torch.Tensor, n: int) -> torch.Tensor:
    """Bits set among the first n of int32 bit words [..., W] -> [..., n] bool."""
    bits = (words[..., :, None] >> torch.arange(32, dtype=torch.int32, device=words.device)) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n].bool()


def cull_counts(scenario, state) -> dict:
    """Per (env, agent, tile) int64 [B, A, T] counts under the names of
    COUNTS, the tiles that keep every cluster (bool [B, A, T]), the live
    rows per env [B] and the clusters per env G."""
    cfg = scenario.cfg
    h, w = cfg.obs_height, cfg.obs_width
    prims = RC.build_prim_table(cfg, state.box_lo, state.box_hi, state.box_color, state.props,
                                state.agents, include_agent_rows=cfg.num_agents > 1)
    live = (prims[:, :, 0] >= 0).sum(1)
    remaining = torch.clamp((state.episode_len_sec - state.episode_sec)
                            / state.episode_len_sec, min=0.0)
    cams = RC.build_cams(cfg, state.agents, remaining)
    _, clusters = RC.build_clusters(prims)
    _, dist = RC.frustum_cull(cams, clusters, h, w)
    survivors = (dist < 1e7).sum(-1)                    # culled get sqrt(1e30) = 1e15

    # the bit-walk's tables as the main path builds them (full capacity)
    tabs = render_tables(scenario, state, mode=RenderMode())
    g2 = tabs["clusters"].shape[1]
    keep = popcount(tabs["clbits"], g2)                 # [B, A, T, G']
    keep_all = keep.all(-1)
    keep = keep & (tabs["clusters"][:, None, None, :, 0] < DEAD)
    bsz, na, nt = keep.shape[:3]
    agents_np = A.agents_numpy(state)
    bound = torch.empty((bsz, na, nt), dtype=torch.float64, device=prims.device)
    for b in range(bsz):
        for a in range(na):
            eye, d = A.view_rays(agents_np, b, a, h, w, prims.device)
            _, depth = A.closest_box_hits(eye, d, tabs["prims"][b])
            bound[b, a] = A.tile_depth_bound(depth, h, w)
    near = tabs["cdist"][:, :, None, :].double() <= bound[..., None]
    return {"survivors": survivors.cpu().numpy(),
            "b2_survivors": keep.sum(-1).cpu().numpy(),
            "b2_visits": (keep & near).sum(-1).cpu().numpy(),
            "keep_all": keep_all.cpu().numpy(),
            "live": live.cpu().numpy(), "clusters": clusters.shape[1]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenario", default="Collect")
    p.add_argument("--num_envs", type=int, default=64)
    p.add_argument("--num_agents", type=int, default=1)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    env = A.random_state(args.scenario, args.num_envs, args.num_agents, seed=3,
                         steps=args.steps, device=args.device)
    try:
        res = cull_counts(env.scenario, env.state)
    finally:
        env.close()
    live, sv = res["live"], res["survivors"]
    print(f"scenario={args.scenario} envs={args.num_envs} "
          f"rows live p50={np.percentile(live, 50):.0f} "
          f"p90={np.percentile(live, 90):.0f} max={live.max()} "
          f"clusters/env={res['clusters']}")
    for k in COUNTS:
        v = res[k]
        print(f"{k} per tile: mean={v.mean():.1f} p50={np.percentile(v, 50):.0f} "
              f"p90={np.percentile(v, 90):.0f} max={v.max()}")
    print("mean survivors by tile row:", np.round(sv.mean(axis=(0, 1)), 1).tolist())
    print(f"tiles keeping every cluster: {res['keep_all'].mean():.2%}")
    import bench_torch

    print(json.dumps({"scenario": args.scenario, "envs": args.num_envs,
                      "agents": args.num_agents, "steps": args.steps,
                      "live_rows": A.summary(live), "clusters": res["clusters"],
                      **{k: A.summary(res[k]) for k in COUNTS},
                      "survivors_by_tile_row": sv.mean(axis=(0, 1)).tolist(),
                      "tiles_keeping_every_cluster": float(res["keep_all"].mean()),
                      "device": args.device,
                      "gpu": bench_torch.card() if args.device != "cpu" else "cpu"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
