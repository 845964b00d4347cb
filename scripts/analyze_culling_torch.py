#!/usr/bin/env python
"""Culling stages of the port's render tables (twin of scripts/analyze_culling.py).

For a scene batch, per 8-row pixel tile of every agent's view: how many
superclusters, clusters and rows survive each culling stage, and the
optimistic lower bound, the rows reachable given the FINAL per-ray depths.
It says whether further speed-up lives in traversal (survivors >> visible)
or in per-row cost (survivors ~= visible).

  frustum  some ray of the tile enters the box in front of the eye, before
           the far plane;
  final    ... before the tile's deepest final depth + 0.01 (the bound the
           kernels' early exit walks to);
  visible  AABB rows that are some pixel's closest hit.

The tables are the port's own (`raycast_cuda.build_prim_table`,
`build_clusters`, `build_superclusters`); the rays, slab tests and depths
are computed as the JAX script computes them: ray directions in numpy
float64 from the agents' float32 yaw and pitch, slabs in float64 (here on
the tables' device), the final depth of a pixel its closest AABB row (props
ignored). The counting is `stage_counts`, for any batched state.

  python3 scripts/analyze_culling_torch.py --scenario Collect --num_envs 1024
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from megaverse_tpu_torch import constants as C  # noqa: E402
from megaverse_tpu_torch.ops import raycast_cuda as RC  # noqa: E402

EYE_OFFSET = np.array([0.0, C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y, 0.0])
STAGES = ("sc_frustum", "cl_frustum", "rows_frustum", "sc_final", "cl_final", "rows_final",
          "rows_visible")


def ray_dirs(h, w, yaw, pitch, fov_deg):
    """Unit ray directions [h, w, 3] (float64) of a camera at `yaw`, `pitch`."""
    rows = np.arange(h)[:, None] + 0.5
    cols = np.arange(w)[None, :] + 0.5
    tan_h = np.tan(np.deg2rad(fov_deg / 2))
    tan_v = tan_h * h / w
    u = (cols / w * 2 - 1) * tan_h
    v = (1 - rows / h * 2) * tan_v
    inv = 1.0 / np.sqrt(u * u + v * v + 1)
    d0 = np.stack(np.broadcast_arrays(u * inv, v * inv, -inv + 0 * u), -1)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    y1 = cp * d0[..., 1] - sp * d0[..., 2]
    z1 = sp * d0[..., 1] + cp * d0[..., 2]
    dx = cy * d0[..., 0] + sy * z1
    dz = -sy * d0[..., 0] + cy * z1
    return np.stack([dx, y1, dz], -1)


def slab(eye, d, lo, hi):
    """eye [3], d [R, 3], lo/hi [M, 3] (float64 tensors) -> tmin, tmax [R, M]."""
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t1 = (lo[None] - eye) * inv[:, None]
    t2 = (hi[None] - eye) * inv[:, None]
    return torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)


def view_rays(agents_np, b, a, h, w, device):
    """Eye [3] and ray directions [h * w, 3] (float64) of agent a of env b;
    `agents_np` holds the agents' pos, yaw and pitch as numpy float32."""
    pos, yaw, pitch = (agents_np[k][b, a] for k in ("pos", "yaw", "pitch"))
    eye = torch.from_numpy(pos + EYE_OFFSET).to(device)
    d = ray_dirs(h, w, yaw, pitch, C.CAMERA_FOV_DEG).reshape(-1, 3)
    return eye, torch.from_numpy(d).to(device)


def agents_numpy(state) -> dict:
    return {k: getattr(state.agents, k).cpu().numpy() for k in ("pos", "yaw", "pitch")}


def closest_box_hits(eye, d, prims_b):
    """Per ray, the parameter of each AABB row it hits (+inf where none)
    [R, boxes] and the final depth [R]: the closest hit, clamped to the far
    plane."""
    box = prims_b[:, 0] == 0
    tmin, tmax = slab(eye, d, prims_b[box, 1:4].double(), prims_b[box, 4:7].double())
    hit = (tmax >= tmin) & (tmin > C.CAMERA_NEAR)
    t = torch.where(hit, tmin, torch.full_like(tmin, float("inf")))
    depth = t.amin(1) if t.shape[1] else torch.full_like(d[:, 0], float("inf"))
    return t, torch.clamp(depth, max=C.CAMERA_FAR)


def tile_depth_bound(depth, h, w):
    """The early exit's bound per 8-row tile [T]: the tile's deepest final
    depth + 0.01."""
    return depth.reshape(h // RC.TILE_H, RC.TILE_H * w).amax(1) + 0.01


def tables(scenario, state):
    """The port's tables of a batched state: prims [B, M, 12] padded to whole
    clusters, clusters [B, G, 8] padded to whole superclusters,
    superclusters [B, S, 8]."""
    cfg = scenario.cfg
    prims = RC.build_prim_table(cfg, state.box_lo, state.box_hi, state.box_color, state.props,
                                state.agents, include_agent_rows=cfg.num_agents > 1)
    prims, clusters = RC.build_clusters(prims)
    clusters, sclusters = RC.build_superclusters(clusters)
    return RC.pad_prims_to_clusters(prims, clusters), clusters, sclusters


def stage_counts(scenario, state) -> dict:
    """Per (env, agent, tile) survivors of each stage (int64 [B, A, T] under
    the names of STAGES), and the table sizes: rows M, live rows per env
    [B], clusters G, superclusters S."""
    cfg = scenario.cfg
    h, w = cfg.obs_height, cfg.obs_width
    prims, clusters, sclusters = tables(scenario, state)
    bsz, m = prims.shape[:2]
    g, s = clusters.shape[1], sclusters.shape[1]
    na = state.agents.pos.shape[1]
    nt = h // RC.TILE_H
    dev = prims.device
    live = prims[..., 0] >= 0
    out = {k: torch.zeros((bsz, na, nt), dtype=torch.int64, device=dev) for k in STAGES}
    agents_np = agents_numpy(state)
    far = torch.full((nt, 1), C.CAMERA_FAR, dtype=torch.float64, device=dev)

    def reach(tmin, tmax, bound):
        """[T, n]: some ray of the tile reaches the box before `bound` [T, 1]."""
        tmin = tmin.reshape(nt, -1, tmin.shape[1])
        tmax = tmax.reshape(nt, -1, tmax.shape[1])
        return ((tmax >= tmin) & (tmax > 0) & (tmin < bound[:, :, None])).any(1)

    for b in range(bsz):
        cl_live = live[b].reshape(g, -1)
        clo, chi = clusters[b, :, 0:3].double(), clusters[b, :, 3:6].double()
        slo, shi = sclusters[b, :, 0:3].double(), sclusters[b, :, 3:6].double()
        for a in range(na):
            eye, d = view_rays(agents_np, b, a, h, w, dev)
            tmin_c, tmax_c = slab(eye, d, clo, chi)
            tmin_s, tmax_s = slab(eye, d, slo, shi)
            t, depth = closest_box_hits(eye, d, prims[b])
            bound = tile_depth_bound(depth, h, w)[:, None]
            for stage, lim in (("frustum", far), ("final", bound)):
                scr = reach(tmin_s, tmax_s, lim)
                clr = reach(tmin_c, tmax_c, lim)
                out[f"sc_{stage}"][b, a] = scr.sum(1)
                out[f"cl_{stage}"][b, a] = clr.sum(1)
                out[f"rows_{stage}"][b, a] = (clr[:, :, None] & cl_live[None]).sum((1, 2))
            # rows whose parameter equals some pixel's final depth (winners)
            vis = (t.reshape(nt, -1, t.shape[1])
                   <= depth.reshape(nt, -1, 1) + 1e-6).any(1)
            out["rows_visible"][b, a] = vis.sum(1)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out.update(rows=m, live=live.sum(1).cpu().numpy(), clusters=g, superclusters=s)
    return out


def summary(v) -> dict:
    v = np.asarray(v, np.float64)
    return {"mean": float(v.mean()), "p50": float(np.percentile(v, 50)),
            "p90": float(np.percentile(v, 90)), "max": float(v.max())}


def random_state(scenario_name, num_envs, num_agents, seed, steps, device):
    """A `VectorEnv` (no rendering) reset from `seed` and stepped `steps`
    times with random multidiscrete actions (numpy seed 0), as the JAX
    scripts make their states; returns the env."""
    from megaverse_tpu_torch.vector_env import VectorEnv

    env = VectorEnv(scenario_name, num_envs=num_envs, num_agents_per_env=num_agents,
                    seed=seed, render=False, device=device)
    env.reset()
    rng = np.random.default_rng(0)
    for _ in range(steps):
        env.step(np.stack([rng.integers(0, n, size=(num_envs, num_agents))
                           for n in C.ACTION_SPACE_SIZES], axis=-1))
    return env


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenario", default="Collect")
    p.add_argument("--num_envs", type=int, default=8)
    p.add_argument("--num_agents", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    env = random_state(args.scenario, args.num_envs, args.num_agents, seed=7, steps=0,
                       device=args.device)
    try:
        res = stage_counts(env.scenario, env.state)
    finally:
        env.close()
    live = res["live"]
    print(f"{args.scenario}: table rows={res['rows']} (live mean {live.mean():.0f} "
          f"max {live.max()}), clusters={res['clusters']}, "
          f"superclusters={res['superclusters']}")
    for k in STAGES:
        v = np.asarray(res[k], np.float64)
        print(f"{k:14s} mean {v.mean():7.1f}  p90 {np.percentile(v, 90):7.1f}  "
              f"max {v.max():7.0f}")
    import bench_torch

    print(json.dumps({"scenario": args.scenario, "envs": args.num_envs,
                      "agents": args.num_agents, "rows": res["rows"],
                      "live_rows": summary(live), "clusters": res["clusters"],
                      "superclusters": res["superclusters"],
                      **{k: summary(res[k]) for k in STAGES},
                      "device": args.device,
                      "gpu": bench_torch.card() if args.device != "cpu" else "cpu"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
