#!/usr/bin/env python
"""Split the port's render path into stages and time each (twin of
scripts/profile_render_stages.py).

Usage: python3 scripts/profile_render_stages_torch.py [--scenario Collect]
       [--num_envs 1024] [--num_agents 1] [--steps 32] [--device cuda]

Resets a `VectorEnv` (seed 42), stops its layout prefetch and times, on its
state, the stages of `env.render_batch` under the main path's form, the
bit-walk (B2):
  table+cluster build   cams, prim table (bucketed as the env renders it),
                        clusters and superclusters, the prim table padded to
                        them, and the hex scenes' PVS cluster mask
                        (`env.prim_rows`, `env.bitwalk_clusters`)
  cull_bits             the per-tile cull and front-to-back supercluster
                        order (`raycast_cuda.cull_bits`)
  kernel                one B2 launch on those tables (`render_packed`)
  full render_batch     all of it through the entry point
each warmed once, then `--steps` calls timed with CUDA events (the host
clock on the CPU, where the kernel is its plain version). The stages' image
must equal render_batch's. The last line is the same numbers as one JSON
object, beside the card's name and power limit.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_train_step_torch import timer  # noqa: E402

STAGES = ("table+cluster build", "cull_bits", "kernel", "full render_batch")


def profile(scenario: str, num_envs: int, num_agents: int, steps: int, device: str) -> dict:
    """Milliseconds per call of each of STAGES, and the tables' sizes."""
    from megaverse_tpu_torch import VectorEnv
    from megaverse_tpu_torch import constants as C
    from megaverse_tpu_torch.env import bitwalk_clusters, prim_rows, render_batch
    from megaverse_tpu_torch.ops import raycast_cuda as RC
    from megaverse_tpu_torch.rl.train import resolve_device

    dev = resolve_device(device)
    env = VectorEnv(scenario, num_envs, num_agents, seed=42, device=dev)
    try:
        env.reset()
        env.flush()
        # stop the layout prefetch threads: generating refill layouts on the
        # host, they would take the interpreter from the timed stages
        env.close()
        scen, state, bucket, mode = env.scenario, env.state, env._bucket, env.render_mode
        if mode.mode != "bits" or not mode.cluster_cull:
            raise ValueError(f"the stages are the bit-walk's; the environment selects {mode}")
        h, w = scen.cfg.obs_height, scen.cfg.obs_width

        def build():
            cams, prims, keep, num_boxes = prim_rows(scen, state, bucket)
            prims, clusters, mask = bitwalk_clusters(scen, state, prims, keep, num_boxes,
                                                     mode.pvs)
            return cams, prims.contiguous(), clusters.contiguous(), mask

        cams, prims, clusters, mask = build()

        def cull():
            return RC.cull_bits(cams, clusters, h, w, cluster_mask=mask)

        sclist, clbits, scdist, cdist = cull()
        ui = float(scen.cfg.params.get(C.P_USE_UI_REWARD_INDICATORS, 0.0)) > 0

        def kernel():
            return RC.render_packed(cams, prims, h, w, clusters=clusters,
                                    sclist=sclist, clbits=clbits, scdist=scdist, cdist=cdist,
                                    ui_indicators=ui, merge_tiles=mode.merge_tiles)

        def full():
            return render_batch(scen, state, fmt="packed", bucket=bucket, mode=mode)

        if not torch.equal(kernel(), full()):
            raise AssertionError("the stages' image differs from render_batch's")
        timeit = timer(dev, steps)
        ms = {name: 1e3 * timeit(fn) for name, fn in zip(STAGES, (build, cull, kernel, full))}
    finally:
        env.close()
    return {"ms": ms, "prims": list(prims.shape), "clusters": list(clusters.shape),
            "sclist": list(sclist.shape), "pvs_mask": mask is not None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenario", default="Collect")
    p.add_argument("--num_envs", type=int, default=1024)
    p.add_argument("--num_agents", type=int, default=1)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    res = profile(args.scenario, args.num_envs, args.num_agents, args.steps, args.device)
    n = args.num_envs * args.num_agents
    print(f"prims={res['prims']} clusters={res['clusters']} sclist={res['sclist']} "
          f"pvs_mask={res['pvs_mask']}")
    for name in STAGES:
        ms = res["ms"][name]
        print(f"{name:22s} {ms:8.3f} ms/step   {n / ms * 1e3:10.0f} obs/s-equiv", flush=True)
    import bench_torch

    print(json.dumps({"scenario": args.scenario, "envs": args.num_envs,
                      "agents": args.num_agents, "steps": args.steps, **res,
                      "device": args.device,
                      "gpu": bench_torch.card() if args.device != "cpu" else "cpu"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
