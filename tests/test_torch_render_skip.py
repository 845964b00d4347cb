"""The skip rules of the culled render forms, on the port's plain functions.

Forms B2-B5 skip a cluster when no pixel of a block can reach its box any more
(`box_reachable` in csrc/render.cu: slab interval against the pixel's current
depth plus a 0.01 slack), and B2 also when its eye distance `cdist` exceeds
the block's depth bound plus that slack. Such a skip can only change an image
if it drops the cluster that holds a pixel's winning row. Depths only fall
while a block renders, and both rules get weaker as the depth grows, so it is
enough that the winning cluster passes both at the pixel's FINAL depth: this
file checks that for every pixel that hits anything, on the synthetic
all-types table, the far-plane table (hits 90-125 m out, rays grazing box
faces) and states of Collect and TowerBuilding, through the plain twins
`raycast_cuda.box_reachable_plain` and `raycast.trace_table`. It calls nothing
of JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from megaverse_tpu_torch import VectorEnv
from megaverse_tpu_torch.env import UNCULLED, render_tables
from megaverse_tpu_torch.ops import raycast as TR
from megaverse_tpu_torch.ops import raycast_cuda as TRC
from megaverse_tpu_torch.utils.synthetic import synthetic_cams, synthetic_far, synthetic_prims

import torch_port_checks  # noqa: F401  (one intra-op torch thread)

H, W = 24, 128


def scene_tables(name):
    """(cams [B, A, 8], prims [B, M, 12]) of one of the four inputs."""
    if name == "synthetic":
        prims = synthetic_prims(seed=5, num_envs=2)
        return torch.from_numpy(synthetic_cams(seed=5, prims=prims, num_agents=3)), \
            torch.from_numpy(prims)
    if name == "far":
        prims, cams = synthetic_far(seed=5, num_envs=2, num_agents=4, height=H)
        return torch.from_numpy(cams), torch.from_numpy(prims)
    scenario = {"collect": "Collect", "tower": "TowerBuilding"}[name]
    env = VectorEnv(scenario, num_envs=2, num_agents_per_env=2, seed=7, device="cpu",
                    render=False)
    env.scenario.cfg = dataclasses.replace(env.scenario.cfg, obs_height=H)
    env.reset()
    rng = np.random.default_rng(3)
    for _ in range(3):
        env.step(rng.integers(0, 2048, size=(2, 2)).astype(np.int32))
    tabs = render_tables(env.scenario, env.state, bucket=env._bucket, mode=UNCULLED)
    env.close()
    # a 24-px frame sees +-13 degrees: tilt the views so that they take in
    # floor, boxes and sky
    cams = tabs["cams"].clone()
    cams[..., 4] = torch.tensor([[-0.35, 0.05], [-0.15, -0.5]])
    return cams, tabs["prims"]


@pytest.mark.parametrize("name", ["synthetic", "far", "collect", "tower"])
def test_winning_cluster_passes_every_skip_rule(name):
    cams, prims = scene_tables(name)
    prims, clusters = TRC.build_clusters(prims)
    clusters, _ = TRC.build_superclusters(clusters)
    prims = TRC.pad_prims_to_clusters(prims, clusters)
    _, _, _, cdist = TRC.cull_bits(cams, clusters, H, W)
    rays, depth, row, *_ = TR.trace_table(cams, prims, H, W)
    hit = depth < TRC.FAR
    assert hit.float().mean() > 0.02, "the input must hit something"
    win = torch.where(hit, row.long() // TRC.CLUSTER_K, torch.zeros_like(row.long()))
    bsz, agents = cams.shape[:2]
    boxes = torch.gather(clusters[:, None, None, :, :6].expand(bsz, agents, H, -1, 6), 3,
                         win[..., None].expand(-1, -1, -1, -1, 6))        # [B,A,H,W,6]
    lo = [boxes[..., k] for k in range(3)]
    hi = [boxes[..., 3 + k] for k in range(3)]
    reach = TRC.box_reachable_plain(rays, lo, hi, depth)
    assert bool(reach[hit].all()), f"{int((~reach & hit).sum())} pixels"
    near = torch.gather(cdist[:, :, None, :].expand(-1, -1, H, -1), 3, win)
    assert bool((near <= depth + TRC.SLACK)[hit].all())
    if name == "far":
        # the input does what it is for: hits close to the far plane
        assert bool(((depth > 90.0) & hit).any())
