"""The skip rules of the render kernel's forms B3 and B6 over B2, on the
port's plain functions.

B3 (csrc/render.cu trace_b3) votes on the live clusters of an env
B3_BATCH at a time, each pixel at the depth it holds when the batch starts,
and never votes on a dead cluster. B6 over B2 (stage_frame_b2) stages once
per frame the clusters any tile of the frame may visit. An image can change
only if one of these drops a cluster that holds a pixel's winning row, so
this file checks, on the synthetic all-types table, the far-plane table and
states of Collect and TowerBuilding (the inputs of test_torch_render_skip.py):
  - the batch vote at the batch's start passes the winning cluster of every
    pixel that hits anything, for the kernel's batch and for a batch of 4
    (more batches per env, later starts);
  - no ray reaches a dead cluster's box at any depth;
  - the frame's set holds every cluster that the bit-walk of any of its tiles
    could visit at the widest bound, the far plane.
It calls nothing of JAX.
"""

import pytest
import torch

from megaverse_tpu_torch.ops import raycast as TR
from megaverse_tpu_torch.ops import raycast_cuda as TRC
from test_torch_render_skip import H, W, scene_tables

TABLES = ["synthetic", "far", "collect", "tower"]


def cluster_depths(cams, prims, num_clusters):
    """[B, A, H, W, G]: each pixel's closest hit among each cluster's rows
    (+INF where none; dead rows never hit)."""
    k = TRC.CLUSTER_K
    return torch.stack(
        [TR.trace_table(cams, prims, H, W, row_order=range(g * k, g * k + k),
                        tiebreak=False, far_start=False)[1]
         for g in range(num_clusters)], dim=-1)


@pytest.mark.parametrize("name", TABLES)
def test_batch_vote_at_the_batch_start_passes_every_winner(name):
    cams, prims = scene_tables(name)
    prims, clusters = TRC.build_clusters(prims)
    g = clusters.shape[1]
    rays, depth, row, *_ = TR.trace_table(cams, prims, H, W)   # in order, strict
    hit = depth < TRC.FAR
    assert hit.float().mean() > 0.02, "the input must hit something"
    win = torch.where(hit, row.long() // TRC.CLUSTER_K, torch.zeros_like(row.long()))
    # in table order a pixel's depth is the smallest hit of the clusters before
    # the current one: the exclusive running minimum
    cd = cluster_depths(cams, prims, g)
    run_min = torch.cummin(cd, dim=-1).values
    before = torch.cat([torch.full_like(cd[..., :1], TR.INF), run_min[..., :-1]], dim=-1)
    live = TRC.live_clusters(clusters)                                   # [B, G]
    rank = torch.cumsum(live.long(), dim=1) - 1
    bsz, agents = cams.shape[:2]
    assert bool(live.gather(1, win.reshape(bsz, -1)).reshape(win.shape)[hit].all())
    boxes = torch.gather(clusters[:, None, None, :, :6].expand(bsz, agents, H, -1, 6), 3,
                         win[..., None].expand(-1, -1, -1, -1, 6))        # [B,A,H,W,6]
    lo = [boxes[..., k] for k in range(3)]
    hi = [boxes[..., 3 + k] for k in range(3)]
    for batch in (TRC.B3_BATCH, 4):
        # table index of the first cluster of the batch that holds cluster j
        first_rank = torch.div(rank, batch, rounding_mode="floor") * batch
        first = torch.stack([torch.searchsorted(rank[b].contiguous(), first_rank[b].contiguous())
                             for b in range(bsz)])                        # [B, G]
        start = torch.gather(before, 4, first[:, None, None, None, :].expand(cd.shape))
        at_start = torch.gather(start, 4, win[..., None])[..., 0]         # [B,A,H,W]
        assert bool((at_start >= depth)[hit].all())
        reach = TRC.box_reachable_plain(rays, lo, hi, at_start)
        assert bool(reach[hit].all()), f"batch {batch}: {int((~reach & hit).sum())} pixels"
        if batch == 4 and name in ("collect", "far"):
            # the input does what it is for: some winner sits in a later batch
            assert bool(((at_start < TR.INF) & hit).any())


@pytest.mark.parametrize("name", TABLES)
def test_dead_cluster_box_never_passes_the_vote(name):
    cams, prims = scene_tables(name)
    # one cluster of dead rows more, as bucketed tables hold them
    dead_rows = torch.zeros((prims.shape[0], 2 * TRC.CLUSTER_K, prims.shape[2]))
    dead_rows[..., 0] = -1.0
    prims, clusters = TRC.build_clusters(torch.cat([prims, dead_rows], dim=1))
    dead = ~TRC.live_clusters(clusters)
    assert bool(dead.any())
    rays = TR.make_rays(cams, H, W)
    for b, g in dead.nonzero().tolist():
        box = clusters[b, g]
        ray_b = TR.Rays(*(x[b] for x in rays))
        for bt in (TR.INF, TRC.FAR):
            reach = TRC.box_reachable_plain(ray_b, box[0:3], box[3:6],
                                            torch.full((), bt))
            assert not bool(reach.any()), (b, g, bt)


@pytest.mark.parametrize("name", TABLES)
def test_frame_set_holds_every_cluster_a_tile_walk_visits(name):
    cams, prims = scene_tables(name)
    prims, clusters = TRC.build_clusters(prims)
    clusters, _ = TRC.build_superclusters(clusters)
    g = clusters.shape[1]
    s = g // TRC.SUPER_K
    sclist, clbits, scdist, cdist = TRC.cull_bits(cams, clusters, H, W)
    frame = TRC.frame_clusters_plain(clbits, cdist, g)                     # [B, A, G]
    # the walk at the far plane: list entries up to the sentinel or the first
    # beyond the bound, then the members whose tile bit is set and whose eye
    # distance is within it
    reached = torch.cumprod(((sclist < s) & (scdist <= TRC.FAR + TRC.SLACK)).int(), dim=-1)
    member = (sclist.clamp(max=s - 1).long()[..., None] * TRC.SUPER_K
              + torch.arange(TRC.SUPER_K))                                 # [B,A,T,S,4]
    flat = member.flatten(-2)
    bit = torch.gather(TRC.cluster_bits(clbits, g), -1, flat)
    near = torch.gather(cdist[:, :, None, :].expand(-1, -1, H // 8, -1), -1, flat)
    cand = (reached.bool()[..., None].expand(member.shape).flatten(-2) & bit
            & (near <= TRC.FAR + TRC.SLACK))
    visited = torch.zeros(bit.shape[:-1] + (g,), dtype=torch.int32)
    visited.scatter_add_(-1, flat, cand.int())
    visited = (visited > 0).any(dim=2)                                     # [B, A, G]
    assert bool(visited.any()), "some tile's walk visits a cluster"
    assert not bool((visited & ~frame).any())
    # and the set is what the tiles can see: no cluster outside every tile
    assert not bool((frame & ~TRC.cluster_bits(clbits, g).any(dim=2)).any())
