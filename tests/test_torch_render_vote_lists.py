"""The skip rules of the render kernel's list forms B4 and B5, on the port's
plain functions.

B4 (csrc/render.cu trace_b4) walks a cluster list (per agent from
`sort_clusters`, per tile from `frustum_cull`, or any permutation) B3_BATCH
entries at a time; B5 (trace_b5) walks a per-tile list of superclusters the
same way and expands the superclusters that pass its vote, 8 at a time, to
their members. An entry is staged only if it is a cluster that owns rows and
whose box is live (B5: a supercluster in range with a live box; members that
own rows and have a live box). Each thread votes at the depths of its pixels
when the batch (B5: the member group) starts; a warp runs only what its own
pixels pass (B5: it tests the members only of the superclusters its pixels
pass), the block copies what any warp passed. With distance bounds, a batch
is cut at its first entry beyond the block's largest depth as it stood after
the previous batch, and a cut batch is the last. An image can change only if
one of these rules drops the cluster that holds a pixel's winning row, so
this file walks every block's list as the kernel does, on the inputs of
test_torch_render_skip.py with clusters of dead rows appended (and, for B5, a
cluster table padded past the rows), and checks for every pixel that hits
anything:
  - its winning cluster is staged, and its batch's vote at the batch's start
    depths passes it (B4), for the kernel's batch of 32 and for a batch of 4;
  - B5's supercluster vote at the batch's start passes the winner's
    supercluster for the pixel itself (so for its warp), and the member vote
    of its group passes the winner, for groups of 8 and of 2;
  - the early exit never cuts the winner: the walk reaches it;
  - and that no dead box or cluster without rows is ever staged.
A skipped cluster never lowers a pixel's depth, so the depths of this walk,
which visits every staged entry of the batches it reaches, are the kernel's.
It calls nothing of JAX.
"""

import functools

import numpy as np
import pytest
import torch

from megaverse_tpu_torch.ops import raycast as TR
from megaverse_tpu_torch.ops import raycast_cuda as TRC
from test_torch_render_skip import H, W, scene_tables
from test_torch_render_vote import cluster_depths

TABLES = ["synthetic", "far", "collect", "tower"]
ROWS = 2   # pixel rows of one block of B4 and B5: 2 lanes x 1 pixel per thread
K = TRC.CLUSTER_K
S_K = TRC.SUPER_K


@functools.lru_cache(maxsize=None)
def walk_inputs(name):
    """Tables of one input, with dead clusters appended so that the cluster
    count is not a multiple of SUPER_K: every list holds dead clusters, and
    B5's cluster table is padded with clusters that own no rows."""
    cams, prims = scene_tables(name)
    prims, clusters = TRC.build_clusters(prims)
    extra = 1 if (clusters.shape[1] + 1) % S_K else 2
    dead = torch.zeros((prims.shape[0], extra * K, prims.shape[2]))
    dead[..., 0] = -1.0
    prims, clusters = TRC.build_clusters(torch.cat([prims, dead], dim=1))
    g = clusters.shape[1]
    cl4, sclusters = TRC.build_superclusters(clusters)
    assert cl4.shape[1] > g and not bool(TRC.live_clusters(clusters).all())
    rays, depth, row, *_ = TR.trace_table(cams, prims, H, W)   # in order, strict
    hit = depth < TRC.FAR
    assert hit.float().mean() > 0.02, "the input must hit something"
    win = torch.where(hit, row.long() // K, torch.zeros_like(row.long()))
    cd = cluster_depths(cams, prims, g)
    # the clusters past the rows never hit
    cd = torch.cat([cd, torch.full(cd.shape[:-1] + (cl4.shape[1] - g,), TR.INF)], dim=-1)
    order_a, dist_a = TRC.sort_clusters(cams, clusters)
    order_t, dist_t = TRC.frustum_cull(cams, clusters, H, W)
    order_s, dist_s = TRC.frustum_cull(cams, sclusters, H, W)
    rng = np.random.default_rng(0)
    bsz, agents = cams.shape[:2]
    shuffled = torch.from_numpy(np.stack([rng.permutation(g) for _ in range(bsz * agents)])
                                .reshape(bsz, agents, g).astype(np.int32))
    lists = {"b4_agent": (order_a, None), "b4_agent_dist": (order_a, dist_a),
             "b4_tile": (order_t, dist_t), "b4_shuffled": (shuffled, None),
             "b5": (order_s, dist_s)}
    return dict(cams=cams, prims=prims, clusters=clusters, cl4=cl4, sclusters=sclusters,
                rays=rays, hit=hit, win=win, cd=cd, lists=lists)


def staged_clusters(gcs, clusters, num_prims):
    """The kernel's staging rule for cluster entries `gcs` (long [n]) of one
    env: a cluster that owns rows (cluster_has_rows) and whose box is live."""
    rows = (gcs >= 0) & (gcs * K + K <= num_prims)
    live = TRC.live_clusters(clusters[gcs.clamp(0, clusters.shape[0] - 1)])
    return gcs[rows & live]


def reachable(rays, box, depth):
    """box_reachable_plain of one box [8] for a block's rays [ROWS, W]."""
    return TRC.box_reachable_plain(rays, box[0:3], box[3:6], depth)


def blocks(inp):
    """(b, a, tile, pixel-row slice) of every block of the kernel."""
    bsz, agents = inp["cams"].shape[:2]
    for b in range(bsz):
        for a in range(agents):
            for y0 in range(0, H, ROWS):
                yield b, a, y0 // TRC.TILE_H, slice(y0, y0 + ROWS)


def batch_cut(entries, dist, maxt):
    """Entries the batch keeps: those before its first one beyond `maxt`."""
    if dist is None:
        return len(entries)
    beyond = (~(maxt >= dist)).nonzero()
    return int(beyond[0]) if len(beyond) else len(entries)


@pytest.mark.parametrize("name", TABLES)
@pytest.mark.parametrize("variant", ["b4_agent", "b4_agent_dist", "b4_tile", "b4_shuffled"])
def test_b4_batch_vote_and_early_exit_keep_every_winner(name, variant):
    inp = walk_inputs(name)
    order, dist = inp["lists"][variant]
    num_prims = inp["prims"].shape[1]
    later = False
    for batch in (TRC.B3_BATCH, 4):
        for b, a, tile, ys in blocks(inp):
            lst = order[b, a, tile if order.dim() == 4 else slice(None)].reshape(-1).long()
            dst = None if dist is None else dist[b, a, tile if dist.dim() == 4 else slice(None)]
            dst = None if dst is None else dst.reshape(-1)
            rays = TR.Rays(*(x[b, a, ys] for x in inp["rays"]))
            hit, win = inp["hit"][b, a, ys], inp["win"][b, a, ys]
            depth = torch.full((ROWS, W), TRC.FAR if dist is not None else TR.INF)
            maxt, seen = TRC.FAR, torch.zeros_like(hit)
            for base in range(0, lst.numel(), batch):
                ent = lst[base:base + batch]
                cut = batch_cut(ent, None if dst is None else dst[base:base + batch], maxt)
                staged = staged_clusters(ent[:cut], inp["clusters"][b], num_prims)
                here = hit & torch.isin(win, staged)
                for gc in win[here].unique().tolist():
                    px = here & (win == gc)
                    ok = reachable(rays, inp["clusters"][b, gc], depth)
                    assert bool(ok[px].all()), (variant, batch, b, a, ys, gc)
                later |= base > 0 and bool(here.any())
                seen |= here
                if len(staged):
                    depth = torch.minimum(depth, inp["cd"][b, a, ys][..., staged].amin(dim=-1))
                maxt = float(depth.max())
                if cut < batch:
                    break
            assert bool(seen[hit].all()), f"{variant} batch {batch}: the walk missed a winner"
    if name in ("collect", "synthetic"):
        # the input does what it is for: some winner sits in a later batch
        assert later


@pytest.mark.parametrize("name", TABLES)
def test_b5_supercluster_and_member_votes_keep_every_winner(name):
    inp = walk_inputs(name)
    order, dist = inp["lists"]["b5"]
    num_prims = inp["prims"].shape[1]
    s = inp["sclusters"].shape[1]
    for batch, group in ((TRC.B3_BATCH, 8), (4, 2)):
        for b, a, tile, ys in blocks(inp):
            lst, dst = order[b, a, tile].long(), dist[b, a, tile]
            rays = TR.Rays(*(x[b, a, ys] for x in inp["rays"]))
            hit, win = inp["hit"][b, a, ys], inp["win"][b, a, ys]
            depth = torch.full((ROWS, W), TRC.FAR)
            maxt, seen = TRC.FAR, torch.zeros_like(hit)
            for base in range(0, lst.numel(), batch):
                ent = lst[base:base + batch]
                cut = batch_cut(ent, dst[base:base + batch], maxt)
                ent = ent[:cut]
                ent = ent[(ent >= 0) & (ent < s)]
                ent = ent[TRC.live_clusters(inp["sclusters"][b, ent])]
                # the supercluster vote at the batch's start: per pixel, and
                # the block's OR
                sc_reach = [reachable(rays, inp["sclusters"][b, sc], depth) for sc in ent.tolist()]
                for sc, ok in zip(ent.tolist(), sc_reach):
                    px = hit & (torch.div(win, S_K, rounding_mode="floor") == sc)
                    assert bool(ok[px].all()), ("supercluster", batch, b, a, ys, sc)
                passed = [sc for sc, ok in zip(ent.tolist(), sc_reach) if bool(ok.any())]
                for g0 in range(0, len(passed), group):
                    members = torch.tensor([sc * S_K + j for sc in passed[g0:g0 + group]
                                            for j in range(S_K)], dtype=torch.long)
                    members = staged_clusters(members, inp["cl4"][b], num_prims)
                    here = hit & torch.isin(win, members)
                    for gc in win[here].unique().tolist():
                        px = here & (win == gc)
                        ok = reachable(rays, inp["cl4"][b, gc], depth)
                        assert bool(ok[px].all()), ("member", batch, b, a, ys, gc)
                    seen |= here
                    if len(members):
                        depth = torch.minimum(depth,
                                              inp["cd"][b, a, ys][..., members].amin(dim=-1))
                maxt = float(depth.max())
                if cut < batch:
                    break
            assert bool(seen[hit].all()), f"batch {batch}: the walk missed a winner"


@pytest.mark.parametrize("name", TABLES)
def test_dead_and_rowless_clusters_are_never_staged(name):
    inp = walk_inputs(name)
    num_prims = inp["prims"].shape[1]
    for b in range(inp["cl4"].shape[0]):
        every = torch.arange(inp["cl4"].shape[1])
        staged = staged_clusters(every, inp["cl4"][b], num_prims)
        live = TRC.live_clusters(inp["cl4"][b])
        has_rows = every * K + K <= num_prims
        assert bool((~live).any()) and bool((~has_rows).any())
        assert set(staged.tolist()) == set(every[live & has_rows].tolist())
        # no ray reaches a box the kernel does not stage, at any depth
        rays = TR.Rays(*(x[b] for x in inp["rays"]))
        for gc in every[~live].tolist():
            box = inp["cl4"][b, gc]
            assert not bool(TRC.box_reachable_plain(rays, box[0:3], box[3:6],
                                                    torch.full((), TR.INF)).any())
        # the rows' owners: every winner owns rows and a live box
        hit, win = inp["hit"][b], inp["win"][b]
        assert bool(torch.isin(win[hit], staged).all())
