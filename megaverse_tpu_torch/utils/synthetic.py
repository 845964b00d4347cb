"""Synthetic render inputs that hold every primitive type.

Empty and TowerBuilding only ever produce AABB, ellipsoid and eye-box rows,
while the render kernel implements all eight row types. This module builds,
from a numpy seed, primitive tables with live rows of EVERY type 0-7 plus dead
rows, and a set of cameras that includes one inside a box and one looking at
the sky. Tests and the on-card smoke check feed the same tables to the kernel,
its plain PyTorch version and the JAX package's reference renderer.
"""

from __future__ import annotations

import numpy as np

from megaverse_tpu_torch import constants as C

ROW_W = 12


def _packed_palette() -> np.ndarray:
    pal8 = np.round(np.asarray(C.PALETTE) * 255.0).astype(np.int64)
    return ((pal8[:, 0] << 16) | (pal8[:, 1] << 8) | pal8[:, 2]).astype(np.float32)


def synthetic_prims(seed: int, num_envs: int = 4):
    """float32 [num_envs, 83, 12]: a floor box plus 7 more AABBs (cluster 0),
    one 8-row run per type 1..7 (so each 8-row cluster is homogeneous and gets
    that type's tag), a run of alternating cone / flipped-cone rows (the "cone
    mixed" tag), a run that mixes types (the generic path), and 3 trailing dead
    rows; about one row in eight of every run is dead. Geometry differs per
    env."""
    rng = np.random.default_rng(seed)
    pal = _packed_palette()
    tables = []
    for _ in range(num_envs):
        rows = []

        def add(ptype, a, b, c=(0, 0, 0), col11=0.0):
            color = pal[rng.integers(1, len(pal))]
            rows.append([ptype, *a, *b, color, *c, col11])

        add(0, (-12.0, -1.0, -12.0), (12.0, 0.0, 12.0))   # floor
        kinds = [0] * 7
        for k in range(1, 8):
            kinds += [k] * 8
        kinds += [3, 4] * 4                                # diamond halves
        kinds += [0, 1, 2, 5, 6, 7, 3, 1]                  # mixed cluster
        for k in kinds:
            ctr = np.array([rng.uniform(-8, 8), rng.uniform(0.3, 2.5), rng.uniform(-8, 8)])
            if rng.random() < 0.12:
                k_out = -1.0                               # dead row, junk payload
            else:
                k_out = float(k)
            yaw = rng.uniform(-np.pi, np.pi)
            if k == 0:
                he = rng.uniform(0.2, 1.2, size=3)
                add(k_out, ctr - he, ctr + he)
            elif k == 1:
                add(k_out, ctr, rng.uniform(0.3, 1.3, size=3))
            elif k in (2, 3, 4):
                add(k_out, ctr, (rng.uniform(0.3, 1.0), rng.uniform(0.3, 1.0),
                                 rng.uniform(0.3, 1.0)))
            elif k == 5:
                add(k_out, ctr, (yaw, rng.uniform(-0.4, 0.4), 0.0))
            elif k == 6:
                add(k_out, ctr, (yaw, np.cos(yaw), np.sin(yaw)),
                    c=rng.uniform(0.2, 1.2, size=3))
            else:
                hy = rng.uniform(0.4, 0.9)
                add(k_out, (ctr[0], hy, ctr[2]), (yaw, np.cos(yaw), np.sin(yaw)),
                    c=(rng.uniform(0.5, 1.5), hy, 0.15),
                    col11=pal[rng.integers(1, len(pal))])
        rows += [[-1.0] + [0.0] * 11] * 3                 # trailing dead rows
        tables.append(np.asarray(rows, np.float32))
    return np.stack(tables)


def synthetic_cams(seed: int, prims: np.ndarray, num_agents: int = 4) -> np.ndarray:
    """float32 [B, num_agents, 8] cameras (eye xyz, yaw, pitch, time fraction,
    lastReward, pad) for `prims` [B, M, 12]. Agent 0 sits INSIDE the first
    live AABB of the type-0 run, agent 1 looks straight at the sky from high
    up, the rest look around from random places; lastReward takes positive,
    negative and zero values so both reward indicators appear."""
    rng = np.random.default_rng(seed + 1)
    bsz = prims.shape[0]
    cams = np.zeros((bsz, num_agents, 8), np.float32)
    for b in range(bsz):
        for a in range(num_agents):
            eye = [rng.uniform(-9, 9), rng.uniform(0.6, 3.0), rng.uniform(-9, 9)]
            yaw, pitch = rng.uniform(-np.pi, np.pi), rng.uniform(-0.5, 0.3)
            if a == 0:
                live = [i for i in range(1, prims.shape[1]) if prims[b, i, 0] == 0.0]
                if live:
                    row = prims[b, live[0]]
                    eye = list((row[1:4] + row[4:7]) * 0.5)
            elif a == 1:
                eye[1], pitch = 9.0, 1.35
            reward = (0.0, 0.7, -1.3, 0.2)[(a + b) % 4]
            cams[b, a] = [*eye, yaw, pitch, rng.uniform(0.0, 1.0), reward, 0.0]
    return cams


def synthetic_far(seed: int, num_envs: int = 8, num_agents: int = 4, height: int = 72,
                  width: int = 128):
    """(prims float32 [num_envs, 64, 12], cams float32 [num_envs, num_agents,
    8]) whose hits lie near the far plane and whose rays graze box faces: the
    inputs on which the 0.01 slack of the kernel's distance bounds and box
    votes is tightest.

    Per env, around one eye: four floor slabs 2.0-2.3 m below it and some
    100 m out (near-horizontal rays meet them), 36 boxes 95-125 m away in the view
    direction whose top or bottom face lies at the eye's height or whose x or
    z face passes through the eye, and one 8-row run each of cones (both
    orientations), ellipsoids and cylinders as far out; about one row in ten
    is dead. Agent 0's pitch makes the pixel row just above the middle look
    exactly level (its rays run along the faces at eye height; row 35 of
    72), agent 2's a row higher up (20 of 72); agent 1 looks level, the
    others at small random pitches."""
    rng = np.random.default_rng(seed)
    pal = _packed_palette()
    tan_h = np.tan(np.deg2rad(C.CAMERA_FOV_DEG / 2))
    tan_v = tan_h * height / width
    level = lambda row: -np.arctan((1.0 - (row + 0.5) / height * 2.0) * tan_v)
    prims = np.empty((num_envs, 64, ROW_W), np.float32)
    cams = np.zeros((num_envs, num_agents, 8), np.float32)
    for b in range(num_envs):
        eye = np.array([rng.uniform(-3, 3), rng.uniform(1.2, 2.0), rng.uniform(-3, 3)])
        heading = rng.uniform(-np.pi, np.pi)
        rows = []

        def add(ptype, a, bb, c=(0.0, 0.0, 0.0)):
            live = float(ptype) if rng.random() >= 0.1 else -1.0
            rows.append([live, *a, *bb, pal[rng.integers(1, len(pal))], *c, 0.0])

        def far_point():
            phi = heading + rng.uniform(-0.7, 0.7)
            d = rng.uniform(95.0, 125.0)
            return eye + d * np.array([-np.sin(phi), 0.0, -np.cos(phi)])

        drop = rng.uniform(2.0, 2.3)
        for _ in range(4):
            ctr = far_point()
            lo, hi = ctr - [25.0, 0.0, 25.0], ctr + [25.0, 0.0, 25.0]
            lo[1], hi[1] = eye[1] - drop - 1.0, eye[1] - drop
            rows.append([0.0, *lo, *hi, pal[1], 0.0, 0.0, 0.0, 0.0])
        for k in range(36):
            ctr, he = far_point(), rng.uniform(1.0, 8.0, size=3)
            lo, hi = ctr - he, ctr + he
            # a horizontal face at eye height, or the vertical face across
            # the view direction's smaller offset through the eye
            across = 0 if abs(ctr[0] - eye[0]) < abs(ctr[2] - eye[2]) else 2
            axis, side = (1, 1, across, across)[k % 4], k % 8 < 4
            if side:
                lo[axis] = eye[axis]
                hi[axis] = eye[axis] + 2.0 * he[axis]
            else:
                hi[axis] = eye[axis]
                lo[axis] = eye[axis] - 2.0 * he[axis]
            add(0, lo, hi)
        for k in range(8):
            ctr = far_point() + [0.0, rng.uniform(-1.5, 1.5), 0.0]
            add(3 + k % 2, ctr, rng.uniform(0.3, 2.0, size=3))
        for ptype in (1, 2):
            for _ in range(8):
                ctr = far_point() + [0.0, rng.uniform(-1.5, 1.5), 0.0]
                add(ptype, ctr, rng.uniform(0.3, 2.0, size=3))
        prims[b] = np.asarray(rows, np.float32)
        for a in range(num_agents):
            pitch = {0: level(height // 2 - 1), 1: 0.0, 2: level(height * 5 // 18)}.get(
                a, rng.uniform(-0.05, 0.05))
            yaw = heading + rng.uniform(-0.2, 0.2)
            cams[b, a] = [*eye, yaw, pitch, rng.uniform(0.0, 1.0), 0.0, 0.0]
    return prims, cams


def form_tables(cams, prims, height: int, width: int, seed: int = 0) -> dict:
    """The tables of every culled form of the render kernel for one (cams
    [B, A, 8], prims [B, M, 12]; torch tensors on one device): case -> keyword
    arguments of `render_packed`. B4 appears four times: per-agent lists
    without and with distance bounds, per-tile lists, and a permutation
    shuffled from `seed` (the kernel must accept any visit order)."""
    import torch

    from megaverse_tpu_torch.ops import raycast_cuda as RC

    p8, clusters = RC.build_clusters(prims)
    p8, clusters = p8.contiguous(), clusters.contiguous()
    g = clusters.shape[1]
    cl4, sclusters = RC.build_superclusters(clusters)
    cl4, sclusters = cl4.contiguous(), sclusters.contiguous()
    p32 = RC.pad_prims_to_clusters(p8, cl4).contiguous()
    sclist, clbits, scdist, cdist = RC.cull_bits(cams, cl4, height, width)
    order_a, dist_a = RC.sort_clusters(cams, clusters)
    order_t, dist_t = RC.frustum_cull(cams, clusters, height, width)
    order_s, dist_s = RC.frustum_cull(cams, sclusters, height, width)
    rng = np.random.default_rng(seed)
    bsz, agents = cams.shape[0], cams.shape[1]
    shuffled = torch.from_numpy(np.stack(
        [rng.permutation(g) for _ in range(bsz * agents)]
    ).reshape(bsz, agents, g).astype(np.int32)).to(cams.device)
    return {
        "b2": dict(prims=p32, clusters=cl4, sclist=sclist, clbits=clbits,
                   scdist=scdist, cdist=cdist),
        "b3": dict(prims=p8, clusters=clusters),
        "b4_agent": dict(prims=p8, clusters=clusters, order=order_a),
        "b4_agent_dist": dict(prims=p8, clusters=clusters, order=order_a, dist=dist_a),
        "b4_tile": dict(prims=p8, clusters=clusters, order=order_t, dist=dist_t),
        "b4_shuffled": dict(prims=p8, clusters=clusters, order=shuffled),
        # the prim table stays at 8 G rows while the cluster table is padded
        # to whole superclusters
        "b5": dict(prims=p8, clusters=cl4, sclusters=sclusters, order=order_s,
                   dist=dist_s),
    }
