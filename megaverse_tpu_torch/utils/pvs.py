"""Host-side potentially-visible-set (PVS) computation for honeycomb mazes.

The hex scenes' render cost is dominated by wall rows that survive frustum
culling but are occluded by nearer walls (measured HexMemory: ~67 rows/tile
survive, <5 visible — scripts/analyze_culling.py). Classic portal PVS fixes
this at episode-generation time: every wall of one maze has the SAME height,
so for an eye below the wall-top plane a ray that ends on a wall (or on any
object fully below the tops) never leaves the slab y in [0, top] — 3D
visibility of those rows reduces exactly to 2D visibility among the wall
footprints. We compute per-cell cell-to-cell visibility over the maze's
portal graph (open edges), then derive per-render-row visibility bitmasks
that the device culling prologue ANDs into the per-tile survival bits
(ops/pvs.py). Conservative throughout: a row is only masked when no
sightline to it can exist, so the rendered image is BIT-IDENTICAL (tested).

The hot path is C++ (native/megaverse_native.cpp: mvn_hex_pvs, portal DFS
with an exact incremental stabbing-line test); the numpy fallback here
implements the same algorithm and is used by tests and native-less installs
(small mazes only — on budget exhaustion everything degrades to visible).

Reference context: the maze geometry matches component_hexagonal_maze.cpp
(walls on hex edges, one shared height per maze); the PVS itself has no
reference counterpart — the reference's Vulkan renderer brute-forces all
drawables per view.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from megaverse_tpu_torch.utils.hexmaze import NEIGH, HoneycombMaze, _edge, _valid

# Hexagon circumradius is 1 (unit edge length, maze units). Inflations keep
# every test conservative: _HEX_R covers the source hexagon plus the device
# cell-assignment slack; wall/object footprints add their own reach below.
_HEX_R = 1.0 + 0.03
_DFS_BUDGET = 200_000


def maze_portal_arrays(maze: HoneycombMaze, closed_interior: "set[int]"):
    """(neigh [C,6] i32, open [C,6] u8, edge_pts [C,6,4] f64).

    closed_interior: indices into maze.interior_wall_cells (= kept walls).
    Outer edges are always walls; interior lattice edges are portals unless
    their wall was kept.
    """
    size = maze.size
    index = {uv: i for i, uv in enumerate(maze.cells)}
    c = len(maze.cells)
    neigh = np.full((c, 6), -1, np.int32)
    open_ = np.zeros((c, 6), np.uint8)
    edge_pts = np.zeros((c, 6, 4), np.float64)
    for i, (u, v) in enumerate(maze.cells):
        for n in range(6):
            uu, vv = u + NEIGH[n][0], v + NEIGH[n][1]
            edge_pts[i, n] = _edge(u, v, n)
            if _valid(size, uu, vv):
                neigh[i, n] = index[(uu, vv)]
                open_[i, n] = 1
    for k in closed_interior:
        i, j = maze.interior_wall_cells[k]
        # find the edge slots on both sides
        for n in range(6):
            if neigh[i, n] == j:
                open_[i, n] = 0
            if neigh[j, n] == i:
                open_[j, n] = 0
    return neigh, open_, edge_pts


def cell_visibility(maze: HoneycombMaze, closed_interior: "set[int]",
                    budget: int = _DFS_BUDGET) -> np.ndarray:
    """Conservative cell-to-cell visibility matrix [C, C] bool.

    vis[a, b] False ONLY when no straight sightline from anywhere in cell a
    can reach cell b through the open portals. Symmetrized (sightlines are
    reversible) so a budget truncation on one side cannot under-mark."""
    neigh, open_, edge_pts = maze_portal_arrays(maze, closed_interior)
    from megaverse_tpu_torch.utils import native

    out = native.hex_pvs(neigh, open_, edge_pts, budget)
    if out is None:
        vis = _py_pvs(neigh, open_, edge_pts, budget)
    else:
        vis = out[0]
    vis = vis.astype(bool)
    return vis | vis.T


# ---------------------------------------------------------------------------
# numpy/python fallback — faithful port of mvn_hex_pvs (portal DFS with
# incremental stabbing-candidate sets, direction-cone and coverage prunes).
# Bit-identical to the native result under the same budget.
# ---------------------------------------------------------------------------

_EPS = 1e-7
_MAX_DEPTH = 40


def _line(p, q):
    d = (q[0] - p[0], q[1] - p[1])
    n = np.hypot(d[0], d[1])
    if n < 1e-9:
        return None
    a, b = -d[1] / n, d[0] / n
    return (a, b, -(a * p[0] + b * p[1]))


def _crosses(l, s0, s1):
    f0 = l[0] * s0[0] + l[1] * s0[1] + l[2]
    f1 = l[0] * s1[0] + l[1] * s1[1] + l[2]
    return (f0 <= _EPS and f1 >= -_EPS) or (f1 <= _EPS and f0 >= -_EPS)


def _py_pvs(neigh, open_, edge_pts, budget) -> np.ndarray:
    c = neigh.shape[0]
    ext = 1e-4
    e0 = np.empty((c, 6, 2))
    e1 = np.empty((c, 6, 2))
    for i in range(c):
        for n in range(6):
            x0, y0, x1, y1 = edge_pts[i, n]
            dx, dy = x1 - x0, y1 - y0
            e0[i, n] = (x0 - dx * ext, y0 - dy * ext)
            e1[i, n] = (x1 + dx * ext, y1 + dy * ext)

    # valid direction sets: subsets of 3 consecutive of the 6 edge-normal
    # directions (slot order IS angular order) — open-half-plane condition
    conevalid = np.zeros((64,), bool)
    for s in range(64):
        for base in range(6):
            cone = (1 << base) | (1 << ((base + 1) % 6)) | (1 << ((base + 2) % 6))
            if (s & ~cone) == 0:
                conevalid[s] = True
                break

    # forward half-plane cover sets per directed open edge
    # columns of edge_pts are (x0, y0, x1, y1): x coords at 0::2, y at 1::2
    ctr = np.stack([edge_pts[:, :, 0::2].reshape(c, -1).mean(1),
                    edge_pts[:, :, 1::2].reshape(c, -1).mean(1)], axis=1)
    beyond = np.zeros((c, 6, c), bool)
    for i in range(c):
        for n in range(6):
            j = neigh[i, n]
            if j < 0 or not open_[i, n]:
                continue
            l = _line(tuple(e0[i, n]), tuple(e1[i, n]))
            if l is None:
                continue
            sj = l[0] * ctr[j, 0] + l[1] * ctr[j, 1] + l[2]
            sgn = 1.0 if sj > 0 else -1.0
            sd = sgn * (l[0] * ctr[:, 0] + l[1] * ctr[:, 1] + l[2])
            beyond[i, n] = sd > -1.05

    vis = np.zeros((c, c), bool)
    state = {"budget": 0}

    def dfs(src, cell, segs, pts, cands, dirset):
        k = len(segs)
        if k >= _MAX_DEPTH:
            return True
        state["budget"] -= 1
        if state["budget"] < 0:
            return False
        for n in range(6):
            j = neigh[cell, n]
            if j < 0 or not open_[cell, n]:
                continue
            nset = dirset | (1 << n)
            if not conevalid[nset]:
                continue
            a = tuple(e0[cell, n])
            b = tuple(e1[cell, n])
            child: List = []
            overflow = False
            if k < 2:
                feasible = True
            else:
                feasible = False
                if k == 2 or cands is None:
                    allp = pts + [a, b]
                    cand_lines = [_line(allp[p], allp[q])
                                  for p in range(len(allp))
                                  for q in range(p + 1, len(allp))]
                else:
                    cand_lines = list(cands)
                    for np_ in (a, b):
                        for p in pts:
                            cand_lines.append(_line(np_, p))
                    cand_lines.append(_line(a, b))
                for l in cand_lines:
                    if l is None or not _crosses(l, a, b):
                        continue
                    if all(_crosses(l, s0, s1) for s0, s1 in segs):
                        feasible = True
                        if len(child) < 64:
                            child.append(l)
                        else:
                            overflow = True
                if not feasible:
                    continue
            vis[src, j] = True
            if not np.any(beyond[cell, n] & ~vis[src]):
                continue  # coverage prune
            if not dfs(src, j, segs + [(a, b)], pts + [a, b],
                       None if overflow else child, nset):
                return False
        return True

    for src in range(c):
        vis[src, src] = True
        state["budget"] = budget
        if not dfs(src, src, [], [], [], 0):
            vis[src, :] = True
    return vis


# ---------------------------------------------------------------------------
# row-mask helpers (scenario generation side)
# ---------------------------------------------------------------------------

def wall_adjacency(centers: np.ndarray, segs: np.ndarray,
                   reach: float = 0.08) -> np.ndarray:
    """adj [C, W] bool: cell c's (inflated) hexagon can touch wall w's
    (inflated) footprint. centers [C, 2], segs [W, 4] (x0,y0,x1,y1), all in
    maze units (unit edge length). `reach` bounds how far the rendered
    footprint extends beyond the segment (edging depth 0.2/3.5 = 0.057 plus
    the 2% length overhang) — conservative superset via point-segment
    distance <= circumradius + reach."""
    if len(segs) == 0:
        return np.zeros((centers.shape[0], 0), bool)
    p = centers[:, None, :]                      # [C, 1, 2]
    a = segs[None, :, 0:2]
    b = segs[None, :, 2:4]
    ab = b - a
    t = np.clip(np.sum((p - a) * ab, -1) / np.maximum(np.sum(ab * ab, -1), 1e-12),
                0.0, 1.0)
    close = a + t[..., None] * ab
    d = np.linalg.norm(p - close, axis=-1)       # [C, W]
    return d <= _HEX_R + reach


def point_adjacency(centers: np.ndarray, pts: np.ndarray,
                    radius: float) -> np.ndarray:
    """adj [C, K] bool: cell hexagon can touch disc(pts[k], radius)."""
    if len(pts) == 0:
        return np.zeros((centers.shape[0], 0), bool)
    d = np.linalg.norm(centers[:, None, :] - pts[None, :, :], axis=-1)
    return d <= _HEX_R + radius


def pack_rows16(rowvis: np.ndarray) -> np.ndarray:
    """bool [N, P] -> int32 [N, ceil(P/16)], 16 row-bits per word (the
    JAX package's word format; ops/pvs.py gathers and unpacks them)."""
    n, p = rowvis.shape
    w = -(-p // 16)
    pad = w * 16 - p
    if pad:
        rowvis = np.concatenate(
            [rowvis, np.zeros((n, pad), bool)], axis=1)
    bits = rowvis.reshape(n, w, 16).astype(np.int32)
    return (bits << np.arange(16, dtype=np.int32)).sum(axis=2).astype(np.int32)
