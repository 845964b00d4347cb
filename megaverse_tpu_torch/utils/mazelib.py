"""Standalone maze-generation library (counterpart of src/libs/mazes).

The engine itself only uses HoneyComb + Kruskal (utils/hexmaze.py,
component_hexagonal_maze.cpp:22-29), but the reference ships a general maze
library (vendored, MIT): graph mazes over several cell shapes with a family of
spanning-tree algorithms (Kruskal, DFS, BFS, loop-erased random walk, Prim —
mazes/src/*.cpp) and SVG output (maze.cpp:38-106). This module reproduces that
capability surface in numpy.

A maze = cells with adjacency (cell, cell, border-segment) edges; generation
removes the borders on a random spanning tree. A copy of
megaverse_tpu/utils/mazelib.py over the port's utils/hexmaze.py.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

Edge = Tuple[int, int, Tuple[float, float, float, float]]


class GraphMaze:
    """cells: centers [C,2]; interior edges; outer border segments."""

    def __init__(self, centers: np.ndarray, interior: List[Edge],
                 outer: List[Tuple[float, float, float, float]]):
        self.centers = centers
        self.interior = interior
        self.outer = outer
        self.removed = np.zeros(len(interior), bool)

    # -- spanning-tree algorithms ------------------------------------------
    def generate(self, rng: np.random.Generator, algorithm: str = "kruskal"):
        algo = {
            "kruskal": self._kruskal,
            "dfs": self._dfs,
            "bfs": self._bfs,
            "prim": self._prim,
            "lerw": self._lerw,
        }[algorithm]
        self.removed[:] = False
        tree = algo(rng)
        self.removed[np.asarray(sorted(tree), np.int64)] = True
        return self

    def _adj(self):
        adj: Dict[int, List[Tuple[int, int]]] = {}
        for k, (i, j, _) in enumerate(self.interior):
            adj.setdefault(i, []).append((j, k))
            adj.setdefault(j, []).append((i, k))
        return adj

    def _kruskal(self, rng):
        parent = list(range(len(self.centers)))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        tree = set()
        for k in rng.permutation(len(self.interior)):
            i, j, _ = self.interior[k]
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[ri] = rj
                tree.add(int(k))
        return tree

    def _dfs(self, rng):
        adj = self._adj()
        visited = {0}
        tree = set()
        stack = [0]
        while stack:
            u = stack[-1]
            nbrs = [(v, k) for v, k in adj.get(u, []) if v not in visited]
            if not nbrs:
                stack.pop()
                continue
            v, k = nbrs[rng.integers(0, len(nbrs))]
            visited.add(v)
            tree.add(k)
            stack.append(v)
        return tree

    def _bfs(self, rng):
        adj = self._adj()
        visited = {0}
        tree = set()
        frontier = [0]
        while frontier:
            u = frontier.pop(0)
            nbrs = [(v, k) for v, k in adj.get(u, []) if v not in visited]
            rng.shuffle(nbrs)
            for v, k in nbrs:
                if v not in visited:
                    visited.add(v)
                    tree.add(k)
                    frontier.append(v)
        return tree

    def _prim(self, rng):
        adj = self._adj()
        visited = {0}
        tree = set()
        frontier = list(adj.get(0, []))
        while frontier:
            idx = int(rng.integers(0, len(frontier)))
            v, k = frontier.pop(idx)
            if v in visited:
                continue
            visited.add(v)
            tree.add(k)
            frontier.extend((w, e) for w, e in adj.get(v, []) if w not in visited)
        return tree

    def _lerw(self, rng):
        """Wilson's algorithm (loop-erased random walks)."""
        adj = self._adj()
        n = len(self.centers)
        in_tree = np.zeros(n, bool)
        in_tree[0] = True
        tree = set()
        for start in range(1, n):
            if in_tree[start]:
                continue
            # random walk with loop erasure
            path = [start]
            edge_of = {}
            u = start
            while not in_tree[u]:
                nbrs = adj.get(u, [])
                v, k = nbrs[rng.integers(0, len(nbrs))]
                if v in path:
                    idx = path.index(v)
                    path = path[: idx + 1]
                else:
                    edge_of[(u, v)] = k
                    path.append(v)
                u = v
            for a, b in zip(path[:-1], path[1:]):
                in_tree[a] = True
                k = edge_of.get((a, b))
                if k is None:
                    for v, kk in adj[a]:
                        if v == b:
                            k = kk
                            break
                tree.add(k)
            in_tree[path[-1]] = True
        return tree

    # -- outputs ------------------------------------------------------------
    def walls(self) -> List[Tuple[float, float, float, float]]:
        """Remaining wall segments (outer + untouched interior)."""
        segs = list(self.outer)
        for k, (_, _, seg) in enumerate(self.interior):
            if not self.removed[k]:
                segs.append(seg)
        return segs

    def to_svg(self, path: str, scale: float = 20.0) -> None:
        """SVG wall output (ref maze.cpp:38-78)."""
        segs = self.walls()
        xs = [c for s in segs for c in (s[0], s[2])]
        ys = [c for s in segs for c in (s[1], s[3])]
        x0, y0 = min(xs), min(ys)
        w = (max(xs) - x0) * scale + 20
        h = (max(ys) - y0) * scale + 20
        lines = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{w:.0f}" height="{h:.0f}">']
        for (x1, y1, x2, y2) in segs:
            lines.append(
                f'<line x1="{(x1-x0)*scale+10:.1f}" y1="{(y1-y0)*scale+10:.1f}" '
                f'x2="{(x2-x0)*scale+10:.1f}" y2="{(y2-y0)*scale+10:.1f}" '
                'stroke="black" stroke-width="2"/>')
        lines.append("</svg>")
        with open(path, "w") as f:
            f.write("\n".join(lines))

    def to_gnuplot(self, path: str) -> None:
        """Gnuplot script output (ref maze.cpp:80-106 PrintMazeGnuplot):
        one arrow-nohead per remaining wall segment plus a plot stanza."""
        segs = self.walls()
        xs = [c for s in segs for c in (s[0], s[2])]
        ys = [c for s in segs for c in (s[1], s[3])]
        pad = 1.0
        lines = [
            "unset border",
            "unset tics",
            "set samples 15",
            f"set xrange [{min(xs) - pad:.3f}:{max(xs) + pad:.3f}]",
            f"set yrange [{min(ys) - pad:.3f}:{max(ys) + pad:.3f}]",
            "set size ratio -1",
        ]
        for (x1, y1, x2, y2) in segs:
            lines.append(
                f"set arrow from {x1:.4f},{y1:.4f} to {x2:.4f},{y2:.4f} "
                "nohead lw 2")
        lines.append("plot -100 notitle")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

def rectangular_maze(width: int, height: int) -> GraphMaze:
    """Rectangular grid maze (ref rectangularmaze.cpp)."""
    centers = np.array([(x + 0.5, y + 0.5) for y in range(height) for x in range(width)])
    idx = lambda x, y: y * width + x
    interior: List[Edge] = []
    outer = []
    for y in range(height):
        for x in range(width):
            if x + 1 < width:
                interior.append((idx(x, y), idx(x + 1, y),
                                 (x + 1.0, float(y), x + 1.0, y + 1.0)))
            else:
                outer.append((x + 1.0, float(y), x + 1.0, y + 1.0))
            if y + 1 < height:
                interior.append((idx(x, y), idx(x, y + 1),
                                 (float(x), y + 1.0, x + 1.0, y + 1.0)))
            else:
                outer.append((float(x), y + 1.0, x + 1.0, y + 1.0))
            if x == 0:
                outer.append((0.0, float(y), 0.0, y + 1.0))
            if y == 0:
                outer.append((float(x), 0.0, x + 1.0, 0.0))
    return GraphMaze(centers, interior, outer)


def honeycomb_maze(size: int) -> GraphMaze:
    """Honeycomb maze (ref honeycombmaze.cpp) via utils/hexmaze geometry."""
    from megaverse_tpu_torch.utils import hexmaze as H

    cells: List[Tuple[int, int]] = []
    index: Dict[Tuple[int, int], int] = {}
    for u in range(-size + 1, size):
        lo, hi = H._vextent(size, u)
        for v in range(lo, hi + 1):
            index[(u, v)] = len(cells)
            cells.append((u, v))
    centers = np.array([H._center(u, v) for (u, v) in cells])
    interior: List[Edge] = []
    outer = []
    for (u, v) in cells:
        i = index[(u, v)]
        for n in range(6):
            uu, vv = u + H.NEIGH[n][0], v + H.NEIGH[n][1]
            if H._valid(size, uu, vv):
                j = index[(uu, vv)]
                if j < i:
                    interior.append((i, j, H._edge(u, v, n)))
            else:
                outer.append(H._edge(u, v, n))
    return GraphMaze(centers, interior, outer)


def hexagonal_maze(size: int) -> GraphMaze:
    """Hexagon-shaped maze of 6*size^2 unit TRIANGLE cells (ref
    hexagonalmaze.cpp: hexagon split into 6 triangular sectors of size^2
    triangles each). Built lattice-first: enumerate up/down triangles of the
    unit triangular lattice whose vertices all fall inside the regular
    hexagon of circumradius `size`, then derive adjacency from shared lattice
    edges — same cell set and topology, no sector bookkeeping."""
    s3 = math.sqrt(3.0)
    e1 = (1.0, 0.0)
    e2 = (0.5, s3 / 2.0)

    def lat(a: int, b: int) -> Tuple[float, float]:
        return (a * e1[0] + b * e2[0], a * e1[1] + b * e2[1])

    def in_hex(p: Tuple[float, float]) -> bool:
        # regular hexagon, circumradius size, vertices at 0/60/.../300 deg:
        # inside iff |p . n| <= apothem for the three edge normals.
        x, y = p
        apothem = size * s3 / 2.0 + 1e-9
        for ang in (math.pi / 2, math.pi / 6 * 5, math.pi / 6):
            if abs(x * math.cos(ang) + y * math.sin(ang)) > apothem:
                return False
        return True

    cells: List[Tuple[Tuple[int, int], ...]] = []  # 3 lattice vertices each
    for a in range(-2 * size, 2 * size + 1):
        for b in range(-2 * size, 2 * size + 1):
            up = ((a, b), (a + 1, b), (a, b + 1))
            dn = ((a + 1, b), (a, b + 1), (a + 1, b + 1))
            for tri in (up, dn):
                if all(in_hex(lat(*v)) for v in tri):
                    cells.append(tri)
    assert len(cells) == 6 * size * size, len(cells)

    centers = np.array(
        [np.mean([lat(*v) for v in tri], axis=0) for tri in cells])
    edge_cells: Dict[frozenset, List[int]] = {}
    for i, tri in enumerate(cells):
        for k in range(3):
            key = frozenset((tri[k], tri[(k + 1) % 3]))
            edge_cells.setdefault(key, []).append(i)
    interior: List[Edge] = []
    outer = []
    for key, owners in edge_cells.items():
        (v1, v2) = sorted(key)
        seg = (*lat(*v1), *lat(*v2))
        if len(owners) == 2:
            interior.append((owners[0], owners[1], seg))
        else:
            outer.append(seg)
    return GraphMaze(centers, interior, outer)


def circular_hexagon_maze(rings: int) -> GraphMaze:
    """Concentric-ring maze with the hexagonal maze's cell counts — ring r
    holds 6*(2r+1) cells, one per triangle of hexagonal row r (ref
    circularhexagonmaze.cpp maps the triangle grid onto annuli; arcs are
    chord-approximated like circular_maze)."""
    centers = []
    ring_start = []
    for r in range(rings):
        ring_start.append(len(centers))
        n = 6 * (2 * r + 1)
        for k in range(n):
            th = 2 * math.pi * (k + 0.5) / n
            centers.append(((r + 0.5) * math.cos(th), (r + 0.5) * math.sin(th)))

    interior: List[Edge] = []
    outer = []

    def radial(r, th):
        return (r * math.cos(th), r * math.sin(th),
                (r + 1) * math.cos(th), (r + 1) * math.sin(th))

    def chord(r, th1, th2):
        return (r * math.cos(th1), r * math.sin(th1),
                r * math.cos(th2), r * math.sin(th2))

    for r in range(rings):
        n = 6 * (2 * r + 1)
        for k in range(n):
            i = ring_start[r] + k
            th2 = 2 * math.pi * (k + 1) / n
            # tangential neighbor (radial wall); ring 0's hub cells meet at
            # the center so the wall spans the full annulus
            if n > 1:
                j = ring_start[r] + (k + 1) % n
                interior.append((i, j, radial(r, th2)))
            # inward neighbors: ring r-1 cells whose angular span overlaps
            if r > 0:
                m = 6 * (2 * r - 1)
                lo = 2 * math.pi * k / n
                hi = th2
                k_lo = int(math.floor(lo / (2 * math.pi) * m - 1e-9))
                k_hi = int(math.ceil(hi / (2 * math.pi) * m + 1e-9))
                for kk in range(k_lo, k_hi):
                    a1 = max(lo, 2 * math.pi * kk / m)
                    a2 = min(hi, 2 * math.pi * (kk + 1) / m)
                    if a2 - a1 < 1e-9:
                        continue
                    inner = ring_start[r - 1] + (kk % m)
                    interior.append((i, inner, chord(r, a1, a2)))
            if r == rings - 1:
                outer.append(chord(r + 1, 2 * math.pi * k / n, th2))
    return GraphMaze(np.asarray(centers), interior, outer)


def user_maze(centers: Sequence[Tuple[float, float]],
              edges: Sequence[Tuple[int, int, Tuple[float, float, float, float]]],
              outer: Sequence[Tuple[float, float, float, float]] = ()) -> GraphMaze:
    """Maze over a user-supplied cell graph (ref usermaze.cpp: Maze built
    from an externally provided adjacency list). `edges` are
    (cell_i, cell_j, wall segment); walls on the spanning tree are removed
    by generate()."""
    return GraphMaze(np.asarray(centers, np.float64), list(edges), list(outer))


def circular_maze(rings: int) -> GraphMaze:
    """Concentric-ring maze (ref circularmaze.cpp, simplified: 6*r cells/ring)."""
    centers = [(0.0, 0.0)]
    ring_start = [0, 1]
    for r in range(1, rings):
        n = 6 * r
        for k in range(n):
            th = 2 * math.pi * k / n
            centers.append(((r + 0.5) * math.cos(th), (r + 0.5) * math.sin(th)))
        ring_start.append(ring_start[-1] + n)
    interior: List[Edge] = []
    outer = []

    def arc(r, th1, th2):
        # chordal approximation of the arc border
        return (r * math.cos(th1), r * math.sin(th1), r * math.cos(th2), r * math.sin(th2))

    for r in range(1, rings):
        n = 6 * r
        for k in range(n):
            i = ring_start[r] + k
            th1 = 2 * math.pi * k / n
            th2 = 2 * math.pi * (k + 1) / n
            # tangential neighbor
            j = ring_start[r] + (k + 1) % n
            interior.append((i, j, (r * math.cos(th2), r * math.sin(th2),
                                    (r + 1) * math.cos(th2), (r + 1) * math.sin(th2))))
            # inward neighbor
            if r == 1:
                interior.append((i, 0, arc(r, th1, th2)))
            else:
                m = 6 * (r - 1)
                inner = ring_start[r - 1] + int(k * m / n) % m
                interior.append((i, inner, arc(r, th1, th2)))
            if r == rings - 1:
                outer.append(arc(r + 1, th1, th2))
    return GraphMaze(np.asarray(centers), interior, outer)
