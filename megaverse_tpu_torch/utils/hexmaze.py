"""Honeycomb maze generation (Kruskal spanning tree over hex cells).

Host-side numpy equivalent of the vendored mazes library's HoneyComb maze with
Kruskal (src/libs/mazes/src/honeycombmaze.cpp:10-84, kruskal.cpp:6-31) as used
by HexagonalMazeComponent (component_hexagonal_maze.cpp:19-128).

Axial coordinates (u, v): cells for u in (-size, size), v in VExtent(u); cell
center (sqrt(3)/2*u + sqrt(3)*v, 1.5*u); hexagon edge n has endpoints at
angles (n-2.5)*pi/3 and +pi/3 around the center (honeycombmaze.cpp:59-67).

NOTE: the reference seeds Kruskal's shuffle from std::random_device
(spanningtreealgorithm.cpp:3-5), so maze topology is NOT controlled by the env
seed there. We fix that determinism hole by drawing everything from the
episode rng (SURVEY 2.1 #30).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

NEIGH = [(-1, 0), (-1, 1), (0, 1), (1, 0), (1, -1), (0, -1)]


def _vextent(size: int, u: int) -> Tuple[int, int]:
    if u < 0:
        return (-size - u + 1, size - 1)
    return (-size + 1, size - 1 - u)


def _valid(size: int, u: int, v: int) -> bool:
    if u <= -size or u >= size:
        return False
    lo, hi = _vextent(size, u)
    return lo <= v <= hi


def _center(u: int, v: int) -> Tuple[float, float]:
    return (np.sqrt(3) / 2 * u + np.sqrt(3) * v, 1.5 * u)


def _edge(u: int, v: int, n: int) -> Tuple[float, float, float, float]:
    cx, cy = _center(u, v)
    t1 = (n - 2.5) * np.pi / 3
    t2 = t1 + np.pi / 3
    return (cx + np.cos(t1), cy + np.sin(t1), cx + np.cos(t2), cy + np.sin(t2))


class HoneycombMaze:
    """Generated maze: cell centers + remaining wall segments."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size = size
        cells: List[Tuple[int, int]] = []
        index: Dict[Tuple[int, int], int] = {}
        for u in range(-size + 1, size):
            lo, hi = _vextent(size, u)
            for v in range(lo, hi + 1):
                index[(u, v)] = len(cells)
                cells.append((u, v))
        self.cells = cells
        self.centers = np.array([_center(u, v) for (u, v) in cells])  # [C,2]

        # interior edges (i < j once) and outer borders
        interior: List[Tuple[int, int, Tuple]] = []
        outer: List[Tuple] = []
        for (u, v) in cells:
            i = index[(u, v)]
            for n in range(6):
                uu, vv = u + NEIGH[n][0], v + NEIGH[n][1]
                if _valid(size, uu, vv):
                    j = index[(uu, vv)]
                    if j < i:
                        interior.append((i, j, _edge(u, v, n)))
                else:
                    outer.append(_edge(u, v, n))
        self.outer_walls = outer

        # Kruskal: shuffle edges, union-find, tree edges get removed
        order = rng.permutation(len(interior))
        parent = list(range(len(cells)))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        in_tree = np.zeros(len(interior), bool)
        for k in order:
            i, j, _ = interior[k]
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[ri] = rj
                in_tree[k] = True

        self.interior_walls = [e for k, (i, j, e) in enumerate(interior) if not in_tree[k]]
        # cell pair per remaining interior wall, aligned with interior_walls
        # (consumed by the PVS: kept walls close their lattice edge)
        self.interior_wall_cells = [
            (i, j) for k, (i, j, e) in enumerate(interior) if not in_tree[k]]

    def bounds(self) -> Tuple[float, float, float, float]:
        """(xmin, ymin, xmax, ymax) (honeycombmaze.cpp:69-73)."""
        xlim = np.sqrt(3) * (self.size - 0.5)
        ylim = 1.5 * self.size - 0.5
        return (-xlim, -ylim, xlim, ylim)


def maze_walls(maze: HoneycombMaze, rng: np.random.Generator,
               omit_probability: float, kept_out: Optional[List[int]] = None,
               ) -> List[Tuple[float, float, float, float]]:
    """Final wall segments: all outer borders + interior walls kept with
    probability (1 - omit_probability) (component_hexagonal_maze.cpp:60-75).

    kept_out (optional list) receives the indices into maze.interior_walls of
    the kept interior walls, in wall order (outer walls have no index — they
    are never portals). The rng draw order is one draw per interior wall,
    unchanged."""
    walls = []
    for k, e in enumerate(maze.interior_walls):
        if rng.random() < omit_probability:
            continue
        if kept_out is not None:
            kept_out.append(k)
        walls.append(e)
    walls.extend(maze.outer_walls)
    return walls
