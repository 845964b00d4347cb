"""Boxoban level loading + procedural fallback generation.

The reference Sokoban scenario loads DeepMind Boxoban level files from
$BOXOBAN_LEVELS or ~/datasets/boxoban (scenario_sokoban.cpp:42-76) and parses
'# $ . @ *' character maps. This module reproduces the loader, and adds a
procedural generator (reverse-play: boxes start on goals and are pulled apart
by a random walk, which guarantees solvability) for hosts without the dataset.

Level format: list of row strings; cells: '#'=wall, '$'=box, '.'=goal,
'@'=player, '*'=box-on-goal, '+'=player-on-goal, ' '=floor.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

WALL, FLOOR = "#", " "


def find_level_files() -> List[str]:
    """Mirror of the reference search (scenario_sokoban.cpp:42-76)."""
    root = os.environ.get("BOXOBAN_LEVELS") or os.path.expanduser("~/datasets/boxoban")
    level_dir = os.path.join(root, "unfiltered", "train")
    files = []
    for i in range(1000):
        p = os.path.join(level_dir, f"{i:03d}.txt")
        if os.path.isfile(p):
            files.append(p)
    return files


def parse_level_file(path: str) -> List[List[str]]:
    """One boxoban file -> list of levels (each a list of row strings)."""
    levels: List[List[str]] = []
    current: List[str] = []
    with open(path) as f:
        for i, line in enumerate(f.read().split("\n")):
            if line.startswith(";"):
                if i > 0:
                    levels.append(current)
                current = []
            else:
                current.append(line)
    if current and any(r.strip() for r in current):
        levels.append(current)
    return [lv for lv in levels if any(r.strip() for r in lv)]


def generate_level(rng: np.random.Generator, size: int = 10, num_boxes: int = 4,
                   scramble: int = 60) -> List[str]:
    """Procedural boxoban-style level via reverse play (always solvable)."""
    for _ in range(50):
        grid = np.full((size, size), WALL, dtype="<U1")
        # carve a random open region with a drunken walk
        x, z = size // 2, size // 2
        carved = set()
        steps = int(size * size * 1.5)
        for _ in range(steps):
            if 1 <= x < size - 1 and 1 <= z < size - 1:
                carved.add((x, z))
            d = rng.integers(0, 4)
            dx, dz = ((1, 0), (-1, 0), (0, 1), (0, -1))[d]
            x = int(np.clip(x + dx, 1, size - 2))
            z = int(np.clip(z + dz, 1, size - 2))
        if len(carved) < num_boxes * 6:
            continue
        for (cx, cz) in carved:
            grid[cx, cz] = FLOOR

        open_cells = list(carved)
        rng.shuffle(open_cells)
        goals = open_cells[:num_boxes]
        boxes = {g: g for g in goals}  # box pos -> (still keyed by pos)
        box_set = set(goals)

        # player next to some box
        player = None
        for (gx, gz) in goals:
            for dx, dz in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                c = (gx + dx, gz + dz)
                if c in carved and c not in box_set:
                    player = c
                    break
            if player:
                break
        if player is None:
            continue

        # reverse-play scramble: the player PULLS boxes
        for _ in range(scramble):
            moves = []
            px, pz = player
            for dx, dz in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                nxt = (px + dx, pz + dz)       # where the player walks to
                box_cell = (px - dx, pz - dz)  # box behind the player gets pulled
                if nxt in carved and nxt not in box_set:
                    moves.append((nxt, box_cell if box_cell in box_set else None))
            if not moves:
                break
            nxt, pulled = moves[rng.integers(0, len(moves))]
            if pulled is not None:
                box_set.remove(pulled)
                box_set.add(player)
            player = nxt

        goal_set = set(goals)
        rows = []
        for xx in range(size):
            row = []
            for zz in range(size):
                c = (xx, zz)
                if grid[xx, zz] == WALL:
                    ch = "#"
                elif c in box_set and c in goal_set:
                    ch = "*"
                elif c in box_set:
                    ch = "$"
                elif c == player and c in goal_set:
                    ch = "+"
                elif c == player:
                    ch = "@"
                elif c in goal_set:
                    ch = "."
                else:
                    ch = " "
                row.append(ch)
            rows.append("".join(row))
        # require at least one box off its goal
        if box_set != goal_set:
            return rows
    return rows  # last attempt even if already solved


class LevelSource:
    """Random level stream: boxoban files when available, generator otherwise."""

    _parse = staticmethod(parse_level_file)  # injectable for tests

    def __init__(self):
        self.files = find_level_files()

    def sample(self, rng: np.random.Generator) -> List[str]:
        if self.files:
            path = self.files[int(rng.integers(0, len(self.files)))]
            levels = self._parse(path)
            return levels[int(rng.integers(0, len(levels)))]
        return generate_level(rng)

    def sample_ref(self, rng) -> List[str]:
        """Reference-stream level draw (scenario_sokoban.cpp:81-118): a
        per-env level cache, refilled by randomSample(levelFiles) + parse +
        std::shuffle when empty; every reset pops the BACK of the cache. The
        cache hangs off the env's persistent Rng object — the analogue of the
        C++ env-instance `levels` vector (the Rng identity outlives episode
        reseeds exactly like `envState.rng` does).

        Without the Boxoban dataset the reference aborts
        (scenario_sokoban.cpp:72-74); here the procedural generator takes
        over, seeded from the episode stream — deterministic, but with no
        reference stream to match."""
        if not self.files:
            gen = np.random.Generator(np.random.PCG64(rng.rand_range(0, 1 << 30)))
            return generate_level(gen)
        cache = getattr(rng, "soko_level_cache", None)
        if cache is None:
            cache = rng.soko_level_cache = []
        if not cache:
            path = rng.random_sample(self.files)
            cache.extend(self._parse(path))
            rng.shuffle(cache)
        return cache.pop()
