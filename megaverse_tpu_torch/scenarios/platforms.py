"""Procedural obstacle-course platform zoo (host-side numpy generation).

Reimplements the reference platform framework
(scenarios/include/scenarios/platforms.hpp:137-557): platforms are generated
in local integer coordinates with an attached world transform (quarter-turn
rotation + translation, replacing the Magnum scene-graph chaining), emit
layout/wall/terrain AABBs, keep an occupancy map for object spawning, and
chain via a "next platform anchor".

All of this runs on the host at episode-generation time; the output is
voxelized into the dense grid consumed by the device step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from megaverse_tpu_torch import constants as C

WALLS_NONE = 0
WALLS_SOUTH = 1
WALLS_NORTH = 2
WALLS_EAST = 4
WALLS_WEST = 8
WALLS_ALL = WALLS_SOUTH | WALLS_NORTH | WALLS_EAST | WALLS_WEST

ORIENTATION_STRAIGHT = 0
ORIENTATION_TURN_LEFT = 1
ORIENTATION_TURN_RIGHT = 2


def tri(n: int) -> int:
    """triangularNumber."""
    return n * (n + 1) // 2


@dataclasses.dataclass
class Transform:
    """World = R_k . p + t, with R_k a quarter-turn about +Y.

    R_1 (90 deg CCW, Magnum rotateY(90)): (x,y,z) -> (z, y, -x).
    """

    k: int = 0
    t: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))

    def rot(self, p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, np.float64)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        k = self.k % 4
        if k == 0:
            xo, zo = x, z
        elif k == 1:
            xo, zo = z, -x
        elif k == 2:
            xo, zo = -x, -z
        else:
            xo, zo = -z, x
        return np.stack([xo, y, zo], axis=-1)

    def apply(self, p) -> np.ndarray:
        return self.rot(p) + self.t

    def box_world(self, lo, hi) -> Tuple[np.ndarray, np.ndarray]:
        """Axis-aligned box corners (ints) -> world AABB (floats)."""
        a = self.apply(np.asarray(lo, np.float64))
        b = self.apply(np.asarray(hi, np.float64))
        return np.minimum(a, b), np.maximum(a, b)


@dataclasses.dataclass
class Box:
    lo: Tuple[int, int, int]
    hi: Tuple[int, int, int]


class Platform:
    """Base platform (ref platforms.hpp:137-304)."""

    def __init__(self, rng: np.random.Generator, walls: int, params, width: int = -1):
        self.rng = rng
        self.walls = walls
        self.params = params
        self.length = 0
        self.height = 0
        self.width = width
        self.layout_boxes: List[Box] = []
        self.wall_boxes: List[Box] = []
        self.terrain_boxes: Dict[int, List[Box]] = {}
        self.occupancy: Dict[Tuple[int, int], int] = {}
        self.transform = Transform()
        # anchor: local transform of the next platform's origin
        self.anchor_offset = np.zeros(3)

    def rr(self, lo: int, hi: int) -> int:
        """randRange [lo, hi) (ref util.hpp)."""
        r = self.rng
        if hasattr(r, "rand_range"):  # reference-stream Rng (utils/refrng.py)
            return r.rand_range(lo, hi)
        return int(r.integers(lo, hi))

    def param(self, name: str) -> int:
        return int(round(self.params[name]))

    # -- generation ---------------------------------------------------------
    def init(self):
        raise NotImplementedError

    def generate(self):
        raise NotImplementedError

    def add_floor(self):
        self.layout_boxes.append(Box((0, 0, 0), (self.length, 1, self.width)))
        self.anchor_offset = np.array([float(self.length), 0.0, 0.0])

    def add_walls(self):
        w, l, h = self.width, self.length, self.height
        if self.walls & WALLS_SOUTH:
            self.wall_boxes.append(Box((0, 0, 0), (1, h, w)))
        if self.walls & WALLS_NORTH:
            self.wall_boxes.append(Box((l - 1, 0, 0), (l, h, w)))
        if self.walls & WALLS_EAST:
            self.wall_boxes.append(Box((0, 0, 0), (l, h, 1)))
        if self.walls & WALLS_WEST:
            self.wall_boxes.append(Box((0, 0, w - 1), (l, h, w)))

    # -- chaining (ref rotateCCW/rotateCW, platforms.hpp:153-165) ----------
    def attach_to(self, parent_anchor: Transform, orientation: int, prev_width: int):
        if orientation == ORIENTATION_STRAIGHT:
            self.transform = parent_anchor
        elif orientation == ORIENTATION_TURN_LEFT:
            # rotateYLocal(90) then translateLocal(-1, 0, -1)
            t = Transform(k=(parent_anchor.k + 1) % 4, t=parent_anchor.t.copy())
            t.t = t.t + t.rot(np.array([-1.0, 0.0, -1.0]))
            self.transform = t
        else:
            t = Transform(k=(parent_anchor.k - 1) % 4, t=parent_anchor.t.copy())
            t.t = t.t + t.rot(np.array([float(prev_width) - 1.0, 0.0, -float(self.width) + 1.0]))
            self.transform = t

    def anchor(self) -> Transform:
        a = Transform(k=self.transform.k, t=self.transform.t.copy())
        a.t = a.t + a.rot(self.anchor_offset)
        return a

    # -- queries ------------------------------------------------------------
    def world_bbox(self) -> Tuple[np.ndarray, np.ndarray]:
        los, his = [], []
        for box in self.layout_boxes + self.wall_boxes:
            lo, hi = self.transform.box_world(box.lo, box.hi)
            los.append(lo)
            his.append(hi)
        if not los:
            return np.zeros(3), np.zeros(3)
        return np.min(los, axis=0), np.max(his, axis=0)

    def collides_with(self, other: "Platform") -> bool:
        alo, ahi = self.world_bbox()
        blo, bhi = other.world_bbox()
        return bool(np.all(ahi > blo) and np.all(bhi > alo))

    def agent_spawn_points(self, num_agents: int) -> List[np.ndarray]:
        """LOCAL coords (ref platforms.hpp:221-243)."""
        points = []
        used = set()
        for _ in range(num_agents):
            for _attempt in range(10):
                x = self.rr(1, self.length - 1)
                z = self.rr(1, self.width - 1)
                if (x, z) in used:
                    continue
                y = self.occupancy.get((x, z), 0) + 1
                self.occupancy[(x, z)] = self.occupancy.get((x, z), 0) + 2
                points.append(np.array([x, y, z], np.float64))
                used.add((x, z))
                break
        return points

    def requires_movable_boxes(self) -> int:
        return 0

    def is_max_difficulty(self) -> bool:
        return False

    def generate_object_positions(self, n: int) -> List[np.ndarray]:
        """WORLD voxel coords (ref platforms.hpp:247-276)."""
        out = []
        for _ in range(n):
            for attempt in range(10):
                x = self.rr(1, self.length - 1)
                z = self.rr(1, self.width - 1)
                if self.occupancy.get((x, z), 0) < 2 or attempt >= 9:
                    self.occupancy[(x, z)] = self.occupancy.get((x, z), 0) + 1
                    y = self.occupancy[(x, z)]
                    out.append(np.array([x, y, z], np.int64))
                    break
        return self.adjust(out)

    def adjust(self, coords: List[np.ndarray]) -> List[np.ndarray]:
        """Local voxel -> world voxel (ref adjustTransformation)."""
        res = []
        for c in coords:
            p = self.transform.apply(np.asarray(c, np.float64) + 0.5)
            res.append(np.floor(p).astype(np.int64))
        return res


class EmptyPlatform(Platform):
    def init(self):
        self.length = self.rr(4, 10)
        if self.width == -1:
            self.width = self.rr(5, 9)
        self.height = 5

    def generate(self):
        self.add_floor()
        self.add_walls()


class WallPlatform(EmptyPlatform):
    def init(self):
        EmptyPlatform.init(self)
        self.wall_height = self.rr(self.param("obstaclesMinHeight"),
                                   self.param("obstaclesMaxHeight") + 1)
        self.height = self.rr(self.wall_height + 4, self.wall_height + 6)

    def generate(self):
        EmptyPlatform.generate(self)
        wall_x = self.rr(1, self.length)
        thickness = self.rr(1, self.length - wall_x + 1)
        self.layout_boxes.append(
            Box((wall_x, 1, 1), (wall_x + thickness, 1 + self.wall_height, self.width - 1)))
        for x in range(wall_x, wall_x + thickness):
            for z in range(1, self.width):
                self.occupancy[(x, z)] = self.wall_height

    def requires_movable_boxes(self):
        return tri(self.wall_height - 1)

    def is_max_difficulty(self):
        return self.wall_height >= self.param("obstaclesMaxHeight")


class LavaPlatform(EmptyPlatform):
    def init(self):
        EmptyPlatform.init(self)
        self.length = self.rr(6, 12)
        min_lava = min(self.param("obstaclesMinLava"), self.length - 2)
        max_lava = min(self.param("obstaclesMaxLava") + 1, self.length - 1)
        self.lava_length = self.rr(min_lava, max_lava)

    def generate(self):
        EmptyPlatform.generate(self)
        lava_x = self.rr(1, self.length - self.lava_length)
        self.terrain_boxes.setdefault(C.TERRAIN_LAVA, []).append(
            Box((lava_x, 1, 1), (lava_x + self.lava_length, 2, self.width - 1)))

    def requires_movable_boxes(self):
        return max(1, self.lava_length - 1)

    def is_max_difficulty(self):
        return self.lava_length >= self.param("obstaclesMaxLava")


class StepPlatform(EmptyPlatform):
    def init(self):
        EmptyPlatform.init(self)
        self.step_height = self.rr(self.param("obstaclesMinHeight"),
                                   self.param("obstaclesMaxHeight") + 1)
        self.height = self.rr(self.step_height + 2, self.step_height + 5)

    def generate(self):
        step_x = self.rr(1, self.length)
        sh = self.step_height
        self.layout_boxes.append(Box((0, 0, 0), (step_x + 1, 1, self.width)))
        self.layout_boxes.append(Box((step_x, sh, 0), (self.length, sh + 1, self.width)))
        self.layout_boxes.append(Box((step_x, 0, 0), (step_x + 1, sh + 1, self.width)))
        self.anchor_offset = np.array([float(self.length), float(sh), 0.0])
        self.add_walls()
        for x in range(step_x + 1, self.length):
            for z in range(1, self.width):
                self.occupancy[(x, z)] = sh

    def requires_movable_boxes(self):
        return tri(self.step_height - 1)

    def is_max_difficulty(self):
        return self.step_height >= self.param("obstaclesMaxHeight")


class GapPlatform(EmptyPlatform):
    def init(self):
        EmptyPlatform.init(self)
        self.gap = self.rr(self.param("obstaclesMinGap"),
                           min(self.param("obstaclesMaxGap") + 1, self.length - 1))
        self.gap_x = self.rr(1, self.length - self.gap)

    def generate(self):
        self.layout_boxes.append(Box((0, 0, 0), (self.gap_x, 1, self.width)))
        self.layout_boxes.append(Box((self.gap_x + self.gap, 0, 0), (self.length, 1, self.width)))
        self.anchor_offset = np.array([float(self.length), 0.0, 0.0])
        self.add_walls()

    def requires_movable_boxes(self):
        return tri(max(0, self.gap - 2))

    def generate_object_positions(self, n: int) -> List[np.ndarray]:
        candidates = [
            (x, z) for x in range(self.length) for z in range(1, self.width - 1)
            if not (self.gap_x <= x < self.gap_x + self.gap)
        ]
        out = []
        for _ in range(n):
            x, z = candidates[self.rr(0, len(candidates))]
            self.occupancy[(x, z)] = self.occupancy.get((x, z), 0) + 1
            out.append(np.array([x, self.occupancy[(x, z)], z], np.int64))
        return self.adjust(out)


class StartPlatform(EmptyPlatform):
    def __init__(self, rng, params, width: int = -1):
        super().__init__(rng, WALLS_SOUTH | WALLS_EAST | WALLS_WEST, params, width)


class ExitPlatform(EmptyPlatform):
    def __init__(self, rng, params, width: int = -1):
        super().__init__(rng, WALLS_NORTH | WALLS_EAST | WALLS_WEST, params, width)

    def generate(self):
        EmptyPlatform.generate(self)
        self.terrain_boxes.setdefault(C.TERRAIN_EXIT, []).append(
            Box((self.length - 3, 1, 1), (self.length - 1, 3, self.width - 1)))


class TransitionPlatform(EmptyPlatform):
    def __init__(self, rng, walls, params, length: int, width: int):
        super().__init__(rng, walls, params, width)
        self.length = length
        self.width = width

    def init(self):
        self.height = 5


def make_platform(platform_type: str, rng, walls, params, width: int) -> Platform:
    cls = {
        "STEP": StepPlatform,
        "GAP": GapPlatform,
        "LAVA": LavaPlatform,
        "WALL": WallPlatform,
        "EMPTY": EmptyPlatform,
    }[platform_type]
    return cls(rng, walls, params, width)
