#!/usr/bin/env python
"""Standalone maze-generation CLI of the port (counterpart of
scripts/mazegen.py and src/apps/mazegen.cpp), through
megaverse_tpu_torch/utils/mazelib.py. Host-side numpy only: it runs no
tensor code, so it takes no --device.

  python scripts/mazegen_torch.py --shape honeycomb --size 6 --algorithm kruskal \\
      --svg maze.svg
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from megaverse_tpu_torch.utils.mazelib import (  # noqa: E402
    circular_hexagon_maze,
    circular_maze,
    hexagonal_maze,
    honeycomb_maze,
    rectangular_maze,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--shape", default="honeycomb",
                   choices=["honeycomb", "rectangular", "circular",
                            "hexagonal", "circularhexagon"])
    p.add_argument("--size", type=int, default=6)
    p.add_argument("--width", type=int, default=10)
    p.add_argument("--height", type=int, default=8)
    p.add_argument("--algorithm", default="kruskal",
                   choices=["kruskal", "dfs", "bfs", "prim", "lerw"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--svg", default=os.path.join(tempfile.gettempdir(), "maze.svg"))
    p.add_argument("--gnuplot", default=None,
                   help="also write a gnuplot script here")
    args = p.parse_args(argv)

    if args.shape == "honeycomb":
        maze = honeycomb_maze(args.size)
    elif args.shape == "circular":
        maze = circular_maze(args.size)
    elif args.shape == "hexagonal":
        maze = hexagonal_maze(args.size)
    elif args.shape == "circularhexagon":
        maze = circular_hexagon_maze(args.size)
    else:
        maze = rectangular_maze(args.width, args.height)

    rng = np.random.default_rng(args.seed)
    maze.generate(rng, args.algorithm)
    maze.to_svg(args.svg)
    if args.gnuplot:
        maze.to_gnuplot(args.gnuplot)
    print(f"{args.shape} maze ({len(maze.centers)} cells, {args.algorithm}) -> {args.svg}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
