"""Console entry points of the port (pyproject [project.scripts]; counterpart
of megaverse_tpu/cli.py).

The benchmark lives at the repo root as bench_torch.py; installed
environments reach it through this wrapper.
"""

from __future__ import annotations


def bench_main(argv=None) -> int:
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    if not (root / "bench_torch.py").exists():
        sys.exit("bench_torch.py not found (installed from a wheel? run from a "
                 "source checkout: python bench_torch.py)")
    # on sys.path, so that the ranks `--n_devices` spawns import it too
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import bench_torch

    return bench_torch.main(argv)
