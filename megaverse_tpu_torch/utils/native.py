"""ctypes binding for the native host-generation library.

Loads native/libmegaverse_native.so (building it with native/build.sh on
first use if the toolchain is available); every entry point has a pure
numpy fallback, so the package works without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libmegaverse_native.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("MEGAVERSE_NO_NATIVE"):
        return None
    if not _LIB_PATH.exists():
        build = _NATIVE_DIR / "build.sh"
        if build.exists():
            try:
                subprocess.run(["sh", str(build)], check=True,
                               capture_output=True, timeout=120)
            except Exception:
                return None
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.mvn_greedy_merge.restype = ctypes.c_int
    lib.mvn_greedy_merge.argtypes = [
        u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, i32p, u8p, ctypes.c_int,
    ]
    lib.mvn_perlin_octave_0_1.restype = None
    lib.mvn_perlin_octave_0_1.argtypes = [
        i64p, f64p, f64p, ctypes.c_int, ctypes.c_int, f64p,
    ]
    lib.mvn_voxelize_segments.restype = None
    lib.mvn_voxelize_segments.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f64p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int,
    ]
    if hasattr(lib, "mvn_hex_pvs"):
        lib.mvn_hex_pvs.restype = ctypes.c_int
        lib.mvn_hex_pvs.argtypes = [
            ctypes.c_int, i32p, u8p, f64p, ctypes.c_longlong, u8p,
        ]
    _lib = lib
    return _lib


def have_native() -> bool:
    return _load() is not None


def greedy_merge(vtype: np.ndarray, vcolor: np.ndarray, max_boxes: int = 4096):
    """Returns (lo [n,3] i32 inclusive, hi [n,3] i32 exclusive, color [n] u8)
    in voxel index space, or None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    nx, ny, nz = vtype.shape
    vt = np.ascontiguousarray(vtype, np.uint8)
    vc = np.ascontiguousarray(vcolor, np.uint8)
    lo = np.empty((max_boxes, 3), np.int32)
    hi = np.empty((max_boxes, 3), np.int32)
    col = np.empty((max_boxes,), np.uint8)
    n = lib.mvn_greedy_merge(vt, vc, nx, ny, nz, lo, hi, col, max_boxes)
    if n < 0:
        raise ValueError(f"greedy_merge overflow (> {max_boxes} boxes)")
    return lo[:n], hi[:n], col[:n]


def perlin_octave_0_1(perm512: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                      octaves: int):
    lib = _load()
    if lib is None:
        return None
    xs = np.ascontiguousarray(xs, np.float64).ravel()
    ys = np.ascontiguousarray(ys, np.float64).ravel()
    out = np.empty_like(xs)
    lib.mvn_perlin_octave_0_1(
        np.ascontiguousarray(perm512, np.int64), xs, ys, xs.size, octaves, out)
    return out


def hex_pvs(neigh: np.ndarray, open_: np.ndarray, edge_pts: np.ndarray,
            budget: int = 200_000):
    """Cell-to-cell visibility over honeycomb cells (see mvn_hex_pvs).

    neigh [C, 6] i32 (-1: outside), open_ [C, 6] u8 (portal?), edge_pts
    [C, 6, 4] f64 portal endpoints. Returns (vis [C, C] u8, completed int)
    or None if the native lib is unavailable. Rows >= completed are
    all-visible (node budget exhausted — conservative)."""
    lib = _load()
    if lib is None or not hasattr(lib, "mvn_hex_pvs"):
        return None
    c = neigh.shape[0]
    vis = np.empty((c, c), np.uint8)
    done = lib.mvn_hex_pvs(
        c, np.ascontiguousarray(neigh, np.int32),
        np.ascontiguousarray(open_, np.uint8),
        np.ascontiguousarray(edge_pts, np.float64).reshape(-1),
        budget, vis)
    return vis, done


def voxelize_segments(vtype: np.ndarray, segs: np.ndarray, origin_x: float,
                      origin_z: float, voxel: float, y0: int, rows: int) -> bool:
    lib = _load()
    if lib is None:
        return False
    nx, ny, nz = vtype.shape
    assert vtype.flags["C_CONTIGUOUS"] and vtype.dtype == np.uint8
    lib.mvn_voxelize_segments(
        vtype, nx, ny, nz, np.ascontiguousarray(segs, np.float64),
        len(segs), origin_x, origin_z, voxel, y0, rows)
    return True
