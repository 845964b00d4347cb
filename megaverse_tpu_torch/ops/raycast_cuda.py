"""CUDA kernel wrapper for the analytic raycasting renderer.

Counterpart of megaverse_tpu/ops/raycast_pallas.py. The Pallas program
`_render_kernel` (launched from that module's `render_packed`) becomes the
hand-written CUDA C++ kernel template of csrc/render.cu, in all six forms of
the reference:
  B1  unculled, rows in table order;
  B2  bit-walk (the traversal the product path uses by default);
  B3  clustered, in table order (slab tests of 32 clusters per block vote);
  B4  B3 through sorted lists: per agent with or without distance bounds
      (sort_clusters), or per tile (frustum_cull);
  B5  two-level: per-tile lists over superclusters;
  B6  any of the above launched frame by frame: resident thread blocks take
      (env, agent) frames from a work queue and stage what a frame shares
      once.
What bounds them on an H100 is f32 arithmetic per visited table row, not
memory traffic (a frame reads a few KB of tables per env and writes 4 bytes
per pixel); the design keeps each pixel's ray and closest-hit carry in
registers and relies on the cull tables built here to visit few rows. B1-B3
give each thread two pixels and stage the rows they visit in shared memory
with asynchronous bulk copies (see csrc/render.cu).

The tables the kernel consumes are plain PyTorch, batched over envs:
  1. build_prim_table: unified primitive rows [B, M, 12] (layout below);
  2. build_clusters / build_superclusters / pad_prims_to_clusters: rows grouped
     into 8-row clusters and 4-cluster superclusters with conservative AABBs
     and a homogeneity tag;
  3. cull_bits: per (env, agent, 8x128 pixel tile) a front-to-back list of
     surviving superclusters, member bitmasks, and eye-distance lower bounds
     (B2); sort_clusters: per-agent front-to-back cluster order (B4);
     frustum_cull: per-tile front-to-back lists of clusters (B4) or of
     superclusters (B5).

Unified primitive row (12 f32):
  [0]     type: 0=aabb, 1=ellipsoid, 2=cylinder-y, 3=cone-y, 4=cone-y flipped,
          5=yaw/pitch-rotated eye box, 6=y-rotated box, 7=fused wall+edging,
          <0 = unused slot
  [1:4]   a: box lo / center / camera pos
  [4:7]   b: box hi / radii / (rx, rz, half_h) / (yaw, pitch, -) /
          (yaw, cos yaw, sin yaw) for rotated boxes
  [7]     rgb albedo packed as float((r8<<16)|(g8<<8)|b8)
  [8:11]  c: rotated-box half extents (types 6, 7)
  [11]    edging packed colour (type 7)
Camera row (8 f32): eye xyz, yaw, pitch, time_fraction, lastReward, pad.
Output: packed RGB int32 [B, A, H, W].

`render_packed` launches the kernel for CUDA tensors and raises on any build
or launch failure; it takes the plain PyTorch version (`render_packed_plain`,
ops/raycast.py) only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from megaverse_tpu_torch import constants as C
from megaverse_tpu_torch.ops import raycast as R
from megaverse_tpu_torch.types import (AgentState, EnvConfig, PropState, PROP_FLAG_VISIBLE,
                                       device_const)

INF = 1e30
TILE_H = R.TILE_H
TILE_W = R.TILE_W
CLUSTER_K = 8   # rows per cluster
SUPER_K = 4     # clusters per supercluster
# Conservative bound radius of the eye box: |offset| + |half extents|
# (0.19 + 0.342), valid for every yaw/pitch.
_EYE_BOUND = 0.54
ROW_W = 12

PRIM_AABB = R.PRIM_AABB
PRIM_ELLIPSOID = R.PRIM_ELLIPSOID
PRIM_CYLINDER = R.PRIM_CYLINDER
PRIM_CONE = R.PRIM_CONE
PRIM_CONE_FLIPPED = R.PRIM_CONE_FLIPPED
PRIM_EYEBOX = R.PRIM_EYEBOX
PRIM_ROTBOX = R.PRIM_ROTBOX
PRIM_ROTBOX_WALL = R.PRIM_ROTBOX_WALL
TAG_CONE_MIXED = 8  # cluster tag: live rows are CONE / CONE_FLIPPED mixed

FAR = float(C.CAMERA_FAR)
# Slack of the kernel's distance and slab bounds (csrc/render.cu SLACK).
SLACK = 0.01
# Clusters per B3 vote (and list entries per B4 and B5 batch), clusters B6
# over B2 stages per frame, and the 32-pixel segments (one warp's columns) of
# a pixel row that `visits` sums over (csrc/render.cu B3_BATCH, FRAME_K,
# VISIT_SEGMENTS).
B3_BATCH = 32
FRAME_K = 64
VISIT_SEGMENTS = TILE_W // 32

# Launch counts of the port's hand-written kernels, one per render form, one
# for the masked copy (ops/masked_copy.py), one for the character controller
# (ops/kcc.py) and one for object stacking (ops/stacking.py): each wrapper
# adds one where it launches its kernel, nowhere else. A merged launch counts
# as B6 whatever it traverses.
FORMS = ("render_b1", "render_b2", "render_b3", "render_b4", "render_b5", "render_b6")
LAUNCHES = {name: 0 for name in FORMS + ("masked_copy", "kcc", "stacking")}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Build + bind (nvcc -> shared library with a plain C interface -> ctypes).
# ---------------------------------------------------------------------------

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # every form == B1 bit for bit needs identical rounding in every row body:
    # no FMA contraction, no fast-math (see csrc/render.cu).
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_lib = None
_lib_lock = threading.Lock()
# the nvcc used, and per source stem the seconds and output of its build
# (left out when an earlier build of the same source was found)
BUILD_INFO = {"nvcc": None}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the render kernels are built from "
                       "megaverse_tpu_torch/csrc at first use and need the CUDA toolkit")


def build_library(source: Path = CSRC_DIR / "render.cu") -> Path:
    """Compile one .cu into build/lib<stem>_<hash>.so (skipped if that exact
    source + flags was built before). Raises with the compiler's output on
    failure. Builds of different sources may run at once (threads)."""
    nvcc = find_nvcc()
    text = source.read_bytes()
    tag = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    BUILD_INFO["nvcc"] = nvcc
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    log = (proc.stdout + proc.stderr).strip()
    BUILD_INFO[source.stem] = {"seconds": time.perf_counter() - t0, "log": log}
    (BUILD_DIR / f"{source.stem}.nvcc.log").write_text(log + "\n")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(tmp, out)
    return out


def load_library():
    """Build (first use) and bind csrc/render.cu. Raises on any failure."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mv_render.restype = i
        lib.mv_render.argtypes = [i, i] + [p] * 14 + [i] * 10 + [p]
        lib.mv_render_const_count.restype = i
        lib.mv_render_const_count.argtypes = []
        if lib.mv_render_const_count() != R.K_COUNT:
            raise RuntimeError("render.cu and ops/raycast.py disagree on the "
                               "constant table layout")
        _lib = lib
        return _lib


# The device-tensor caches below are unbounded, like `types.device_const`: a
# captured tick graph (capture.py) keeps reading a cached tensor's address
# while no Python call touches its entry, so an evicted entry would hand its
# memory back to the allocator under a live graph. The tensors are tiny.
@functools.lru_cache(maxsize=None)
def _device_constants(height: int, width: int, device_str: str) -> torch.Tensor:
    return torch.from_numpy(R.render_constants(height, width)).to(device_str)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def select_form(clusters=None, order=None, dist=None, sclusters=None,
                sclist=None, merge_tiles: bool = False):
    """(form 1..5, launch-counter name) that `render_packed` takes for these
    tables: the reference's choice (raycast_pallas.render_packed)."""
    if clusters is None:
        form = 1
    elif sclist is not None:
        form = 2
    elif sclusters is not None:
        form = 5
    elif order is not None:
        form = 4
    else:
        form = 3
    return form, ("render_b6" if merge_tiles else FORMS[form - 1])


def render_packed(cams: torch.Tensor, prims: torch.Tensor, height: int, width: int,
                  clusters: Optional[torch.Tensor] = None,
                  order: Optional[torch.Tensor] = None,
                  dist: Optional[torch.Tensor] = None,
                  ui_indicators: bool = False,
                  sclusters: Optional[torch.Tensor] = None,
                  merge_tiles: bool = False,
                  sclist: Optional[torch.Tensor] = None,
                  clbits: Optional[torch.Tensor] = None,
                  scdist: Optional[torch.Tensor] = None,
                  cdist: Optional[torch.Tensor] = None,
                  visits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cams [B, A, 8] f32, prims [B, M, 12] f32 -> packed RGB int32 [B,A,H,W].

    Every form gives the same image; the tables passed pick the traversal
    (T = H/8, G clusters, S = G/4 superclusters). The culled forms and B6
    take H % 8 == 0 and W == 128; tiled B1 takes any H x W:
      B1  no cull tables: every row, in table order;
      B2  `clusters` [B,G,8] + `sclist` int32 [B,A,T,S], `clbits` int32
          [B,A,T,ceil(G/32)], `scdist` f32 [B,A,T,S], `cdist` f32 [B,A,G]
          (build_clusters, build_superclusters, pad_prims_to_clusters,
          cull_bits; M == 8 G): the bit-walk;
      B3  `clusters` alone (M == 8 G): clusters in table order, rows run only
          where some ray of the block can still find a closer hit;
      B4  + `order` int32 [B,A,G] (any permutation of the clusters; ties
          resolve to the lowest row, so the image does not depend on it), and
          optionally `dist` f32 [B,A,G], ascending lower bounds on the hit
          distance of the listed clusters (sort_clusters): the walk then ends
          at the first entry beyond every ray's closest hit. `order.ndim == 4`
          means per-tile lists [B,A,T,G] with their `dist` (frustum_cull);
      B5  + `sclusters` [B,S,8]: `order`/`dist` [B,A,T,S] list superclusters
          (frustum_cull on the supercluster table); `clusters` is padded to
          4 S, `prims` need not be (8 G' rows for the G' <= G real clusters);
      B6  `merge_tiles`: the same traversal, launched frame by frame
          instead of one thread block per sub-block (an int32 work queue of
          B * A + 1 zeros is allocated per call).

    CUDA tensors launch the kernel (built at first use) or raise; CPU tensors
    take the plain PyTorch version. Measurement only, on CUDA: `visits`, an
    int32 tensor from `new_visits` that receives, per pixel row, the number
    of all-AABB and of other clusters whose rows ran for it (forms B2-B5),
    summed over the row's segments of 32 pixels, VISIT_SEGMENTS per tile
    across (B4 and B5 run a cluster per warp, the other forms per block of
    pixel rows): at width 128, `visits.sum() / VISIT_SEGMENTS` clusters ran
    per pixel row."""
    tables = dict(clusters=clusters, order=order, dist=dist, sclusters=sclusters,
                  merge_tiles=merge_tiles, sclist=sclist, clbits=clbits,
                  scdist=scdist, cdist=cdist)
    if cams.device.type != "cuda":
        return render_packed_plain(cams, prims, height, width,
                                   ui_indicators=ui_indicators, **tables)
    form, counter = select_form(clusters, order, dist, sclusters, sclist, merge_tiles)
    if height < 1 or width < 1 or (
            (form != 1 or merge_tiles) and (height % TILE_H != 0 or width != TILE_W)):
        raise ValueError(f"render_packed needs H % {TILE_H} == 0 and W == {TILE_W} "
                         f"(any H x W for the tiled unculled form), got {(height, width)}")
    dev = cams.device
    bsz, num_agents = cams.shape[0], cams.shape[1]
    num_prims = prims.shape[1]
    t = height // TILE_H
    f32, i32 = torch.float32, torch.int32
    _check("cams", cams, f32, (bsz, num_agents, 8), dev)
    _check("prims", prims, f32, (bsz, num_prims, ROW_W), dev)
    g = words = list_len = per_tile = 0
    if form >= 2:
        g = clusters.shape[1]
        _check("clusters", clusters, f32, (bsz, g, 8), dev)
        if num_prims % CLUSTER_K != 0 or num_prims > g * CLUSTER_K:
            raise ValueError(f"clustered forms need M % {CLUSTER_K} == 0 and "
                             f"M <= {CLUSTER_K}*G, got M={num_prims}, G={g}")
    if form == 2:
        if any(x is None for x in (clbits, scdist, cdist)) or order is not None \
                or sclusters is not None:
            raise ValueError("bit-walk form needs sclist, clbits, scdist and cdist "
                             "and takes no order or sclusters")
        if num_prims != g * CLUSTER_K or g % SUPER_K != 0:
            raise ValueError(f"bit-walk form needs M == {CLUSTER_K}*G and "
                             f"G % {SUPER_K} == 0, got M={num_prims}, G={g}")
        s = g // SUPER_K
        words = -(-g // 32)
        _check("sclist", sclist, i32, (bsz, num_agents, t, s), dev)
        _check("clbits", clbits, i32, (bsz, num_agents, t, words), dev)
        _check("scdist", scdist, f32, (bsz, num_agents, t, s), dev)
        _check("cdist", cdist, f32, (bsz, num_agents, g), dev)
    elif form in (4, 5):
        if form == 5:
            s = sclusters.shape[1]
            if g != s * SUPER_K or order is None or dist is None or order.dim() != 4:
                raise ValueError("supercluster form needs G == 4*S and per-tile "
                                 "order and dist over the superclusters")
            _check("sclusters", sclusters, f32, (bsz, s, 8), dev)
            list_len = s
        else:
            if num_prims != g * CLUSTER_K:
                raise ValueError(f"sorted form needs M == {CLUSTER_K}*G, got "
                                 f"M={num_prims}, G={g}")
            list_len = g
        per_tile = 1 if order.dim() == 4 else 0
        if per_tile and dist is None:
            raise ValueError("per-tile lists need their dist")
        shape = (bsz, num_agents, t, list_len) if per_tile else (bsz, num_agents, list_len)
        _check("order", order, i32, shape, dev)
        if dist is not None:
            _check("dist", dist, f32, shape, dev)
    elif form == 3 and num_prims != g * CLUSTER_K:
        raise ValueError(f"clustered form needs M == {CLUSTER_K}*G, got "
                         f"M={num_prims}, G={g}")
    if visits is not None:
        _check("visits", visits, i32, (bsz, num_agents, height, 2), dev)
    # the kernel reads rows and boxes as 16-byte vectors and bulk-copies them
    for name, x in (("prims", prims), ("clusters", clusters), ("sclusters", sclusters)):
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{name}: data must start at a multiple of 16 bytes")
    lib = load_library()
    kc = _device_constants(height, width, str(dev))
    out = torch.empty((bsz, num_agents, height, width), dtype=i32, device=dev)
    # the merged launch's work queue: next frame, then each frame's next sub-block
    work = torch.zeros(bsz * num_agents + 1, dtype=i32, device=dev) if merge_tiles else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        LAUNCHES[counter] += 1
        err = lib.mv_render(
            form, 1 if merge_tiles else 0, ptr(cams), ptr(prims), ptr(clusters),
            ptr(sclusters), ptr(order), ptr(dist), ptr(sclist), ptr(clbits),
            ptr(scdist), ptr(cdist), ptr(kc), ptr(out), ptr(visits), ptr(work), bsz,
            num_agents, height, width, num_prims, g, words, list_len, per_tile,
            1 if ui_indicators else 0, stream)
    if err != 0:
        raise RuntimeError(f"render kernel launch failed: CUDA error {err}")
    return out


def new_visits(cams: torch.Tensor, height: int) -> torch.Tensor:
    """Zeroed int32 [B, A, H, 2] buffer for render_packed(visits=...)."""
    return torch.zeros(cams.shape[:2] + (height, 2), dtype=torch.int32, device=cams.device)


def box_reachable_plain(rays: R.Rays, lo, hi, bt: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's cluster vote predicate (csrc/render.cu
    box_reachable): can a ray of `rays` still find a hit closer than its depth
    `bt` inside the box (lo, hi: 3-sequences broadcastable to the rays)? The
    slab interval of ops/raycast.py with no near-plane term, SLACK on the
    depth."""
    tmin, tmax = R.slab_interval(lo, hi, rays.oxix, rays.oyiy, rays.oziz,
                                 rays.ix, rays.iy, rays.iz)[:2]
    return (tmax >= tmin) & (tmax > 0) & (tmin < bt + SLACK)


def live_clusters(clusters: torch.Tensor) -> torch.Tensor:
    """bool [..., G] of cluster tables [..., G, 8]: the clusters that hold a
    live row. A dead one is a point box at +INF (build_clusters,
    build_superclusters); the kernel's form B3 never votes on it."""
    return clusters[..., 0] < 1e29


def frame_clusters_plain(clbits: torch.Tensor, cdist: torch.Tensor,
                         num_clusters: int) -> torch.Tensor:
    """Plain version of the clusters B6 over B2 stages once per frame
    (csrc/render.cu stage_frame_b2, before it keeps the first FRAME_K): bool
    [B, A, G] from cull_bits' clbits [B, A, T, W] and cdist [B, A, G]. A
    cluster is in it when any tile of the frame has its bit and its eye
    distance is within the far plane: no walk visits any other."""
    return cluster_bits(clbits, num_clusters).any(dim=2) & (cdist <= FAR + SLACK)


def cluster_bits(clbits: torch.Tensor, num_clusters: int) -> torch.Tensor:
    """Per-tile cluster bits int32 [..., W] -> bool [..., G]."""
    gi = torch.arange(num_clusters, device=clbits.device)
    return ((clbits[..., gi >> 5] >> (gi & 31).to(torch.int32)) & 1) != 0


def cluster_row_mask(clbits: torch.Tensor, num_prims: int) -> torch.Tensor:
    """Per-tile cluster bits int32 [B,A,T,Wc] -> per-tile row mask bool
    [B,A,T,M] (row i is testable iff its cluster's bit is set)."""
    return cluster_bits(clbits, num_prims // CLUSTER_K).repeat_interleave(CLUSTER_K, dim=-1)


def _listed(order: torch.Tensor, keep: torch.Tensor, n: int) -> torch.Tensor:
    """Lists `order` int [..., L] with a bool `keep` per entry -> bool [..., n]:
    which of the n items each list keeps."""
    mark = torch.zeros(order.shape[:-1] + (n + 1,), dtype=torch.bool, device=order.device)
    idx = order.long()
    ok = keep & (idx >= 0) & (idx < n)
    mark.scatter_(-1, torch.where(ok, idx, torch.full_like(idx, n)), ok)
    return mark[..., :n]


def _global_order(order: torch.Tensor, key: torch.Tensor, n: int) -> list:
    """One visiting order of n items for the whole batch: by the smallest
    `key` any list gives them."""
    best = torch.full((n + 1,), INF, dtype=torch.float32, device=order.device)
    idx = order.long().clamp(0, n).reshape(-1)
    best = best.scatter_reduce(0, idx, key.expand(order.shape).reshape(-1).to(torch.float32),
                               reduce="amin")
    return torch.argsort(best[:n], stable=True).tolist()


def render_packed_plain(cams, prims, height, width, clusters=None, order=None,
                        dist=None, ui_indicators=False, sclusters=None,
                        merge_tiles=False, sclist=None, clbits=None, scdist=None,
                        cdist=None) -> torch.Tensor:
    """Plain PyTorch version of `render_packed` (same signature, any device).

    Each form honours what its tables decide without a depth test, through
    the table renderer of ops/raycast.py (one row at a time over the whole
    batch, so one visiting order serves every env, agent and tile):
      B1  in table order;
      B2  each tile's surviving clusters, superclusters ordered by their
          nearest bound over all tiles, far-plane start, row-index tie-break;
      B3  in table order with the strict carry from +INF, dead clusters
          (point box at +INF) skipped;
      B4  the clusters each list names, ordered by their earliest place in
          any list, row-index tie-break; without `dist` from +INF, with `dist`
          from the far plane and only entries with dist <= far (the walk can
          never reach the others);
      B5  the same over superclusters, each expanding to its 32 rows;
      B6  (`merge_tiles`) is a launch shape: the image of the form it wraps.
    The depth-dependent skips of the kernel (which only ever drop rows that
    cannot win) are not emulated."""
    form, _ = select_form(clusters, order, dist, sclusters, sclist)
    if form == 1:
        return R.render_table_packed(cams, prims, height, width, ui_indicators)
    num_prims = prims.shape[1]
    g = clusters.shape[1]
    live = live_clusters(clusters)[:, None, None, :]          # [B,1,1,G]
    rows_of = lambda mask: mask.repeat_interleave(CLUSTER_K, dim=-1)[..., :num_prims]
    if form == 2:
        assert num_prims == g * CLUSTER_K and g % SUPER_K == 0, (num_prims, g)
        s = g // SUPER_K
        row_mask = cluster_row_mask(clbits, num_prims)
        key = torch.where(sclist < s, scdist, torch.full_like(scdist, INF))
        sc_order = _global_order(sclist, key, s)
        rows = [sc * SUPER_K * CLUSTER_K + j for sc in sc_order
                for j in range(SUPER_K * CLUSTER_K)]
        return R.render_table_packed(cams, prims, height, width, ui_indicators,
                                     row_order=rows, row_mask=row_mask)
    if form == 3:
        assert num_prims == g * CLUSTER_K, (num_prims, g)
        return R.render_table_packed(cams, prims, height, width, ui_indicators,
                                     row_mask=rows_of(live), tiebreak=False,
                                     far_start=False)
    # B4 / B5: lists of clusters or of superclusters
    per_item = CLUSTER_K if form == 4 else SUPER_K * CLUSTER_K
    n = g if form == 4 else sclusters.shape[1]
    assert order.shape[-1] == n, (order.shape, n)
    if order.dim() == 3:
        order = order[:, :, None, :]                           # [B,A,1,L]
        dist = None if dist is None else dist[:, :, None, :]
    keep = torch.ones_like(order, dtype=torch.bool) if dist is None else dist <= FAR
    pos = torch.arange(order.shape[-1], dtype=torch.float32, device=order.device)
    items = _global_order(order, torch.where(keep, pos, torch.full_like(pos, INF)), n)
    listed = _listed(order, keep, n)                           # [B,A,T|1,n]
    if form == 5:
        listed = listed.repeat_interleave(SUPER_K, dim=-1)     # per cluster
    row_mask = rows_of(listed & live)
    rows = [it * per_item + j for it in items for j in range(per_item)
            if it * per_item + j < num_prims]
    return R.render_table_packed(cams, prims, height, width, ui_indicators,
                                 row_order=rows, row_mask=row_mask, tiebreak=True,
                                 far_start=dist is not None)


# ---------------------------------------------------------------------------
# Cluster tables.
# ---------------------------------------------------------------------------

def _dead_rows(prims: torch.Tensor, n: int) -> torch.Tensor:
    dead = torch.zeros((prims.shape[0], n, prims.shape[2]), dtype=prims.dtype,
                       device=prims.device)
    dead[:, :, 0].fill_(-1.0)
    return dead


def build_clusters(prims: torch.Tensor, k: int = CLUSTER_K):
    """Pad prim tables [B, M, 12] to a multiple of k rows and build the cluster
    AABB tables [B, M'/k, 8] (lo xyz, hi xyz, tag, pad). Per-row bounds are
    conservative per type; dead rows (type < 0) take an inverted AABB so they
    never inflate a live cluster, and all-dead clusters collapse to a far
    point box. Returns (prims_padded, clusters)."""
    bsz, m, _ = prims.shape
    pad = (-m) % k
    if pad:
        prims = torch.cat([prims, _dead_rows(prims, pad)], dim=1)
    ptype = prims[:, :, 0].to(torch.int32)
    a = prims[:, :, 1:4]
    b = prims[:, :, 4:7]
    c = prims[:, :, 8:11]

    # Conservative half extents about center `a` for non-box rows.
    quad_he = torch.stack([b[..., 0], b[..., 2], b[..., 1]], dim=-1)  # cyl/cone
    # y-rotated box: exact world AABB of the rotated extents (b carries
    # (yaw, cos yaw, sin yaw) for rotbox rows)
    cy, sy = b[..., 1].abs(), b[..., 2].abs()
    rot_he = torch.stack(
        [c[..., 0] * cy + c[..., 2] * sy, c[..., 1], c[..., 0] * sy + c[..., 2] * cy],
        dim=-1)
    is_t = lambda t: (ptype == t)[..., None]
    he = torch.where(is_t(PRIM_ELLIPSOID), b, quad_he)
    he = torch.where(is_t(PRIM_EYEBOX), torch.full_like(he, _EYE_BOUND), he)
    he = torch.where(is_t(PRIM_ROTBOX), rot_he, he)
    # fused wall rows: the AABB must also cover the derived edging box
    whx = c[..., 0] * float(np.float32(C.WALL_EDGE_LEN_SCALE))
    whz = torch.clamp(c[..., 2], min=float(np.float32(C.WALL_EDGE_HZ)))
    wall_he = torch.stack(
        [whx * cy + whz * sy, c[..., 1], whx * sy + whz * cy], dim=-1)
    he = torch.where(is_t(PRIM_ROTBOX_WALL), wall_he, he)

    is_box = is_t(PRIM_AABB)
    lo = torch.where(is_box, a, a - he)
    hi = torch.where(is_box, b, a + he)
    dead = (ptype < 0)[..., None]
    lo = torch.where(dead, torch.full_like(lo, INF), lo)
    hi = torch.where(dead, torch.full_like(hi, -INF), hi)

    g = prims.shape[1] // k
    clo = lo.reshape(bsz, g, k, 3).amin(dim=2)
    chi = hi.reshape(bsz, g, k, 3).amax(dim=2)
    empty = chi[..., :1] < clo[..., :1]
    clo = torch.where(empty, torch.full_like(clo, INF), clo)
    chi = torch.where(empty, torch.full_like(chi, INF), chi)
    # Homogeneity tag (column 6): the shared row type if every LIVE row in the
    # cluster has it; TAG_CONE_MIXED when live rows are CONE/CONE_FLIPPED
    # mixed; else -1 (generic path). Dead rows are wildcards; all-dead -> -1.
    grp = ptype.reshape(bsz, g, k)
    live = grp >= 0
    ref_t = grp.amax(dim=2)
    any_live = live.any(dim=2)
    same = ((grp == ref_t[..., None]) | ~live).all(dim=2) & any_live
    coney = ((grp == PRIM_CONE) | (grp == PRIM_CONE_FLIPPED) | ~live).all(dim=2) & any_live
    tag = torch.where(same, ref_t,
                      torch.where(coney, torch.full_like(ref_t, TAG_CONE_MIXED),
                                  torch.full_like(ref_t, -1))).to(torch.float32)
    clusters = torch.cat(
        [clo, chi, tag[..., None], torch.zeros_like(tag)[..., None]], dim=-1)
    return prims, clusters


def pad_prims_to_clusters(prims: torch.Tensor, clusters: torch.Tensor,
                          k: int = CLUSTER_K) -> torch.Tensor:
    """Pad prim tables with dead rows so num_prims == num_clusters * k (after
    build_superclusters padded the cluster table to a multiple of SUPER_K)."""
    want = clusters.shape[1] * k
    m = prims.shape[1]
    assert want >= m, (want, m)
    if want == m:
        return prims
    return torch.cat([prims, _dead_rows(prims, want - m)], dim=1)


def build_superclusters(clusters: torch.Tensor, k: int = SUPER_K):
    """Pad cluster tables [B, G, 8] to a multiple of k and build the
    supercluster AABB tables [B, G'/k, 8]. Dead clusters (point box at +INF)
    do not inflate a live supercluster; all-dead superclusters collapse to the
    same +INF point box. Returns (clusters_padded, sclusters)."""
    bsz, g, w = clusters.shape
    pad = (-g) % k
    if pad:
        dead = torch.full((bsz, pad, w), INF, dtype=clusters.dtype, device=clusters.device)
        dead[:, :, 6:].fill_(0.0)
        clusters = torch.cat([clusters, dead], dim=1)
    lo = clusters[..., 0:3]
    hi = clusters[..., 3:6]
    dead = lo[..., :1] > 1e29
    lo = torch.where(dead, torch.full_like(lo, INF), lo)
    hi = torch.where(dead, torch.full_like(hi, -INF), hi)
    n = clusters.shape[1] // k
    slo = lo.reshape(bsz, n, k, 3).amin(dim=2)
    shi = hi.reshape(bsz, n, k, 3).amax(dim=2)
    empty = shi[..., :1] < slo[..., :1]
    slo = torch.where(empty, torch.full_like(slo, INF), slo)
    shi = torch.where(empty, torch.full_like(shi, INF), shi)
    sclusters = torch.cat(
        [slo, shi, torch.zeros((bsz, n, 2), dtype=torch.float32, device=clusters.device)],
        dim=-1)
    return clusters, sclusters


@functools.lru_cache(maxsize=8)
def _tile_dir_bounds(height: int, width: int, tile_h: int = TILE_H,
                     tile_w: int = TILE_W):
    """Static camera-space ray-direction bounds per pixel tile: f32 numpy
    [T, 3] lo and hi, widened by a safety margin so they bound the kernel's
    f32/rsqrt directions for every pixel of the tile."""
    rows = np.arange(height, dtype=np.float64)[:, None]
    cols = np.arange(width, dtype=np.float64)[None, :]
    tan_h = np.tan(np.deg2rad(C.CAMERA_FOV_DEG / 2))
    tan_v = tan_h * height / width
    u = ((cols + 0.5) / width * 2.0 - 1.0) * tan_h
    v = (1.0 - (rows + 0.5) / height * 2.0) * tan_v
    inv_len = 1.0 / np.sqrt(u * u + v * v + 1.0)
    d0 = np.stack(np.broadcast_arrays(u * inv_len, v * inv_len,
                                      -inv_len + 0 * u), axis=-1)
    ty = -(-height // tile_h)
    tx = width // tile_w
    margin = 2e-3  # covers rsqrt/trig approximation vs numpy exact
    lo = np.empty((ty * tx, 3), np.float32)
    hi = np.empty((ty * tx, 3), np.float32)
    for iy in range(ty):
        for ix in range(tx):
            blk = d0[iy * tile_h:(iy + 1) * tile_h,
                     ix * tile_w:(ix + 1) * tile_w]
            lo[iy * tx + ix] = blk.min(axis=(0, 1)) - margin
            hi[iy * tx + ix] = blk.max(axis=(0, 1)) + margin
    return lo, hi


@functools.lru_cache(maxsize=None)
def _tile_dir_bounds_on(height: int, width: int, tile_h: int, tile_w: int, device: str):
    """`_tile_dir_bounds` as f32 tensors on `device`, made once."""
    return tuple(torch.from_numpy(x).to(device)
                 for x in _tile_dir_bounds(height, width, tile_h, tile_w))


def _tile_survive(cams: torch.Tensor, clusters: torch.Tensor,
                  height: int, width: int,
                  tile_h: int = TILE_H, tile_w: int = TILE_W) -> torch.Tensor:
    """Conservative per-tile frustum survival mask [B, A, T, G].

    For each (env, agent, 8-row pixel tile) the cluster AABB is slab-tested
    against INTERVAL ray directions (exact camera-space per-tile bounds
    rotated by the agent's yaw/pitch with interval arithmetic, widened by a
    float-safety margin), so any cluster that any ray of the tile could enter
    in front of the camera and inside the far plane SURVIVES."""
    d0lo, d0hi = _tile_dir_bounds_on(height, width, tile_h, tile_w, str(cams.device))
    d0lo, d0hi = d0lo[None, None], d0hi[None, None]                    # [1,1,T,3]

    yaw = cams[:, :, 3:4]                              # [B, A, 1]
    pitch = cams[:, :, 4:5]
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)

    def mul(c, lo, hi):
        a, b = c * lo, c * hi
        return torch.minimum(a, b), torch.maximum(a, b)

    def add(i1, i2):
        return i1[0] + i2[0], i1[1] + i2[1]

    ax = lambda i: (d0lo[..., i], d0hi[..., i])
    # Same rotation as the kernel: y1 = cp*dy0 - sp*dz0; z1 = sp*dy0 + cp*dz0;
    # dx = cy*dx0 + sy*z1; dy = y1; dz = -sy*dx0 + cy*z1.
    y1 = add(mul(cp, *ax(1)), mul(-sp, *ax(2)))
    z1 = add(mul(sp, *ax(1)), mul(cp, *ax(2)))
    dxi = add(mul(cy, *ax(0)), mul(sy, *z1))
    dyi = y1
    dzi = add(mul(-sy, *ax(0)), mul(cy, *z1))

    eye = cams[:, :, None, None, :3]                   # [B, A, 1, 1, 3]
    lo = clusters[:, None, None, :, 0:3]               # [B, 1, 1, G, 3]
    hi = clusters[:, None, None, :, 3:6]

    eps = 1e-9
    shape = (cams.shape[0], cams.shape[1], d0lo.shape[2], clusters.shape[1])
    tmin = torch.full(shape, -INF, dtype=torch.float32, device=cams.device)
    tmax = torch.full(shape, INF, dtype=torch.float32, device=cams.device)
    for a_i, (dl, dh) in enumerate((dxi, dyi, dzi)):
        dl = dl[..., None]                             # [B, A, T, 1]
        dh = dh[..., None]
        # If the tile's direction interval touches zero on this axis, some
        # ray can be arbitrarily close to parallel: the axis constrains
        # nothing (conservative pass).
        definite = (dl > eps) | (dh < -eps)
        il, ih = 1.0 / dh, 1.0 / dl                    # sign-consistent
        p1 = lo[..., a_i] - eye[..., a_i]
        p2 = hi[..., a_i] - eye[..., a_i]
        c1, c2 = p1 * il, p1 * ih
        c3, c4 = p2 * il, p2 * ih
        ax_min = torch.minimum(torch.minimum(c1, c2), torch.minimum(c3, c4))
        ax_max = torch.maximum(torch.maximum(c1, c2), torch.maximum(c3, c4))
        tmin = torch.where(definite, torch.maximum(tmin, ax_min), tmin)
        tmax = torch.where(definite, torch.minimum(tmax, ax_max), tmax)

    slack = 0.02
    return ((tmax >= tmin - slack) & (tmax > -slack)
            & (tmin < C.CAMERA_FAR + slack))           # [B, A, T, G]


def _eye_box_distance_sq(cams: torch.Tensor, clusters: torch.Tensor) -> torch.Tensor:
    """Squared distance from each eye to the closest point of each box
    [B, A, G]."""
    eye = cams[:, :, None, :3]                       # [B, A, 1, 3]
    lo = clusters[:, None, :, 0:3]                   # [B, 1, G, 3]
    hi = clusters[:, None, :, 3:6]
    d = torch.clamp(torch.maximum(lo - eye, eye - hi), min=0.0)
    return (d * d).sum(dim=-1)


def sort_clusters(cams: torch.Tensor, clusters: torch.Tensor):
    """Front-to-back cluster visit order per agent: the clusters sorted by the
    squared distance from the camera eye to the closest point of their AABB.
    cams [B, A, 8], clusters [B, G, 8] -> (order int32 [B, A, G],
    dist f32 [B, A, G]). Dead clusters (point box at +INF) sort last.

    `dist[b, a, g]` is the eye distance to the closest point of cluster
    `order[b, a, g]`'s AABB: a lower bound on any ray-hit parameter t from
    that cluster (ray directions are unit length), ascending in g. It drives
    the kernel's early ray termination: once a block's worst closest hit is
    strictly below dist[g], clusters g.. cannot contribute."""
    key = _eye_box_distance_sq(cams, clusters)
    # stable: equal keys keep ascending cluster index, the (key, idx) order
    skey, order = torch.sort(key, dim=-1, stable=True)
    return order.to(torch.int32).contiguous(), torch.sqrt(skey).contiguous()


def frustum_cull(cams: torch.Tensor, clusters: torch.Tensor, height: int, width: int,
                 tile_h: int = TILE_H, tile_w: int = TILE_W):
    """Per-TILE front-to-back cluster lists with conservative frustum culling.

    cams [B, A, 8], clusters [B, G, 8] ->
        (order int32 [B, A, T, G], dist f32 [B, A, T, G]), T = height/TILE_H.
    `clusters` may equally be a supercluster table.

    Survival is `_tile_survive`'s conservative interval slab test. Culled and
    dead clusters get dist = sqrt(+INF) = 1e15 and sort last: the
    kernel's early-exit condition (the largest depth starts at the far plane)
    therefore never visits them. Survivors keep the eye-distance lower bound
    used for early termination, sorted ascending (front-to-back)."""
    survive = _tile_survive(cams, clusters, height, width, tile_h, tile_w)
    key = _eye_box_distance_sq(cams, clusters)[:, :, None, :].expand(survive.shape)
    key = torch.where(survive, key, torch.full((), INF, dtype=torch.float32,
                                               device=cams.device))
    skey, order = torch.sort(key, dim=-1, stable=True)
    return order.to(torch.int32).contiguous(), torch.sqrt(skey).contiguous()


def pack_bits(sv: torch.Tensor) -> torch.Tensor:
    """bool [..., n] -> int32 [..., ceil(n/32)], bit j of word w = sv[32 w + j].
    Bit 31 lands in the sign bit: the words are summed in int64 and folded
    into int32 two's complement deliberately."""
    n = sv.shape[-1]
    w = -(-n // 32)
    pad = w * 32 - n
    if pad:
        sv = torch.cat([sv, torch.zeros(sv.shape[:-1] + (pad,), dtype=torch.bool,
                                        device=sv.device)], dim=-1)
    sv = sv.reshape(sv.shape[:-1] + (w, 32)).to(torch.int64)
    v = (sv << torch.arange(32, dtype=torch.int64, device=sv.device)).sum(dim=-1)
    v = torch.where(v >= 2 ** 31, v - 2 ** 32, v)
    return v.to(torch.int32)


def cull_bits(cams: torch.Tensor, clusters: torch.Tensor, height: int, width: int,
              super_k: int = SUPER_K, tile_h: int = TILE_H, tile_w: int = TILE_W,
              cluster_mask: Optional[torch.Tensor] = None):
    """Per-tile survivor lists + depth bounds for the bit-walk kernel.

    cams [B, A, 8], clusters [B, G, 8] (G % super_k == 0) ->
        (sclist int32 [B, A, T, S], clbits int32 [B, A, T, Wc],
         scdist f32 [B, A, T, S], cdist f32 [B, A, G])
    with S = G/super_k, Wc = ceil(G/32). Bit g of clbits is `_tile_survive`'s
    conservative frustum test for cluster g. cdist[g] is the eye->cluster-AABB
    Euclidean distance: a true lower bound on the ray parameter of ANY hit
    against the cluster's rows (dirs are unit length). sclist is the tile's
    surviving superclusters sorted FRONT-TO-BACK by their members' min cdist
    (survivors only), sentinel-terminated (sentinel = S); scdist carries the
    matching sorted bounds (+INF past the survivors)."""
    survive = _tile_survive(cams, clusters, height, width, tile_h, tile_w)
    if cluster_mask is not None:
        # conservative per-(env, agent, cluster) visibility bits: a False bit
        # proves no ray can hit the cluster's rows
        survive = survive & cluster_mask[:, :, None, :]
    g = survive.shape[-1]
    assert g % super_k == 0, (g, super_k)

    d = torch.clamp(torch.maximum(clusters[:, None, :, 0:3] - cams[:, :, None, :3],
                                  cams[:, :, None, :3] - clusters[:, None, :, 3:6]),
                    min=0.0)
    cdist = torch.sqrt((d * d).sum(dim=-1))              # [B, A, G]

    ns = g // super_k
    # per-tile member bound: INF for non-surviving members, so a
    # supercluster's key reflects only members the kernel could actually run
    mdist = torch.where(survive, cdist[:, :, None, :].expand(survive.shape),
                        torch.full((), INF, dtype=torch.float32, device=cams.device))
    sc_key = mdist.reshape(mdist.shape[:-1] + (ns, super_k)).amin(dim=-1)
    # stable: equal keys (the +INF tail included) keep ascending index order
    skey, order = torch.sort(sc_key, dim=-1, stable=True)
    sclist = torch.where(skey < INF, order.to(torch.int32),
                         torch.full((), ns, dtype=torch.int32, device=cams.device))
    return sclist.contiguous(), pack_bits(survive), skey.contiguous(), cdist.contiguous()


# ---------------------------------------------------------------------------
# Primitive-table construction (plain PyTorch, batched over envs).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _packed_palette(device_str: str) -> torch.Tensor:
    # packed-int palette (float-exact: values <= 0xFFFFFF < 2^24)
    pal8 = np.round(np.asarray(C.PALETTE) * 255.0).astype(np.int64)
    packed = (pal8[:, 0] << 16) | (pal8[:, 1] << 8) | pal8[:, 2]
    return torch.tensor(packed, dtype=torch.float32, device=device_str)


def build_prim_table(cfg: EnvConfig, box_lo: torch.Tensor, box_hi: torch.Tensor,
                     box_color: torch.Tensor, props: PropState, agents: AgentState,
                     include_agent_rows: bool = True) -> torch.Tensor:
    """Unified primitive tables [B, M_total, 12].

    include_agent_rows=False drops the agent body/eye rows: for first-person
    rendering with a single agent they can never be visible (the camera sits
    inside both and inside hits are culled)."""
    dev = box_lo.device
    f32 = torch.float32
    palette = _packed_palette(str(dev))
    bsz, m = box_color.shape

    # Layout boxes.
    t_box = (box_color > 0).to(f32) - 1.0   # PRIM_AABB (0) for live boxes, -1 dead
    rows_box = torch.cat(
        [t_box[..., None], box_lo, box_hi, palette[box_color.long()][..., None],
         torch.zeros((bsz, m, 4), dtype=f32, device=dev)], dim=-1)

    # Props.
    p = props.type.shape[1]
    pt = props.type.to(torch.int32)
    visible = ((props.flags & PROP_FLAG_VISIBLE) != 0) & (pt != C.PROP_NONE)
    sc = props.scale.abs()
    flipped = props.scale[..., 1] < 0

    ktype = torch.full_like(pt, -1)
    for cond, k in (
            (pt == C.PROP_ROTBOX_WALL, PRIM_ROTBOX_WALL),
            (pt == C.PROP_ROTBOX, PRIM_ROTBOX),
            ((pt == C.PROP_CONE) & flipped, PRIM_CONE_FLIPPED),
            ((pt == C.PROP_CONE) & ~flipped, PRIM_CONE),
            (pt == C.PROP_CYLINDER, PRIM_CYLINDER),
            ((pt == C.PROP_SPHERE) | (pt == C.PROP_CAPSULE), PRIM_ELLIPSOID),
            (pt == C.PROP_BOX, PRIM_AABB)):
        ktype = torch.where(cond, torch.full_like(pt, k), ktype)
    ktype = torch.where(visible, ktype, torch.full_like(pt, -1)).to(f32)

    is_box = (pt == C.PROP_BOX)[..., None]
    is_rot = ((pt == C.PROP_ROTBOX) | (pt == C.PROP_ROTBOX_WALL))[..., None]
    a_vec = torch.where(is_box, props.pos - sc, props.pos)
    ry = torch.where(pt == C.PROP_CAPSULE, 2.0 * sc[..., 1], sc[..., 1])
    radii = torch.stack([sc[..., 0], ry, sc[..., 2]], dim=-1)
    quad_b = torch.stack([sc[..., 0], sc[..., 2], 0.5 * sc[..., 1]], dim=-1)
    # rotbox rows ship (yaw, cos yaw, sin yaw): the kernel reads the
    # precomputed trig instead of evaluating it per row per pixel
    rot_b = torch.stack([props.yaw, torch.cos(props.yaw), torch.sin(props.yaw)], dim=-1)
    is_ell = ((pt == C.PROP_SPHERE) | (pt == C.PROP_CAPSULE))[..., None]
    b_vec = torch.where(is_box, props.pos + sc,
                        torch.where(is_rot, rot_b, torch.where(is_ell, radii, quad_b)))
    c_vec = torch.where(is_rot, sc, torch.zeros_like(sc))
    # col 11: the fused wall row's edging packed colour
    is_wall = pt == C.PROP_ROTBOX_WALL
    col11 = torch.where(is_wall, palette[props.color2.long()],
                        torch.zeros((bsz, p), dtype=f32, device=dev))
    rows_prop = torch.cat(
        [ktype[..., None], a_vec, b_vec, palette[props.color.long()][..., None],
         c_vec, col11[..., None]], dim=-1)

    if not include_agent_rows:
        return torch.cat([rows_box, rows_prop], dim=1).contiguous()

    # Agent bodies + eye boxes.
    num_agents = agents.pos.shape[1]
    body_off = device_const((0.0, C.AGENT_BODY_OFFSET_Y + 0.09, 0.0), f32, dev)
    body_c = agents.pos + body_off
    body_r = device_const((0.35, 0.72, 0.35), f32, dev).expand(bsz, num_agents, 3)
    agent_colors = np.asarray(C.AGENT_COLORS)
    body_idx = device_const(agent_colors[np.arange(num_agents) % len(agent_colors)].tolist(),
                            torch.long, dev)
    body_rgb = palette[body_idx].expand(bsz, num_agents)
    z4 = torch.zeros((bsz, num_agents, 4), dtype=f32, device=dev)
    full = lambda v: torch.full((bsz, num_agents, 1), float(v), dtype=f32, device=dev)
    rows_body = torch.cat(
        [full(PRIM_ELLIPSOID), body_c, body_r, body_rgb[..., None], z4], dim=-1)

    cam_off = device_const(
        (0.0, C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y, 0.0), f32, dev)
    cam_pos = agents.pos + cam_off
    eye_rgb = palette[C.COLOR_IDX["AGENT_EYES"]].expand(bsz, num_agents)
    rows_eyes = torch.cat(
        [full(PRIM_EYEBOX), cam_pos,
         torch.stack([agents.yaw, agents.pitch, torch.zeros_like(agents.yaw)], dim=-1),
         eye_rgb[..., None], z4], dim=-1)

    return torch.cat([rows_box, rows_prop, rows_body, rows_eyes], dim=1).contiguous()


def build_cams(cfg: EnvConfig, agents: AgentState, time_fraction: torch.Tensor,
               last_reward: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Camera tables [B, A, 8]: eye xyz, yaw, pitch, time_fraction [B],
    lastReward (column 6, drives the UI reward indicators), pad."""
    bsz, num_agents = agents.yaw.shape
    dev = agents.pos.device
    eye = agents.pos + device_const(
        (0.0, C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y, 0.0), torch.float32, dev)
    tf = time_fraction.to(torch.float32).reshape(bsz, 1).expand(bsz, num_agents)
    lr = (torch.zeros_like(agents.yaw) if last_reward is None
          else last_reward.to(torch.float32).expand(bsz, num_agents))
    return torch.cat(
        [eye, agents.yaw[..., None], agents.pitch[..., None], tf[..., None],
         lr[..., None], torch.zeros_like(agents.yaw)[..., None]], dim=-1).contiguous()


def unpack_rgb(packed: torch.Tensor) -> torch.Tensor:
    """int32 [..., H, W] packed -> uint8 [..., H, W, 3]."""
    r = (packed >> 16) & 0xFF
    g = (packed >> 8) & 0xFF
    b = packed & 0xFF
    return torch.stack([r, g, b], dim=-1).to(torch.uint8)
