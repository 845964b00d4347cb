"""The least time the card could take to render one tick's frames, counted
from the scene as the reference describes it: a yardstick that no change to
the program's traversal, culling or tables can move.

Bytes: the camera table and the scene's live primitive rows read once, the
packed frame written once. Operations: for each pixel a fixed ray set-up,
plus one ray-primitive test for every live primitive whose bounding box its
ray enters before (or at) the nearest hit, or the far plane where nothing is
hit. The per-test and per-pixel operation counts are frozen copies of the
counts the port's check script made from its render kernel.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# f32 operations one pixel spends on one table row (the intersection routine
# and the carry update) and on its ray set-up and epilogue (frozen copies of
# chip_smoke.py's OPS_ROW_AABB, OPS_ROW_OTHER, OPS_PIXEL_FIXED).
OPS_ROW_AABB = 40
OPS_ROW_OTHER = 100
OPS_PIXEL_FIXED = 150

CAM_BYTES = 8 * 4       # one camera row: 8 float32
ROW_BYTES = 12 * 4      # one primitive row: 12 float32
PIXEL_BYTES = 4         # one packed pixel


def row_tests(cams: torch.Tensor, prims: torch.Tensor, height: int, width: int,
              rows_per_pass: int = 64):
    """(tests of box rows, tests of other rows) that the frames of `cams`
    [B, A, 8] over `prims` [B, M, 12] need: per pixel, every live row whose
    bounding box the ray enters at or before its nearest hit (or the far
    plane)."""
    from reference.sim.env import row_bounds
    from reference.sim.ops import raycast as R

    rays, t_hit, *_ = R.trace_table(cams, prims, height, width)
    t_stop = torch.clamp(t_hit, max=R.FAR)                       # [B, A, H, W]
    lo, hi = row_bounds(prims)                                   # [B, M, 3]
    ptype = prims[:, :, 0]
    n_box, n_other = 0, 0
    m = prims.shape[1]
    for s in range(0, m, rows_per_pass):
        sl = slice(s, min(m, s + rows_per_pass))
        # [B, 1, 1, 1, R] against rays [B, A, H, W, 1]
        b = lambda x, k: x[:, sl, k].reshape(x.shape[0], 1, 1, 1, -1)
        r = lambda x: x[..., None]
        tmin, tmax, _, _ = R.slab_interval(
            (b(lo, 0), b(lo, 1), b(lo, 2)), (b(hi, 0), b(hi, 1), b(hi, 2)),
            r(rays.oxix), r(rays.oyiy), r(rays.oziz), r(rays.ix), r(rays.iy), r(rays.iz))
        enters = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin <= r(t_stop))
        t = ptype[:, sl].reshape(ptype.shape[0], 1, 1, 1, -1)
        n_box += int((enters & (t == R.PRIM_AABB)).sum())
        n_other += int((enters & (t > R.PRIM_AABB)).sum())
    return n_box, n_other


def work(scenario_name: str, num_agents: int, scene: Dict) -> Dict[str, float]:
    """Bytes and operations of one tick's frames over the whole batch.
    `scene`: `state` ({leaf path: tensor} of a sample of the batch's envs,
    the port's field names), `live_rows` (live primitive rows of the whole
    batch) and `num_envs` (the batch)."""
    from judge import rebuild
    from reference.sim.env import scene_tables
    from reference.sim.scenarios import make_scenario
    from reference.sim.types import scene_to_device, state_from_scene, tree_map

    scenario = make_scenario(scenario_name, num_agents=num_agents)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    one = scenario.generate_checked(np.random.Generator(np.random.PCG64(0)))
    one = tree_map(lambda x: np.asarray(x)[None], one)
    template = state_from_scene(scene_to_device(one, "cpu"), num_agents,
                                torch.zeros((1,), dtype=torch.int64))
    state = rebuild(template, {k: v.to(dev) for k, v in scene["state"].items()})
    cams, prims = scene_tables(scenario, state)
    cfg = scenario.cfg
    h, w = cfg.obs_height, cfg.obs_width
    with torch.no_grad():
        n_box, n_other = row_tests(cams, prims, h, w)
    s = cams.shape[0]
    b = scene["num_envs"]
    pixels = b * num_agents * h * w
    ops = pixels * OPS_PIXEL_FIXED + (n_box * OPS_ROW_AABB + n_other * OPS_ROW_OTHER) * b / s
    nbytes = b * num_agents * CAM_BYTES + scene["live_rows"] * ROW_BYTES + pixels * PIXEL_BYTES
    return {"bytes": float(nbytes), "ops": float(ops), "tests_per_pixel":
            (n_box + n_other) / (s * num_agents * h * w)}


def least_seconds(scenario_name: str, num_agents: int, scene: Dict, bytes_per_s: float,
                  flop_per_s: float) -> float:
    wk = work(scenario_name, num_agents, scene)
    return max(wk["bytes"] / bytes_per_s, wk["ops"] / flop_per_s)
