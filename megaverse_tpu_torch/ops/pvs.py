"""Device-side PVS row-mask lookup for the render culling prologue
(counterpart of megaverse_tpu/ops/pvs.py).

The hex scenarios carry per-episode tables in their scenario state (built by
utils/pvs.py at generation time):
  pvs_centers [B, CMAX, 2] f32    world-xz cell centers, +1e9 padding
  pvs_rows16  [B, CMAX+1, W] i32  per-cell render-row visibility bits, 16
                                  bits per word; row CMAX is an all-ones
                                  sentinel
  pvs_walltop [B] f32             wall-top plane y (2*wall_height); <= 0
                                  disables PVS for the env

Per (env, agent) the eye maps to its containing cell by nearest center, which
is exact for a honeycomb (cells are the Voronoi regions of their centers).
The guard falls back to the sentinel (everything visible) wherever the 2D
reduction's premise could fail: eye at or above the wall-top plane (jump
apex, standing on a wall) or outside every cell. The row words are read by a
gather (the JAX package reads them with a one-hot matmul, a TPU idiom).
"""

from __future__ import annotations

import torch

from megaverse_tpu_torch import constants as C

# Matches utils/pvs._HEX_R: the device cell assignment is valid while the eye
# is within the maze; beyond circumradius + slack of every center -> sentinel.
_EYE_MARGIN = 0.05


def row_mask(agents_pos: torch.Tensor, centers: torch.Tensor, rows16: torch.Tensor,
             walltop: torch.Tensor, num_rows: int, cell_scale: float) -> torch.Tensor:
    """Per-agent render-row visibility bits for a batch of envs.

    agents_pos [B, A, 3], centers [B, CMAX, 2], rows16 [B, CMAX+1, W] i32,
    walltop [B], cell_scale = world units per maze unit (the hex
    circumradius in world units). Returns bool [B, A, num_rows]."""
    cmax = centers.shape[1]
    eye_y = agents_pos[..., 1] + (C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y)
    eye_xz = torch.stack([agents_pos[..., 0], agents_pos[..., 2]], dim=-1)
    d2 = ((eye_xz[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(dim=-1)  # [B, A, CMAX]
    dmin, cell = d2.min(dim=-1)                 # first minimum, as jnp.argmin
    ok = ((walltop[:, None] > 0.0)
          & (eye_y < walltop[:, None] - _EYE_MARGIN)
          & (dmin < (cell_scale * (1.0 + _EYE_MARGIN)) ** 2))
    idx = torch.where(ok, cell, torch.full_like(cell, cmax))  # sentinel row
    bidx = torch.arange(idx.shape[0], device=idx.device)[:, None]
    words = rows16[bidx, idx]                   # [B, A, W], 16-bit words
    shifts = torch.arange(16, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.flatten(-2)[..., :num_rows].to(torch.bool)
