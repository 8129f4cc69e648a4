"""Plain PyTorch judges of a pose against one observation, independent of
where a search started: the search's render-and-compare score, and how
far the observed points lie from the CAD's surface.

The score is the one the port's template search documents (lower is
better): at half resolution, the mean depth gap over the pixels that both
the CAD rendered at the pose and the observation cover, plus one minus the
silhouette IoU of the render against the detection mask (2 x 2 blocks
any-pooled). The observed depth is every second pixel of the frame inside
the mask, where the search splats a random sample of the masked points;
the two estimate the same mean.
"""
from __future__ import annotations

import torch

from . import raster as rr

ROWS = 512  # observed points a block of the distance computation


def view_score(verts, faces, T: torch.Tensor, depth: torch.Tensor, mask: torch.Tensor,
               cam: dict) -> float:
    """The render-and-compare score of pose ``T`` (4, 4) against the frame's
    ``depth`` (H, W) and detection ``mask`` (H, W) bool."""
    cam_r = rr.scaled(cam, 2)
    Hr, Wr = cam_r["height"], cam_r["width"]
    dep = rr.render_depth(verts, faces, T, cam_r)
    d_s = depth[: Hr * 2: 2, : Wr * 2: 2]
    m_s = mask[: Hr * 2: 2, : Wr * 2: 2]
    obs = torch.where(m_s & (d_s > 0), d_s, torch.zeros_like(d_s))
    msk = mask[: Hr * 2, : Wr * 2].reshape(Hr, 2, Wr, 2).any(3).any(1)
    sil = dep > 0
    both = sil & (obs > 0)
    dz = (dep - obs).abs()[both].sum() / torch.clamp(both.sum(), min=1)
    iou = (sil & msk).sum() / torch.clamp((sil | msk).sum(), min=1)
    return float(dz + (1.0 - iou))


def surface_gap_mm(obs: torch.Tensor, model_pts: torch.Tensor, T: torch.Tensor) -> float:
    """Mean distance, in mm, from each observed point (N, 3) to the nearest
    of the model's surface points (M, 3) under pose ``T``. Differences
    written out, no matrix product."""
    m = rr.transform(T, model_pts)
    total = torch.zeros((), dtype=torch.float64, device=obs.device)
    for s in range(0, obs.shape[0], ROWS):
        d = torch.linalg.norm(obs[s:s + ROWS, None, :] - m[None, :, :], dim=-1)
        total += d.min(1).values.double().sum()
    return float(total / max(obs.shape[0], 1)) * 1e3
