"""Point-cloud filtering for the explicit 3D memory (counterpart of
`evoworld_tpu/memory/pointcloud.py`).

Every point keeps its slot; filtering gives a boolean mask that the splat
renderer reads. The confidence threshold is a percentile (default 50, 0 keeps
everything) with JAX's and numpy's linear interpolation between order
statistics. It is computed with `torch.kthvalue`, not `torch.quantile`, which
refuses inputs of more than 2^24 elements (a 5-segment episode with an
unbounded reconstruction window holds 97 frames x 392 x 518 = 19.7 M points).
"""

from __future__ import annotations

import math

import torch


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The q-th percentile (0..100) of all of `x`, linear interpolation (0-d fp32)."""
    flat = x.reshape(-1).float()
    pos = q / 100.0 * (flat.numel() - 1)
    low = min(max(math.floor(pos), 0), flat.numel() - 1)
    high_weight = pos - math.floor(pos)
    low_value = torch.kthvalue(flat, low + 1).values
    if high_weight == 0.0:
        return low_value
    high_value = torch.kthvalue(flat, min(low + 2, flat.numel())).values
    return low_value * (1.0 - high_weight) + high_value * high_weight


def confidence_mask(
    conf: torch.Tensor,
    conf_percentile: float = 50.0,
    colors: torch.Tensor | None = None,
    mask_black_bg: bool = False,
    mask_white_bg: bool = False,
) -> torch.Tensor:
    """Boolean mask of points whose confidence reaches the percentile.

    Args:
        conf: (...) per-point confidence.
        conf_percentile: percentile in [0, 100]; 0 keeps everything.
        colors: optional (..., 3) colours in [0, 1] for the background masks.
    """
    if conf_percentile == 0.0:
        mask = torch.ones(conf.shape, dtype=torch.bool, device=conf.device)
    else:
        mask = conf >= percentile(conf, conf_percentile)
    if colors is not None and mask_black_bg:
        mask = mask & (colors.sum(dim=-1) * 255.0 >= 16.0)
    if colors is not None and mask_white_bg:
        mask = mask & ~(colors > 240 / 255).all(dim=-1)
    return mask


def scene_scale(points: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """|| p95 - p5 || over the valid points, per axis percentiles."""
    pts = points.reshape(-1, 3)
    if valid is not None:
        pts = pts[valid.reshape(-1)]
    lo = torch.stack([percentile(pts[:, i], 5.0) for i in range(3)])
    hi = torch.stack([percentile(pts[:, i], 95.0) for i in range(3)])
    return torch.linalg.norm(hi - lo)
