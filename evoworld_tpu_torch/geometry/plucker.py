"""Pluecker camera-ray embeddings (counterpart of `evoworld_tpu/geometry/plucker.py`).

Channel order [direction(3), moment(3)] with moment = origin x direction.
"""

from __future__ import annotations

import torch


def plucker_embedding(rays: torch.Tensor, c2w: torch.Tensor) -> torch.Tensor:
    """World-frame Pluecker coordinates for camera rays under N poses.

    Args:
        rays: (H, W, 3) unit ray directions in camera coordinates.
        c2w: (N, 3, 4) camera-to-world transforms.

    Returns:
        (N, 6, H, W); channels 0:3 are world-frame directions, 3:6 moments t x d.
    """
    rays = rays.float()
    c2w = c2w.float()
    rot, t = c2w[:, :3, :3], c2w[:, :3, 3]
    d_world = torch.einsum("nij,hwj->nhwi", rot, rays)
    origin = t[:, None, None, :].expand_as(d_world)
    moment = torch.linalg.cross(origin, d_world, dim=-1)
    return torch.cat([d_world, moment], dim=-1).permute(0, 3, 1, 2)
