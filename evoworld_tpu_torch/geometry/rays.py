"""Per-pixel ray direction grids, equirectangular and pinhole (counterpart of
`evoworld_tpu/geometry/rays.py`).

RDF convention: X right, Y down, Z forward; the panorama centre maps to +Z,
the top row to -Y.
"""

from __future__ import annotations

import math

import torch


def equirect_ray_grid(height: int, width: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Unit ray directions for every pixel of an equirectangular image.

    Pixel (x, y) maps to longitude phi = (x/W - 0.5) * 2*pi and latitude
    theta = (y/H - 0.5) * pi; the direction is
    [cos(theta) sin(phi), sin(theta), cos(theta) cos(phi)].

    Returns:
        (height, width, 3) fp32 unit vectors.
    """
    ys = torch.arange(height, dtype=torch.float32, device=device)
    xs = torch.arange(width, dtype=torch.float32, device=device)
    theta = (ys / height - 0.5) * math.pi
    phi = (xs / width - 0.5) * (2.0 * math.pi)
    cos_t, sin_t = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    cos_p, sin_p = torch.cos(phi)[None, :], torch.sin(phi)[None, :]
    d_x = cos_t * sin_p
    d_y = sin_t.expand(height, width)
    d_z = cos_t * cos_p
    return torch.stack([d_x, d_y, d_z], dim=-1)


def pinhole_ray_grid(
    height: int, width: int, fov_x_deg: float = 90.0, device: str | torch.device = "cpu"
) -> torch.Tensor:
    """Unit ray directions of a pinhole camera looking down +Z (RDF).

    Horizontal field of view `fov_x_deg`, square pixels, pixel centres (the
    principal point at ((W-1)/2, (H-1)/2)).

    Returns:
        (height, width, 3) fp32 unit vectors in camera coordinates.
    """
    fx = (width / 2.0) / torch.tan(torch.deg2rad(torch.tensor(fov_x_deg, dtype=torch.float32, device=device)) / 2.0)
    xs = torch.arange(width, dtype=torch.float32, device=device) - (width - 1) / 2.0
    ys = torch.arange(height, dtype=torch.float32, device=device) - (height - 1) / 2.0
    x = xs[None, :].expand(height, width) / fx
    y = ys[:, None].expand(height, width) / fx
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def pinhole_intrinsics(height: int, width: int, fov_x_deg: float = 90.0,
                       device: str | torch.device = "cpu") -> torch.Tensor:
    """The (3, 3) fp32 intrinsic matrix matching `pinhole_ray_grid`: focal
    length in pixels from the horizontal field of view, the principal point
    at the pixel centres' middle."""
    fx = (width / 2.0) / math.tan(math.radians(fov_x_deg) / 2.0)
    return torch.tensor([[fx, 0.0, (width - 1) / 2.0], [0.0, fx, (height - 1) / 2.0], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)
