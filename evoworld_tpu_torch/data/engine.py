"""Offline data engine: engine cubemap captures -> equirectangular panoramas
(counterpart of `evoworld_tpu/data/engine.py`).

Each captured frame is six face images ({front,back,left,right,top,bottom})
which are resampled into an (H, W) equirectangular panorama by nearest
neighbour, with the upstream batched converter's face selection and UV
arithmetic, its rotated longitude lon = -x/W*2pi - pi + pi/2 included: the
trigonometry in fp32, the texel index truncated toward zero. Unreal Engine
captures differ only in their top and bottom faces, which arrive rotated by
180 degrees.
"""

from __future__ import annotations

import math

import torch

FACE_ORDER = ("right", "left", "bottom", "top", "front", "back")


def unity_cubes_to_pano(faces: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(6, S, S, C) faces in FACE_ORDER -> (H, W, C) panorama (nearest neighbour)."""
    face_size = faces.shape[1]
    dev = faces.device
    # The upstream converter's names: `yv` runs along x and `xv` along y.
    yv = torch.arange(width, dtype=torch.float32, device=dev)[None, :].expand(height, width)
    xv = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(height, width)
    lon = (-yv / width) * 2.0 * math.pi - math.pi + math.pi / 2.0
    lat = (xv / height) * math.pi - math.pi / 2.0

    x = torch.cos(lat) * torch.cos(lon)
    y = torch.sin(lat)
    z = torch.cos(lat) * torch.sin(lon)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay >= ax) & (ay >= az) & ~is_x
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)))
    sx, sy, sz = (torch.clamp(a, min=1e-12) for a in (ax, ay, az))
    u = torch.where(is_x, torch.where(x > 0, -z, z) / sx,
                    torch.where(is_y, -x / sy, torch.where(z > 0, x, -x) / sz))
    v = torch.where(is_x, -y / sx, torch.where(is_y, torch.where(y > 0, -z, z) / sy, -y / sz))
    u = (u + 1.0) / 2.0
    v = (v + 1.0) / 2.0
    u_px = torch.clamp((u * (face_size - 1)).to(torch.int32), 0, face_size - 1).long()
    v_px = torch.clamp(((1.0 - v) * (face_size - 1)).to(torch.int32), 0, face_size - 1).long()
    return faces[face, v_px, u_px]


def ue_cubes_to_pano(faces: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Unreal Engine captures, (6, S, S, C) raw faces in FACE_ORDER: the top
    and bottom faces are turned by 180 degrees, then sampled as Unity's."""
    fixed = faces.clone()
    fixed[2] = torch.rot90(faces[2], 2, dims=(0, 1))  # bottom
    fixed[3] = torch.rot90(faces[3], 2, dims=(0, 1))  # top
    return unity_cubes_to_pano(fixed, height, width)
