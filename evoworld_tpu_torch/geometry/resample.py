"""Spherical resampling (counterpart of `evoworld_tpu/geometry/resample.py`):
equirectangular sampling, equirect -> perspective crops, panorama yaw
rotation, and equirect <-> cubemap (bilinear, pixel centres).

Images are channels-last (H, W, C) float tensors.
"""

from __future__ import annotations

import math

import torch

from evoworld_tpu_torch.geometry.rays import equirect_ray_grid, pinhole_ray_grid


def _gather_hw(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """Gather pixels (H, W, C) at integer index grids (...) -> (..., C)."""
    return img[iy, ix]


def bilinear_sample_pano(pano: torch.Tensor, lon: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample an equirectangular image at spherical coordinates.

    Pixel x covers longitude (x/W - 0.5)*2pi, so u = (lon/2pi + 0.5)*W;
    longitude wraps at the seam, latitude clamps at the poles.

    Args:
        pano: (H, W, C) image.
        lon, lat: (...) radians.

    Returns:
        (..., C) sampled colours.
    """
    height, width = pano.shape[0], pano.shape[1]
    u = (lon / (2.0 * math.pi) + 0.5) * width
    v = (lat / math.pi + 0.5) * height
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    u0i = torch.remainder(u0.to(torch.int64), width)
    u1i = torch.remainder(u0i + 1, width)
    v0i = torch.clamp(v0.to(torch.int64), 0, height - 1)
    v1i = torch.clamp(v0i + 1, 0, height - 1)
    top = _gather_hw(pano, v0i, u0i) * (1.0 - du) + _gather_hw(pano, v0i, u1i) * du
    bot = _gather_hw(pano, v1i, u0i) * (1.0 - du) + _gather_hw(pano, v1i, u1i) * du
    return top * (1.0 - dv) + bot * dv


def _rot_x(a: torch.Tensor) -> torch.Tensor:
    c, s, o, z = torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([torch.stack(r) for r in ((o, z, z), (z, c, -s), (z, s, c))])


def _rot_y(a: torch.Tensor) -> torch.Tensor:
    c, s, o, z = torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([torch.stack(r) for r in ((c, z, s), (z, o, z), (-s, z, c))])


def _rot_z(a: torch.Tensor) -> torch.Tensor:
    c, s, o, z = torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([torch.stack(r) for r in ((c, -s, z), (s, c, z), (z, z, o))])


def equi_to_pers(
    pano: torch.Tensor,
    yaw: torch.Tensor | float = 0.0,
    pitch: torch.Tensor | float = 0.0,
    roll: torch.Tensor | float = 0.0,
    out_height: int = 384,
    out_width: int = 512,
    fov_x_deg: float = 90.0,
) -> torch.Tensor:
    """Pinhole perspective view of an equirectangular panorama.

    pyequilib's convention, as in the JAX module: a positive `yaw` (radians)
    turns the view toward negative panorama longitude; positive pitch looks up.

    Returns:
        (out_height, out_width, C) perspective image.
    """
    dev = pano.device
    rays = pinhole_ray_grid(out_height, out_width, fov_x_deg, device=dev)  # (h, w, 3) RDF
    yaw, pitch, roll = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (yaw, pitch, roll))
    rot = _rot_y(-yaw) @ _rot_x(-pitch) @ _rot_z(-roll)
    d = torch.einsum("ij,hwj->hwi", rot, rays)
    lon = torch.atan2(d[..., 0], d[..., 2])
    lat = torch.asin(torch.clamp(d[..., 1], -1.0, 1.0))
    return bilinear_sample_pano(pano, lon, lat)


def rotate_pano_yaw(pano: torch.Tensor, degrees: torch.Tensor | float) -> torch.Tensor:
    """Rotate an equirectangular panorama about the vertical axis.

    Output pixel x reads input pixel floor((x + degrees/360*W) mod W), the
    nearest-floor sampling of the upstream navigator; positive degrees shift
    content leftward. (H, W, C) -> (H, W, C).
    """
    width = pano.shape[1]
    degrees = torch.as_tensor(degrees, dtype=torch.float32, device=pano.device)
    xs = torch.arange(width, dtype=torch.float32, device=pano.device)
    src = torch.remainder(xs + degrees / 360.0 * width, width)
    src_i = torch.clamp(torch.floor(src).to(torch.int64), 0, width - 1)
    return pano[:, src_i, :]


#: face index -> face, each looking down its axis in the RDF frame. The order
#: and orientation invert each other (equirect -> cube -> equirect is the
#: identity away from the seams); they are not the capture engines' layout
#: (`data/engine.py`).
CUBE_FACES = ("front", "right", "back", "left", "up", "down")


def _face_dirs(face_size: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Unit ray directions of all six faces' pixel centres: (6, S, S, 3)."""
    s = (torch.arange(face_size, dtype=torch.float32, device=device) + 0.5) / face_size * 2.0 - 1.0
    a = s[None, :].expand(face_size, face_size)  # varies along x
    b = s[:, None].expand(face_size, face_size)  # varies along y
    one = torch.ones_like(a)
    d = torch.stack([
        torch.stack([a, b, one], -1),     # front, +Z
        torch.stack([one, b, -a], -1),    # right, +X
        torch.stack([-a, b, -one], -1),   # back, -Z
        torch.stack([-one, b, a], -1),    # left, -X
        torch.stack([a, -one, -b], -1),   # up, -Y
        torch.stack([a, one, b], -1),     # down, +Y
    ])
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def pano_to_cubemap(pano: torch.Tensor, face_size: int) -> torch.Tensor:
    """(H, W, C) equirect image -> (6, S, S, C) cube faces in CUBE_FACES order."""
    d = _face_dirs(face_size, pano.device)
    lon = torch.atan2(d[..., 0], d[..., 2])
    lat = torch.asin(torch.clamp(d[..., 1], -1.0, 1.0))
    return bilinear_sample_pano(pano, lon, lat)


def cubemap_to_pano(faces: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(6, S, S, C) cube faces in CUBE_FACES order -> (H, W, C) equirect image:
    each ray reads the face of its dominant axis, bilinearly, clamped at the
    face's edges."""
    face_size = faces.shape[1]
    d = equirect_ray_grid(height, width, device=faces.device)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_z = (az >= ax) & (az >= ay)
    is_x = ~is_z & (ax >= ay)
    face = torch.where(is_z, torch.where(z > 0, 0, 2),
                       torch.where(is_x, torch.where(x > 0, 1, 3), torch.where(y < 0, 4, 5)))
    denom = torch.clamp(torch.where(is_z, az, torch.where(is_x, ax, ay)), min=1e-12)
    # in-plane coordinates, inverting _face_dirs
    u = torch.where(is_z, torch.where(z > 0, x, -x) / denom,
                    torch.where(is_x, torch.where(x > 0, -z, z) / denom, x / denom))
    v = torch.where(is_z | is_x, y / denom, torch.where(y < 0, -z, z) / denom)
    fu = (u + 1.0) * 0.5 * face_size - 0.5
    fv = (v + 1.0) * 0.5 * face_size - 0.5
    u0, v0 = torch.floor(fu), torch.floor(fv)
    du, dv = (fu - u0)[..., None], (fv - v0)[..., None]
    u0i = torch.clamp(u0.to(torch.int64), 0, face_size - 1)
    v0i = torch.clamp(v0.to(torch.int64), 0, face_size - 1)
    u1i, v1i = torch.clamp(u0i + 1, max=face_size - 1), torch.clamp(v0i + 1, max=face_size - 1)
    top = faces[face, v0i, u0i] * (1.0 - du) + faces[face, v0i, u1i] * du
    bot = faces[face, v1i, u0i] * (1.0 - du) + faces[face, v1i, u1i] * du
    return top * (1.0 - dv) + bot * dv
