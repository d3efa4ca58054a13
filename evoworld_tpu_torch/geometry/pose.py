"""Camera pose math (counterpart of `evoworld_tpu/geometry/pose.py`).

R = Rz @ Ry @ Rx with angles in degrees; relative-to-first poses
F_rel[i] = F[0]^{-1} @ F[i]; Unity (left-handed) to OpenCV right-down-forward
by sign flips. All in fp32.
"""

from __future__ import annotations

import torch

#: Sign flips applied to [x, y, z, rotx, roty, rotz] to convert Unity poses
#: to the OpenCV right-down-forward frame.
UNITY_TO_OPENCV = (1.0, -1.0, 1.0, -1.0, 1.0, -1.0)


def unity_to_opencv(xyz_euler: torch.Tensor) -> torch.Tensor:
    """Apply the Unity->OpenCV sign convention to (..., 6) pose rows."""
    return xyz_euler * torch.tensor(UNITY_TO_OPENCV, dtype=xyz_euler.dtype, device=xyz_euler.device)


def euler_deg_to_rotmat(euler_deg: torch.Tensor) -> torch.Tensor:
    """(..., 3) [rotx, roty, rotz] degrees -> (..., 3, 3) with R = Rz@Ry@Rx."""
    rad = torch.deg2rad(euler_deg.float())
    cx, cy, cz = torch.cos(rad[..., 0]), torch.cos(rad[..., 1]), torch.cos(rad[..., 2])
    sx, sy, sz = torch.sin(rad[..., 0]), torch.sin(rad[..., 1]), torch.sin(rad[..., 2])
    rows = [
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def pose_to_matrix(
    xyz_euler: torch.Tensor, relative: bool = False, homogeneous: bool = False
) -> torch.Tensor:
    """Convert (B, 6) [x, y, z, rotx, roty, rotz] rows to camera matrices.

    Args:
        xyz_euler: (B, 6) pose rows, angles in degrees.
        relative: re-express every pose relative to the first frame.
        homogeneous: return (B, 4, 4) instead of (B, 3, 4).

    Returns:
        Camera-to-world transforms.
    """
    xyz_euler = xyz_euler.float()
    rot = euler_deg_to_rotmat(xyz_euler[:, 3:6])   # (B, 3, 3)
    t = xyz_euler[:, 0:3, None]                     # (B, 3, 1)
    if relative:
        r0_inv = rot[0].T
        rot = torch.einsum("ij,bjk->bik", r0_inv, rot)
        t = torch.einsum("ij,bjk->bik", r0_inv, t - t[0])
    mat = torch.cat([rot, t], dim=-1)               # (B, 3, 4)
    if homogeneous:
        bottom = torch.zeros((mat.shape[0], 1, 4), dtype=mat.dtype, device=mat.device)
        bottom[:, 0, 3] = 1.0
        mat = torch.cat([mat, bottom], dim=1)
    return mat


def invert_pose(mat34: torch.Tensor) -> torch.Tensor:
    """Invert (..., 3, 4) rigid transforms: (R, t) -> (R^T, -R^T t)."""
    rot_inv = mat34[..., :3, :3].transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...jk->...ik", rot_inv, mat34[..., :3, 3:])
    return torch.cat([rot_inv, t_inv], dim=-1)


def compose_poses(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose (..., 3, 4) rigid transforms: result = a @ b (as 4x4s)."""
    rot = torch.einsum("...ij,...jk->...ik", a[..., :3, :3], b[..., :3, :3])
    t = torch.einsum("...ij,...jk->...ik", a[..., :3, :3], b[..., :3, 3:]) + a[..., :3, 3:]
    return torch.cat([rot, t], dim=-1)
