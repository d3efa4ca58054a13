"""VGGT camera decoding and depth unprojection (counterpart of
`evoworld_tpu/models/vggt/geometry.py`), in fp32.

pose_enc = [t (3), quaternion (4, scalar-last xyzw), fov (2)], the
"absT_quaR_FoV" encoding of upstream VGGT; extrinsics are world-to-camera.
"""

from __future__ import annotations

import torch


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion [x, y, z, w] -> (..., 3, 3) rotation matrix."""
    q = quat / torch.clamp(torch.linalg.norm(quat, dim=-1, keepdim=True), min=1e-12)
    x, y, z, w = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def pose_encoding_to_extri_intri(pose_enc: torch.Tensor, image_hw: tuple[int, int]):
    """(S, 9) pose encoding -> (extrinsic (S, 3, 4) w2c, intrinsic (S, 3, 3)).

    The fields of view are clamped into [0.05, 3.1] rad, as in the JAX module:
    a no-op for trained weights, and it keeps random weights' intrinsics finite.
    """
    height, width = image_hw
    pose_enc = pose_enc.float()
    fov_h = torch.clamp(pose_enc[:, 7].abs(), 0.05, 3.1)
    fov_w = torch.clamp(pose_enc[:, 8].abs(), 0.05, 3.1)
    extrinsic = torch.cat([quat_to_rotmat(pose_enc[:, 3:7]), pose_enc[:, 0:3, None]], dim=-1)
    fy = (height / 2.0) / torch.tan(fov_h / 2.0)
    fx = (width / 2.0) / torch.tan(fov_w / 2.0)
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    intrinsic = torch.stack([
        torch.stack([fx, zeros, torch.full_like(fx, width / 2.0)], -1),
        torch.stack([zeros, fy, torch.full_like(fy, height / 2.0)], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=-2)
    return extrinsic, intrinsic


def unproject_depth_map_to_point_map(
    depth: torch.Tensor, extrinsic: torch.Tensor, intrinsic: torch.Tensor
) -> torch.Tensor:
    """(S, H, W[, 1]) z-depth -> (S, H, W, 3) world points: R^T (p_cam - t)."""
    if depth.dim() == 4:
        depth = depth[..., 0]
    depth = depth.float()
    _, height, width = depth.shape
    uu = torch.arange(width, dtype=torch.float32, device=depth.device)[None, None, :]
    vv = torch.arange(height, dtype=torch.float32, device=depth.device)[None, :, None]
    fx, fy = intrinsic[:, 0, 0, None, None], intrinsic[:, 1, 1, None, None]
    cx, cy = intrinsic[:, 0, 2, None, None], intrinsic[:, 1, 2, None, None]
    p_cam = torch.stack([(uu - cx) / fx * depth, (vv - cy) / fy * depth, depth], dim=-1)
    p = p_cam - extrinsic[:, None, None, :, 3]
    return torch.einsum("sji,shwj->shwi", extrinsic[:, :, :3], p)
