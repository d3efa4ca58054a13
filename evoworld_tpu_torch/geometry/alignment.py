"""Pose alignment: similarity transforms between predicted and GT cameras
(counterpart of `evoworld_tpu/geometry/alignment.py`).

The two-point similarity fit of the upstream `align_first_and_last_points`
(Rodrigues rotation between the first-to-last vectors) and the Kabsch
similarity of `get_camera_transformation`, in fp32 torch with the degenerate
branches as `torch.where`, as the JAX module has them.
"""

from __future__ import annotations

import torch


def rotation_between_vectors(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotation matrix taking direction u to direction v (Rodrigues formula).

    Zero-length inputs and parallel vectors give the identity; antiparallel
    vectors give a true 180-degree rotation 2 p p^T - I about an axis p
    perpendicular to u (det = +1, maps u to -u), not upstream's det = -1
    reflection.
    """
    u, v = u.float(), v.float()
    eye = torch.eye(3, dtype=torch.float32, device=u.device)
    nu, nv = torch.linalg.norm(u), torch.linalg.norm(v)
    u_hat = u / torch.clamp(nu, min=1e-15)
    v_hat = v / torch.clamp(nv, min=1e-15)
    dot = torch.clamp(torch.dot(u_hat, v_hat), -1.0, 1.0)

    w = torch.linalg.cross(u_hat, v_hat)
    w_hat = w / torch.clamp(torch.linalg.norm(w), min=1e-15)
    angle = torch.arccos(dot)
    zero = torch.zeros((), dtype=torch.float32, device=u.device)
    k = torch.stack([
        torch.stack([zero, -w_hat[2], w_hat[1]]),
        torch.stack([w_hat[2], zero, -w_hat[0]]),
        torch.stack([-w_hat[1], w_hat[0], zero]),
    ])
    general = eye + torch.sin(angle) * k + (1.0 - torch.cos(angle)) * (k @ k)

    alt = torch.where(torch.abs(u_hat[0]) > 0.9, eye[1], eye[0])
    perp = torch.linalg.cross(u_hat, alt)
    perp = perp / torch.clamp(torch.linalg.norm(perp), min=1e-15)
    flip = 2.0 * torch.outer(perp, perp) - eye

    one = torch.ones((), dtype=torch.float32, device=u.device)
    out = torch.where(torch.isclose(dot, one), eye, torch.where(torch.isclose(dot, -one), flip, general))
    return torch.where((nu < 1e-15) | (nv < 1e-15), eye, out)


def similarity_from_point_pairs(a: torch.Tensor, b: torch.Tensor):
    """(s, R, t) with b[0] = s R a[0] + t and b[-1] = s R a[-1] + t.

    Only the first and last rows of each (N, 3) tensor are used. Returns
    scale (0-d tensor), rotation (3, 3), translation (3,).
    """
    a, b = a.float(), b.float()
    va, vb = a[-1] - a[0], b[-1] - b[0]
    len_a, len_b = torch.linalg.norm(va), torch.linalg.norm(vb)
    degenerate = len_a < 1e-15
    s = torch.where(degenerate, torch.ones_like(len_a), len_b / torch.clamp(len_a, min=1e-15))
    rot = torch.where(degenerate, torch.eye(3, dtype=torch.float32, device=a.device), rotation_between_vectors(va, vb))
    t = b[0] - s * (rot @ a[0])
    return s, rot, t


def kabsch_similarity(gt_centers: torch.Tensor, pred_centers: torch.Tensor):
    """Least-squares scale, then Kabsch rotation and translation from pred to GT.

    Args:
        gt_centers: (N, 3) target points.
        pred_centers: (N, 3) source points.

    Returns:
        theta (0-d tensor), rotation (3, 3), translation (3,).
    """
    gt, pred = gt_centers.float(), pred_centers.float()
    theta = torch.sum(gt * pred) / torch.clamp(torch.sum(pred * pred), min=1e-15)
    pred_s = theta * pred
    cg, cp = gt.mean(dim=0), pred_s.mean(dim=0)
    h = (pred_s - cp).T @ (gt - cg)
    u, _, vt = torch.linalg.svd(h)
    det = torch.linalg.det(vt.T @ u.T)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), torch.sign(det)])
    rot = (vt.T * d[None, :]) @ u.T
    return theta, rot, cg - rot @ cp


def apply_similarity(points: torch.Tensor, s, rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x -> s R x + t on (..., 3) points."""
    return s * torch.einsum("ij,...j->...i", rot, points) + t
