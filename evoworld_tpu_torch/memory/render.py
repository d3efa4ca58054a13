"""Memory rendering (counterpart of `evoworld_tpu/memory/render.py`): align
the GT cameras to the reconstruction and splat the point cloud onto the next
segment's panoramic views.

  1. fit a similarity (s, R, t) on the FIRST and LAST camera centres mapping
     GT centres into the reconstruction's frame;
  2. transform the next segment's GT poses (rows (segment_id+1)*24+1 on) by it;
  3. z-buffer splat the cloud at each target pose (`ops/splat.py`).
With a mesh the views are split over its ranks (each holding the whole
cloud): the poses are padded to a multiple of the mesh size by repeating the
last, each rank renders its contiguous share, and an all-gather joins them,
cut back to T. Each view is rendered alone either way, so the result is the
unsharded one bit for bit.
"""

from __future__ import annotations

import torch

from evoworld_tpu_torch.geometry.alignment import similarity_from_point_pairs
from evoworld_tpu_torch.geometry.pose import invert_pose
from evoworld_tpu_torch.ops.splat import splat_points_to_pano


def align_target_poses(
    gt_c2w: torch.Tensor,
    pred_extrinsic_w2c: torch.Tensor,
    segment_id: int,
    num_target_view: int = 24,
    recon_start: int = 0,
) -> torch.Tensor:
    """Map the next segment's GT cameras into the reconstruction frame.

    Args:
        gt_c2w: (N, 3 or 4, 4) relative GT camera-to-world poses (OpenCV RDF).
        pred_extrinsic_w2c: (S, 3, 4) VGGT world-to-camera extrinsics.
        segment_id: current segment index.
        recon_start: GT pose row of the first reconstructed frame.

    Returns:
        (num_target_view, 3, 4) render poses, rotation blocks scaled by s.
    """
    gt_c2w = gt_c2w[..., :3, :4].float()
    pred_c2w = invert_pose(pred_extrinsic_w2c.float())
    target_start = (segment_id + 1) * num_target_view + 1
    # B = s R A + t with A = GT centres, B = predicted centres (upstream direction).
    s, rot, t = similarity_from_point_pairs(gt_c2w[recon_start:target_start, :, 3], pred_c2w[:, :, 3])
    targets = gt_c2w[target_start: target_start + num_target_view]
    new_rot = s * torch.einsum("ij,njk->nik", rot, targets[:, :, :3])
    new_t = s * torch.einsum("ij,nj->ni", rot, targets[:, :, 3]) + t
    return torch.cat([new_rot, new_t[:, :, None]], dim=-1)


def render_memory_panoramas(
    points: torch.Tensor,
    colors: torch.Tensor,
    valid: torch.Tensor,
    target_c2w: torch.Tensor,
    height: int = 1000,
    width: int = 2000,
    splat_radius: int = 2,
    mesh=None,
) -> torch.Tensor:
    """Splat the memory cloud onto each target camera, one view at a time.

    The aligned poses' rotation blocks are s R; the splat inverts them as rigid
    transforms, so each is divided by its column norm first.

    Args:
        points: (N, 3) world points; colors: (N, 3) in [0, 1]; valid: (N,) bool.
        target_c2w: (T, 3, 4) render poses.
        mesh: optional `parallel.mesh.Mesh` whose ranks share the views out.

    Returns:
        (T, height, width, 3) panoramas in [0, 1], zero where no point lands.
    """
    rot = target_c2w[:, :, :3]
    scale = torch.linalg.norm(rot[:, :, 0], dim=-1)[:, None, None]
    poses = torch.cat([rot / torch.clamp(scale, min=1e-12), target_c2w[:, :, 3:]], dim=-1)
    sharded = mesh is not None and mesh.size > 1
    if sharded:
        from evoworld_tpu_torch.parallel.collectives import all_gather
        from evoworld_tpu_torch.parallel.mesh import shard_batch

        t = poses.shape[0]
        poses = shard_batch(poses, mesh)
    out = torch.stack([
        splat_points_to_pano(points, colors, c2w, height, width, valid=valid, splat_radius=splat_radius)[0]
        for c2w in poses
    ])
    return all_gather(out, mesh)[:t] if sharded else out
