"""Offline VGGT reprojection: the memory panoramas of training episodes
(counterpart of `evoworld_tpu/cli/reproject.py`), the last step of preparing
them after `cli.pano_to_pers`.

Per episode: VGGT on the look-at-center crops (`perspective_look_at_center/`)
but the last `loop.num_target_view`; the sky's points zeroed in the
confidences (`data.mask_sky`, on by default: the U^2-Net of
`runtime.skyseg_onnx`, or a heuristic with a warning where that file is
absent); the GT cameras (`camera_poses_look_at_center.txt`, taken as they
are) aligned on the source frames' centres; the cloud above the confidence
percentile splatted at the last `loop.num_target_view` poses into
`<data.reprojection_name>/{00..}.png` at `pipeline.height` x
`pipeline.width`. Episodes `data.start_idx` to `data.end_idx` (-1: all) of
`data.root`; an episode whose output holds `loop.num_target_view` files is
skipped, and VGGT is built only where a selected episode needs it.

Usage (on the card; on W cards, one process each):
  python -m evoworld_tpu_torch.cli.reproject --data.root=<dataset or episode> \\
      [--loop.conf_percentile=30] [--runtime.vggt_checkpoint=<model.pt>] \\
      [--runtime.skyseg_onnx=<skyseg.onnx>]
  torchrun --nproc-per-node W -m evoworld_tpu_torch.cli.reproject <the same flags>

With WORLD_SIZE > 1 the ranks shard VGGT over the mesh (`runtime.inference_setup`;
`--runtime.vggt_mesh=false` keeps it whole on every rank): its frames where W
divides their count, its global attention on the head-sharded route (or the
ring). Every rank returns the same records; rank 0 alone writes the renders.
One process on one card keeps VGGT's parameters in host memory between
episodes. From Python, `main(argv, device="cpu")` runs on the CPU (ranks on
the CPU: `parallel/launch.py`).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed

from evoworld_tpu_torch.cli.common import load_frames, logger, parse_config, save_frames
from evoworld_tpu_torch.config import compute_dtype
from evoworld_tpu_torch.data.dataset import load_camera_poses
from evoworld_tpu_torch.geometry.alignment import similarity_from_point_pairs
from evoworld_tpu_torch.geometry.pose import invert_pose, pose_to_matrix
from evoworld_tpu_torch.loop.unified import StageClock
from evoworld_tpu_torch.memory.pointcloud import confidence_mask
from evoworld_tpu_torch.memory.render import render_memory_panoramas
from evoworld_tpu_torch.memory.skyseg import SkySegmentation
from evoworld_tpu_torch.runtime import build_reconstructor, check_compute_dtype, inference_setup


def sky_segmentation(config, device) -> SkySegmentation:
    """The U^2-Net of `runtime.skyseg_onnx`, or the heuristic with a warning."""
    path = config.runtime.skyseg_onnx
    if path and os.path.exists(path):
        return SkySegmentation(path, device)
    logger.warning(f"skyseg weights not found at {path!r}; using the weights-free heuristic sky mask instead "
                   "(pass --data.mask_sky=false to disable sky masking)")
    return SkySegmentation(None, device)


def _out_dir(ep_dir: str, config) -> str:
    return os.path.join(ep_dir, config.data.reprojection_name or "rendered_panorama_vggt_open3d")


def _pers_dir(ep_dir: str) -> str:
    return os.path.join(ep_dir, "perspective_look_at_center")


def _rendered(ep_dir: str, config) -> bool:
    out_dir = _out_dir(ep_dir, config)
    return os.path.isdir(out_dir) and len(os.listdir(out_dir)) >= config.loop.num_target_view


def process_episode(ep_dir: str, reconstructor, config, device, timings: dict | None = None,
                    writes: bool = True) -> bool:
    """Render one episode's memory panoramas (written where `writes`); False
    where it is skipped. `timings`, if given, gets the seconds of
    reconstruct, sky_mask and render, the device synchronised around each."""
    cfg = config.loop
    if _rendered(ep_dir, config):
        logger.info(f"skip {ep_dir} (already rendered)")
        return False
    pers_dir = _pers_dir(ep_dir)
    if not os.path.isdir(pers_dir):
        logger.warning(f"{ep_dir}: run cli.pano_to_pers first; skipping")
        return False

    dev = torch.device(device)
    clock = StageClock(timings, dev)
    names = sorted(f for f in os.listdir(pers_dir) if f.endswith(".png"))
    source = [os.path.join(pers_dir, n) for n in names[:-cfg.num_target_view]]
    imgs = torch.from_numpy(np.stack(load_frames(source))).to(dev)
    preds = clock("reconstruct", lambda: reconstructor(imgs))
    conf = preds["conf"]
    if config.data.mask_sky:  # the upstream tool's default
        sky = sky_segmentation(config, dev)
        conf = clock("sky_mask", lambda: sky.apply_to_conf(conf, imgs))

    def render():
        cam = load_camera_poses(os.path.join(ep_dir, "camera_poses_look_at_center.txt"), unity_to_opencv=False)
        gt_c2w = pose_to_matrix(torch.from_numpy(cam).to(dev), relative=True)
        pred_c2w = invert_pose(preds["extrinsic"].float())
        s, rot, t = similarity_from_point_pairs(gt_c2w[:len(source), :, 3], pred_c2w[:, :, 3])
        targets = gt_c2w[-cfg.num_target_view:]
        new_rot = s * torch.einsum("ij,njk->nik", rot, targets[:, :, :3])
        new_t = s * torch.einsum("ij,nj->ni", rot, targets[:, :, 3]) + t
        valid = confidence_mask(conf, cfg.conf_percentile).reshape(-1)
        return render_memory_panoramas(preds["world_points"].reshape(-1, 3), preds["colors"].reshape(-1, 3), valid,
                                       torch.cat([new_rot, new_t[:, :, None]], dim=-1),
                                       config.pipeline.height, config.pipeline.width)

    renders = clock("render", render)
    if writes:
        save_frames(renders, _out_dir(ep_dir, config), 0, "{:02d}.png")
        logger.info(f"rendered {cfg.num_target_view} memory panoramas for {ep_dir}")
    return True


def main(argv=None, device: str | torch.device = "cuda") -> list[dict]:
    """Run the CLI; returns one record per selected episode: its directory,
    whether it was rendered, and its stage seconds."""
    config = parse_config(argv, __doc__)
    rt = config.runtime
    dtype = compute_dtype(rt)
    check_compute_dtype(device, dtype)
    dev, mesh = inference_setup(device, rt.mesh_data, rt.mesh_model)
    writes = mesh is None or mesh.rank == 0
    root = config.data.root
    if os.path.isdir(os.path.join(root, "panorama")):
        episodes = [root]
    else:
        episodes = [os.path.join(root, e) for e in sorted(os.listdir(root))
                    if os.path.isdir(os.path.join(root, e, "panorama"))]
    end = config.data.end_idx if config.data.end_idx >= 0 else len(episodes)
    episodes = episodes[config.data.start_idx:end]
    reconstructor = None
    if any(os.path.isdir(_pers_dir(ep)) and not _rendered(ep, config) for ep in episodes):
        reconstructor = build_reconstructor("tiny" if rt.vggt_tiny else "full", rt.seed, dtype, dev,
                                            vggt_checkpoint=rt.vggt_checkpoint,
                                            allow_random_weights=rt.allow_random_weights,
                                            mesh=mesh if rt.vggt_mesh else None)
    records = []
    for ep in episodes:
        timings: dict = {}
        rendered = process_episode(ep, reconstructor, config, dev, timings, writes)
        if mesh is not None:  # the renders are on disk before any rank looks at the next episode's or returns
            torch.distributed.barrier()
        records.append(dict(episode=ep, rendered=rendered, stage_seconds=timings))
    return records


if __name__ == "__main__":
    main()
