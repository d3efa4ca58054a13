"""Equirect -> perspective crops that look ahead (counterpart of
`evoworld_tpu/cli/pano_to_pers.py`), the first step of preparing training
episodes.

Per episode, each panorama frame (`panorama/*.png` or `*.jpg`) is resampled
to a `loop.pers_height` x `loop.pers_width` pinhole view of
`loop.pers_fov_x` degrees whose yaw points at a future camera (the look-at
anchor of its segment, row (segment + 1) * 24 + 24): the crops go to
`perspective_look_at_center/{001..}.png`, quantized by truncation, and the
camera file with those yaws to `camera_poses_look_at_center.txt`. The yaw
arithmetic runs on the host in float64 on the float32 poses, as in the JAX
CLI, so the camera file's text is the same. An episode whose crop directory
holds as many files as its panorama directory is skipped.

Usage (on the card):
  python -m evoworld_tpu_torch.cli.pano_to_pers --data.root=<dataset or episode>

From Python, `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from evoworld_tpu_torch.cli.common import load_frames, logger, parse_config, to_uint8
from evoworld_tpu_torch.data.dataset import load_camera_poses
from evoworld_tpu_torch.data.native_io import save_png_batch
from evoworld_tpu_torch.device import resolve_device
from evoworld_tpu_torch.geometry.resample import equi_to_pers

CHUNK = 16  # panoramas decoded, cropped and written together


def crop_frames(paths, yaws, config, dev) -> np.ndarray:
    """(N, pers_height, pers_width, 3) uint8 crops of the panoramas at `paths`,
    each turned by its yaw (radians), on `dev`."""
    cfg = config.loop
    crops = [equi_to_pers(torch.from_numpy(img).to(dev), yaw=yaw, out_height=cfg.pers_height,
                          out_width=cfg.pers_width, fov_x_deg=cfg.pers_fov_x)
             for img, yaw in zip(load_frames(paths), yaws, strict=True)]
    return to_uint8(torch.stack(crops))


def look_at_yaws(cam: np.ndarray, n_frames: int, num_target_view: int) -> list[float]:
    """Each frame's yaw difference (radians) to its segment's look-at camera."""
    yaws = []
    for i in range(n_frames):
        seg = i // (num_target_view + 1)
        look_at_idx = min((seg + 1) * num_target_view + num_target_view, len(cam) - 1)
        cur, look = cam[min(i, len(cam) - 1)], cam[look_at_idx]
        yaws.append(math.radians(cur[4]) - math.atan2(look[0] - cur[0], look[2] - cur[2]))
    return yaws


def process_episode(ep_dir: str, config, dev) -> int:
    """Crop one episode; returns the crops written (0 when it is skipped)."""
    out_dir = os.path.join(ep_dir, "perspective_look_at_center")
    pano_dir = os.path.join(ep_dir, "panorama")
    if os.path.isdir(out_dir) and len(os.listdir(out_dir)) >= len(os.listdir(pano_dir)):
        logger.info(f"skip {ep_dir} (already done)")
        return 0
    os.makedirs(out_dir, exist_ok=True)

    cam = load_camera_poses(os.path.join(ep_dir, "camera_poses.txt"))
    names = sorted(f for f in os.listdir(pano_dir) if f.endswith((".png", ".jpg")))
    yaws = look_at_yaws(cam, len(names), config.loop.num_target_view)
    for at in range(0, len(names), CHUNK):
        paths = [os.path.join(pano_dir, n) for n in names[at:at + CHUNK]]
        save_png_batch([os.path.join(out_dir, f"{i + 1:03d}.png") for i in range(at, at + len(paths))],
                       crop_frames(paths, yaws[at:at + CHUNK], config, dev))
    new_cam = cam.copy()
    n = min(len(names), len(new_cam))
    new_cam[:n, 4] = [math.degrees(y) for y in yaws[:n]]
    with open(os.path.join(ep_dir, "camera_poses_look_at_center.txt"), "w") as f:
        f.write("Frame,PosX,PosY,PosZ,RotX,RotY,RotZ\n")
        for i, row in enumerate(new_cam):
            f.write(f"{i + 1}," + ",".join(f"{v:.6f}" for v in row) + "\n")
    logger.info(f"wrote {len(names)} perspective frames for {ep_dir}")
    return len(names)


def main(argv=None, device: str | torch.device = "cuda") -> int:
    """Run the CLI; returns the crops written over all episodes."""
    config = parse_config(argv, __doc__)
    dev = resolve_device(device)
    root = config.data.root
    if os.path.isdir(os.path.join(root, "panorama")):
        episodes = [root]
    else:
        episodes = [os.path.join(root, e) for e in sorted(os.listdir(root))
                    if os.path.isdir(os.path.join(root, e, "panorama"))]
    return sum(process_episode(ep, config, dev) for ep in episodes)


if __name__ == "__main__":
    main()
