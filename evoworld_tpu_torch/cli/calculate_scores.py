"""Batch video-file scorer: navigated.mp4 against original.mp4 in each
subfolder (counterpart of `evoworld_tpu/cli/calculate_scores.py`).

Walks `--data.root`'s subfolders in sorted order, takes those holding both
`navigated.mp4` and `original.mp4`, decodes each (`data/native_video.py`:
the port's MPEG-4 Part 2 decoder, byte for byte OpenCV's decode of `mp4v`
files; H.264 and the other formats it refuses raise an error naming the
file), resizes every frame to 64x64 in OpenCV's bilinear arithmetic,
truncates every video to the shortest length, and scores the batch once:
FVD (with at least 2 pairs of at least 10 frames; else a warning), SSIM,
PSNR and LPIPS through `eval/harness.py`, in the reference's result
structure, printed as JSON and written to `<data.root>/scores.json`.

Feature-net weights: `--runtime.metric_weights_dir=<dir>` holding lpips.pt /
i3d.pt (or i3d_torchscript.pt), upstream torch state dicts; a net without
weights draws its own at random (`"weights": "random_seed0_torch"`).

Usage (on the card):
  python -m evoworld_tpu_torch.cli.calculate_scores --data.root=<folder> \\
      [--runtime.metric_weights_dir=<dir>]

From Python, `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from evoworld_tpu_torch.cli.common import logger, parse_config
from evoworld_tpu_torch.data.native_video import read_mp4, resize_linear_u8
from evoworld_tpu_torch.device import resolve_device
from evoworld_tpu_torch.eval.harness import (
    FeatureNets,
    calculate_fvd_batch,
    calculate_lpips,
    calculate_psnr,
    calculate_ssim,
)
from evoworld_tpu_torch.eval.weights import load_metric_weights


def load_video(path: str, target_size: int = 64) -> np.ndarray | None:
    """(T, target_size, target_size, 3) float32 RGB in [0, 1], each frame
    resized as `cv2.resize` resizes it (INTER_LINEAR, on its 8-bit values),
    or None for a file with no frames."""
    frames = read_mp4(path)
    if not len(frames):
        return None
    return resize_linear_u8(frames, target_size, target_size).astype(np.float32) / 255.0


def main(argv=None, device: str | torch.device = "cuda") -> dict:
    """Run the CLI; returns the scores written to scores.json."""
    config = parse_config(argv, __doc__)
    dev = resolve_device(device)
    root = config.data.root
    subfolders = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))

    navigated, original = [], []
    for sub in subfolders:
        nav_p = os.path.join(root, sub, "navigated.mp4")
        org_p = os.path.join(root, sub, "original.mp4")
        if not (os.path.exists(nav_p) and os.path.exists(org_p)):
            continue
        nav, org = load_video(nav_p), load_video(org_p)
        if nav is None or org is None:
            continue
        navigated.append(nav)
        original.append(org)

    if not navigated:
        raise SystemExit(f"no navigated.mp4/original.mp4 pairs under {root}")

    t = min(min(v.shape[0] for v in navigated), min(v.shape[0] for v in original))
    gen = np.stack([v[:t] for v in navigated])
    gt = np.stack([v[:t] for v in original])
    logger.info(f"{gen.shape[0]} video pairs, {t} frames @ {gen.shape[2]}x{gen.shape[3]}")

    nets = FeatureNets(load_metric_weights(config.runtime.metric_weights_dir), device=dev)

    result = {}
    if gen.shape[0] >= 2 and t >= 10:  # Frechet needs >= 2 videos, I3D >= 10 frames
        result["fvd"] = calculate_fvd_batch(gen, gt, nets=nets)
    else:
        logger.warning(
            f"fvd skipped: need >=2 video pairs and >=10 frames, have "
            f"{gen.shape[0]} pairs x {t} frames"
        )
    result["ssim"] = calculate_ssim(gen, gt, dev)
    result["psnr"] = calculate_psnr(gen, gt, dev)
    result["lpips"] = calculate_lpips(gen, gt, nets=nets)
    print(json.dumps(result, indent=4))
    out_path = os.path.join(root, "scores.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=4)
    logger.info(f"wrote {out_path}")
    return result


if __name__ == "__main__":
    main()
