"""Metric aggregation over prediction directories -> eval_score.json
(counterpart of `evoworld_tpu/cli/calculate_metrics.py`).

Loads the last `pipeline.num_frames` PNGs of each episode's generated and
GT directories (through the port's C++ decoder, `data/native_io.py`),
computes fvd / ssim / psnr / lpips / latent_mse / loop_closure_latent_mse in
the reference's result structure (`eval/harness.py`) and writes
`<data.root>/eval_score.json`; prints a one-line JSON summary.

Feature-net weights: `--runtime.metric_weights_dir=<dir>` holding any of
lpips.pt / inception_v4.pt / i3d.pt (or i3d_torchscript.pt), upstream torch
state dicts; a net without weights draws its own at random and is tagged
`"weights": "random_seed0_torch"` (comparable across the port's runs only).

Usage (on the card):
  python -m evoworld_tpu_torch.cli.calculate_metrics --data.root=<save_dir> \\
      --data.sampling=predictions_2:predictions_gt_2
  (`data.sampling` doubles as "<generated subdir>:<GT subdir>")

From Python, `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from evoworld_tpu_torch.cli.common import logger, parse_config
from evoworld_tpu_torch.data.native_io import image_size, load_image_batch
from evoworld_tpu_torch.device import resolve_device
from evoworld_tpu_torch.eval.harness import FeatureNets, calculate_all_metrics
from evoworld_tpu_torch.eval.weights import load_metric_weights


_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point coefficients (Resample.c)


def _pil_bilinear_coeffs(in_size: int, out_size: int):
    """PIL's BILINEAR taps along one axis (`precompute_coeffs` and
    `normalize_coeffs_8bpc`): (first input index (out,), int64 weights
    (out, ksize)), the weights in 2^-22 units, zero past each output's taps."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = np.maximum(1.0 - np.abs((taps[None] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale)), 0.0)
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):  # summed tap by tap, in PIL's order
        ww += w[:, x]
    w = w / np.where(ww != 0.0, ww, 1.0)[:, None]
    fixed = np.where(w < 0, -0.5 + w * (1 << _PRECISION_BITS), 0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)
    return xmin, fixed


def _pil_bilinear_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass of PIL's 8-bit resample along `axis` of (H, W, C) uint8."""
    xmin, k = _pil_bilinear_coeffs(img.shape[axis], out_size)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None], img.shape[axis] - 1)   # (out, ksize)
    src = np.take(img, idx, axis=axis).astype(np.int64)       # axis becomes (out, ksize)
    kk = k.reshape((1,) * axis + k.shape + (1,) * (img.ndim - axis - 1))
    acc = (src * kk).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_bilinear_resize(img: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3) uint8, byte for byte PIL's
    `Image.resize((w, h), Image.BILINEAR)` on an RGB image: the antialiased
    triangle filter (support scaled by the reduction), coefficients in 22-bit
    fixed point, the horizontal pass first and rounded to 8 bits, each pass
    skipped where its size does not change."""
    h, w = size_hw
    if img.shape[1] != w:
        img = _pil_bilinear_pass(img, w, axis=1)
    if img.shape[0] != h:
        img = _pil_bilinear_pass(img, h, axis=0)
    return img


def read_video_dir(path: str, num_frames: int, size_hw: tuple[int, int] | None = None) -> np.ndarray:
    """The last `num_frames` `.png` files of a directory (sorted by name; each
    decoded as the PNG or JPEG its first bytes name) -> (N, H, W, 3) float32
    in [0, 1]. Without `size_hw` the frames must share one size; with it,
    a frame of another size is resized to (H, W) as the JAX CLI's PIL route
    does (`pil_bilinear_resize` on its 8-bit values)."""
    names = sorted(f for f in os.listdir(path) if f.lower().endswith(".png"))[-num_frames:]
    paths = [os.path.join(path, n) for n in names]
    if size_hw is not None:
        out = np.empty((len(paths), *size_hw, 3), np.float32)
        for i, p in enumerate(paths):
            frame = load_image_batch([p], *image_size(p), minus1_1=False)[0]
            if frame.shape[:2] != tuple(size_hw):
                u8 = np.rint(frame * 255.0).astype(np.uint8)
                frame = pil_bilinear_resize(u8, size_hw).astype(np.float32) / 255.0
            out[i] = frame
        return out
    sizes = {image_size(p) for p in paths}
    if len(sizes) != 1:
        raise ValueError(f"{path}: frames of sizes {sorted(sizes)}; need one size")
    (h, w), = sizes
    return load_image_batch(paths, h, w, minus1_1=False)


def main(argv=None, device: str | torch.device = "cuda") -> dict:
    """Run the CLI; returns the scores written to eval_score.json."""
    config = parse_config(argv, __doc__)
    dev = resolve_device(device)
    root = config.data.root
    spec = config.data.sampling
    gen_subdir, gt_subdir = (spec.split(":") + ["predictions_gt_2"])[:2] if ":" in spec \
        else ("predictions_2", "predictions_gt_2")
    num_frames = config.pipeline.num_frames

    episodes = sorted(e for e in os.listdir(root) if os.path.isdir(os.path.join(root, e, gen_subdir)))
    if not episodes and os.path.isdir(os.path.join(root, gen_subdir)):
        episodes = [""]
    if not episodes:
        raise SystemExit(f"no episodes with {gen_subdir} under {root}")

    gen = [read_video_dir(os.path.join(root, e, gen_subdir), num_frames) for e in episodes]
    gt = [read_video_dir(os.path.join(root, e, gt_subdir), num_frames) for e in episodes]
    n_frames = min(min(v.shape[0] for v in gen), min(v.shape[0] for v in gt))
    gen = np.stack([v[-n_frames:] for v in gen])
    gt = np.stack([v[-n_frames:] for v in gt])
    logger.info(f"{len(episodes)} episodes, videos {gen.shape}")

    nets = FeatureNets(load_metric_weights(config.runtime.metric_weights_dir), device=dev)
    scores = calculate_all_metrics(gen, gt, nets=nets)
    scores["num_videos"] = int(gen.shape[0])

    out_path = os.path.join(root, "eval_score.json")
    with open(out_path, "w") as f:
        json.dump(scores, f, indent=2)
    logger.info(
        f"wrote {out_path}: psnr={scores['psnr']['value_mean']:.3f} "
        f"ssim={scores['ssim']['value_mean']:.4f} "
        f"lpips={scores['lpips']['value_mean']:.4f} "
        f"latent_mse={scores['latent_mse']['value_mean']:.5f}"
    )
    print(json.dumps({
        "psnr": scores["psnr"]["value_mean"],
        "ssim": scores["ssim"]["value_mean"],
        "lpips": scores["lpips"]["value_mean"],
        "latent_mse": scores["latent_mse"]["value_mean"],
        "loop_closure_latent_mse": scores["loop_closure_latent_mse"]["value_mean"],
        **({"fvd": scores["fvd"]["value_mean"]} if "fvd" in scores else {}),
    }))
    return scores


if __name__ == "__main__":
    main()
