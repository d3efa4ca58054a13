"""The full metric harness: reference-format `eval_score.json` entries
(counterpart of `evoworld_tpu/eval/harness.py`).

The aggregated result has the keys fvd / ssim / psnr / lpips / latent_mse /
loop_closure_latent_mse of the reference's `calculate_all_metrics.py`, each

    {"value": {timestamp: mean}, "value_mean": float,
     "value_std": {timestamp: std},      # absent for fvd
     "video_setting": ..., "video_setting_name": ...}

Videos are numpy (N, F, H, W, 3) in [0, 1]; each video goes to `device`
(CUDA unless the caller asks for the CPU) as it is scored. The feature nets
(LPIPS-Alex, Inception-v4, I3D) load upstream torch weights where given;
without them each draws its own from a CPU torch.Generator seeded with 0 (so
the card and the CPU score with the same nets) and the result carries `"weights": "random_seed0_torch"`, comparable across the
port's runs but neither with the reference nor with the JAX package's
"random_seed0" numbers. All compute is fp32, TF32 off on the card
(`metrics.full_fp32`). The frames' resizes are `jax.image.resize`'s
(`ops/resize.py::resize_half_pixel`): bilinear with antialiasing to 299 for
Inception and for LPIPS' upscale of frames under 64 px, without it for I3D.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from evoworld_tpu_torch.device import resolve_device
from evoworld_tpu_torch.eval import weights as ew
from evoworld_tpu_torch.eval.feature_nets import InceptionI3D, LPIPSAlex, i3d_preprocess
from evoworld_tpu_torch.eval.inception_v4 import InceptionV4Features
from evoworld_tpu_torch.eval.metrics import frechet_distance, full_fp32, psnr, ssim
from evoworld_tpu_torch.models.vggt.aggregator import IMAGENET_MEAN, IMAGENET_STD
from evoworld_tpu_torch.models.weights import init_random_
from evoworld_tpu_torch.ops.resize import resize_half_pixel


def _result(per_video_per_frame: np.ndarray, video_setting, extra=None) -> dict:
    """(N, F) per-video per-frame values -> the reference's result dict."""
    arr = np.asarray(per_video_per_frame, np.float64)
    out = {
        "value": {int(t): float(arr[:, t].mean()) for t in range(arr.shape[1])},
        "value_mean": float(arr.mean()),
        "value_std": {int(t): float(arr[:, t].std()) for t in range(arr.shape[1])},
        "video_setting": list(video_setting),
        "video_setting_name": "time, channel, heigth, width",
    }
    if extra:
        out.update(extra)
    return out


def _frame_setting(videos: np.ndarray):
    n, f, h, w, c = videos.shape
    return (f, c, h, w)


@torch.no_grad()
def _per_frame(fn, gen: np.ndarray, gt: np.ndarray, device) -> np.ndarray:
    """fn(generated frames, GT frames) -> (F,) per video, stacked to (N, F),
    one video at a time on `device`."""
    dev = resolve_device(device)
    with full_fp32():
        return np.stack([fn(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)).cpu().numpy()
                         for a, b in zip(gen, gt)])


def calculate_psnr(gen: np.ndarray, gt: np.ndarray, device: str | torch.device = "cuda") -> dict:
    """(N, F, H, W, 3) [0, 1] videos -> the reference-format PSNR result."""
    return _result(_per_frame(psnr, gen, gt, device), _frame_setting(gen))


def calculate_ssim(gen: np.ndarray, gt: np.ndarray, device: str | torch.device = "cuda") -> dict:
    return _result(_per_frame(ssim, gen, gt, device), _frame_setting(gen))


class FeatureNets:
    """The metric nets on `device`, built at first use, each from its upstream
    torch state dict in `weights` ("lpips" | "inception_v4" | "i3d", as
    `eval.weights.load_metric_weights` returns them) or random from a CPU
    generator seeded with 0 (the same weights on every device), then moved
    to `device`."""

    _NETS = {
        "lpips": (LPIPSAlex, ew.lpips_state_dict),
        "inception_v4": (InceptionV4Features, ew.inception_v4_state_dict),
        "i3d": (InceptionI3D, ew.i3d_state_dict),
    }

    def __init__(self, weights: Optional[dict] = None, device: str | torch.device = "cuda"):
        self.weights = weights or {}
        self.device = resolve_device(device)
        self._cache: dict[str, nn.Module] = {}

    def tag(self, name: str) -> str:
        return "converted" if name in self.weights else ew.RANDOM_TAG

    def net(self, name: str) -> nn.Module:
        if name not in self._cache:
            cls, to_port = self._NETS[name]
            model = cls()
            if name in self.weights:
                ew.load_net_(model, to_port(self.weights[name]))
            else:  # batch-norm statistics stay fresh: mean 0, variance 1
                init_random_(model, torch.Generator().manual_seed(0))
            self._cache[name] = model.to(self.device).eval().requires_grad_(False)
        return self._cache[name]


@torch.no_grad()
def calculate_lpips(gen: np.ndarray, gt: np.ndarray, nets: FeatureNets) -> dict:
    """LPIPS-Alex per frame ([-1, 1] inputs, spatial mean). Frames under 64 px
    on a side are upscaled first: AlexNet's stride-4 stem and two max pools
    leave nothing of smaller maps."""
    net, dev = nets.net("lpips"), nets.device
    n, f, h, w = gen.shape[:4]
    size = None
    if min(h, w) < 64:
        scale = 64 / min(h, w)
        size = (int(round(h * scale)), int(round(w * scale)))
    vals = np.zeros((n, f))
    with full_fp32():
        for i in range(n):
            a, b = (torch.as_tensor(v[i], device=dev) for v in (gen, gt))
            if size is not None:
                a, b = resize_half_pixel(a, size), resize_half_pixel(b, size)
            vals[i] = net(a * 2.0 - 1.0, b * 2.0 - 1.0).cpu().numpy()
    setting = (f, 3) + (size or (h, w))
    return _result(vals, setting, {"weights": nets.tag("lpips")})


def _inception_preprocess(frames: torch.Tensor) -> torch.Tensor:
    """(M, H, W, 3) [0, 1] -> (M, 299, 299, 3) ImageNet-normalised."""
    x = resize_half_pixel(frames, (299, 299))
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


@torch.no_grad()
def calculate_latent_mse(gen: np.ndarray, gt: np.ndarray, nets: FeatureNets) -> dict:
    """Inception-v4 feature MSE per frame: squared feature differences
    averaged over the videos and the 1536 channels at each timestamp."""
    net, dev = nets.net("inception_v4"), nets.device
    n, f = gen.shape[:2]
    fg = np.zeros((n, f, 1536), np.float32)
    fr = np.zeros((n, f, 1536), np.float32)
    with full_fp32():
        for i in range(n):
            fg[i] = net(_inception_preprocess(torch.as_tensor(gen[i], device=dev))).cpu().numpy()
            fr[i] = net(_inception_preprocess(torch.as_tensor(gt[i], device=dev))).cpu().numpy()
    sq = (fg - fr) ** 2
    mse_t = sq.mean(axis=(0, 2))
    std_t = sq.std(axis=(0, 2))
    return {
        "value": {int(t): float(mse_t[t]) for t in range(f)},
        "value_mean": float(mse_t.mean()),
        "value_std": {int(t): float(std_t[t]) for t in range(f)},
        "video_setting": list(_frame_setting(gen)),
        "video_setting_name": "time, channel, heigth, width",
        "weights": nets.tag("inception_v4"),
    }


@torch.no_grad()
def calculate_fvd_batch(gen: np.ndarray, gt: np.ndarray, nets: FeatureNets, min_timestamp: int = 10,
                        batch_size: int = 10, i3d_size: int = 224) -> dict:
    """FVD for each clip length min_timestamp..F (I3D features of the first
    t frames, `batch_size` videos a call)."""
    net, dev = nets.net("i3d"), nets.device
    n, f = gen.shape[:2]

    def feats(videos, t):
        out = []
        for start in range(0, n, batch_size):
            clip = torch.as_tensor(videos[start : start + batch_size, :t], device=dev)
            out.append(net(i3d_preprocess(clip, i3d_size)).cpu().numpy())
        return np.concatenate(out)

    results = {}
    with full_fp32():
        for t in range(min_timestamp, f + 1):
            results[int(t)] = frechet_distance(feats(gen, t), feats(gt, t))
    return {
        "value": results,
        "value_mean": float(np.mean(list(results.values()))),
        "fvd_setting": "styleganv-equivalent-i3d",
        "weights": nets.tag("i3d"),
        "video_setting": list(gen.shape[:2]) + [3, gen.shape[2], gen.shape[3]],
        "video_setting_name": "batch_size, channel, time, height, width",
    }


def calculate_all_metrics(gen: np.ndarray, gt: np.ndarray, nets: Optional[FeatureNets] = None,
                          with_fvd: bool = True, i3d_size: int = 224,
                          device: str | torch.device = "cuda") -> dict:
    """(N, F, H, W, 3) [0, 1] videos -> the full reference-format result (FVD
    only with at least 2 videos of at least 10 frames). `nets` default to
    random ones on `device`; the nets' device is the one used."""
    nets = nets or FeatureNets(device=device)
    result = {}
    if with_fvd and gen.shape[0] >= 2 and gen.shape[1] >= 10:
        result["fvd"] = calculate_fvd_batch(gen, gt, nets, i3d_size=i3d_size)
    result["ssim"] = calculate_ssim(gen, gt, nets.device)
    result["psnr"] = calculate_psnr(gen, gt, nets.device)
    result["lpips"] = calculate_lpips(gen, gt, nets)
    result["latent_mse"] = calculate_latent_mse(gen, gt, nets)
    result["loop_closure_latent_mse"] = calculate_latent_mse(gen[:, -1:], gt[:, -1:], nets)
    return result
