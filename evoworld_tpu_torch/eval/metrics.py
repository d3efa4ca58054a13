"""Evaluation metrics: PSNR, SSIM, Frechet distance (counterpart of
`evoworld_tpu/eval/metrics.py`).

The reference harness's formulas (PSNR of [0, 1] images, 100 below an MSE of
1e-10; SSIM with an 11x11 sigma-1.5 Gaussian window, reflect-101 borders, a
5-pixel valid crop, C1 = 0.01^2, C2 = 0.03^2, averaged over channels; the
Frechet distance between Gaussian feature moments), on torch tensors of
any device, batched over leading axes instead of one call per frame.

SSIM's variance terms E[x^2] - mu^2 cancel, so its Gaussian filter must be
true fp32: on the card `full_fp32` switches TF32 off for matmuls and cuDNN
convolutions while the metric computes and restores the caller's flags (the
JAX package asks for `Precision.HIGHEST` for the same reason). Images are
channels-last, (..., H, W, C) in [0, 1].
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_fp32():
    """fp32 matmuls and cuDNN convolutions (no TF32) inside, whatever the
    caller set; the caller's flags come back on exit."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PSNR of (..., H, W, C) [0, 1] images -> (...) fp32."""
    mse = ((img1.float() - img2.float()) ** 2).mean(dim=(-3, -2, -1))
    return torch.where(mse < 1e-10, torch.full_like(mse, 100.0), 20.0 * torch.log10(1.0 / torch.sqrt(mse)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    # Normalised in float64 on the host (the reference's cv2 path), then fp32.
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    g = g / g.sum()
    return torch.from_numpy(np.outer(g, g).astype(np.float32))


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """SSIM of (..., H, W, C) [0, 1] images -> (...) fp32: per channel the
    mean of the cropped SSIM map, then the mean over channels.

    The filtered moments are taken of the images less 0.5 (the variances
    do not move; the means get 0.5 back): E[x^2] - E[x]^2 of values near
    0.5 cancels most of its digits, and oneDNN's fp32 convolution on the
    CPU then left SSIM 2e-5 from its float64 value on noisy 8-bit frames
    (the JAX package's, 1e-6)."""
    lead, (h, w, c) = img1.shape[:-3], img1.shape[-3:]
    x = img1.float().reshape(-1, h, w, c).permute(0, 3, 1, 2).reshape(-1, 1, h, w) - 0.5
    y = img2.float().reshape(-1, h, w, c).permute(0, 3, 1, 2).reshape(-1, 1, h, w) - 0.5
    window = _gaussian_window().to(x.device)
    k = window.shape[0]
    maps = torch.cat([x, y, x * x, y * y, x * y], dim=1)                 # (N*C, 5, H, W)
    with full_fp32():
        maps = F.pad(maps, (k // 2,) * 4, mode="reflect")
        filtered = F.conv2d(maps, window.expand(5, 1, k, k).contiguous(), groups=5)
    m1, m2, e11, e22, e12 = filtered[:, :, 5:-5, 5:-5].unbind(1)
    s1, s2, s12 = e11 - m1**2, e22 - m2**2, e12 - m1 * m2
    mu1, mu2 = m1 + 0.5, m2 + 0.5
    mu1_sq, mu2_sq, mu12 = mu1**2, mu2**2, mu1 * mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return ssim_map.mean(dim=(-2, -1)).reshape(-1, c).mean(-1).reshape(lead)


def frechet_distance(feats1: np.ndarray, feats2: np.ndarray) -> float:
    """Frechet distance between Gaussians fit to (N, D) feature sets, on the
    host (numpy and scipy); with one sample on either side only the means'
    term (the reference's styleganv FVD skips the covariance then)."""
    from scipy.linalg import sqrtm

    mu1, mu2 = feats1.mean(0), feats2.mean(0)
    diff = mu1 - mu2
    if feats1.shape[0] <= 1 or feats2.shape[0] <= 1:
        return float(diff @ diff)
    sigma1 = np.cov(feats1, rowvar=False)
    sigma2 = np.cov(feats2, rowvar=False)
    covmean = sqrtm(sigma1 @ sigma2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def batch_video_metrics(gen, gt) -> dict:
    """Per-frame PSNR and SSIM over (N, F, H, W, C) [0, 1] videos (tensors
    or arrays; `gt` moves to `gen`'s device), 8 frames at a time.

    Returns {"psnr": mean, "ssim": mean, "psnr_per_frame": (F,),
    "ssim_per_frame": (F,)}: the mean over videos per timestamp, then over
    timestamps, as the reference aggregates."""
    gen = torch.as_tensor(gen)
    gt = torch.as_tensor(gt, device=gen.device)
    if gen.shape != gt.shape:
        raise ValueError(f"video shapes differ: {tuple(gen.shape)} and {tuple(gt.shape)}")
    n, f = gen.shape[:2]
    a, b = gen.reshape(n * f, *gen.shape[2:]), gt.reshape(n * f, *gt.shape[2:])
    psnr_vals = torch.cat([psnr(x, y) for x, y in zip(a.split(8), b.split(8))]).reshape(n, f)
    ssim_vals = torch.cat([ssim(x, y) for x, y in zip(a.split(8), b.split(8))]).reshape(n, f)
    psnr_vals, ssim_vals = psnr_vals.double().cpu().numpy(), ssim_vals.double().cpu().numpy()
    return {
        "psnr": float(psnr_vals.mean()),
        "ssim": float(ssim_vals.mean()),
        "psnr_per_frame": psnr_vals.mean(0),
        "ssim_per_frame": ssim_vals.mean(0),
    }
