"""Antialiased resize + separable Gaussian blur (counterpart of `evoworld_tpu/ops/resize.py`).

Downscales the first frame to 224x224 for CLIP: sigma = max((factor-1)/2,
1e-3), an odd kernel of about 4 sigma, reflect padding, then bicubic
interpolation with torch's align_corners=True convention (a = -0.75) as two
small matmuls. Channels-last (N, H, W, C) at the public functions, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel1d(size: int, sigma: float, dtype: torch.dtype, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    if size % 2 == 0:
        x = x + 0.5
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).to(dtype)


def gaussian_blur2d(
    images: torch.Tensor, kernel_size: tuple[int, int], sigma: tuple[float, float]
) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding, (N, H, W, C)."""
    ky, kx = kernel_size
    c = images.shape[-1]
    kernel_x = _gaussian_kernel1d(kx, sigma[1], images.dtype, images.device)
    kernel_y = _gaussian_kernel1d(ky, sigma[0], images.dtype, images.device)
    x = images.permute(0, 3, 1, 2)  # NCHW for conv2d
    x = F.pad(x, ((kx - 1) // 2, kx - 1 - (kx - 1) // 2, 0, 0), mode="reflect")
    x = F.conv2d(x, kernel_x.view(1, 1, 1, kx).expand(c, 1, 1, kx), groups=c)
    x = F.pad(x, (0, 0, (ky - 1) // 2, ky - 1 - (ky - 1) // 2), mode="reflect")
    x = F.conv2d(x, kernel_y.view(1, 1, ky, 1).expand(c, 1, ky, 1), groups=c)
    return x.permute(0, 2, 3, 1)


def resize_antialiased(images: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Gaussian-prefiltered bicubic resize, (N, H, W, C) -> (N, h, w, C)."""
    h, w = images.shape[1], images.shape[2]
    oh, ow = out_hw
    factor_h, factor_w = h / oh, w / ow
    sigma_h = max((factor_h - 1.0) / 2.0, 0.001)
    sigma_w = max((factor_w - 1.0) / 2.0, 0.001)
    ky = int(max(2.0 * 2 * sigma_h, 3))
    kx = int(max(2.0 * 2 * sigma_w, 3))
    ky += 1 - ky % 2
    kx += 1 - kx % 2
    if factor_h > 1.0 or factor_w > 1.0:
        images = gaussian_blur2d(images, (ky, kx), (sigma_h, sigma_w))
    return bicubic_align_corners(images, (oh, ow))


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (torch bicubic's a = -0.75)."""
    t = np.abs(t)
    return np.where(
        t <= 1.0,
        (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0,
        np.where(t < 2.0, a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a, 0.0),
    )


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bicubic interpolation weights, align_corners=True."""
    pos = np.zeros((1,)) if n_out == 1 else np.arange(n_out) * (n_in - 1) / (n_out - 1)
    base = np.floor(pos).astype(int)
    frac = pos - base
    w = np.zeros((n_out, n_in), np.float32)
    for k in range(-1, 3):
        idx = np.clip(base + k, 0, n_in - 1)
        w[np.arange(n_out), idx] += _cubic_kernel(k - frac).astype(np.float32)
    return w


def bicubic_align_corners(images: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Separable align-corners bicubic resize of (N, H, W, C) via two matmuls."""
    h, w = images.shape[1], images.shape[2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return images
    wh = torch.from_numpy(_resize_matrix(h, oh)).to(images.device, images.dtype)
    ww = torch.from_numpy(_resize_matrix(w, ow)).to(images.device, images.dtype)
    x = torch.einsum("oh,nhwc->nowc", wh, images)
    return torch.einsum("pw,nowc->nopc", ww, x)
