"""Resizes (counterpart of `evoworld_tpu/ops/resize.py`, and of the
`jax.image.resize` calls of the VGGT modules).

- `resize_antialiased`: downscales the first frame to 224x224 for CLIP:
  sigma = max((factor-1)/2, 1e-3), an odd kernel of about 4 sigma, reflect
  padding, then bicubic interpolation with torch's align_corners=True
  convention (a = -0.75) as two small matmuls.
- `resize_bilinear_align_corners`: the DPT head's upsampling (torch's
  align_corners=True bilinear), computed in fp32.
- `resize_half_pixel`: `jax.image.resize` with "bilinear" or "cubic" (Keys,
  a = -0.5): half-pixel centres, weights renormalised at the borders, and a
  kernel widened by the factor when downsampling (its antialias). VGGT's
  preprocessing upsamples 384x512 crops to 392x518, where no antialias term
  enters and it equals F.interpolate(mode="bilinear", align_corners=False);
  the positional embedding's 37x37 -> 28x37 bicubic resize downsamples;
  the evaluation harness resizes frames to 299 and 224 with it, and
  `antialias=False` serves I3D's preprocessing.
Channels-last (..., H, W, C) at the public functions, as in the JAX package.
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


def bilinear_align_corners_nchw(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Align-corners bilinear resize of (N, C, H, W), in fp32, returned in x's dtype."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x.float(), size=tuple(out_hw), mode="bilinear", align_corners=True).to(x.dtype)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True sampling (output pixel i samples
    input coordinate i*(H-1)/(H'-1)), on (..., H, W, C)."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    nchw = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    out = bilinear_align_corners_nchw(nchw, out_hw).permute(0, 2, 3, 1)
    return out.reshape(*lead, *out_hw, c)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel with a = -0.5, as `jax.image.resize`'s "cubic"."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_HALF_PIXEL_KERNELS = {"bilinear": lambda x: np.maximum(0.0, 1.0 - np.abs(x)), "cubic": _keys_cubic}


def _half_pixel_matrix(n_in: int, n_out: int, method: str, antialias: bool = True) -> np.ndarray:
    """(n_out, n_in) weights of `jax.image.resize` along one axis."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    # One rounding to fp32 of the exact (i + 0.5) * s - 0.5, as the fused
    # multiply-add of compiled code gives it (XLA's, and F.interpolate's).
    sample = ((np.arange(n_out) + 0.5) * np.float64(np.float32(inv_scale)) - 0.5).astype(np.float32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / np.float32(kernel_scale)
    weights = _HALF_PIXEL_KERNELS[method](x).astype(np.float32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0.0).T.astype(np.float32)


def resize_half_pixel(x: torch.Tensor, out_hw: tuple[int, int], method: str = "bilinear",
                      antialias: bool = True) -> torch.Tensor:
    """`jax.image.resize` over the H and W axes of (..., H, W, C), in fp32 and
    returned in x's dtype; an axis whose size does not change is left as it
    is. `antialias` False keeps the kernel's width when downsampling (plain
    half-pixel interpolation, `jax.image.resize(..., antialias=False)`)."""
    h, w = x.shape[-3], x.shape[-2]
    out = x.float()
    if out_hw[0] != h:
        wh = torch.from_numpy(_half_pixel_matrix(h, out_hw[0], method, antialias)).to(x.device)
        out = torch.einsum("oh,...hwc->...owc", wh, out)
    if out_hw[1] != w:
        ww = torch.from_numpy(_half_pixel_matrix(w, out_hw[1], method, antialias)).to(x.device)
        out = torch.einsum("pw,...hwc->...hpc", ww, out)
    return out.to(x.dtype)
