"""Sky segmentation for filtering sky points out of a reconstruction
(counterpart of `evoworld_tpu/memory/skyseg.py`).

The upstream reprojection runs `skyseg.onnx`, a U^2-Net, at 320x320 through
onnxruntime, min-max normalizes its map to [0, 255] and multiplies point
confidences by (mask > 0.01). Here the net is `memory/u2net.py`, filled from
the ONNX file's initializers (read by `memory/onnx_io.py`, no onnx package)
by `load_state_dict` under their upstream names, and run in fp32 with TF32
off (`eval.metrics.full_fp32`), as a fixed fp32 net whatever the runtime's
compute dtype. Without a weights file a brightness and smoothness heuristic
stands in.

The pre- and post-processing are the JAX module's: a 320x320 bilinear resize
with `jax.image.resize`'s antialias (`ops/resize.py::resize_half_pixel`),
ImageNet normalization, min-max to [0, 255] per image, floor, a bilinear
resize back to the image's size, and 255 where that is under 1 (not sky),
else 0. Images are channels-last (N, H, W, 3) in [0, 1].
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from evoworld_tpu_torch.device import resolve_device
from evoworld_tpu_torch.eval.metrics import full_fp32
from evoworld_tpu_torch.memory.u2net import U2Net
from evoworld_tpu_torch.ops.resize import resize_half_pixel

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_WRAPPER_PREFIXES = ("u2net.", "model.", "module.")
NET_SIZE = 320
CHUNK = 16  # crops through the net at a time


def load_u2net_state_(net: U2Net, tensors: Mapping[str, np.ndarray | torch.Tensor]) -> U2Net:
    """Fill `net` from upstream-named tensors (a `torch.onnx.export`'s
    initializers or a state dict): wrapper prefixes some exporters add are
    stripped and batch norms' counters may be absent; raises ValueError
    naming what is missing or left over."""
    state = {}
    for key, value in tensors.items():
        for prefix in _WRAPPER_PREFIXES:
            key = key.removeprefix(prefix)
        if not key.endswith("num_batches_tracked"):
            state[key] = torch.tensor(np.asarray(value, np.float32))
    missing, unexpected = net.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"U^2-Net weights do not fit the net: missing {missing[:4]}, unexpected {unexpected[:4]} "
                         f"({len(missing)} and {len(unexpected)} in all)")
    return net


class SkySegmentation:
    """The sky mask of `weights_path` (a skyseg.onnx), or of the heuristic
    where it is None, on `device`."""

    def __init__(self, weights_path: Optional[str] = None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.net = None
        if weights_path:
            from evoworld_tpu_torch.memory.onnx_io import read_onnx_initializers

            self.net = load_u2net_state_(U2Net(), read_onnx_initializers(weights_path)).to(self.device).eval()

    @torch.no_grad()
    def sky_masks(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) RGB in [0, 1] -> (N, H, W) fp32 masks: 0 on sky, 255 elsewhere."""
        images = torch.as_tensor(images).to(self.device, torch.float32)
        if self.net is None:
            return torch.stack([sky_mask_heuristic(img) for img in images])
        h, w = images.shape[1:3]
        mean = torch.tensor(_IMAGENET_MEAN, device=self.device)
        std = torch.tensor(_IMAGENET_STD, device=self.device)
        with full_fp32():  # the resizes are matmuls too
            out = torch.cat([
                self.net(((resize_half_pixel(images[at:at + CHUNK], (NET_SIZE, NET_SIZE)) - mean) / std)
                         .permute(0, 3, 1, 2))[:, 0]
                for at in range(0, len(images), CHUNK)])
            lo = out.amin(dim=(1, 2), keepdim=True)
            hi = out.amax(dim=(1, 2), keepdim=True)
            norm = torch.floor((out - lo) / torch.clamp(hi - lo, min=1e-12) * 255.0)  # the uint8 grid
            full = resize_half_pixel(norm[..., None], (h, w))[..., 0]
        return torch.where(full < 1.0, 255.0, 0.0)

    def apply_to_conf(self, conf: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
        """Zero the (N, h, w) confidences on sky pixels; masks of another size
        than the confidences are resized to theirs (bilinear) first."""
        masks = self.sky_masks(images)
        if masks.shape[1:] != conf.shape[1:]:
            masks = resize_half_pixel(masks[..., None], tuple(conf.shape[1:]))[..., 0]
        return conf * (masks > 0.01).to(conf.dtype)


def sky_mask_heuristic(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) [0, 1] -> (H, W) mask, 0 on sky and 255 elsewhere, with no
    weights: bright, smooth, blue-ish pixels in the upper 60% of the image."""
    h = image.shape[0]
    lum = image.mean(-1)
    gx = torch.abs(torch.diff(lum, dim=1, append=lum[:, -1:]))
    gy = torch.abs(torch.diff(lum, dim=0, append=lum[-1:, :]))
    smooth = (gx + gy) < 0.02
    bright = lum > 0.55
    blueish = image[..., 2] >= image[..., 0] - 0.05
    upper = (torch.arange(h, device=image.device) < h * 0.6)[:, None]
    return torch.where(smooth & bright & blueish & upper, 0.0, 255.0)


def apply_sky_mask(conf: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """The heuristic's masks applied to (N, h, w) confidences of (N, h, w, 3) images."""
    masks = torch.stack([sky_mask_heuristic(img) for img in images])
    return conf * (masks > 0.01).to(conf.dtype)
