"""Metric feature networks: InceptionI3D (FVD) and AlexNet-LPIPS
(counterpart of `evoworld_tpu/eval/feature_nets.py`).

Module and parameter names are upstream's, so their torch checkpoints load
with `load_state_dict`: the videogpt / piergiaj `pytorch_i3d.InceptionI3d`
(`Conv3d_1a_7x7.conv3d.weight`, `Mixed_3b.b1b.bn.running_mean`, ...,
`logits.conv3d.bias`) and the `lpips` package's `LPIPS(net="alex")`
(`scaling_layer.shift`, `net.slice{1..5}.<torchvision index>`,
`lin{0..4}.model.1.weight`). Batch norms run in eval mode with the JAX
package's epsilon (1e-5 for I3D). Convolutions pad as TF's "SAME" does
(for stride 2 at an even size that is one more pixel after than before),
as the upstream I3D computes it per call.

Layouts at the public functions are the JAX package's, channels-last: I3D
takes (N, T, H, W, 3) in [-1, 1], LPIPS (N, H, W, 3) pairs in [-1, 1].
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from evoworld_tpu_torch.ops.resize import resize_half_pixel


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF "SAME" padding (before, after) of one axis."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same_3d(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """Pad (N, C, T, H, W) with zeros for a TF-"SAME" 3D window."""
    pads = [same_padding(s, k, st) for s, k, st in zip(x.shape[2:], kernel, stride)]
    return F.pad(x, [p for pair in reversed(pads) for p in pair])


class MaxPool3dSame(nn.Module):
    """Max pool with TF-"SAME" zero padding (upstream MaxPool3dSamePadding;
    every input is post-ReLU, so zero padding equals -inf padding)."""

    def __init__(self, kernel, stride):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(_pad_same_3d(x, self.kernel, self.stride), self.kernel, self.stride)


class Unit3D(nn.Module):
    """Conv3d (TF-"SAME" padding) + eval-mode batch norm + ReLU."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1), stride=(1, 1, 1), use_bn: bool = True,
                 activation: bool = True):
        super().__init__()
        self.kernel, self.stride, self.activation = tuple(kernel), tuple(stride), activation
        self.conv3d = nn.Conv3d(cin, cout, self.kernel, self.stride, bias=not use_bn)
        self.bn = nn.BatchNorm3d(cout, eps=1e-5) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(_pad_same_3d(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionModule(nn.Module):
    """I3D mixing block: 1x1 | 1x1 -> 3x3x3 | 1x1 -> 3x3x3 | max pool -> 1x1."""

    def __init__(self, cin: int, out: tuple):
        super().__init__()
        self.b0 = Unit3D(cin, out[0])
        self.b1a = Unit3D(cin, out[1])
        self.b1b = Unit3D(out[1], out[2], (3, 3, 3))
        self.b2a = Unit3D(cin, out[3])
        self.b2b = Unit3D(out[3], out[4], (3, 3, 3))
        self.b3a = MaxPool3dSame((3, 3, 3), (1, 1, 1))
        self.b3b = Unit3D(cin, out[5])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), self.b3b(self.b3a(x))], dim=1)


_I3D_MIXED = (
    ("Mixed_3b", 192, (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", 256, (128, 128, 192, 32, 96, 64)),
    ("MaxPool3d_4a_3x3", (3, 3, 3), (2, 2, 2)),
    ("Mixed_4b", 480, (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", 512, (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", 512, (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", 512, (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", 528, (256, 160, 320, 32, 128, 128)),
    ("MaxPool3d_5a_2x2", (2, 2, 2), (2, 2, 2)),
    ("Mixed_5b", 832, (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", 832, (384, 192, 384, 48, 128, 128)),
)


class InceptionI3D(nn.Module):
    """I3D (Carreira & Zisserman) to `num_classes` logits averaged over time:
    (N, T, H, W, 3) in [-1, 1] -> (N, num_classes), the FVD feature.

    The head takes the spatial mean of Mixed_5c (the 7x7 average pool at a
    224 input, where the map is 7x7), a sliding temporal mean of width 2,
    the 1x1x1 logits convolution and the mean over the window positions, as
    the JAX package does.
    """

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.MaxPool3d_2a_3x3 = MaxPool3dSame((1, 3, 3), (1, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        self.MaxPool3d_3a_3x3 = MaxPool3dSame((1, 3, 3), (1, 2, 2))
        for name, a, b in _I3D_MIXED:
            self.add_module(name, InceptionModule(a, b) if name.startswith("Mixed") else MaxPool3dSame(a, b))
        self.logits = Unit3D(1024, num_classes, use_bn=False, activation=False)

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        x = videos.permute(0, 4, 1, 2, 3)                      # (N, 3, T, H, W)
        for name in ("Conv3d_1a_7x7", "MaxPool3d_2a_3x3", "Conv3d_2b_1x1", "Conv3d_2c_3x3", "MaxPool3d_3a_3x3"):
            x = getattr(self, name)(x)
        for name, _, _ in _I3D_MIXED:
            x = getattr(self, name)(x)
        x = x.mean(dim=(3, 4), keepdim=True)                    # spatial
        if x.shape[2] > 1:
            x = (x[:, :, :-1] + x[:, :, 1:]) / 2                # temporal window 2
        return self.logits(x).mean(dim=(2, 3, 4))


# torchvision AlexNet `features` indices of the five convolutions, by the
# lpips package's slice that holds each: (slice, index, out, kernel, stride, pad).
_ALEX = ((1, 0, 64, 11, 4, 2), (2, 3, 192, 5, 1, 2), (3, 6, 384, 3, 1, 1), (4, 8, 256, 3, 1, 1),
         (5, 10, 256, 3, 1, 1))


class AlexNetFeatures(nn.Module):
    """AlexNet's conv tower as lpips slices it: the five ReLU maps."""

    def __init__(self):
        super().__init__()
        cin = 3
        for s, idx, cout, k, stride, pad in _ALEX:
            slice_ = nn.Module()
            slice_.add_module(str(idx), nn.Conv2d(cin, cout, k, stride, pad))
            self.add_module(f"slice{s}", slice_)
            cin = cout

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for s, idx, *_ in _ALEX:
            if s in (2, 3):  # max pool after the first two ReLU maps
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(getattr(getattr(self, f"slice{s}"), str(idx))(x))
            feats.append(x)
        return feats


class ScalingLayer(nn.Module):
    """lpips' input normalisation of [-1, 1] images."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188])[None, :, None, None])
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450])[None, :, None, None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.shift) / self.scale


class NetLinLayer(nn.Module):
    """lpips' 1x1 calibration head (`model.0` is its dropout)."""

    def __init__(self, cin: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(cin, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class LPIPSAlex(nn.Module):
    """LPIPS distance with the AlexNet backbone: (N, H, W, 3) pairs in
    [-1, 1] -> (N,), each layer's channel-normalised squared difference
    weighted by its head and averaged over space, summed over the layers."""

    def __init__(self):
        super().__init__()
        self.scaling_layer = ScalingLayer()
        self.net = AlexNetFeatures()
        for i, (_, _, cout, *_) in enumerate(_ALEX):
            self.add_module(f"lin{i}", NetLinLayer(cout))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.net(self.scaling_layer(x.permute(0, 3, 1, 2)))
        fy = self.net(self.scaling_layer(y.permute(0, 3, 1, 2)))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
            total = total + getattr(self, f"lin{i}")((a - b) ** 2)[:, 0].mean(dim=(1, 2))
        return total


def i3d_preprocess(videos: torch.Tensor, target: int = 224) -> torch.Tensor:
    """(N, T, H, W, 3) [0, 1] -> I3D input in [-1, 1]: the shorter side
    scaled to `target` (bilinear, half-pixel centres, no antialiasing, as the
    reference's F.interpolate), then the central target x target square."""
    n, t, h, w, c = videos.shape
    scale = target / min(h, w)
    rh, rw = (target, math.ceil(w * scale)) if h < w else (math.ceil(h * scale), target)
    out = resize_half_pixel(videos.float(), (rh, rw), antialias=False)
    h0, w0 = (rh - target) // 2, (rw - target) // 2
    return out[:, :, h0 : h0 + target, w0 : w0 + target] * 2.0 - 1.0
