"""U^2-Net salient-object segmentation, the net behind the sky segmentation's
`skyseg.onnx` (counterpart of `evoworld_tpu/memory/u2net.py`).

The published U2NET(3, 1) (Qin et al., Pattern Recognition 2020,
xuebinqin/U-2-Net `u2net.py`) under its upstream module names
(`stageN.rebnconvM.conv_s1` / `bn_s1`, `sideN`, `outconv`), so that the
initializers a `torch.onnx.export` of it embeds load by `load_state_dict`
(`memory/skyseg.py`). NCHW; batch norm in eval mode (eps 1e-5); 2x2 max-pool
with ceil_mode (odd sizes pad); every upsampling through
`ops/resize.py::resize_half_pixel`, `jax.image.resize`'s bilinear
arithmetic, which for upsampling is torch's align_corners=False bilinear.

Structure:
  encoder  : RSU7(3,32,64) RSU6(64,32,128) RSU5(128,64,256) RSU4(256,128,512)
             RSU4F(512,256,512) RSU4F(512,256,512), 2x maxpool between
  decoder  : RSU4F(1024,256,512) RSU4(1024,128,256) RSU5(512,64,128)
             RSU6(256,32,64) RSU7(128,16,64), bilinear upsample + concat skips
  heads    : six 3x3 side convs -> 1 channel, upsampled to the input's size,
             concatenated -> 1x1 fuse conv; the fused map through a sigmoid.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from evoworld_tpu_torch.ops.resize import resize_half_pixel


def _upsample_like(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize of (N, C, h, w) to (N, C, *hw)."""
    return resize_half_pixel(x.permute(0, 2, 3, 1), tuple(hw)).permute(0, 3, 1, 2)


class REBNCONV(nn.Module):
    """3x3 conv (dilation `dirate`) + batch norm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate, dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn_s1(self.conv_s1(x)))


class RSU(nn.Module):
    """Residual U-block of `height` levels (RSU7 ... RSU4)."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", REBNCONV(mid_ch, mid_ch))
        setattr(self, f"rebnconv{height}", REBNCONV(mid_ch, mid_ch, dirate=2))
        for i in range(height - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", REBNCONV(mid_ch * 2, mid_ch))
        self.rebnconv1d = REBNCONV(mid_ch * 2, out_ch)
        self.pool = nn.MaxPool2d(2, stride=2, ceil_mode=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        enc = [self.rebnconv1(hxin)]
        h = enc[0]
        for i in range(2, self.height):
            h = getattr(self, f"rebnconv{i}")(self.pool(h))
            enc.append(h)
        d = getattr(self, f"rebnconv{self.height}")(h)
        for i in range(self.height - 1, 0, -1):
            d = getattr(self, f"rebnconv{i}d")(torch.cat((d, enc[i - 1]), 1))
            if i > 1:
                d = _upsample_like(d, enc[i - 2].shape[2:])
        return d + hxin


class RSU4F(nn.Module):
    """Dilated residual U-block without pooling."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, dirate=1)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, dirate=2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, dirate=4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, dirate=8)
        self.rebnconv3d = REBNCONV(mid_ch * 2, mid_ch, dirate=4)
        self.rebnconv2d = REBNCONV(mid_ch * 2, mid_ch, dirate=2)
        self.rebnconv1d = REBNCONV(mid_ch * 2, out_ch, dirate=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        d3 = self.rebnconv3d(torch.cat((h4, h3), 1))
        d2 = self.rebnconv2d(torch.cat((d3, h2), 1))
        d1 = self.rebnconv1d(torch.cat((d2, h1), 1))
        return d1 + hxin


class U2Net(nn.Module):
    """U2NET(3, 1): (N, 3, H, W) -> the fused sigmoid saliency map (N, 1, H, W),
    the first output of the ONNX session, the only one the sky mask reads."""

    def __init__(self):
        super().__init__()
        self.stage1 = RSU(7, 3, 32, 64)
        self.stage2 = RSU(6, 64, 32, 128)
        self.stage3 = RSU(5, 128, 64, 256)
        self.stage4 = RSU(4, 256, 128, 512)
        self.stage5 = RSU4F(512, 256, 512)
        self.stage6 = RSU4F(512, 256, 512)
        self.stage5d = RSU4F(1024, 256, 512)
        self.stage4d = RSU(4, 1024, 128, 256)
        self.stage3d = RSU(5, 512, 64, 128)
        self.stage2d = RSU(6, 256, 32, 64)
        self.stage1d = RSU(7, 128, 16, 64)
        for i, ch in enumerate((64, 64, 128, 256, 512, 512), start=1):
            setattr(self, f"side{i}", nn.Conv2d(ch, 1, 3, padding=1))
        self.outconv = nn.Conv2d(6, 1, 1)
        self.pool = nn.MaxPool2d(2, stride=2, ceil_mode=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hx1 = self.stage1(x)
        hx2 = self.stage2(self.pool(hx1))
        hx3 = self.stage3(self.pool(hx2))
        hx4 = self.stage4(self.pool(hx3))
        hx5 = self.stage5(self.pool(hx4))
        hx6 = self.stage6(self.pool(hx5))
        hx5d = self.stage5d(torch.cat((_upsample_like(hx6, hx5.shape[2:]), hx5), 1))
        hx4d = self.stage4d(torch.cat((_upsample_like(hx5d, hx4.shape[2:]), hx4), 1))
        hx3d = self.stage3d(torch.cat((_upsample_like(hx4d, hx3.shape[2:]), hx3), 1))
        hx2d = self.stage2d(torch.cat((_upsample_like(hx3d, hx2.shape[2:]), hx2), 1))
        hx1d = self.stage1d(torch.cat((_upsample_like(hx2d, hx1.shape[2:]), hx1), 1))
        size = x.shape[2:]
        sides = [self.side1(hx1d)] + [
            _upsample_like(getattr(self, f"side{i}")(h), size)
            for i, h in enumerate((hx2d, hx3d, hx4d, hx5d, hx6), start=2)]
        return torch.sigmoid(self.outconv(torch.cat(sides, 1)))
