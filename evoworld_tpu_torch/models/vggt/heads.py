"""VGGT heads (counterpart of `evoworld_tpu/models/vggt/heads.py`): the
iterative camera head and the DPT dense head, with upstream
facebookresearch/vggt parameter names (`camera_head.trunk.N`,
`poseLN_modulation.1`, `depth_head.projects.N`, `resize_layers.N`,
`scratch.refinenetN.resConfUnitM.convK` ...).

The DPT head runs channels-first inside and returns channels-last
(N, H, W, C), the JAX module's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from evoworld_tpu_torch.models.layers import LayerNorm
from evoworld_tpu_torch.models.vggt.aggregator import LN_EPS, Block
from evoworld_tpu_torch.ops.resize import bilinear_align_corners_nchw


class PoseBranch(nn.Module):
    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim // 2)
        self.fc2 = nn.Linear(dim // 2, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class CameraHead(nn.Module):
    """(B, S, dim_in) camera tokens -> (B, S, 9) fp32 pose encoding.

    Each of `num_iters` refinements embeds the current estimate, modulates
    the tokens with an adaptive LayerNorm (shift, scale, gate), runs the
    trunk (attending across frames; no QK norm, upstream's Block defaults)
    and adds a predicted delta.
    """

    def __init__(self, dim_in: int = 2048, trunk_depth: int = 4, num_heads: int = 16,
                 num_iters: int = 4, out_dim: int = 9):
        super().__init__()
        self.num_iters, self.out_dim = num_iters, out_dim
        self.token_norm = LayerNorm(dim_in, LN_EPS)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, out_dim))
        self.embed_pose = nn.Linear(out_dim, dim_in)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(dim_in, 3 * dim_in))
        self.trunk = nn.ModuleList([Block(dim_in, num_heads, 4.0, False, 0.01) for _ in range(trunk_depth)])
        self.trunk_norm = LayerNorm(dim_in, LN_EPS)
        self.pose_branch = PoseBranch(dim_in, out_dim)

    def forward(self, camera_tokens: torch.Tensor) -> torch.Tensor:
        b, s, d = camera_tokens.shape
        dtype = camera_tokens.dtype
        tokens = self.token_norm(camera_tokens)
        modulated_in = F.layer_norm(tokens.float(), (d,), eps=LN_EPS).to(dtype)  # adaLN: no affine
        pose = self.empty_pose_tokens.float().expand(b, s, self.out_dim)
        for it in range(self.num_iters):
            shift, scale, gate = self.poseLN_modulation(self.embed_pose(pose.to(dtype))).chunk(3, dim=-1)
            h = gate * (modulated_in * (1.0 + scale) + shift) + tokens
            for block in self.trunk:
                h = block(h)
            delta = self.pose_branch(self.trunk_norm(h)).float()
            pose = delta if it == 0 else pose + delta
        return pose


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    features: int = 256
    out_channels: int = 2              # depth + confidence
    layer_dims: Tuple[int, ...] = (256, 512, 1024, 1024)
    dim: int = 2048                    # aggregator tap width (frame || global)
    patch_size: int = 14


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """RefineNet fusion: x + (skip + unit1(skip)), then unit2, an align-corners
    upsample to `out_hw` and a 1x1 projection. resConfUnit1 exists in every
    block (upstream's state dict carries it), the coarsest never runs it."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None, out_hw) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        return self.out_conv(bilinear_align_corners_nchw(x, out_hw))


class DPTScratch(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        f = cfg.features
        for i, oc in enumerate(cfg.layer_dims):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(oc, f, 3, padding=1, bias=False))
        for j in range(1, 5):
            setattr(self, f"refinenet{j}", FeatureFusionBlock(f))
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
                                          nn.Conv2d(32, cfg.out_channels, 1))


class DPTHead(nn.Module):
    """Four tapped layers of patch tokens -> dense (N, H, W, out_channels).

    Reassemble: a 1x1 projection per layer, resampled to x4, x2, x1 and x0.5
    of the patch grid (transposed convs 4/4 and 2/2, identity, a 3x3 stride-2
    conv), a bias-free 3x3 `layerN_rn`; fuse top-down; then output_conv1, an
    align-corners upsample to the image and output_conv2.
    """

    def __init__(self, cfg: DPTConfig = DPTConfig()):
        super().__init__()
        dims = cfg.layer_dims
        self.projects = nn.ModuleList([nn.Conv2d(cfg.dim, oc, 1) for oc in dims])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(dims[0], dims[0], 4, stride=4),
            nn.ConvTranspose2d(dims[1], dims[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(dims[3], dims[3], 3, stride=2, padding=1),
        ])
        self.scratch = DPTScratch(cfg)

    def forward(self, layer_tokens: Sequence[torch.Tensor], patch_hw, image_hw) -> torch.Tensor:
        """layer_tokens: 4 x (N, P, dim) patch tokens -> (N, H, W, out_channels)."""
        ph, pw = patch_hw
        sc = self.scratch
        feats = []
        for i, tokens in enumerate(layer_tokens):
            f = tokens.transpose(1, 2).reshape(tokens.shape[0], tokens.shape[2], ph, pw)
            f = self.resize_layers[i](self.projects[i](f))
            feats.append(getattr(sc, f"layer{i + 1}_rn")(f))
        x = sc.refinenet4(feats[3], None, feats[2].shape[-2:])
        x = sc.refinenet3(x, feats[2], feats[1].shape[-2:])
        x = sc.refinenet2(x, feats[1], feats[0].shape[-2:])
        x = sc.refinenet1(x, feats[0], (feats[0].shape[-2] * 2, feats[0].shape[-1] * 2))
        x = bilinear_align_corners_nchw(sc.output_conv1(x), image_hw)
        return sc.output_conv2(x).permute(0, 2, 3, 1)
