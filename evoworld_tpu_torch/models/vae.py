"""VAE with temporal decoder (SVD's `AutoencoderKLTemporalDecoder`).

Counterpart of `evoworld_tpu/models/vae.py`, with diffusers' parameter names:
a standard SD image encoder (asymmetric (0, 1) downsample padding,
quant_conv, no post_quant_conv) and a decoder whose residual blocks carry a
frame-axis branch with switched learned mixing, plus a final depth-3
temporal output conv. Images are (N, 3, H, W), latents (N, 4, h, w).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from evoworld_tpu_torch.models.layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    SpatioTemporalResBlock,
    Upsample2D,
)
from evoworld_tpu_torch.ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4


class VAEAttention(nn.Module):
    """Mid-block spatial self-attention: GroupNorm -> q/k/v (with bias) ->
    attention with head_dim 512 -> out -> + residual."""

    def __init__(self, channels: int, head_dim: int = 512):
        super().__init__()
        self.heads = max(channels // head_dim, 1)
        self.group_norm = GroupNorm(channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(n, h * w, c)
        shape = (n, h * w, self.heads, c // self.heads)
        out = multi_head_attention(self.to_q(y).view(shape), self.to_k(y).view(shape), self.to_v(y).view(shape))
        out = self.to_out[0](out.reshape(n, h * w, c))
        return out.view(n, h, w, c).permute(0, 3, 1, 2) + x


class Encoder(nn.Module):
    """SD image encoder: (N, 3, H, W) -> (N, 2*latent, h, w) moments (before quant_conv)."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        chs = config.block_out_channels
        self.conv_in = nn.Conv2d(3, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        in_ch = chs[0]
        for i, ch in enumerate(chs):
            blk = nn.Module()  # diffusers' block: resnets + downsamplers
            blk.resnets = nn.ModuleList(
                [ResnetBlock2D(in_ch if j == 0 else ch, ch, None, eps=1e-6) for j in range(config.layers_per_block)]
            )
            blk.downsamplers = (
                nn.ModuleList([Downsample2D(ch, asymmetric_padding=True)]) if i != len(chs) - 1 else None
            )
            self.down_blocks.append(blk)
            in_ch = ch
        top = chs[-1]
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock2D(top, top, None, eps=1e-6) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(top)])
        self.conv_norm_out = GroupNorm(top, eps=1e-6)
        self.conv_out = nn.Conv2d(top, 2 * config.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                x = r(x)
            if blk.downsamplers is not None:
                x = blk.downsamplers[0](x)
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


def _decoder_block(in_ch: int, out_ch: int) -> SpatioTemporalResBlock:
    return SpatioTemporalResBlock(
        in_ch, out_ch, None, eps=1e-6, temporal_eps=1e-5, merge_strategy_switch=True, merge_alpha_init=0.0
    )


class TemporalDecoder(nn.Module):
    """SVD temporal decoder: (B*F, 4, h, w) latents -> (B*F, 3, H, W) frames."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        chs = config.block_out_channels
        top = chs[-1]
        self.conv_in = nn.Conv2d(config.latent_channels, top, 3, padding=1)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([_decoder_block(top, top), _decoder_block(top, top)])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(top)])
        rev = list(reversed(chs))
        self.up_blocks = nn.ModuleList()
        in_ch = top
        for i, ch in enumerate(rev):
            blk = nn.Module()  # diffusers' block: resnets + upsamplers
            blk.resnets = nn.ModuleList(
                [_decoder_block(in_ch if j == 0 else ch, ch) for j in range(config.layers_per_block + 1)]
            )
            blk.upsamplers = nn.ModuleList([Upsample2D(ch)]) if i != len(rev) - 1 else None
            self.up_blocks.append(blk)
            in_ch = ch
        self.conv_norm_out = GroupNorm(chs[0], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[0], 3, 3, padding=1)
        self.time_conv_out = nn.Conv3d(3, 3, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        x = self.conv_in(z)
        x = self.mid_block.resnets[0](x, None, num_frames)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x, None, num_frames)
        for blk in self.up_blocks:
            for r in blk.resnets:
                x = r(x, None, num_frames)
            if blk.upsamplers is not None:
                x = blk.upsamplers[0](x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        # Final temporal conv over the frame axis.
        bf, ch, height, width = x.shape
        x5 = x.view(bf // num_frames, num_frames, ch, height, width).permute(0, 2, 1, 3, 4)
        x5 = self.time_conv_out(x5)
        return x5.permute(0, 2, 1, 3, 4).reshape(bf, ch, height, width)


class AutoencoderKLTemporal(nn.Module):
    """Encoder + temporal decoder pair."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.decoder = TemporalDecoder(config)

    def encode_moments(self, images: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) -> (N, 8, h, w) mean/logvar moments."""
        return self.quant_conv(self.encoder(images))

    def encode_mode(self, images: torch.Tensor) -> torch.Tensor:
        """Deterministic latent (the distribution's mode): the first 4 channels."""
        return self.encode_moments(images)[:, : self.config.latent_channels]

    def encode_sample(self, images: torch.Tensor, noise: torch.Tensor, chunk: int = 0) -> torch.Tensor:
        """A sample of the posterior, fp32: mean + exp(0.5 * clip(logvar, -30, 20)) * noise.

        `images` (N, 3, H, W) are encoded `chunk` at a time (0: all at once) in
        the module's dtype; `noise` is (N, 4, h, w) standard normal.
        """
        dtype = next(self.parameters()).dtype
        moments = torch.cat([
            self.encode_moments(part.to(dtype)).float() for part in images.split(chunk or images.shape[0])
        ])
        mean, logvar = moments.chunk(2, dim=1)
        return mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * noise

    def decode(self, latents: torch.Tensor, num_frames: int) -> torch.Tensor:
        """(B*F, 4, h, w) unscaled latents -> (B*F, 3, H, W) in [-1, 1]."""
        return self.decoder(latents, num_frames)
