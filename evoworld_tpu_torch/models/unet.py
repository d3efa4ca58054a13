"""Spatio-temporal conditional UNet (SVD architecture, 18-channel input).

Counterpart of `evoworld_tpu/models/unet.py`, with diffusers'
`UNetSpatioTemporalConditionModel` parameter names: conv_in, time/added-time
embeddings, 4 down blocks (cross, cross, cross, plain), mid block, 4 up
blocks, conv_norm_out/conv_out. Activations are (B*F, C, H, W).

`forward(..., frames=FrameShard)` runs the UNet over this rank's frames of
every batch row (the frame-sharded training step): every block takes the
shard and the cross-frame layers of `models/layers.py` reach the other
ranks. Under block remat the recomputation repeats those collectives in the
backward, in the same order on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from evoworld_tpu_torch.models.layers import (
    Downsample2D,
    GroupNorm,
    SpatioTemporalResBlock,
    TimestepEmbedding,
    TransformerSpatioTemporalModel,
    Upsample2D,
    sinusoidal_time_embedding,
)
from evoworld_tpu_torch.parallel.mesh import FrameShard


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Architecture hyperparameters (SVD-XT defaults with EvoWorld's 18-channel input)."""

    in_channels: int = 18
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    transformer_layers_per_block: int = 1
    # Down/up block types by level: 0..2 cross-attention, 3 plain.
    cross_attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    # Recompute every down, mid and up block in the backward pass instead of
    # keeping its activations (gradient checkpointing) while grad is enabled.
    remat: bool = False


def _st_res(in_ch: int, out_ch: int, temb_ch: int) -> SpatioTemporalResBlock:
    return SpatioTemporalResBlock(in_ch, out_ch, temb_ch, eps=1e-5, temporal_eps=1e-5)


class DownBlock(nn.Module):
    """layers_per_block x (res block [+ transformer]), optional downsample.

    With `heads` it is diffusers' CrossAttnDownBlockSpatioTemporal, without
    it DownBlockSpatioTemporal.
    """

    def __init__(self, in_ch, out_ch, temb_ch, num_layers, add_downsample, heads=None, cross_dim=1024,
                 transformer_layers=1):
        super().__init__()
        self.resnets = nn.ModuleList([_st_res(in_ch if i == 0 else out_ch, out_ch, temb_ch) for i in range(num_layers)])
        self.attentions = None
        if heads is not None:
            self.attentions = nn.ModuleList([
                TransformerSpatioTemporalModel(heads, out_ch // heads, out_ch, cross_dim, transformer_layers)
                for _ in range(num_layers)
            ])
        self.downsamplers = nn.ModuleList([Downsample2D(out_ch)]) if add_downsample else None

    def forward(self, x, temb, context, num_frames, indicator, frames=None):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb, num_frames, indicator, frames)
            if self.attentions is not None:
                x = self.attentions[i](x, context, num_frames, indicator, frames)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class UpBlock(nn.Module):
    """(layers_per_block + 1) x (skip-concat res block [+ transformer]), optional upsample."""

    def __init__(self, res_in_chs, out_ch, temb_ch, add_upsample, heads=None, cross_dim=1024,
                 transformer_layers=1):
        super().__init__()
        self.resnets = nn.ModuleList([_st_res(c, out_ch, temb_ch) for c in res_in_chs])
        self.attentions = None
        if heads is not None:
            self.attentions = nn.ModuleList([
                TransformerSpatioTemporalModel(heads, out_ch // heads, out_ch, cross_dim, transformer_layers)
                for _ in res_in_chs
            ])
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)]) if add_upsample else None

    def forward(self, x, skips, temb, context, num_frames, indicator, frames=None):
        """`skips`: this block's skip activations, the last consumed first."""
        for i, resnet in enumerate(self.resnets):
            x = torch.cat([x, skips[-1 - i]], dim=1)
            x = resnet(x, temb, num_frames, indicator, frames)
            if self.attentions is not None:
                x = self.attentions[i](x, context, num_frames, indicator, frames)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    """res -> transformer -> res (diffusers UNetMidBlockSpatioTemporal)."""

    def __init__(self, ch, temb_ch, heads, cross_dim, transformer_layers=1):
        super().__init__()
        self.resnets = nn.ModuleList([_st_res(ch, ch, temb_ch), _st_res(ch, ch, temb_ch)])
        self.attentions = nn.ModuleList(
            [TransformerSpatioTemporalModel(heads, ch // heads, ch, cross_dim, transformer_layers)]
        )

    def forward(self, x, temb, context, num_frames, indicator, frames=None):
        x = self.resnets[0](x, temb, num_frames, indicator, frames)
        x = self.attentions[0](x, context, num_frames, indicator, frames)
        return self.resnets[1](x, temb, num_frames, indicator, frames)


class UNetSpatioTemporal(nn.Module):
    """The full UNet.

    forward(sample (B, F, C_in, H, W), timestep (scalar or (B,)), context
    (B, 1, cross_dim), added_time_ids (B, 3)) -> (B, F, out_channels, H, W);
    with `frames`, F is this rank's frame count and `image_only_indicator`
    (if given) holds this rank's frames.
    """

    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        self.config = cfg = config
        ch0 = cfg.block_out_channels[0]
        temb_ch = ch0 * 4
        n = len(cfg.block_out_channels)
        tl = cfg.transformer_layers_per_block

        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb_ch)
        self.add_embedding = TimestepEmbedding(cfg.addition_time_embed_dim * 3, temb_ch)

        self.down_blocks = nn.ModuleList()
        skip_chs = [ch0]
        in_ch = ch0
        for i, out_ch in enumerate(cfg.block_out_channels):
            last = i == n - 1
            heads = cfg.num_attention_heads[i] if cfg.cross_attn_blocks[i] else None
            self.down_blocks.append(DownBlock(
                in_ch, out_ch, temb_ch, cfg.layers_per_block, not last, heads, cfg.cross_attention_dim, tl))
            skip_chs += [out_ch] * cfg.layers_per_block + ([] if last else [out_ch])
            in_ch = out_ch

        self.mid_block = MidBlock(
            cfg.block_out_channels[-1], temb_ch, cfg.num_attention_heads[-1], cfg.cross_attention_dim, tl)

        self.up_blocks = nn.ModuleList()
        x_ch = cfg.block_out_channels[-1]
        for i in range(n):
            level = n - 1 - i
            out_ch = cfg.block_out_channels[level]
            res_in = []
            for _ in range(cfg.layers_per_block + 1):
                res_in.append(x_ch + skip_chs.pop())
                x_ch = out_ch
            heads = cfg.num_attention_heads[level] if cfg.cross_attn_blocks[level] else None
            self.up_blocks.append(UpBlock(
                res_in, out_ch, temb_ch, i != n - 1, heads, cfg.cross_attention_dim, tl))

        self.conv_norm_out = GroupNorm(ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,
        timestep: torch.Tensor,
        context: torch.Tensor,
        added_time_ids: torch.Tensor,
        image_only_indicator: Optional[torch.Tensor] = None,
        frames: Optional[FrameShard] = None,
    ) -> torch.Tensor:
        cfg = self.config
        batch, num_frames = sample.shape[:2]
        if frames is not None and frames.count != num_frames:
            raise ValueError(f"the sample holds {num_frames} frames, the frame shard {frames.count}")
        if frames is not None and frames.axis.size == 1:
            frames = None
        dtype = sample.dtype
        ch0 = cfg.block_out_channels[0]

        timesteps = torch.as_tensor(timestep, device=sample.device).reshape(-1).expand(batch)
        emb = self.time_embedding(sinusoidal_time_embedding(timesteps, ch0).to(dtype))
        add = sinusoidal_time_embedding(added_time_ids.reshape(-1), cfg.addition_time_embed_dim)
        emb = emb + self.add_embedding(add.reshape(batch, -1).to(dtype))

        # Per-frame replication: everything below runs on (B*F, ...).
        emb = emb.repeat_interleave(num_frames, dim=0)
        context = context.repeat_interleave(num_frames, dim=0)
        if image_only_indicator is None:
            image_only_indicator = torch.zeros((batch, num_frames), dtype=dtype, device=sample.device)

        def run(block, *args):
            if cfg.remat and torch.is_grad_enabled():
                return checkpoint(block, *args, use_reentrant=False)
            return block(*args)

        x = self.conv_in(sample.flatten(0, 1))
        skips = [x]
        for block in self.down_blocks:
            x, s = run(block, x, emb, context, num_frames, image_only_indicator, frames)
            skips.extend(s)
        x = run(self.mid_block, x, emb, context, num_frames, image_only_indicator, frames)
        for block in self.up_blocks:
            n = len(block.resnets)
            x = run(block, x, skips[-n:], emb, context, num_frames, image_only_indicator, frames)
            del skips[-n:]

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.view(batch, num_frames, *x.shape[1:])
