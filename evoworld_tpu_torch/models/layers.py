"""Building blocks of the spatio-temporal UNet and temporal VAE.

Counterpart of `evoworld_tpu/models/layers.py`, written the PyTorch way:
channels-first (B*F, C, H, W) activations, temporal tensors (B, C, F, H, W),
and diffusers' parameter names (conv1/norm1/time_emb_proj/to_out.0/ff.net.0.proj
...) so a diffusers state dict loads as it is. Norms keep fp32 statistics;
everything else computes in the activations' dtype.

Over a frame shard (`frames=`, a `parallel/mesh.py::FrameShard`: this rank
holds frames [start, stop) of every batch row, the frame-sharded training
step), everything per frame runs on the rank's frames alone, and the three
operations that cross frames do what the JAX package's GSPMD partitioning
of the same layers does:
  - `TemporalResnetBlock`: its GroupNorms take their statistics over
    (C / G, F, H, W) summed over the ranks (the mean, then the centred
    squares); its (3, 1, 1) convolutions take one frame of halo from each
    neighbour, zeros only at the clip's two ends;
  - `TemporalBasicTransformerBlock`: an all-to-all moves the frame shard to
    a shard of tokens with every frame, the block runs there, and a second
    all-to-all moves it back (each rank's activations about 1 / W of the
    whole);
  - `TransformerSpatioTemporalModel`: the frames' positional embedding takes
    their global indices.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from evoworld_tpu_torch.ops.attention import multi_head_attention
from evoworld_tpu_torch.parallel.collectives import frames_to_tokens, halo, sum_over, tokens_to_frames
from evoworld_tpu_torch.parallel.mesh import FrameShard, split_sizes


def sinusoidal_time_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal features for (continuous) timesteps: (B,) -> (B, dim) fp32.

    SVD's convention: cos first, max period 10000, no frequency shift; `dim`
    is even (a channel count of the UNet).
    """
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    args = timesteps.float()[:, None] * torch.exp(exponent / half)[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP lifting sinusoidal features to the embed dim."""

    def __init__(self, in_dim: int, embed_dim: int, out_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, out_dim or embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the channel axis (dim 1) with fp32 statistics; over a
    frame shard of (B, C, F, H, W), statistics of the whole clip."""

    def __init__(self, num_channels: int, eps: float = 1e-5, num_groups: int = 32):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor, frames: Optional[FrameShard] = None) -> torch.Tensor:
        if frames is None:
            out = F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps)
            return out.to(x.dtype)
        b, c = x.shape[:2]
        xg = x.float().reshape(b, self.num_groups, -1)
        count = xg.shape[-1] // frames.count * frames.total  # (C / G) * H * W of every frame
        mean = sum_over(xg.sum(-1), frames.axis)[..., None] / count
        centred = xg - mean
        var = sum_over(centred.square().sum(-1), frames.axis)[..., None] / count
        out = (centred * torch.rsqrt(var + self.eps)).reshape(x.shape)
        affine = (1, c) + (1,) * (x.dim() - 2)
        return (out * self.weight.float().view(affine) + self.bias.float().view(affine)).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with fp32 statistics, output in `out_dtype`
    (default: the input's dtype)."""

    def __init__(self, dim: int, eps: float = 1e-5, out_dtype: Optional[torch.dtype] = None):
        super().__init__(dim, eps=eps)
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)
        return out.to(self.out_dtype or x.dtype)


class Attention(nn.Module):
    """diffusers `Attention` as the SVD UNet uses it: no q/k/v bias, output
    projection with bias, scale 1/sqrt(head_dim). (B, S, C) in and out."""

    def __init__(self, query_dim: int, heads: int, head_dim: int, cross_dim: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(cross_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(cross_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, sq, skv = x.shape[0], x.shape[1], ctx.shape[1]
        q = self.to_q(x).view(b, sq, self.heads, self.head_dim)
        k = self.to_k(ctx).view(b, skv, self.heads, self.head_dim)
        v = self.to_v(ctx).view(b, skv, self.heads, self.head_dim)
        out = multi_head_attention(q, k, v).reshape(b, sq, self.heads * self.head_dim)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    """diffusers GEGLU: hidden, gate = proj(x).chunk(2); hidden * gelu(gate), exact GELU."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hidden, gate = self.proj(x).chunk(2, dim=-1)
        return hidden * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU transformer MLP (dim -> mult*dim -> dim), named net.0.proj / net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv3x3 (+temb) -> GN -> SiLU -> conv3x3, plus the residual."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int], eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = GroupNorm(out_channels, eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return residual + h


class TemporalResnetBlock(nn.Module):
    """Residual block convolving along frames: (B, C, F, H, W), kernel (3, 1, 1)."""

    def __init__(self, channels: int, temb_channels: Optional[int], eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(channels, eps)
        self.conv1 = nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))
        self.time_emb_proj = nn.Linear(temb_channels, channels) if temb_channels else None
        self.norm2 = GroupNorm(channels, eps)
        self.conv2 = nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                frames: Optional[FrameShard] = None) -> torch.Tensor:
        h = _frame_conv(self.conv1, F.silu(self.norm1(x, frames)), frames)
        if temb is not None:
            # temb: (B, F, C_t) -> (B, C, F, 1, 1), added per frame.
            h = h + self.time_emb_proj(F.silu(temb)).permute(0, 2, 1)[:, :, :, None, None]
        h = _frame_conv(self.conv2, F.silu(self.norm2(h, frames)), frames)
        return x + h


def _frame_conv(conv: nn.Conv3d, x: torch.Tensor, frames: Optional[FrameShard]) -> torch.Tensor:
    """A (3, 1, 1) convolution over (B, C, F, H, W); over a frame shard, on
    the rank's frames between their neighbours' halo frames."""
    if frames is None:
        return conv(x)
    prev, nxt = halo(x, frames, dim=2)
    return F.conv3d(torch.cat([prev, x, nxt], dim=2), conv.weight, conv.bias)


class AlphaBlender(nn.Module):
    """Learned scalar blend of the spatial and temporal branches.

    alpha = sigmoid(mix_factor), forced to 1 where `image_only_indicator` is
    set (it arrives already shaped to broadcast against the inputs).
    `switch_to_temporal_mix` swaps the roles (the VAE decoder's blocks).
    """

    def __init__(self, alpha: float = 0.5, switch_to_temporal_mix: bool = False):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.tensor([alpha]))
        self.switch_to_temporal_mix = switch_to_temporal_mix

    def forward(
        self,
        x_spatial: torch.Tensor,
        x_temporal: torch.Tensor,
        image_only_indicator: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        alpha = torch.sigmoid(self.mix_factor.float())[0]
        if image_only_indicator is not None:
            alpha = torch.where(image_only_indicator.bool(), torch.ones_like(alpha), alpha)
        alpha = alpha.to(x_spatial.dtype)
        if self.switch_to_temporal_mix:
            alpha = 1.0 - alpha
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class SpatioTemporalResBlock(nn.Module):
    """Spatial ResNet -> temporal ResNet -> learned alpha blend, on (B*F, C, H, W)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int],
        eps: float = 1e-6,
        temporal_eps: float = 1e-6,
        merge_strategy_switch: bool = False,
        merge_alpha_init: float = 0.5,
    ):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_channels, out_channels, temb_channels, eps)
        self.temporal_res_block = TemporalResnetBlock(out_channels, temb_channels, temporal_eps)
        self.time_mixer = AlphaBlender(merge_alpha_init, merge_strategy_switch)

    def forward(
        self,
        x: torch.Tensor,
        temb: Optional[torch.Tensor],
        num_frames: int,
        image_only_indicator: Optional[torch.Tensor] = None,
        frames: Optional[FrameShard] = None,
    ) -> torch.Tensor:
        h = self.spatial_res_block(x, temb)
        bf, ch, height, width = h.shape
        batch = bf // num_frames
        h5 = h.view(batch, num_frames, ch, height, width).permute(0, 2, 1, 3, 4)
        temb5 = temb.view(batch, num_frames, -1) if temb is not None else None
        ht = self.temporal_res_block(h5, temb5, frames)
        ind = image_only_indicator[:, None, :, None, None] if image_only_indicator is not None else None
        mixed = self.time_mixer(h5, ht, ind)
        return mixed.permute(0, 2, 1, 3, 4).reshape(bf, ch, height, width)


class BasicTransformerBlock(nn.Module):
    """Spatial transformer block: self-attn, cross-attn, GEGLU FF, pre-LN."""

    def __init__(self, dim: int, heads: int, head_dim: int, cross_dim: Optional[int]):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, head_dim, cross_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class TemporalBasicTransformerBlock(nn.Module):
    """Temporal transformer block: attends across frames for each spatial token.

    (B*F, S, C) in and out; internally (B*S, F, C). Over a frame shard, (B*F_local,
    S, C) in and out and (B*S_local, F, C) inside; `context` then has
    B*S_local rows.
    """

    def __init__(self, dim: int, heads: int, head_dim: int, cross_dim: Optional[int]):
        super().__init__()
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, head_dim, cross_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, num_frames: int, context: Optional[torch.Tensor] = None,
                frames: Optional[FrameShard] = None) -> torch.Tensor:
        bf, seq, ch = x.shape
        batch = bf // num_frames
        h = x.view(batch, num_frames, seq, ch)
        if frames is not None:
            h = frames_to_tokens(h, frames)
        f_all, tokens = h.shape[1:3]
        h = h.permute(0, 2, 1, 3).reshape(batch * tokens, f_all, ch)
        h = h + self.ff_in(self.norm_in(h))
        h = h + self.attn1(self.norm1(h))
        if context is not None:
            h = h + self.attn2(self.norm2(h), context)
        h = h + self.ff(self.norm3(h))
        h = h.view(batch, tokens, f_all, ch).permute(0, 2, 1, 3)
        if frames is not None:
            h = tokens_to_frames(h, frames, seq)
        return h.reshape(bf, seq, ch)


class TransformerSpatioTemporalModel(nn.Module):
    """Spatial + temporal transformer pair with learned time mixing, (B*F, C, H, W).

    The temporal branch gets a per-frame positional embedding and
    cross-attends to the first frame's context.
    """

    def __init__(self, heads: int, head_dim: int, in_channels: int, cross_dim: int = 1024, num_layers: int = 1):
        super().__init__()
        inner = heads * head_dim
        self.inner = inner
        self.norm = GroupNorm(in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, head_dim, cross_dim) for _ in range(num_layers)]
        )
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(inner, heads, head_dim, cross_dim) for _ in range(num_layers)]
        )
        self.time_pos_embed = TimestepEmbedding(inner, inner * 4, inner)
        self.time_mixer = AlphaBlender()
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(
        self,
        x: torch.Tensor,
        context: torch.Tensor,
        num_frames: int,
        image_only_indicator: Optional[torch.Tensor] = None,
        frames: Optional[FrameShard] = None,
    ) -> torch.Tensor:
        bf, ch, height, width = x.shape
        batch = bf // num_frames
        seq = height * width
        residual = x

        # Temporal cross-attention context: the first frame's (every frame's is the same), for every token
        # (over a frame shard, for this rank's tokens).
        tokens = seq if frames is None else split_sizes(seq, frames.axis.size)[frames.axis.rank]
        ctx_first = context.view(batch, num_frames, -1, context.shape[-1])[:, 0]
        time_context = ctx_first[:, None].expand(batch, tokens, *ctx_first.shape[1:])
        time_context = time_context.reshape(batch * tokens, *ctx_first.shape[1:])

        h = self.norm(x).permute(0, 2, 3, 1).reshape(bf, seq, ch)
        h = self.proj_in(h)

        first = 0 if frames is None else frames.start  # the global index of the first frame held
        frame_idx = torch.arange(first, first + num_frames, dtype=torch.float32, device=x.device).repeat(batch)
        emb = self.time_pos_embed(sinusoidal_time_embedding(frame_idx, self.inner).to(x.dtype))[:, None, :]

        ind = image_only_indicator[:, :, None, None] if image_only_indicator is not None else None
        for block, tblock in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h = block(h, context)
            h_mix = tblock(h + emb, num_frames, time_context, frames)
            h = self.time_mixer(
                h.view(batch, num_frames, seq, self.inner),
                h_mix.view(batch, num_frames, seq, self.inner),
                ind,
            ).reshape(bf, seq, self.inner)

        h = self.proj_out(h)
        return h.view(bf, height, width, ch).permute(0, 3, 1, 2) + residual


class Downsample2D(nn.Module):
    """Strided 3x3 conv: symmetric padding in the UNet, (0, 1) in the VAE encoder."""

    def __init__(self, channels: int, asymmetric_padding: bool = False):
        super().__init__()
        self.asymmetric_padding = asymmetric_padding
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0 if asymmetric_padding else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric_padding:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
