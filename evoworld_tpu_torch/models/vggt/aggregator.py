"""VGGT aggregator: a DINOv2-style patch encoder, then alternating frame-wise
and global attention (counterpart of `evoworld_tpu/models/vggt/aggregator.py`).

Parameter names are upstream facebookresearch/vggt's
(`aggregator.patch_embed.blocks.N...`, `aggregator.frame_blocks.N`,
`aggregator.global_blocks.N`, `camera_token` (1, 2, 1, C),
`register_token` (1, 2, R, C)), as
`evoworld_tpu/models/vggt/weights.py::convert_vggt_state_dict` reads them.
Images arrive channels-last (B, S, H, W, 3) in [0, 1]; LayerNorms keep fp32
statistics (epsilon 1e-6, Flax's default); everything else computes in the
activations' dtype.

Attention goes through `ops/attention.py::multi_head_attention`: the frame
attention (1041 tokens a frame at 392x518) takes the plain route, the global
attention (frames x 1041 tokens, 16 heads x 64) the Hopper flash kernel on
the card. With a mesh (`forward(images, mesh)`), each rank runs the
per-frame work (patch encoder, frame blocks) on its share of the frames
when the mesh size divides the frame count (else every rank runs all of
them); the tokens are all-gathered before each global block, which every
rank runs whole with its attention on the mesh routes
(`ops/attention.py::head_sharded_attention`), and each rank keeps its own
frames' rows after it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from evoworld_tpu_torch.models.layers import LayerNorm
from evoworld_tpu_torch.ops.attention import head_sharded_attention, multi_head_attention
from evoworld_tpu_torch.ops.resize import resize_half_pixel

LN_EPS = 1e-6
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24            # pairs of (frame, global) attention blocks
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    qk_norm: bool = True
    layerscale_init: float = 0.01
    # Block pairs whose (frame || global) outputs feed the DPT heads; the last
    # must be depth - 1 (it also feeds the camera head).
    output_layers: Tuple[int, ...] = (4, 11, 17, 23)
    # The grid the positional embedding is stored at (518 / 14 = 37 a side).
    base_patch_hw: Tuple[int, int] = (37, 37)
    patch_encoder_depth: int = 24
    dino_num_register_tokens: int = 4


def rope_2d(t: torch.Tensor, positions: torch.Tensor, base: float = 100.0) -> torch.Tensor:
    """Upstream VGGT's 2D rotary embedding on (B, S, H, Dh) q or k.

    The first half of the head dim rotates by the token's y, the second by x,
    each GPT-NeoX style (angles repeated twice, rotate-half pairing).
    positions: (S, 2) integer (y, x); zero rows rotate by 0.
    """
    half = t.shape[-1] // 2

    def rope1d(x, pos):
        dim = x.shape[-1]
        inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim))
        ang = pos.float()[:, None] * inv[None]
        emb = torch.cat([ang, ang], dim=-1)
        cos = torch.cos(emb)[None, :, None, :].to(x.dtype)
        sin = torch.sin(emb)[None, :, None, :].to(x.dtype)
        x1, x2 = x.chunk(2, dim=-1)
        return x * cos + torch.cat([-x2, x1], dim=-1) * sin

    return torch.cat([rope1d(t[..., :half], positions[:, 0]), rope1d(t[..., half:], positions[:, 1])], dim=-1)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class SelfAttention(nn.Module):
    """Fused qkv, optional per-head QK LayerNorm, optional 2D RoPE, projection."""

    def __init__(self, dim: int, num_heads: int, qk_norm: bool):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        head_dim = dim // num_heads
        self.q_norm = LayerNorm(head_dim, LN_EPS) if qk_norm else None
        self.k_norm = LayerNorm(head_dim, LN_EPS) if qk_norm else None

    def forward(self, x: torch.Tensor, positions: torch.Tensor | None = None) -> torch.Tensor:
        b, s, d = x.shape
        qkv = self.qkv(x).view(b, s, 3, self.num_heads, d // self.num_heads)
        q, k, v = qkv.unbind(2)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if positions is not None:  # upstream order: QK norm, then rotary
            q, k = rope_2d(q, positions), rope_2d(k, positions)
        return self.proj(multi_head_attention(q, k, v).reshape(b, s, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-LN transformer block with LayerScale (upstream vggt/dinov2 `Block`)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, qk_norm: bool, layerscale_init: float):
        super().__init__()
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.attn = SelfAttention(dim, num_heads, qk_norm)
        self.ls1 = LayerScale(dim, layerscale_init)
        self.norm2 = LayerNorm(dim, LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, layerscale_init)

    def forward(self, x: torch.Tensor, positions: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x), positions))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchConv(nn.Module):
    def __init__(self, dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)


class DinoEncoder(nn.Module):
    """The frame-local ViT patch encoder (upstream `aggregator.patch_embed`, a
    DINOv2 ViT with cls and register tokens, which ride through every block
    and are dropped after the final norm)."""

    def __init__(self, cfg: AggregatorConfig):
        super().__init__()
        d = cfg.embed_dim
        bh, bw = cfg.base_patch_hw
        self.patch_embed = PatchConv(d, cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + bh * bw, d))  # row 0: the cls token's
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.register_tokens = nn.Parameter(torch.zeros(1, cfg.dino_num_register_tokens, d))
        self.blocks = nn.ModuleList(
            [Block(d, cfg.num_heads, cfg.mlp_ratio, False, 1.0) for _ in range(cfg.patch_encoder_depth)]
        )
        self.norm = LayerNorm(d, LN_EPS)
        self.base_patch_hw = (bh, bw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) normalised images -> (N, P, C) patch features."""
        w = self.patch_embed.proj.weight
        patches = self.patch_embed.proj(x.permute(0, 3, 1, 2).to(w.dtype))     # (N, C, ph, pw)
        n, d, ph, pw = patches.shape
        patches = patches.flatten(2).transpose(1, 2)                           # (N, P, C)
        pos = self.pos_embed[0, 1:].float()
        if (ph, pw) != self.base_patch_hw:  # DINOv2's bicubic interpolate_pos_encoding
            pos = resize_half_pixel(pos.reshape(*self.base_patch_hw, d), (ph, pw), "cubic").reshape(ph * pw, d)
        patches = patches + pos.to(patches.dtype)[None]
        special = torch.cat([self.cls_token[0] + self.pos_embed[0, :1], self.register_tokens[0]], 0)
        tokens = torch.cat([special.to(patches.dtype)[None].expand(n, -1, -1), patches], dim=1)
        for block in self.blocks:
            tokens = block(tokens)
        return self.norm(tokens)[:, special.shape[0]:]


class Aggregator(nn.Module):
    """(B, S, H, W, 3) images in [0, 1] -> (list over `output_layers` of
    (B, S, T, 2C) frame || global token stacks, (ph, pw)); T = 1 camera +
    R register + P patch tokens."""

    def __init__(self, cfg: AggregatorConfig = AggregatorConfig()):
        super().__init__()
        if cfg.output_layers[-1] != cfg.depth - 1:
            raise ValueError("the last tap must be the final block pair")
        if cfg.patch_encoder_depth < 1:
            raise ValueError("the port's aggregator needs a patch encoder (patch_encoder_depth >= 1)")
        self.config = cfg
        d = cfg.embed_dim
        self.patch_embed = DinoEncoder(cfg)
        # Leading 2-slot axis: slot 0 for the first (query) frame, slot 1 for the others.
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, d))
        self.register_token = nn.Parameter(torch.zeros(1, 2, cfg.num_register_tokens, d))
        self.frame_blocks, self.global_blocks = (
            nn.ModuleList([Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.qk_norm, cfg.layerscale_init)
                           for _ in range(cfg.depth)])
            for _ in range(2))

    def forward(self, images: torch.Tensor, mesh=None):
        """`mesh`: optional `parallel.mesh.Mesh` (every rank given the same
        images); the taps then hold this rank's frames only, `frame_shard`
        of them (all S when the mesh size does not divide S)."""
        cfg = self.config
        b, s, height, width, _ = images.shape
        lo, hi = frame_shard(s, mesh)
        sharded = hi - lo < s
        ph, pw = height // cfg.patch_size, width // cfg.patch_size
        mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
        std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
        patches = self.patch_embed(((images[:, lo:hi] - mean) / std).reshape(b * (hi - lo), height, width, 3))
        d = patches.shape[-1]

        special = torch.cat([self.camera_token, self.register_token], dim=2)[0]   # (2, 1+R, d)
        per_frame = special[torch.tensor([0] + [1] * (s - 1), device=images.device)[lo:hi]]
        tokens = torch.cat([per_frame.to(patches.dtype).repeat(b, 1, 1), patches], dim=1)  # (B*S_rank, T, d)
        t = tokens.shape[1]

        # Rotary positions: special tokens at (0, 0), the patch grid shifted by +1.
        n_special = 1 + cfg.num_register_tokens
        gy, gx = torch.meshgrid(torch.arange(ph, device=images.device) + 1,
                                torch.arange(pw, device=images.device) + 1, indexing="ij")
        pos_frame = torch.cat([torch.zeros((n_special, 2), dtype=torch.int64, device=images.device),
                               torch.stack([gy, gx], dim=-1).reshape(-1, 2)], dim=0)    # (T, 2)
        pos_global = pos_frame.repeat(s, 1)                                            # (S*T, 2)

        outputs = []
        for i, (frame_block, global_block) in enumerate(zip(self.frame_blocks, self.global_blocks)):
            frame_out = frame_block(tokens, pos_frame)
            every = gather_frames(frame_out.reshape(b, hi - lo, t, d), mesh) if sharded else frame_out
            with head_sharded_attention(mesh):
                glob = global_block(every.reshape(b, s * t, d), pos_global)
            tokens = glob.reshape(b, s, t, d)[:, lo:hi].reshape(b * (hi - lo), t, d)
            if i in cfg.output_layers:
                outputs.append(torch.cat([frame_out, tokens], dim=-1).reshape(b, hi - lo, t, 2 * d))
        return outputs, (ph, pw)


def frame_shard(s: int, mesh) -> tuple[int, int]:
    """(first, last + 1) of this rank's frames: a 1 / W share where the mesh
    size W divides the frame count, else all of them (the JAX package
    replicates the frames there too)."""
    if mesh is None or mesh.size == 1 or s % mesh.size:
        return 0, s
    per = s // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def gather_frames(x: torch.Tensor, mesh) -> torch.Tensor:
    """(B, S_rank, ...) frame shards of every rank -> (B, S, ...) on each."""
    from evoworld_tpu_torch.parallel.collectives import all_gather

    return all_gather(x.transpose(0, 1).contiguous(), mesh).transpose(0, 1)
