"""CLIP ViT-H/14 vision tower with projection head.

Counterpart of `evoworld_tpu/models/clip.py`, with transformers'
`CLIPVisionModelWithProjection` parameter names (vision_model.embeddings...,
vision_model.encoder.layers.N..., visual_projection). 224x224 input, patch
14, hidden 1280, 32 layers, 16 heads, MLP 5120, projection to the 1024-d
image embedding the UNet cross-attends to.

As in the JAX module, the LayerNorms output fp32, so the residual stream
after `pre_layrnorm` and every projection inside the layers run in fp32;
the patch embedding and the final projection run in the input's dtype.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from evoworld_tpu_torch.models.layers import LayerNorm
from evoworld_tpu_torch.ops.attention import multi_head_attention

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    mlp_dim: int = 5120
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5
    # "gelu" (exact: the SVD image encoder, open_clip) or "quick_gelu"
    # (x * sigmoid(1.702 x): OpenAI CLIP, DreamSim's clip_vitb32 branch).
    hidden_act: str = "gelu"


class Linear(nn.Linear):
    """nn.Linear computing in the input's dtype (weights cast on the fly)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.heads = cfg.num_heads
        d = cfg.hidden_size
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(d, d) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        shape = (b, s, self.heads, d // self.heads)
        out = multi_head_attention(self.q_proj(x).view(shape), self.k_proj(x).view(shape), self.v_proj(x).view(shape))
        return self.out_proj(out.reshape(b, s, d))


class CLIPMLP(nn.Module):
    """fc1 -> the config's GELU -> fc2."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        if cfg.hidden_act not in ("gelu", "quick_gelu"):
            raise ValueError(f"unknown hidden_act {cfg.hidden_act!r}")
        self.quick = cfg.hidden_act == "quick_gelu"
        self.fc1 = Linear(cfg.hidden_size, cfg.mlp_dim)
        self.fc2 = Linear(cfg.mlp_dim, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h) if self.quick else F.gelu(h))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, out_dtype=torch.float32)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, out_dtype=torch.float32)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.num_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(self.num_patches + 1, cfg.hidden_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        w = self.patch_embedding.weight.to(pixels.dtype)
        patches = F.conv2d(pixels, w, stride=self.patch_embedding.stride).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(pixels.dtype).expand(pixels.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1)
        return x + self.position_embedding.weight.to(pixels.dtype)[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, out_dtype=torch.float32)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, out_dtype=torch.float32)


class CLIPVisionTower(nn.Module):
    """Normalised pixels (B, 3, 224, 224) -> (B, projection_dim) in the pixels' dtype."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)
        self.visual_projection = Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixels))  # fp32 from here on
        for layer in vm.encoder.layers:
            x = layer(x)
        pooled = vm.post_layernorm(x[:, 0])
        return self.visual_projection(pooled.to(pixels.dtype))


def clip_preprocess(images: torch.Tensor) -> torch.Tensor:
    """Normalise [0, 1] RGB (B, H, W, 3) channels-last images with CLIP mean/std."""
    mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std
