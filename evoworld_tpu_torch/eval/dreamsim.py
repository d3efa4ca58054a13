"""DreamSim perceptual distance, the single-branch `dino_vitb16` variant and
the published three-branch ensemble (counterpart of
`evoworld_tpu/eval/dreamsim.py`).

- `DreamSim`: a DINO ViT-B/16 whose CLS embedding is compared by cosine
  distance, d(a, b) = 1 - cos(f(a), f(b)).
- `DreamSimEnsemble`: DINO ViT-B/16 (768-d CLS), OpenAI CLIP ViT-B/32 (512-d
  projection, QuickGELU) and open_clip ViT-B/32 (512-d, exact GELU); each
  branch's embedding is L2-normalised, the three are concatenated into the
  1792-d embedding and pairs are compared by cosine distance.
Frames are resized to 224 as `jax.image.resize` "bilinear" does (antialiased
when it downsamples), then normalised per branch (ImageNet statistics for
DINO, CLIP's for both CLIP branches). The DINO blocks are the VGGT port's
`Block` (no QK norm, LayerScale 1: DINO v1 has none, no rotary positions)
and the CLIP branches `models/clip.py::CLIPVisionTower`, so upstream state
dicts load by name: DINO's (`cls_token`, `pos_embed`, `patch_embed.proj`,
`blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}`, `norm`), and
OpenAI / open_clip `visual.*` through `openai_to_transformers_clip`.

Without weights each branch draws its own from a CPU torch.Generator seeded
with `seed` (the same weights on every device) and the scorer is tagged "random_seed0_torch": those values are not
the JAX package's "random_seed0" ones. Everything computes in fp32, with TF32
off on the card (`eval.metrics.full_fp32`).
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from evoworld_tpu_torch.device import resolve_device
from evoworld_tpu_torch.eval.metrics import full_fp32
from evoworld_tpu_torch.eval.weights import RANDOM_TAG
from evoworld_tpu_torch.models.clip import CLIP_MEAN, CLIP_STD, CLIPVisionConfig, CLIPVisionTower
from evoworld_tpu_torch.models.layers import LayerNorm
from evoworld_tpu_torch.models.vggt.aggregator import IMAGENET_MEAN, IMAGENET_STD, LN_EPS, Block, LayerScale
from evoworld_tpu_torch.models.weights import init_random_, load_checkpoint_
from evoworld_tpu_torch.ops.resize import resize_half_pixel


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)


class DinoViT(nn.Module):
    """DINO ViT-B/16: patch embedding, CLS token, 12 blocks, final norm.
    (N, 224, 224, 3) ImageNet-normalised -> (N, 768) CLS embedding."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12, patch_size: int = 16,
                 image_size: int = 224):
        super().__init__()
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + (image_size // patch_size) ** 2, embed_dim))
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads, 4.0, False, 1.0) for _ in range(depth)])
        self.norm = LayerNorm(embed_dim, LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embed.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), patches], dim=1) + self.pos_embed
        for block in self.blocks:
            tokens = block(tokens)
        return self.norm(tokens.float())[:, 0]


def _clip_b32_config(hidden_act: str) -> CLIPVisionConfig:
    return CLIPVisionConfig(patch_size=32, hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
                            projection_dim=512, hidden_act=hidden_act)


class _ClipBranch(nn.Module):
    """A CLIP tower on channels-last input, as the ensemble calls its branches."""

    def __init__(self, hidden_act: str):
        super().__init__()
        self.tower = CLIPVisionTower(_clip_b32_config(hidden_act))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tower(x.permute(0, 3, 1, 2))


_BRANCHES = {
    "dino_vitb16": (DinoViT, (), IMAGENET_MEAN, IMAGENET_STD),
    "clip_vitb32": (_ClipBranch, ("quick_gelu",), CLIP_MEAN, CLIP_STD),
    "open_clip_vitb32": (_ClipBranch, ("gelu",), CLIP_MEAN, CLIP_STD),
}


def dino_state_dict(src: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """An upstream DINO ViT state dict in the port's names: LayerScale
    gammas (which DINO v1 lacks) filled with ones, `mask_token` dropped."""
    out = {k: torch.as_tensor(v) for k, v in src.items() if k != "mask_token"}
    i = 0
    while f"blocks.{i}.norm1.weight" in out:
        dim = out[f"blocks.{i}.norm1.weight"].shape[0]
        for ls in ("ls1", "ls2"):
            out.setdefault(f"blocks.{i}.{ls}.gamma", torch.ones(dim))
        i += 1
    return out


def openai_to_transformers_clip(src: Mapping[str, np.ndarray]) -> Tuple[dict, list]:
    """OpenAI CLIP `visual.*` naming (open_clip's ViTs use the same visual
    trunk) -> transformers CLIPVisionModelWithProjection naming.

    The fused `attn.in_proj_weight` / `_bias` rows split into q / k / v
    thirds; `visual.proj` is stored (hidden, out) and used as `x @ proj`, so
    it transposes into `visual_projection.weight` (out, hidden). Returns the
    remapped dict and a report of the unmapped `visual.*` keys (the text
    tower and the logit scale are left out silently).
    """
    out: dict = {}
    report: list = []
    pfx = "vision_model."
    static = {
        "visual.conv1.weight": pfx + "embeddings.patch_embedding.weight",
        "visual.class_embedding": pfx + "embeddings.class_embedding",
        "visual.positional_embedding": pfx + "embeddings.position_embedding.weight",
        "visual.ln_pre.weight": pfx + "pre_layrnorm.weight",
        "visual.ln_pre.bias": pfx + "pre_layrnorm.bias",
        "visual.ln_post.weight": pfx + "post_layernorm.weight",
        "visual.ln_post.bias": pfx + "post_layernorm.bias",
    }
    for k, v in src.items():
        if not k.startswith("visual."):
            continue
        a = np.asarray(v)
        if k in static:
            out[static[k]] = a
        elif k == "visual.proj":
            out["visual_projection.weight"] = a.T
        elif k.startswith("visual.transformer.resblocks."):
            i, name = k[len("visual.transformer.resblocks."):].split(".", 1)
            d = pfx + f"encoder.layers.{i}."
            if name in ("ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias"):
                ln, wb = name.split(".")
                out[d + f"layer_norm{ln[-1]}.{wb}"] = a
            elif name in ("attn.in_proj_weight", "attn.in_proj_bias"):
                wb = name.rsplit("_", 1)[1]
                for proj, third in zip(("q_proj", "k_proj", "v_proj"), np.split(a, 3, axis=0)):
                    out[d + f"self_attn.{proj}.{wb}"] = third
            elif name.startswith("attn.out_proj."):
                out[d + "self_attn." + name[len("attn."):]] = a
            elif name.startswith("mlp.c_fc."):
                out[d + "mlp.fc1." + name.rsplit(".", 1)[1]] = a
            elif name.startswith("mlp.c_proj."):
                out[d + "mlp.fc2." + name.rsplit(".", 1)[1]] = a
            else:
                report.append(f"unmapped source key {k}")
        else:
            report.append(f"unmapped source key {k}")
    return out, report


def clip_visual_state_dict(src: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """An OpenAI / open_clip state dict -> a CLIP branch's state dict;
    raises ValueError naming what does not map."""
    remapped, report = openai_to_transformers_clip(src)
    if report:
        raise ValueError(f"CLIP visual state dict: {'; '.join(report[:8])}")
    return {"tower." + k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in remapped.items()}


def make_branch(name: str, state: Mapping[str, torch.Tensor] | None, seed: int, device) -> nn.Module:
    """One branch in fp32 on `device`: from its port-named state dict
    (strict), or random from a CPU generator seeded with `seed`, the same
    weights on every device (DINO's LayerScales 1, as DINO v1 has none)."""
    cls, args, _, _ = _BRANCHES[name]
    model = cls(*args)
    if state is not None:
        load_checkpoint_(model, state)
    else:
        init_random_(model, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, LayerScale):
                    m.gamma.fill_(1.0)
    return model.to(device).eval()


def _normalise(x: torch.Tensor, mean, std) -> torch.Tensor:
    return (x - torch.tensor(mean, device=x.device)) / torch.tensor(std, device=x.device)


def _unit(f: np.ndarray) -> np.ndarray:
    return f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12)


class DreamSimEnsemble:
    """DreamSim's default: the three-branch ViT ensemble, 1792-d embedding.

    `branch_states` maps a branch name to its port-named state dict; absent
    branches are random (tag "random_seed0_torch"). Runs on `device`.
    """

    BRANCHES = ("dino_vitb16", "clip_vitb32", "open_clip_vitb32")

    def __init__(self, branch_states: Mapping[str, dict] | None = None, seed: int = 0,
                 device: str | torch.device = "cuda", branches: Tuple[str, ...] = BRANCHES):
        branch_states = dict(branch_states or {})
        self.device = resolve_device(device)
        self.branches = branches
        self.models = {b: make_branch(b, branch_states.get(b), seed, self.device) for b in branches}
        converted = [b for b in branches if b in branch_states]
        self.weights_tag = "converted:" + ",".join(converted) if converted else RANDOM_TAG

    @torch.no_grad()
    def embed(self, images) -> np.ndarray:
        """(N, H, W, 3) [0, 1] -> (N, D) float64: each branch's L2-normalised
        embedding, concatenated."""
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        feats = []
        with full_fp32():
            x = resize_half_pixel(x, (224, 224))
            for b in self.branches:
                _, _, mean, std = _BRANCHES[b]
                feats.append(_unit(self.models[b](_normalise(x, mean, std)).cpu().numpy().astype(np.float64)))
        return np.concatenate(feats, axis=-1)

    def __call__(self, img1, img2) -> np.ndarray:
        """(N, H, W, 3) [0, 1] pairs (or single images) -> (N,) cosine distances."""
        img1, img2 = np.asarray(img1), np.asarray(img2)
        a = _unit(self.embed(img1[None] if img1.ndim == 3 else img1))
        b = _unit(self.embed(img2[None] if img2.ndim == 3 else img2))
        return 1.0 - (a * b).sum(-1)


class DreamSim(DreamSimEnsemble):
    """The single-branch `dino_vitb16` variant (mirrors model(img1, img2))."""

    def __init__(self, state: Mapping[str, torch.Tensor] | None = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__({"dino_vitb16": state} if state is not None else None, seed, device, ("dino_vitb16",))
        self.weights_tag = "converted" if state is not None else RANDOM_TAG


def make_dreamsim(variant: str = "dino_vitb16", branch_states=None, seed: int = 0,
                  device: str | torch.device = "cuda"):
    """Factory over the two variants; `branch_states` as `DreamSimEnsemble`'s."""
    if variant == "ensemble":
        return DreamSimEnsemble(branch_states, seed=seed, device=device)
    if variant == "dino_vitb16":
        return DreamSim((branch_states or {}).get("dino_vitb16"), seed=seed, device=device)
    raise ValueError(f"unknown dreamsim variant {variant!r}")
