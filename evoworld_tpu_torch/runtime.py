"""Runtime assembly (counterpart of `evoworld_tpu/runtime.py`): the pipeline
for generation and the three models for training.

Random weights only for now: the repository holds no checkpoint, so loading
diffusers safetensors directories waits until one is available.
"""

from __future__ import annotations

import dataclasses

import torch

from evoworld_tpu_torch.device import resolve_device
from evoworld_tpu_torch.diffusion.pipeline import (
    PanoDiffusionPipeline,
    PipelineConfig,
    make_random_pipeline,
    random_model,
)
from evoworld_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower
from evoworld_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporal
from evoworld_tpu_torch.models.vae import AutoencoderKLTemporal, VAEConfig
from evoworld_tpu_torch.train.train_step import freeze_master_cast

#: Model configurations by preset: "full" is SVD-XT's architecture with the
#: 18-channel input, "tiny" the smoke-test widths of the JAX package.
PRESETS = {
    "full": (UNetConfig(), VAEConfig(), CLIPVisionConfig()),
    "tiny": (
        UNetConfig(block_out_channels=(32, 64, 128, 128), num_attention_heads=(2, 4, 8, 8)),
        VAEConfig(block_out_channels=(32, 64, 128, 128)),
        CLIPVisionConfig(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128),
    ),
}


def build_pipeline(
    pipeline_config: PipelineConfig = PipelineConfig(),
    model_preset: str = "full",
    seed: int = 0,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> PanoDiffusionPipeline:
    """Build the diffusion pipeline with deterministic random weights.

    Runs on CUDA unless `device="cpu"` is passed; raises RuntimeError when
    CUDA is asked for and absent.
    """
    dev = resolve_device(device)
    if model_preset not in PRESETS:
        raise ValueError(f"unknown model_preset {model_preset!r}; choose from {sorted(PRESETS)}")
    unet_cfg, vae_cfg, clip_cfg = PRESETS[model_preset]
    return make_random_pipeline(
        pipeline_config, unet_cfg, vae_cfg, clip_cfg, seed=seed, compute_dtype=compute_dtype, device=dev
    )


def build_trainer(
    model_preset: str = "full",
    seed: int = 0,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> tuple[UNetSpatioTemporal, AutoencoderKLTemporal, CLIPVisionTower]:
    """(unet, vae, clip_tower) with deterministic random weights, ready for `train`.

    The UNet is drawn in fp32 (stream seed*3 + 0, as in `build_pipeline`),
    then cast to the master-weight policy: fp32 trainable parameters,
    `compute_dtype` frozen ones; its blocks are checkpointed (remat). The VAE and
    CLIP are frozen in `compute_dtype`. Runs on CUDA unless `device="cpu"` is
    passed; raises RuntimeError when CUDA is asked for and absent.
    """
    dev = resolve_device(device)
    if model_preset not in PRESETS:
        raise ValueError(f"unknown model_preset {model_preset!r}; choose from {sorted(PRESETS)}")
    unet_cfg, vae_cfg, clip_cfg = PRESETS[model_preset]

    def gen(salt):
        return torch.Generator(device=dev).manual_seed(seed * 3 + salt)

    unet = random_model(UNetSpatioTemporal, dataclasses.replace(unet_cfg, remat=True), gen(0), dev, torch.float32)
    freeze_master_cast(unet.train(), compute_dtype)
    vae = random_model(AutoencoderKLTemporal, vae_cfg, gen(1), dev, compute_dtype).eval().requires_grad_(False)
    clip = random_model(CLIPVisionTower, clip_cfg, gen(2), dev, compute_dtype).eval().requires_grad_(False)
    return unet, vae, clip
