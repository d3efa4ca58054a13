"""Runtime assembly (counterpart of `evoworld_tpu/runtime.py::build_pipeline`).

Random weights only for now: the repository holds no checkpoint, so loading
diffusers safetensors directories waits until one is available.
"""

from __future__ import annotations

import torch

from evoworld_tpu_torch.device import resolve_device
from evoworld_tpu_torch.diffusion.pipeline import PanoDiffusionPipeline, PipelineConfig, make_random_pipeline
from evoworld_tpu_torch.models.clip import CLIPVisionConfig
from evoworld_tpu_torch.models.unet import UNetConfig
from evoworld_tpu_torch.models.vae import VAEConfig

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
