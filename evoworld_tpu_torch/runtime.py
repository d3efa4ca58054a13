"""Runtime assembly (counterpart of `evoworld_tpu/runtime.py`): the pipeline
for generation, the three models for training, and the VGGT reconstructor of
the evolving-memory loop.

Weights come from a checkpoint when one is given, else at random from the
seed. `build_pipeline(checkpoint_dir=...)` reads a diffusers pipeline
directory: `unet/`, `vae/` and `image_encoder/`, each holding `*.safetensors`
(shards merged) under the diffusers and transformers names, which the port's
modules keep, so each model is filled by a strict `load_state_dict`; SVD's
8-channel `conv_in` is zero-padded to the UNet's 18. `build_reconstructor(
vggt_checkpoint=...)` reads facebook/VGGT-1B's `model.pt` under upstream's
names. `build_trainer(checkpoint_dir=...)` reads the same directory as
`build_pipeline`. The repository ships no checkpoint (WEIGHTS.md); the tests
write small random ones.

On CUDA every entry point takes bfloat16, float16 or float32: the Hopper
flash-attention kernels exist in those three types, and the attention
dispatch never falls back to plain attention on the card. Any other dtype
(float64) raises ValueError there before any weight is drawn; the CPU takes
any dtype.

A multi-GPU run is one process per rank under `torchrun`:
`inference_setup` brings the process group up (WORLD_SIZE > 1 in the
environment), gives each rank `cuda:LOCAL_RANK % device_count` and returns
the mesh (`runtime.mesh_data` x `runtime.mesh_model` ranks, the JAX
package's `_inference_mesh`), which `build_pipeline` and
`build_reconstructor` shard over and the training CLI's data-parallel step
runs on.

On one CUDA device without a mesh, `build_reconstructor` parks VGGT's
parameters in pinned host memory between calls (`offload_params`, the JAX
package's default host offload).
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from evoworld_tpu_torch.device import resolve_device
from evoworld_tpu_torch.diffusion.pipeline import (
    PanoDiffusionPipeline,
    PipelineConfig,
    empty_model,
    make_random_pipeline,
    random_model,
)
from evoworld_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower
from evoworld_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporal
from evoworld_tpu_torch.models.vae import AutoencoderKLTemporal, VAEConfig
from evoworld_tpu_torch.models.vggt.aggregator import AggregatorConfig
from evoworld_tpu_torch.models.vggt.model import VGGT, Reconstructor, VGGTConfig, make_reconstructor, resolve_offload
from evoworld_tpu_torch.models.weights import (
    checkpoint_mismatches,
    init_random_,
    load_checkpoint_,
    load_safetensors_dir,
    load_vggt_checkpoint,
)
from evoworld_tpu_torch.train.train_step import freeze_master_cast

logger = logging.getLogger("evoworld_tpu_torch")

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

#: VGGT configurations by preset: "full" is VGGT-1B's (embed 1024, 24 frame /
#: global pairs, 16 heads, a 24-block patch encoder), "tiny" the JAX package's
#: smoke-test widths (embed 64, 4 pairs, 4 heads, one encoder block).
VGGT_PRESETS = {
    "full": VGGTConfig(),
    "tiny": VGGTConfig(aggregator=AggregatorConfig(
        embed_dim=64, depth=4, num_heads=4, num_register_tokens=2, output_layers=(0, 1, 2, 3),
        patch_encoder_depth=1)),
}


#: Compute dtypes the card's flash-attention kernels take: bf16 and fp16
#: (one wgmma design templated over the type) and fp32 (wgmma on a three-part
#: bf16 split of each operand).
CUDA_COMPUTE_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def check_compute_dtype(device: str | torch.device, compute_dtype: torch.dtype) -> None:
    """Refuse a compute dtype the card's kernels do not take (before any work)."""
    if torch.device(device).type == "cuda" and compute_dtype not in CUDA_COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype {compute_dtype} on CUDA: the port's Hopper flash-attention kernels take "
            "bfloat16, float16 or float32; use one of those on the card, or device='cpu'"
        )


def inference_setup(device: str | torch.device = "cuda", mesh_data: int = 0, mesh_model: int = 1):
    """(this rank's device, the mesh or None), for the serving and training CLIs.

    With WORLD_SIZE > 1 in the environment (`torchrun --nproc-per-node W`)
    the process group comes up (`parallel/mesh.py::init_distributed`: NCCL
    where each rank has a card of its own, gloo where ranks share one) unless
    it is up already, and the mesh is `mesh_data` x `mesh_model` ranks
    (`mesh_data` 0: all of them over `mesh_model`). One process: the
    resolved device and no mesh."""
    import torch.distributed as dist

    from evoworld_tpu_torch.parallel.mesh import init_distributed, make_mesh, rank_device

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 and not dist.is_initialized():
        return resolve_device(device), None
    if dist.is_initialized():
        dev = rank_device(device, int(os.environ.get("LOCAL_RANK", dist.get_rank())))
    else:
        dev = init_distributed(device)
    mesh = make_mesh(dev, mesh_data, mesh_model)
    return dev, (mesh if mesh.size > 1 else None)


def _preset(presets: dict, name: str):
    if name not in presets:
        raise ValueError(f"unknown model_preset {name!r}; choose from {sorted(presets)}")
    return presets[name]


def build_pipeline(
    pipeline_config: PipelineConfig = PipelineConfig(),
    model_preset: str = "full",
    seed: int = 0,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    checkpoint_dir: str | None = None,
    allow_random_weights: bool = True,
    mesh=None,
) -> PanoDiffusionPipeline:
    """Build the diffusion pipeline from a checkpoint directory, or with
    deterministic random weights; sharded over `mesh` (`inference_setup`)
    when given, every rank building the same weights.

    With `checkpoint_dir` holding `unet/`, `vae/` and `image_encoder/`
    safetensors, the preset's three models are filled from them (strict
    names and shapes; conv_in zero-padded to the UNet's input channels) and
    every leaf is cast to `compute_dtype`, as the JAX package casts every
    leaf (`evoworld_tpu/runtime.py:104`); the random path casts the same. A
    directory missing one of the three logs a warning and falls back to
    random weights; with `allow_random_weights` False, no usable checkpoint
    raises FileNotFoundError. Runs on CUDA unless `device="cpu"` is passed;
    raises RuntimeError when CUDA is asked for and absent, ValueError for a
    compute dtype other than bfloat16, float16 or float32 on CUDA (before any file is
    read).
    """
    check_compute_dtype(device, compute_dtype)
    dev = resolve_device(device)
    unet_cfg, vae_cfg, clip_cfg = _preset(PRESETS, model_preset)
    models = _load_checkpoint_models(checkpoint_dir, (unet_cfg, vae_cfg, clip_cfg), dev, (compute_dtype,) * 3,
                                     allow_random_weights)
    if models is not None:
        return PanoDiffusionPipeline(*models, pipeline_config, compute_dtype, mesh)
    logger.warning(f"Building the {model_preset} pipeline with RANDOM weights (seed {seed})")
    return make_random_pipeline(
        pipeline_config, unet_cfg, vae_cfg, clip_cfg, seed=seed, compute_dtype=compute_dtype, device=dev, mesh=mesh
    )


def _load_checkpoint_models(checkpoint_dir, configs, dev, dtypes, allow_random_weights: bool):
    """(unet, vae, clip) of `configs` filled from a diffusers pipeline
    directory in `dtypes`, or None where there is none to read and random
    weights are allowed (FileNotFoundError where they are not)."""
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        logger.info(f"Loading checkpoint from {checkpoint_dir}")
        states = [load_safetensors_dir(os.path.join(checkpoint_dir, sub)) for sub in ("unet", "vae", "image_encoder")]
        if all(states):
            return [load_checkpoint_(empty_model(cls, cfg, dev, dtype), state) for cls, cfg, dtype, state in zip(
                (UNetSpatioTemporal, AutoencoderKLTemporal, CLIPVisionTower), configs, dtypes, states)]
        logger.warning(f"checkpoint dir {checkpoint_dir} incomplete; falling back")
    if not allow_random_weights:
        raise FileNotFoundError(f"no usable checkpoint at {checkpoint_dir!r} and allow_random_weights is False")
    return None


def build_trainer(
    model_preset: str = "full",
    seed: int = 0,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    checkpoint_dir: str | None = None,
    allow_random_weights: bool = True,
) -> tuple[UNetSpatioTemporal, AutoencoderKLTemporal, CLIPVisionTower]:
    """(unet, vae, clip_tower) ready for `train`, from a checkpoint directory
    or with deterministic random weights.

    With `checkpoint_dir` holding `unet/`, `vae/` and `image_encoder/`
    safetensors (as for `build_pipeline`: strict names and shapes, conv_in
    zero-padded to 18 input channels) the UNet is read in fp32, the VAE and
    CLIP in `compute_dtype`; without one (a warning, or FileNotFoundError
    when `allow_random_weights` is False) the UNet is drawn in fp32 (stream
    seed*3 + 0, as in `build_pipeline`) and the others in `compute_dtype`.
    The UNet is then cast to the master-weight policy: fp32 trainable
    parameters (a checkpoint's own values, where the JAX package rounds them
    to the compute dtype first), `compute_dtype` frozen ones; its blocks are
    checkpointed (remat). The VAE and CLIP are frozen. Runs on CUDA unless
    `device="cpu"` is passed; raises RuntimeError when CUDA is asked for and
    absent, ValueError for a compute dtype other than bfloat16, float16 or
    float32 on CUDA (before any file is read).
    """
    check_compute_dtype(device, compute_dtype)
    dev = resolve_device(device)
    unet_cfg, vae_cfg, clip_cfg = _preset(PRESETS, model_preset)
    configs = (dataclasses.replace(unet_cfg, remat=True), vae_cfg, clip_cfg)
    models = _load_checkpoint_models(checkpoint_dir, configs, dev, (torch.float32, compute_dtype, compute_dtype),
                                     allow_random_weights)
    if models is None:
        logger.warning(f"Building the {model_preset} trainer with RANDOM weights (seed {seed})")

        def gen(salt):
            return torch.Generator(device=dev).manual_seed(seed * 3 + salt)

        models = [random_model(cls, cfg, gen(salt), dev, dtype) for salt, (cls, cfg, dtype) in enumerate(zip(
            (UNetSpatioTemporal, AutoencoderKLTemporal, CLIPVisionTower), configs,
            (torch.float32, compute_dtype, compute_dtype)))]
    unet, vae, clip = models
    freeze_master_cast(unet.train(), compute_dtype)
    return unet, vae.eval().requires_grad_(False), clip.eval().requires_grad_(False)


def _keep_fp32(name: str) -> bool:
    """Leaves the reference keeps in fp32: norm affines, LayerScales, the pose seed."""
    return "norm" in name or name.endswith(".gamma") or name.endswith("empty_pose_tokens")


def build_reconstructor(
    model_preset: str = "full",
    seed: int = 0,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    vggt_checkpoint: str | None = None,
    allow_random_weights: bool = True,
    mesh=None,
    offload_params: bool | None = None,
) -> Reconstructor:
    """The loop's VGGT reconstructor, from a checkpoint or with deterministic
    random weights; sharded over `mesh` when given (frames, and the global
    attention on the head-sharded or ring route, `ops/attention.py`).

    The model is built on the meta device and filled by `init_random_` from a
    generator seeded with `seed` on `device`. With `vggt_checkpoint` (an
    existing upstream `model.pt`) the checkpoint's tensors then replace
    those values by name; keys, names and shapes that do not fit are logged
    (missing leaves keep their random values, others are left out), and
    raise ValueError when `allow_random_weights` is False, as the JAX package
    does with its conversion report. No checkpoint and `allow_random_weights`
    False raises FileNotFoundError. Norm affines, LayerScales and the camera
    head's pose seed stay fp32 (the JAX package's `cast_compute_leaves`),
    every other leaf is cast to `compute_dtype`. The depth head runs in
    chunks of 8 frames. `offload_params` (None: on for one CUDA device
    without a mesh, off otherwise; True on the CPU raises ValueError) keeps
    the parameters in pinned host memory between calls
    (`models/vggt/model.py::Reconstructor`). Runs on CUDA unless
    `device="cpu"` is passed; raises RuntimeError when CUDA is asked for and
    absent, ValueError for a compute dtype other than bfloat16, float16 or
    float32 on CUDA.
    """
    check_compute_dtype(device, compute_dtype)
    resolve_offload(torch.device(device), mesh, offload_params)  # refused on the CPU before any weight is drawn
    dev = resolve_device(device)
    config = _preset(VGGT_PRESETS, model_preset)
    with torch.device("meta"):
        model = VGGT(config)
    model = init_random_(model.to_empty(device=dev), torch.Generator(device=dev).manual_seed(seed))
    if vggt_checkpoint and os.path.exists(vggt_checkpoint):
        logger.info(f"Loading VGGT from {vggt_checkpoint}")
        state = load_vggt_checkpoint(vggt_checkpoint)
        report = checkpoint_mismatches(model, state)
        if report:
            logger.warning(f"VGGT checkpoint: {len(report)} issues ({'; '.join(report[:8])} ...)")
            if not allow_random_weights:
                raise ValueError(f"VGGT checkpoint {vggt_checkpoint} does not fit the model: {report[:8]}")
        own = model.state_dict()
        with torch.no_grad():
            for name, value in state.items():
                if name in own and tuple(value.shape) == tuple(own[name].shape):
                    own[name].copy_(value)
    elif not allow_random_weights:
        raise FileNotFoundError(f"no VGGT checkpoint at {vggt_checkpoint!r} and allow_random_weights is False")
    else:
        logger.warning(f"Building the {model_preset} VGGT with RANDOM weights (seed {seed})")
    for name, p in model.named_parameters():
        if not _keep_fp32(name):
            p.data = p.data.to(compute_dtype)
    return make_reconstructor(model.requires_grad_(False), compute_dtype, mesh=mesh, offload_params=offload_params)
