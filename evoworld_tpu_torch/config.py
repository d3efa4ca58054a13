"""Typed configuration tree with dotted CLI overrides (counterpart of
`evoworld_tpu/config.py`, which imports JAX modules and so cannot be shared).

The same sections, field names and defaults as the JAX package's tree (but
`data.root`, which has none here); the
port's own `PipelineConfig`, `LoopConfig`, `TrainConfig` and `TrainerConfig`
fill the first four. Every CLI accepts `--section.field=value` (or
`--section.field value`) overrides. `runtime.compute_dtype` maps to a torch
dtype through `compute_dtype`; bfloat16, float16 and float32 all run on
CUDA, each on flash kernels of its type, and any other dtype meets the entry
points' refusal (`runtime.check_compute_dtype`) before any file is read. The
mesh fields (`runtime.mesh_data`, `mesh_model`, `vggt_mesh`) shape a serving
run under `torchrun` (`runtime.inference_setup`); in one process they do
nothing, as the JAX package's do on one device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import torch

from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
from evoworld_tpu_torch.loop.unified import LoopConfig
from evoworld_tpu_torch.train.train_step import TrainConfig
from evoworld_tpu_torch.train.trainer import TrainerConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    root: str = ""  # a run names its data (--data.root); the JAX tree's default is a path of its own machine
    height: int = 576
    width: int = 1024
    sequence_length: int = 25
    sampling: str = "reprojection"
    # Data-engine capture convention for cube_to_pano ("unity" | "ue").
    engine: str = "unity"
    reprojection_name: str = "rendered_panorama_vggt_open3d"
    memory_path: Optional[str] = None
    pos_scale: float = 0.1
    single_episode: bool = True
    start_idx: int = 0
    end_idx: int = -1
    # Sky masking in the offline reprojection tool (`cli/reproject.py`).
    mask_sky: bool = True


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    seed: int = 42
    compute_dtype: str = "bfloat16"
    model_preset: str = "full"  # "full" | "tiny" (smoke runs without weights)
    mesh_data: int = 0          # ranks on the data axis (0: all of them over mesh_model)
    mesh_model: int = 1
    checkpoint_dir: Optional[str] = None      # diffusers pipeline dir (unet/ vae/ image_encoder/)
    svd_checkpoint: Optional[str] = None      # the same layout, as the HF SVD pipeline ships it
    vggt_checkpoint: Optional[str] = None     # facebook/VGGT-1B model.pt
    vggt_tiny: bool = False  # small random VGGT (CPU demos / smoke runs)
    vggt_mesh: bool = True   # shard VGGT over the serving mesh too
    metric_weights_dir: str = ""
    skyseg_onnx: str = "skyseg.onnx"
    dreamsim_variant: str = "dino_vitb16"
    allow_random_weights: bool = True
    save_dir: str = "outputs"
    profile: bool = False


@dataclasses.dataclass(frozen=True)
class ParityConfig:
    """Thresholds of the weights-day parity gate (`cli/validate_parity.py`)."""

    dry_run: bool = False
    reference_scores: str = ""
    reference_frames: str = ""
    resize_reference: bool = False
    tolerance: float = 0.01
    metrics: str = "psnr,lpips"


@dataclasses.dataclass(frozen=True)
class EvoWorldConfig:
    pipeline: PipelineConfig = PipelineConfig()
    loop: LoopConfig = LoopConfig()
    train: TrainConfig = TrainConfig()
    trainer: TrainerConfig = TrainerConfig()
    data: DataConfig = DataConfig()
    runtime: RuntimeConfig = RuntimeConfig()
    parity: ParityConfig = ParityConfig()


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def compute_dtype(runtime: RuntimeConfig) -> torch.dtype:
    """`runtime.compute_dtype` as a torch dtype."""
    if runtime.compute_dtype not in _DTYPES:
        raise SystemExit(f"runtime.compute_dtype must be one of {sorted(_DTYPES)}, got {runtime.compute_dtype!r}")
    return _DTYPES[runtime.compute_dtype]


def _coerce(value: str, current):
    t = type(current)
    if t is bool:
        return value.lower() in ("1", "true", "yes")
    if current is None:
        return value
    if t in (int, float, str):
        return t(value)
    if t is tuple:
        parts = [p for p in value.strip("()[] ").split(",") if p]
        elem = type(current[0]) if current else str
        return tuple(elem(p) for p in parts)
    raise ValueError(f"cannot coerce {value!r} to {t}")


def apply_overrides(config: EvoWorldConfig, argv: Sequence[str]) -> EvoWorldConfig:
    """Apply `--section.field=value` (or `--section.field value`) overrides."""
    updates: dict[str, dict] = {}
    args = list(argv)
    i = 0
    while i < len(args):
        arg = args[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument {arg!r}")
        body = arg[2:]
        if "=" in body:
            key, value = body.split("=", 1)
        else:
            if i + 1 >= len(args):
                raise SystemExit(f"missing value for {arg}")
            key, value = body, args[i + 1]
            i += 1
        i += 1
        if "." not in key:
            raise SystemExit(f"override must be section.field, got {key!r}")
        section, field = key.split(".", 1)
        updates.setdefault(section, {})[field] = value

    out = config
    for section, fields in updates.items():
        sub = getattr(out, section, None)
        if sub is None:
            raise SystemExit(f"unknown config section {section!r}")
        coerced = {}
        for field, raw in fields.items():
            if not hasattr(sub, field):
                raise SystemExit(f"unknown field {section}.{field}")
            coerced[field] = _coerce(raw, getattr(sub, field))
        out = dataclasses.replace(out, **{section: dataclasses.replace(sub, **coerced)})
    return out


def describe(config: EvoWorldConfig) -> str:
    return json.dumps(dataclasses.asdict(config), indent=2, default=str)
