"""Checkpoint conversion tools (counterpart of
`evoworld_tpu/cli/convert_checkpoint.py`).

Covers two reference utilities:
  - fp32 -> fp16/bf16 safetensors conversion (upstream's
    utils/convert_32_to_16bit.py), which writes the fp16 checkpoints that
    `--runtime.compute_dtype float16` loads;
  - a check that an SVD pipeline dir fills the port's models: every
    sub-model's names and shapes, read from the safetensors headers alone,
    against the full-width UNet, VAE and CLIP built on the meta device.

Both read and write safetensors through `models/weights.py` (the
`safetensors` package is not a dependency).

Usage:
  # dtype conversion of a safetensors file
  python -m evoworld_tpu_torch.cli.convert_checkpoint halve <in.safetensors> <out.safetensors> [bf16|fp16]

  # validate an SVD pipeline dir converts cleanly against our model trees
  python -m evoworld_tpu_torch.cli.convert_checkpoint validate <pipeline_dir>
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from evoworld_tpu_torch.models.weights import (
    checkpoint_mismatches,
    load_safetensors,
    load_safetensors_dir,
    safetensors_shapes,
    save_safetensors,
)

_HALF = {"fp16": torch.float16, "bf16": torch.bfloat16}


def _halve_tensor(t: torch.Tensor, target: torch.dtype) -> torch.Tensor:
    """`t` in `target` where it is F32 or F64, else unchanged, rounded as the
    JAX tool's numpy `astype` rounds: float64 to fp16 in one rounding
    (numpy's own cast; torch's goes through fp32 and can round twice), float64
    to bf16 through fp32 (as ml_dtypes does), fp32 to either to nearest even."""
    if t.dtype == torch.float64 and target == torch.float16:
        return torch.from_numpy(t.numpy().astype(np.float16))
    return t.to(target) if t.dtype in (torch.float32, torch.float64) else t


def halve(src: str, dst: str, dtype: str = "fp16") -> None:
    """Write `src`'s tensors to `dst` with every F32 / F64 tensor cast to
    `dtype` ("fp16" or "bf16"); integer, bool, F16 and BF16 tensors pass
    through unchanged."""
    if dtype not in _HALF:
        raise SystemExit(f"unknown dtype {dtype!r}: fp16 or bf16")
    out = {k: _halve_tensor(t, _HALF[dtype]) for k, t in load_safetensors(src).items()}
    save_safetensors(out, dst)
    print(f"wrote {dst} ({len(out)} tensors as {dtype})")


def _meta_state(shapes: dict, model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Meta tensors of a checkpoint's shapes, with a UNet's `conv_in` of fewer
    input channels than the model's (SVD's 8) at the model's shape: the
    loader zero-pads it (`expand_conv_in_weight`), as the JAX converter does."""
    state = {k: torch.empty(shape, device="meta") for k, (_, shape) in shapes.items()}
    own = model.state_dict().get("conv_in.weight")
    got = state.get("conv_in.weight")
    if own is not None and got is not None and own.dim() == got.dim() == 4:
        if got.shape[1] <= own.shape[1] and (got.shape[0], *got.shape[2:]) == (own.shape[0], *own.shape[2:]):
            state["conv_in.weight"] = torch.empty(own.shape, device="meta")
    return state


def validate_pipeline_dir(pipeline_dir: str) -> list[str]:
    """Check every sub-model of an HF-format SVD pipeline dir against the
    port's full-width models; returns a list of problem strings (empty =
    clean) and prints "<sub>: OK" or its first 10 problems.

    Each sub-model's names and shapes come from its safetensors headers
    (shards merged), so no weight is read; the models are built on the meta
    device, so none is allocated. An absent sub-model is
    "<sub>: missing safetensors"."""
    from evoworld_tpu_torch.models.clip import CLIPVisionTower
    from evoworld_tpu_torch.models.unet import UNetSpatioTemporal
    from evoworld_tpu_torch.models.vae import AutoencoderKLTemporal
    from evoworld_tpu_torch.runtime import PRESETS

    all_problems: list[str] = []
    for sub, cls, config in zip(("unet", "vae", "image_encoder"),
                                (UNetSpatioTemporal, AutoencoderKLTemporal, CLIPVisionTower), PRESETS["full"]):
        shapes = load_safetensors_dir(os.path.join(pipeline_dir, sub), reader=safetensors_shapes)
        if shapes is None:
            print(f"{sub}: MISSING safetensors")
            all_problems.append(f"{sub}: missing safetensors")
            continue
        with torch.device("meta"):
            model = cls(config)
        problems = checkpoint_mismatches(model, _meta_state(shapes, model))
        print(f"{sub}: {'OK' if not problems else problems[:10]}")
        all_problems.extend(f"{sub}: {p}" for p in problems)
    return all_problems


def validate(pipeline_dir: str) -> None:
    sys.exit(0 if not validate_pipeline_dir(pipeline_dir) else 1)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    cmd, *rest = argv
    if cmd == "halve":
        halve(*rest)
    elif cmd == "validate":
        validate(*rest)
    else:
        raise SystemExit(f"unknown command {cmd!r}\n{__doc__}")


if __name__ == "__main__":
    main()
