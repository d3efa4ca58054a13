"""EDM fine-tuning entry point with validation (counterpart of
`evoworld_tpu/cli/train.py`).

Loads the UNet, VAE and CLIP from a diffusers pipeline directory (SVD's
8-channel conv_in padded to 18; random weights from `runtime.seed` where
none is given and `runtime.allow_random_weights` holds), trains the
temporal blocks, conv_in / conv_out and the norms on `data.root`'s episodes
with `train/trainer.py::train` (resume-latest, EMA, checkpoints under
`<runtime.save_dir>/checkpoints`), and every `trainer.validation_steps`
steps renders one clip of the first episode with the EMA parameters: a
GT | generated side-by-side GIF `validation_{step:06d}.gif` in
`runtime.save_dir`, its PSNR and SSIM in `validation_metrics.jsonl`.

Usage (on the card; on W cards, one process each):
  python -m evoworld_tpu_torch.cli.train --data.root=<dataset root> \\
      --data.single_episode=false --train.total_steps=30000 \\
      [--runtime.checkpoint_dir=<diffusers pipeline dir>] [--runtime.save_dir=outputs]
  torchrun --nproc-per-node W -m evoworld_tpu_torch.cli.train <the same flags> \\
      [--train.zero_stage=2] [--runtime.mesh_model=1]

With WORLD_SIZE > 1 the process group comes up (`runtime.inference_setup`)
over `runtime.mesh_data` x `runtime.mesh_model` ranks, and the global batch
is `trainer.per_device_batch_size` times the data axis; ranks on the model
axis compute their data peer's rows (no tensor parallelism, as in the JAX
CLI). The step is data-parallel at `train.zero_stage` 1 (Adam's moments
sharded) or 2 (the gradients too); rank 0 writes the checkpoints (the
one-process format: a run resumes at any rank count), the tracker and the
validation files. From Python, `main(argv, device="cpu")` runs on the CPU
(ranks on the CPU: `parallel/launch.py`). The validation clip draws from
`torch.Generator(device).manual_seed(runtime.seed)`, so its frames are not
the JAX CLI's (which draws from jax.random).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.nn as nn

from evoworld_tpu_torch.cli.common import logger, parse_config
from evoworld_tpu_torch.config import compute_dtype
from evoworld_tpu_torch.data.dataset import EpisodeDataset
from evoworld_tpu_torch.diffusion.pipeline import PanoDiffusionPipeline
from evoworld_tpu_torch.eval.metrics import batch_video_metrics
from evoworld_tpu_torch.loop.navigator import Navigator
from evoworld_tpu_torch.runtime import build_trainer, check_compute_dtype, inference_setup
from evoworld_tpu_torch.train.trainer import TrainerConfig, train
from evoworld_tpu_torch.utils.trackers import JSONLTracker
from evoworld_tpu_torch.utils.video import export_gif, side_by_side


class AutocastUNet(nn.Module):
    """The training UNet as the pipeline calls it: its fp32 masters and
    `dtype` frozen parameters compute in `dtype` under autocast, as in the
    training step's forward (the JAX pipeline casts every leaf to the
    activations' dtype the same way)."""

    def __init__(self, unet: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.unet, self.dtype = unet, dtype

    def forward(self, *args, **kwargs):
        dev = next(self.unet.parameters()).device
        with torch.autocast(dev.type, dtype=self.dtype, enabled=self.dtype != torch.float32):
            return self.unet(*args, **kwargs)


def main(argv=None, device: str | torch.device = "cuda"):
    """Run the CLI; returns the final TrainState (the UNet holding the EMA
    parameters when EMA is on)."""
    config = parse_config(argv, __doc__)
    data, rt = config.data, config.runtime

    # The output dir and step budget derive from their canonical flags; an
    # override of either would be silently replaced, so it is refused.
    defaults = TrainerConfig()
    if config.trainer.output_dir != defaults.output_dir:
        raise SystemExit("--trainer.output_dir is derived here; use --runtime.save_dir")
    if config.trainer.max_steps != defaults.max_steps:
        raise SystemExit("--trainer.max_steps is derived here; use --train.total_steps")
    trainer_config = dataclasses.replace(config.trainer, output_dir=rt.save_dir, max_steps=config.train.total_steps)
    dtype = compute_dtype(rt)
    check_compute_dtype(device, dtype)
    dev, mesh = inference_setup(device, rt.mesh_data, rt.mesh_model)

    dataset = EpisodeDataset(
        data.root,
        height=config.pipeline.height,
        width=config.pipeline.width,
        sequence_length=data.sequence_length,
        sampling=data.sampling,
        reprojection_name=data.reprojection_name,
        memory_path=data.memory_path,
        pos_scale=data.pos_scale,
        single_episode=data.single_episode,
    )
    logger.info(f"dataset: {len(dataset)} episodes")
    unet, vae, clip = build_trainer(rt.model_preset, rt.seed, dtype, dev,
                                    checkpoint_dir=rt.checkpoint_dir or rt.svd_checkpoint,
                                    allow_random_weights=rt.allow_random_weights)

    # Created once (a tracker made per call would reset its clock), by the rank that validates.
    val_tracker = JSONLTracker(rt.save_dir, run_name="validation") if mesh is None or mesh.rank == 0 else None

    def validation_fn(state, step):
        logger.info(f"validation at step {step}")
        t0 = time.perf_counter()
        pipeline = PanoDiffusionPipeline(AutocastUNet(state.unet, dtype), vae, clip, config.pipeline, dtype)
        navigator = Navigator(pipeline, num_frames=config.pipeline.num_frames)
        sample = dataset[0]
        frames = navigator.generate_segment(
            sample.cam_traj,
            torch.from_numpy(sample.pixel_values[0]).to(dev),
            torch.from_numpy(sample.memory_values[: config.pipeline.num_frames]).to(dev),
            use_memory=True,
            generator=torch.Generator(device=dev).manual_seed(rt.seed),
        )
        gt = np.clip(sample.pixel_values[: frames.shape[0]] / 2 + 0.5, 0, 1)
        scores = batch_video_metrics(frames[None], torch.from_numpy(gt[None]))
        out = os.path.join(rt.save_dir, f"validation_{step:06d}.gif")
        export_gif(side_by_side(gt, frames.cpu().numpy()), out)
        val_tracker.log(step, {"val_psnr": scores["psnr"], "val_ssim": scores["ssim"]})
        val_tracker.log_artifact(step, "validation_gif", out)
        logger.info(f"validation gif: {out} (psnr {scores['psnr']:.3f}, ssim {scores['ssim']:.4f}, "
                    f"{time.perf_counter() - t0:.3f} s)")

    batch_size = trainer_config.per_device_batch_size * (mesh.data if mesh is not None else 1)
    state = train(unet, vae, clip, dataset, config.train, trainer_config, batch_size=batch_size,
                  compute_dtype=dtype, validation_fn=validation_fn, mesh=mesh)
    logger.info(f"training done at step {state.step}")
    return state


if __name__ == "__main__":
    main()
