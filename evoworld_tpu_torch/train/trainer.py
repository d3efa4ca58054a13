"""Training orchestration: batching, accumulation, EMA, checkpointing,
validation, logging.

Counterpart of `evoworld_tpu/train/trainer.py`: checkpoints are
`torch.save` files with keep-limit pruning and resume-latest, the EMA of the
parameters is kept beside them, scalars go to a JSONL tracker, and a
caller's validation hook runs every `validation_steps` steps on the EMA
parameters (`cli/train.py` renders and scores a clip there).

On a mesh (one process per rank, `train(..., mesh=...)`), every rank draws
the same global batches and loss draws and `train_step` runs its rows; the
EMA is kept on every rank from the gathered masters; rank 0 alone writes
the tracker, the checkpoints (in the one-process format, the moments
gathered whole, so that a run resumes at any rank count) and the validation
files, the others waiting at a barrier after each.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import time
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn as nn

from evoworld_tpu_torch.data.prefetch import PrefetchIterator
from evoworld_tpu_torch.geometry.plucker import plucker_embedding
from evoworld_tpu_torch.geometry.pose import pose_to_matrix
from evoworld_tpu_torch.geometry.rays import equirect_ray_grid
from evoworld_tpu_torch.parallel.mesh import Mesh
from evoworld_tpu_torch.train.train_step import (
    TrainConfig,
    TrainState,
    make_lr_schedule,
    make_train_state,
    train_step,
)
from evoworld_tpu_torch.utils.trackers import JSONLTracker

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    output_dir: str = "outputs/train"
    max_steps: int = 30000
    checkpointing_steps: int = 500
    checkpoints_total_limit: int = 2
    log_steps: int = 10
    gradient_accumulation_steps: int = 1
    resume: bool = True
    use_ema: bool = False
    ema_decay: float = 0.9999
    # Batches built ahead by a background thread (0: synchronous iteration).
    prefetch_depth: int = 2
    # Steps between calls of `train`'s validation hook; the batch of one rank
    # (the training CLI's global batch is this times the data axis).
    validation_steps: int = 1000
    per_device_batch_size: int = 1


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], params: dict[str, torch.Tensor], decay: float) -> dict[str, torch.Tensor]:
    """In place: ema = ema * decay + params * (1 - decay), in fp32, stored in each EMA tensor's dtype."""
    for name, e in ema.items():
        e.copy_(e.float() * decay + params[name].float() * (1.0 - decay))
    return ema


def _barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.size > 1:
        torch.distributed.barrier()


def save_without_crc32(obj, path: str) -> None:
    """`torch.save` with the zip records' CRC-32s left out (written as 0):
    `torch.load` never reads them, and summing them cost a full-width
    checkpoint's save a large share of its seconds."""
    was = torch.serialization.get_crc32_options()
    torch.serialization.set_crc32_options(False)
    try:
        torch.save(obj, path)
    finally:
        torch.serialization.set_crc32_options(was)


class CheckpointManager:
    """`torch.save` checkpoints `<directory>/<step>.pt` with keep-limit and resume-latest.

    A checkpoint holds the step, the UNet's parameters, the optimizer's state,
    the state of the loss's generator (`TrainState.generator`, where there is
    one) and, when given, the EMA parameters. On a `mesh` every rank calls `save`
    (the optimizer gathers its moments), rank 0 alone writes and prunes, and
    the ranks meet at a barrier after it; every rank reads.
    """

    _NAME = re.compile(r"(\d+)\.pt")

    def __init__(self, directory: str, keep: int = 2, mesh: Optional[Mesh] = None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.mesh = mesh
        self.writes = mesh is None or mesh.rank == 0
        if self.writes:
            os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(self._NAME.fullmatch, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: TrainState, ema: Optional[dict[str, torch.Tensor]] = None) -> None:
        opt_state = state.optimizer.state_dict()
        if self.writes:
            tmp = self._path(step) + ".tmp"
            rng = state.generator.get_state() if state.generator is not None else None
            save_without_crc32({"step": step, "params": state.unet.state_dict(), "opt_state": opt_state, "ema": ema,
                                "rng": rng}, tmp)
            os.replace(tmp, self._path(step))
            for old in self.all_steps()[:-self.keep]:
                os.remove(self._path(old))
        del opt_state
        _barrier(self.mesh)

    def restore(self, step: int, state: TrainState) -> Optional[dict[str, torch.Tensor]]:
        """Load checkpoint `step` into `state` in place (on a mesh, each rank
        keeps its pieces of the moments; the generator's state where both
        have one); returns its EMA parameters (or None)."""
        device = next(state.unet.parameters()).device
        ckpt = torch.load(self._path(step), map_location=device, weights_only=True)
        state.unet.load_state_dict(ckpt["params"])
        state.optimizer.load_state_dict(ckpt["opt_state"])
        state.step = int(ckpt["step"])
        if state.generator is not None and ckpt.get("rng") is not None:
            state.generator.set_state(ckpt["rng"].cpu())
        if ckpt["ema"] is None:
            logger.warning(f"checkpoint step {step} has no EMA; restoring raw params only (EMA will reset)")
        return ckpt["ema"]


def run_validation(validation_fn, state: TrainState, ema: Optional[dict[str, torch.Tensor]], step: int) -> None:
    """`validation_fn(state, step)` with the EMA parameters in the UNet (when
    `ema` is given), leaving training as it was: the fp32 masters go back
    bit for bit, the EMA and the optimizer are not touched, and the UNet's
    train mode is restored. Only the trainable parameters are swapped: a
    frozen parameter's EMA equals it exactly (an average of equal values,
    rounded back to its bf16 or fp32)."""
    unet = state.unet
    training = unet.training
    masters = None
    if ema is not None:
        masters = {n: p.detach().clone() for n, p in unet.named_parameters() if p.requires_grad}
        with torch.no_grad():
            for n, p in unet.named_parameters():
                if n in masters:
                    p.copy_(ema[n])
    try:
        validation_fn(state, step)
    finally:
        if masters is not None:
            with torch.no_grad():
                for n, p in unet.named_parameters():
                    if n in masters:
                        p.copy_(masters[n])
        unet.train(training)


def episode_batches(dataset, batch_size: int, latent_hw: tuple[int, int], seed: int = 0,
                    skip: int = 0) -> Iterator[dict]:
    """Train batches with Pluecker embeddings at latent resolution, forever.

    `dataset` has `len()` and items with `pixel_values` (F, H, W, 3),
    `memory_values` (>= F, H, W, 3) and `cam_traj` (F, 6) pose rows; samples
    are drawn with replacement from a numpy generator seeded with `seed`,
    after the draws of `skip` batches (a resumed run's, none of them loaded).
    Yields CPU tensors: pixel_values and memory_values (B, F, H, W, 3),
    plucker (B, F, h, w, 6), channels-last.
    """
    rays = equirect_ray_grid(*latent_hw)
    rng = np.random.default_rng(seed)
    for _ in range(skip):
        rng.integers(0, len(dataset), size=batch_size)
    while True:
        idxs = rng.integers(0, len(dataset), size=batch_size)
        px, mem, plk = [], [], []
        for i in idxs:
            sample = dataset[int(i)]
            f = sample.pixel_values.shape[0]
            px.append(np.asarray(sample.pixel_values, np.float32))
            mem.append(np.asarray(sample.memory_values, np.float32)[:f])
            c2w = pose_to_matrix(torch.as_tensor(np.asarray(sample.cam_traj, np.float32)), relative=True)
            plk.append(plucker_embedding(rays, c2w).permute(0, 2, 3, 1))
        yield {
            "pixel_values": torch.from_numpy(np.stack(px)),
            "memory_values": torch.from_numpy(np.stack(mem)),
            "plucker": torch.stack(plk),
        }


def train(
    unet: nn.Module,
    vae: nn.Module,
    clip_tower: nn.Module,
    dataset,
    config: TrainConfig,
    trainer_config: TrainerConfig,
    batch_size: int = 1,
    compute_dtype: torch.dtype = torch.bfloat16,
    validation_fn=None,
    mesh: Optional[Mesh] = None,
) -> TrainState:
    """Run the training loop on the UNet's device; returns the final TrainState.

    `dataset` needs `height`, `width`, `len()` and the items of
    `episode_batches`. The UNet is cast in place to the master-weight policy
    (`freeze_master_cast`); the VAE and CLIP stay frozen. With
    `trainer_config.resume` the newest checkpoint under
    `<output_dir>/checkpoints` is loaded first. The random draws of the loss
    come from a torch generator on the UNet's device seeded with 0, as the
    JAX loop's key; a resumed run restores its state from the checkpoint and
    skips the batches drawn before, so that it goes on as the uninterrupted
    run would (the JAX loop starts both afresh). With EMA, the EMA
    parameters are loaded into the UNet at the end (after the final
    checkpoint, which keeps the raw ones; a step the loop has just
    checkpointed is not written again).
    `validation_fn(state, step)`, where given, runs after step `step`'s
    checkpoint whenever `step` is a multiple of `validation_steps`, through
    `run_validation` (the EMA parameters in the UNet; nothing of training
    changed, the loss's generator not drawn from).

    With a `mesh`, `batch_size` is the global batch (the data axis must
    divide it) and every rank runs this same call: see the module's
    docstring. Validation runs on rank 0 while the others wait. The model
    ranks hold the whole UNet (its checkpoints are the one-process format);
    tensor-parallel weights are `make_train_state`'s, for `train_step`.
    """
    tc = trainer_config
    if mesh is not None and mesh.size == 1:
        mesh = None
    writes = mesh is None or mesh.rank == 0
    state = make_train_state(config, unet, compute_dtype, mesh, tensor_parallel=False)
    device = next(unet.parameters()).device
    state.generator = torch.Generator(device=device).manual_seed(0)
    ckpt = CheckpointManager(os.path.join(tc.output_dir, "checkpoints"), keep=tc.checkpoints_total_limit, mesh=mesh)
    restored_ema = None
    if tc.resume and ckpt.latest_step() is not None:
        logger.info(f"Resuming from checkpoint step {ckpt.latest_step()}")
        restored_ema = ckpt.restore(ckpt.latest_step(), state)

    batches = episode_batches(dataset, batch_size, (dataset.height // 8, dataset.width // 8),
                              skip=state.step * tc.gradient_accumulation_steps)
    if tc.prefetch_depth > 0:
        batches = PrefetchIterator(batches, depth=tc.prefetch_depth)
    tracker = JSONLTracker(tc.output_dir) if writes else None
    lr_schedule = make_lr_schedule(config)

    ema = None
    if tc.use_ema:
        ema = restored_ema if restored_ema is not None else {
            n: p.detach().clone() for n, p in unet.named_parameters()}
    running, t0 = 0.0, time.time()
    start_step = saved_step = state.step
    try:
        for step in range(start_step, tc.max_steps):
            micro = [next(batches) for _ in range(tc.gradient_accumulation_steps)]
            metrics = train_step(state, vae, clip_tower, micro, config, compute_dtype, generator=state.generator,
                                 mesh=mesh)
            if ema is not None:
                ema_update(ema, dict(unet.named_parameters()), tc.ema_decay)
            running += metrics["loss"]

            if (step + 1) % tc.log_steps == 0:
                dt = time.time() - t0
                mean_loss = running / tc.log_steps
                if tracker is not None:
                    logger.info(f"step {step + 1} loss {mean_loss:.4f} ({dt / tc.log_steps:.2f}s/step)")
                    tracker.log(step + 1, {"train_loss": mean_loss, "lr": lr_schedule(step + 1),
                                           "grad_norm": metrics["grad_norm"], "sec_per_step": dt / tc.log_steps})
                running, t0 = 0.0, time.time()

            if (step + 1) % tc.checkpointing_steps == 0:
                ckpt.save(step + 1, state, ema)
                saved_step = step + 1
                logger.info(f"checkpoint saved at step {step + 1}")

            if validation_fn is not None and (step + 1) % tc.validation_steps == 0:
                if writes:
                    run_validation(validation_fn, state, ema, step + 1)
                _barrier(mesh)
    finally:
        close = getattr(batches, "close", None)
        if close is not None:
            close()

    if state.step > saved_step:
        ckpt.save(state.step, state, ema)
        logger.info(f"final checkpoint saved at step {state.step}")
    if ema is not None:
        unet.load_state_dict(ema)
    return state
