"""EDM fine-tuning step (counterpart of `evoworld_tpu/train/train_step.py`).

One step of the reference training loop body, on one device:

  - latents   = vae.encode(frames).sample() * 0.18215
  - cond lat  = vae.encode(frames + sigma_aug * eps) (unscaled),
                sigma_aug ~ LogNormal(-3, 0.5)
  - sigma     ~ LogNormal(0.7, 1.6); noisy = latents + sigma * eps
  - unet([c_in * noisy; first-frame lat; memory lat; Pluecker],
         t = 0.25 log sigma, CLIP ctx, added_time_ids [7, 127, sigma_aug])
  - denoised  = c_out * pred + c_skip * noisy
  - loss      = mean((1 + sigma^2) / sigma^2 * (denoised - latents)^2)
  - conditioning dropout: p zeroes CLIP + first-frame latents, 2p memory latents
  - only temporal transformer blocks, conv_in/out and every norm train;
    AdamW with global-norm clipping over the trainable set and a
    warmup-cosine learning rate.

Mixed precision as in the reference: trainable parameters keep fp32 masters,
frozen ones are stored in the compute dtype (`freeze_master_cast`), and the
UNet runs under autocast so every matmul and convolution computes in the
compute dtype while the norms keep fp32 statistics. The VAE and CLIP are
frozen and run without grad. Torch and JAX draw different random numbers, so
`edm_loss` takes each draw as an optional input (`draws`).

Data-parallel (`train_step(..., mesh=...)`, the JAX package's
`make_sharded_train_step(mesh, zero_stage)`): every rank is given the same
global micro-batches and draws and runs its data rank's rows; the trainable
gradients then become the global mean, all-reduced (ZeRO-1) or, at
`zero_stage` >= 2, reduce-scattered to the ZeRO rule's dim-0 pieces
(`parallel/mesh.py::zero_sharded`) with the rest all-reduced. The optimizer
keeps Adam's moments only for this rank's piece of each sharded leaf (both
stages), updates that piece and all-gathers the updated masters, so that
every rank holds the whole UNet.

Frame-sharded (`train_step(..., mesh, shard_frames=True)`, the JAX
package's `make_sharded_train_step(shard_frames=True)`, which constrains the
frame axis to "data"): every rank is given the same global micro-batches and
draws and keeps its frames (`parallel/mesh.py::FrameShard` over the data
axis) of the VAE encodes, the noise, the memory frames' conditioning noise
and latents, and the Pluecker rays; frame 0's conditioning latent (the
first-frame latent every frame takes) and CLIP's first frame it computes
itself. The UNet runs over the frame shard (`models/unet.py`), the loss is
the rank's part of the global mean, and the trainable gradients, each a
partial sum of the whole one, are summed over the ranks (then the ZeRO
stages act as above). Frames with a model axis of more than 1 are refused.

Tensor-parallel (`make_train_state` with `mesh.model > 1`): the weights that
`parallel/mesh.py::shard_params_tp` splits keep each model rank's slice of
output features only (`parallel/tensor_parallel.py`: masters, frozen
compute-dtype copies, and so moments and gradients), and their layers are
column parallel. Each gradient is averaged over the data ranks of its model
index (a replicated one is the same on every model rank), ZeRO acts on the
local slices, and the global norm adds the split slices' squares over the
model ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional, Sequence

import torch
import torch.nn as nn

from evoworld_tpu_torch.diffusion.scheduler import edm_loss_weight, edm_precondition
from evoworld_tpu_torch.models.clip import clip_preprocess
from evoworld_tpu_torch.ops.resize import resize_antialiased
from evoworld_tpu_torch.parallel.collectives import all_gather, all_reduce_mean, all_reduce_sum, reduce_scatter
from evoworld_tpu_torch.parallel.mesh import (
    TP_MIN_SIZE,
    ZERO_MIN_SIZE,
    FrameShard,
    Mesh,
    axes,
    shard_batch,
    shard_params_tp,
    zero_sharded,
)
from evoworld_tpu_torch.parallel.tensor_parallel import column_parallel_

#: A parameter trains when its name contains one of these (lower-cased), the
#: reference's partial unfreeze.
TRAINABLE_KEYS = ("temporal_transformer_block", "conv_in", "conv_out", "norm")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    conditioning_dropout_prob: float = 0.1
    sigma_loc: float = 0.7
    sigma_scale: float = 1.6
    cond_sigma_loc: float = -3.0
    cond_sigma_scale: float = 0.5
    vae_scaling: float = 0.18215
    fps_cond: float = 7.0
    motion_bucket_id: float = 127.0
    total_steps: int = 30000
    warmup_steps: int = 500
    lr_schedule: str = "cosine"  # "cosine" | "constant"
    # Frames per VAE-encoder call inside the loss (0 = all at once); chunking
    # is exact because frames encode independently.
    vae_encode_chunk: int = 8
    # ZeRO stage of the data-parallel step (`train_step(mesh=...)`): 1 shards
    # the Adam moments over the data ranks, >= 2 the gradients too. No mesh
    # shards nothing.
    zero_stage: int = 1


def trainable_mask(module: nn.Module) -> dict[str, bool]:
    """{parameter name: trains?} over `module`'s parameters."""
    return {name: any(key in name.lower() for key in TRAINABLE_KEYS) for name, _ in module.named_parameters()}


def freeze_master_cast(module: nn.Module, compute_dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """In place: trainable parameters become fp32 masters with grad, frozen ones
    `compute_dtype` without grad. Idempotent. Returns `module`."""
    mask = trainable_mask(module)
    for name, p in module.named_parameters():
        p.data = p.data.to(torch.float32 if mask[name] else compute_dtype)
        p.requires_grad_(mask[name])
    return module


def make_lr_schedule(config: TrainConfig) -> Callable[[int], float]:
    """Learning rate by update count: optax's warmup_cosine_decay_schedule(0,
    lr, warmup, total) (linear from 0, then cosine to 0), or a constant."""
    lr, warmup, total = config.learning_rate, config.warmup_steps, config.total_steps
    if config.lr_schedule != "cosine":
        return lambda count: lr
    if total - warmup <= 0:
        raise ValueError(f"the cosine schedule needs total_steps > warmup_steps, got {total} and {warmup}")

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        t = min(count - warmup, total - warmup)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t / (total - warmup)))

    return schedule


class AdamW(torch.optim.Optimizer):
    """optax's chain(clip_by_global_norm, adamw) over one parameter list.

    Per step: the gradients' global norm g; if g >= max_grad_norm each
    gradient becomes grad / g * max_grad_norm; then Adam moments, bias
    correction, update m_hat / (sqrt(v_hat) + eps) + weight_decay * p, and
    p -= lr(count) * update with the count before the step (so the warmup's
    first update has lr 0). A missing gradient counts as zeros. The update
    count lives in the param group and travels with `state_dict()`.

    With a `mesh` (ZeRO-1), a parameter under the ZeRO rule keeps moments
    for this data rank's dim-0 piece only and `step` updates that piece, then
    all-gathers the pieces into every rank's parameter (one collective for
    all of them). `state_dict()` gathers the moments whole, the one-process
    format (a collective: every rank calls it), and `load_state_dict` keeps
    this rank's pieces of whole moments. The pieces travel over the data
    ranks of this rank's model index. `split` flags the parameters that hold
    a tensor-parallel slice (whose squares the global norm adds over the
    model ranks).
    """

    def __init__(self, params, schedule: Callable[[int], float], b1: float, b2: float, eps: float,
                 weight_decay: float, max_grad_norm: float, mesh: Optional[Mesh] = None,
                 zero_min_size: int = ZERO_MIN_SIZE, split: Optional[Sequence[bool]] = None):
        super().__init__(list(params), dict(count=0))
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.data_axis, self.model_axis = axes(self.mesh) if self.mesh is not None else (None, None)
        self.sharded = [zero_sharded(p, self.mesh, zero_min_size) for p in self.param_groups[0]["params"]]
        self.split = list(split) if split is not None else [False] * len(self.sharded)

    def _piece(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Parameter i's piece of `x` (its whole shape) where it is sharded, else `x`."""
        return shard_batch(x, self.mesh, over_data=True) if self.sharded[i] else x

    def _global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The norm over every trainable gradient: a sharded leaf's piece (the
        gradients at ZeRO-2) adds its squares across the data ranks, a
        tensor-parallel slice across the model ranks, and a whole gradient
        counts once."""
        norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
        pieces = [i for i, (p, g) in enumerate(zip(self.param_groups[0]["params"], grads)) if g.shape != p.shape]
        split = [i for i, s in enumerate(self.split) if s]
        if not pieces and not split:
            return torch.linalg.vector_norm(norms)
        squares = norms.square()
        if pieces:
            squares[pieces] = all_reduce_sum(squares[pieces], self.data_axis)
        if split:
            squares[split] = all_reduce_sum(squares[split], self.model_axis)
        return squares.sum().sqrt()

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Apply one update from `grads` (default: each parameter's .grad;
        a sharded leaf's may be its piece); returns the global norm of the
        gradients before clipping."""
        group = self.param_groups[0]
        params = group["params"]
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        norm = self._global_norm(grads)
        clip = not bool(norm < self.max_grad_norm)
        lr = self.schedule(group["count"])
        group["count"] += 1
        bc1, bc2 = 1.0 - self.b1 ** group["count"], 1.0 - self.b2 ** group["count"]
        for i, (p, g) in enumerate(zip(params, grads)):
            target = self._piece(i, p)
            if g.shape != target.shape:
                g = self._piece(i, g)
            if clip:
                g = g / norm * self.max_grad_norm
            state = self.state[p]
            if not state:
                state["mu"], state["nu"] = torch.zeros_like(target), torch.zeros_like(target)
            mu, nu = state["mu"], state["nu"]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.weight_decay * target
            target.add_(update, alpha=-lr)
        if any(self.sharded):
            shared = [p for p, s in zip(params, self.sharded) if s]
            for p, whole in zip(shared, self._gather([shard_batch(p, self.mesh, over_data=True) for p in shared])):
                p.copy_(whole)
        return norm

    def _gather(self, pieces: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Every data rank's pieces of the sharded leaves, joined whole (one
        all-gather over the data ranks of this model index)."""
        data = self.data_axis.size
        flat = torch.cat([t.reshape(-1) for t in pieces])
        rows = all_gather(flat, self.data_axis).view(data, -1)
        out, start = [], 0
        for t in pieces:
            out.append(rows[:, start:start + t.numel()].reshape(data * t.shape[0], *t.shape[1:]))
            start += t.numel()
        return out

    def state_dict(self) -> dict:
        sd = super().state_dict()
        if any(self.sharded):
            index = [i for i, s in enumerate(self.sharded) if s and i in sd["state"]]
            if index:
                moments = self._gather([sd["state"][i][k] for i in index for k in ("mu", "nu")])
                for j, i in enumerate(index):
                    sd["state"][i] = dict(sd["state"][i], mu=moments[2 * j], nu=moments[2 * j + 1])
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)
        for i, p in enumerate(self.param_groups[0]["params"]):
            if self.sharded[i] and p in self.state:
                for k in ("mu", "nu"):
                    self.state[p][k] = self._piece(i, self.state[p][k]).clone()


def make_optimizer(config: TrainConfig, unet: nn.Module, mesh: Optional[Mesh] = None,
                   zero_min_size: int = ZERO_MIN_SIZE, split: Optional[Mapping[str, Optional[int]]] = None
                   ) -> AdamW:
    """AdamW with clipping over the trainable parameters only; frozen ones
    get no state. With a `mesh` its moments follow the ZeRO rule (tensors of
    at least `zero_min_size` elements); `split` is the tensor-parallel rule's
    map, where the UNet holds slices."""
    mask = trainable_mask(unet)
    names = [name for name, _ in unet.named_parameters() if mask[name]]
    return AdamW(
        [p for name, p in unet.named_parameters() if mask[name]],
        make_lr_schedule(config), config.adam_b1, config.adam_b2, config.adam_eps,
        config.weight_decay, config.max_grad_norm, mesh, zero_min_size,
        [split is not None and split[n] is not None for n in names],
    )


@dataclasses.dataclass
class TrainState:
    """The UNet (its parameters are the trained state), its optimizer, the
    step count and, where the loop draws from one, the loss's generator
    (checkpointed, so that a resumed run draws what the uninterrupted one would)."""

    unet: nn.Module
    optimizer: AdamW
    step: int = 0
    generator: Optional[torch.Generator] = None
    split: Optional[dict[str, Optional[int]]] = None  # the tensor-parallel rule's map, where the UNet holds slices


def make_train_state(config: TrainConfig, unet: nn.Module, compute_dtype: torch.dtype = torch.bfloat16,
                     mesh: Optional[Mesh] = None, zero_min_size: int = ZERO_MIN_SIZE,
                     tp_min_size: int = TP_MIN_SIZE, tensor_parallel: bool = True) -> TrainState:
    """The state of `unet` cast to the master-weight policy; with a `mesh`,
    its optimizer shards the moments (`train_step` then takes the same mesh).
    With `mesh.model > 1` and `tensor_parallel`, the weights that
    `shard_params_tp(unet, mesh, tp_min_size)` splits keep this model rank's
    slice (`TrainState.split` holds the rule's map); without
    `tensor_parallel` the model ranks hold the whole UNet, each repeating its
    data peer (the training CLI's layout)."""
    freeze_master_cast(unet, compute_dtype)
    split = None
    if mesh is not None and mesh.model > 1 and tensor_parallel:
        split = shard_params_tp(unet, mesh, tp_min_size)
        column_parallel_(unet, split, axes(mesh)[1])
    return TrainState(unet, make_optimizer(config, unet, mesh, zero_min_size, split), 0, split=split)


def edm_loss(
    unet: nn.Module,
    vae: nn.Module,
    clip_tower: nn.Module,
    batch: Mapping[str, torch.Tensor],
    config: TrainConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    frames: Optional[FrameShard] = None,
) -> torch.Tensor:
    """EDM denoising loss for one batch, differentiable in the UNet's trainable parameters.

    With `frames` (a frame shard of the batch's F frames) this rank encodes,
    noises and denoises its frames only, from the whole batch and draws, and
    returns its part of the global mean (the sum of its terms over the count
    of all of them): the parts of the ranks add up to the loss.

    batch (the JAX package's channels-last layouts):
      pixel_values: (B, F, H, W, 3) in [-1, 1]
      memory_values: (B, F, H, W, 3) in [-1, 1]
      plucker: (B, F, h, w, 6)
    draws: the fp32 random inputs, all of them, or None to draw them from
      `generator` on the UNet's device (`loss_draws`). Names and shapes (h, w
      the latent size):
      latent_eps (B*F, h, w, 4) and cond_latent_eps (B*(1+F), h, w, 4) normal:
        the VAE posterior samples of the frames and of the conditioning frames;
      cond_sigma_eps (B,) normal: sigma_aug = exp(-3 + 0.5 * eps);
      cond_noise (B, 1+F, H, W, 3) normal: the conditioning frames' noise;
      drop (B,) uniform: conditioning dropout;
      sigma_eps (B,) normal: sigma = exp(0.7 + 1.6 * eps);
      noise (B, F, h, w, 4) normal: the EDM noise.
    """
    dev = next(unet.parameters()).device
    px = batch["pixel_values"].to(dev, torch.float32)
    mem = batch["memory_values"].to(dev, torch.float32)
    plucker = batch["plucker"].to(dev, torch.float32).permute(0, 1, 4, 2, 3)   # (B, F, 6, h, w)
    b, f = px.shape[:2]
    lh, lw = plucker.shape[-2:]
    if draws is None:
        draws = loss_draws(batch, generator, dev)

    def draw(name, shape):
        t = draws[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"draw {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        return t.to(dev, torch.float32)

    def log_normal(name, loc, scale):  # (B,) exp(loc + scale * eps)
        return torch.exp(loc + scale * draw(name, (b,)))

    # This rank's frames, and its conditioning frames (frame 0's, then the memory's).
    own = torch.arange(f, device=dev) if frames is None else torch.arange(frames.start, frames.stop, device=dev)
    cond_own = torch.cat([own.new_zeros(1), own + 1])
    fl = own.numel()

    def sample_latents(images, name, n, rows):  # (B, N, H, W, 3) -> (B, N, 4, h, w) fp32, rows of (B, n) draws
        eps = draw(name, (b * n, lh, lw, 4)).view(b, n, lh, lw, 4)[:, rows].flatten(0, 1).permute(0, 3, 1, 2)
        z = vae.encode_sample(images.flatten(0, 1).permute(0, 3, 1, 2), eps, config.vae_encode_chunk)
        return z.view(*images.shape[:2], *z.shape[1:])

    with torch.no_grad():
        latents = sample_latents(px[:, own], "latent_eps", f, own) * config.vae_scaling
        cond_imgs = torch.cat([px[:, :1], mem[:, own]], dim=1)
        cond_sigma = log_normal("cond_sigma_eps", config.cond_sigma_loc, config.cond_sigma_scale)
        cond_noise = draw("cond_noise", (b, 1 + f, *px.shape[2:]))[:, cond_own]
        cond_imgs = cond_imgs + cond_sigma.view(b, 1, 1, 1, 1) * cond_noise
        cond_lat = sample_latents(cond_imgs, "cond_latent_eps", 1 + f, cond_own)
        first_lat = cond_lat[:, :1].expand(-1, fl, -1, -1, -1)
        mem_lat = cond_lat[:, 1:]

        x224 = resize_antialiased(px[:, 0], (224, 224))
        clip_in = clip_preprocess((x224 + 1.0) / 2.0).permute(0, 3, 1, 2)
        context = clip_tower(clip_in.to(compute_dtype)).float()[:, None, :]     # (B, 1, D)

        p = config.conditioning_dropout_prob
        rand = draw("drop", (b,))
        img_keep, mem_keep = (rand >= p).float(), (rand >= 2.0 * p).float()
        context = context * img_keep.view(b, 1, 1)
        first_lat = first_lat * img_keep.view(b, 1, 1, 1, 1)
        mem_lat = mem_lat * mem_keep.view(b, 1, 1, 1, 1)

    sigma = log_normal("sigma_eps", config.sigma_loc, config.sigma_scale)
    c_in, c_skip, c_out, timesteps = edm_precondition(sigma)
    c_in, c_skip, c_out, sig = (t.view(b, 1, 1, 1, 1) for t in (c_in, c_skip, c_out, sigma))
    noisy = latents + draw("noise", (b, f, lh, lw, 4))[:, own].permute(0, 1, 4, 2, 3) * sig
    unet_in = torch.cat([noisy * c_in, first_lat, mem_lat, plucker[:, own]], dim=2)    # (B, F, 18, h, w)
    time_ids = torch.stack([torch.full((b,), config.fps_cond, device=dev),
                            torch.full((b,), config.motion_bucket_id, device=dev), cond_sigma], dim=-1)
    with torch.autocast(dev.type, dtype=compute_dtype, enabled=compute_dtype != torch.float32):
        pred = unet(unet_in.to(compute_dtype), timesteps, context.to(compute_dtype), time_ids, frames=frames).float()
    denoised = pred * c_out + c_skip * noisy
    terms = edm_loss_weight(sig) * (denoised - latents) ** 2
    if frames is None:
        return torch.mean(terms)
    return terms.sum() / (terms.numel() // fl * f)


def loss_draws(batch: Mapping[str, torch.Tensor], generator: Optional[torch.Generator],
               device: torch.device) -> dict[str, torch.Tensor]:
    """Every random input of `edm_loss` for `batch` (see its `draws`), drawn
    from `generator` on `device`: normal but `drop`, uniform."""
    b, f, height, width = batch["pixel_values"].shape[:4]
    lh, lw = batch["plucker"].shape[2:4]

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    draws = {"latent_eps": normal(b * f, lh, lw, 4), "cond_sigma_eps": normal(b),
             "cond_noise": normal(b, 1 + f, height, width, 3), "cond_latent_eps": normal(b * (1 + f), lh, lw, 4)}
    draws["drop"] = torch.rand((b,), generator=generator, device=device)
    draws["sigma_eps"], draws["noise"] = normal(b), normal(b, f, lh, lw, 4)
    return draws


def _rows(tree: Mapping[str, torch.Tensor], b: int, mesh: Mesh) -> dict[str, torch.Tensor]:
    """This data rank's rows of a batch or of its draws: the leading axis is
    the batch `b`, or `b` x frames flattened batch-major (the posterior draws)."""
    out = {}
    for k, v in tree.items():
        if v.shape[0] == b:
            out[k] = shard_batch(v, mesh, over_data=True)
        else:
            out[k] = shard_batch(v.reshape(b, -1, *v.shape[1:]), mesh, over_data=True).flatten(0, 1)
    return out


def _reduce_gradients(optimizer: AdamW, zero_stage: int, mean: bool = True) -> list[torch.Tensor]:
    """The trainable gradients reduced over the data ranks of each model
    index, as their mean (data-parallel rows) or with `mean` False their
    sum (frame shards' partial sums): each sharded leaf's piece
    (reduce-scattered) at `zero_stage` >= 2, every other gradient whole
    (all-reduced); one collective of each kind. The `.grad`s are released."""
    axis = optimizer.data_axis
    params = optimizer.param_groups[0]["params"]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    for p in params:
        p.grad = None
    out: list = [None] * len(params)
    scatter = [zero_stage >= 2 and s for s in optimizer.sharded]
    whole = [i for i, s in enumerate(scatter) if not s]
    pieces = [i for i, s in enumerate(scatter) if s]
    if whole:
        flat = torch.cat([grads[i].reshape(-1) for i in whole])
        for i in whole:
            grads[i] = None
        (all_reduce_mean if mean else all_reduce_sum)(flat, axis)
        for i, g in zip(whole, flat.split([params[i].numel() for i in whole])):
            out[i] = g.view(params[i].shape)
    if pieces:
        rows = torch.cat([grads[i].reshape(axis.size, -1) for i in pieces], dim=1)
        del grads
        row = reduce_scatter(rows, axis, mean)
        del rows
        for i, g in zip(pieces, row.split([params[i].numel() // axis.size for i in pieces])):
            out[i] = g.view(params[i].shape[0] // axis.size, *params[i].shape[1:])
    return out


def train_step(
    state: TrainState,
    vae: nn.Module,
    clip_tower: nn.Module,
    micro_batches: Sequence[Mapping[str, torch.Tensor]],
    config: TrainConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    draws: Optional[Sequence[Mapping[str, torch.Tensor]]] = None,
    generator: Optional[torch.Generator] = None,
    mesh: Optional[Mesh] = None,
    shard_frames: bool = False,
) -> dict[str, float]:
    """One optimizer update over `micro_batches` (gradient accumulation).

    Each micro-batch's gradients accumulate; their sum is divided by the count
    (the mean over micro-batches), then the optimizer runs once and
    `state.step` advances. `draws[i]` are micro-batch i's random inputs (see
    `edm_loss`). Returns the mean loss and the gradients' global norm before
    clipping.

    With a `mesh` (the one the state was made with), every rank passes the
    same global micro-batches, whose rows the data axis must divide, and the
    same draws (or the same `generator`: the whole micro-batch's are drawn,
    `loss_draws`, then this rank's rows taken, so that the step is the
    one-process step's). The gradients become the global mean as
    `config.zero_stage` says, and every rank returns the global loss and
    norm and holds the updated UNet.

    With `shard_frames` the mesh's data axis splits every micro-batch's
    frames instead of its rows (`FrameShard`; the batch and draws are whole
    on every rank, as above): each rank's loss and gradients are its parts,
    summed over the ranks. The mesh's model axis must then be 1.
    """
    if mesh is not None and mesh.size == 1:
        mesh = None
    if (mesh is None) != (state.optimizer.mesh is None):
        raise ValueError("train_step's mesh must be the one its state was made with (make_train_state(mesh=...))")
    if shard_frames and mesh is not None and mesh.model > 1:
        raise NotImplementedError(f"shard_frames over a {mesh.data} x {mesh.model} mesh: the frame-sharded step "
                                  "runs with a model axis of 1 (frames and tensor parallelism together are not "
                                  "supported)")
    frame_axis = state.optimizer.data_axis if shard_frames and mesh is not None else None
    state.optimizer.zero_grad(set_to_none=True)
    dev = next(state.unet.parameters()).device
    loss_sum = torch.zeros((), device=dev)
    for i, batch in enumerate(micro_batches):
        micro_draws = draws[i] if draws is not None else None
        frames = None
        if mesh is not None:
            if micro_draws is None:
                micro_draws = loss_draws(batch, generator, dev)
            if frame_axis is not None:
                frames = FrameShard(frame_axis, batch["pixel_values"].shape[1])
            else:
                b = batch["pixel_values"].shape[0]
                batch, micro_draws = _rows(batch, b, mesh), _rows(micro_draws, b, mesh)
        loss = edm_loss(state.unet, vae, clip_tower, batch, config, compute_dtype, micro_draws, generator, frames)
        loss.backward()
        loss_sum += loss.detach()
    n = len(micro_batches)
    if n > 1:
        for p in state.optimizer.param_groups[0]["params"]:
            if p.grad is not None:
                p.grad.div_(n)
    grads = None
    if mesh is not None:
        grads = _reduce_gradients(state.optimizer, config.zero_stage, mean=frame_axis is None)
        if frame_axis is None:
            all_reduce_mean(loss_sum, state.optimizer.data_axis)
        else:
            all_reduce_sum(loss_sum, frame_axis)
    grad_norm = state.optimizer.step(grads)
    state.step += 1
    return {"loss": float(loss_sum / n), "grad_norm": float(grad_norm)}
