"""Single-clip panoramic video diffusion pipeline.

Counterpart of `evoworld_tpu/diffusion/pipeline.py`, in three stages:
  1. encode: CLIP-embed the first frame (antialiased 224x224; zero
     embedding for the unconditional half), VAE-encode the first frame and
     the memory frames with noise augmentation in chunks of `encode_chunk`,
     and assemble per-frame conditioning (first-frame latent + memory latent
     + 6-channel Pluecker = 14 channels, 18 with the noisy latent);
  2. denoise: Euler/Karras steps of the UNet with CFG as a batch of 2 and
     per-frame guidance linspace(min, max);
  3. decode: the temporal VAE in chunks of `decode_chunk`.
Latent math runs in fp32, model compute in `compute_dtype`.

With a mesh (a multi-GPU run, one process per rank, every rank given the
same inputs and draws) the three stages are split over the ranks and every
rank returns the whole clip, as the JAX package's pipeline does on its mesh:
the conditioning encode by chunks of frames, the denoise by frames (the
mesh's data axis splits the clip's frames by `parallel/mesh.py::FrameShard`,
13 + 12 at W = 2; every rank runs both guidance halves on its frames, the
UNet's cross-frame layers reaching the other ranks, and the latents are
joined once, after the last step; the model ranks of one data rank hold the
same frames), and the decode by chunks. A clip of fewer frames than data
ranks is refused when the pipeline is built.

Public layouts are the JAX package's: image (H, W, 3) in [-1, 1], plucker
(F, 6, h, w), memory (F, H, W, 3), latents (F, h, w, 4), output
(F, H, W, 3) in [0, 1]. Torch and JAX draw different random numbers, so
`__call__` takes both draws (`latents`, `cond_noise`) as optional inputs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from evoworld_tpu_torch.device import resolve_device
from evoworld_tpu_torch.diffusion.scheduler import (
    EulerScheduleConfig,
    euler_step,
    karras_sigmas,
    scale_model_input,
    sigma_to_timestep,
)
from evoworld_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower, clip_preprocess
from evoworld_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporal
from evoworld_tpu_torch.models.vae import AutoencoderKLTemporal, VAEConfig
from evoworld_tpu_torch.models.weights import init_random_
from evoworld_tpu_torch.ops.resize import resize_antialiased
from evoworld_tpu_torch.parallel.collectives import all_gather, gather_frames
from evoworld_tpu_torch.parallel.mesh import FrameShard, axes, shard_bounds


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    height: int = 576
    width: int = 1024
    num_frames: int = 25
    num_steps: int = 25
    min_guidance: float = 1.0
    max_guidance: float = 3.0
    fps: int = 7
    motion_bucket_id: int = 127
    noise_aug_strength: float = 0.02
    decode_chunk: int = 5
    encode_chunk: int = 2  # must divide num_frames + 1
    vae_scaling: float = 0.18215
    schedule: EulerScheduleConfig = EulerScheduleConfig()

    @property
    def latent_height(self) -> int:
        return self.height // 8

    @property
    def latent_width(self) -> int:
        return self.width // 8


class PanoDiffusionPipeline:
    """The three models plus the clip's stages; `__call__` generates one clip.

    The models are expected on one device, already in `compute_dtype`. With
    a mesh, `frame_shard` is this rank's share of the denoise (None without one).
    """

    def __init__(
        self,
        unet: UNetSpatioTemporal,
        vae: AutoencoderKLTemporal,
        clip_tower: CLIPVisionTower,
        config: PipelineConfig = PipelineConfig(),
        compute_dtype: torch.dtype = torch.bfloat16,
        mesh=None,
    ):
        c = config
        if (c.num_frames + 1) % c.encode_chunk or c.num_frames % c.decode_chunk:
            raise ValueError("encode_chunk must divide num_frames + 1 and decode_chunk num_frames")
        self.unet, self.vae, self.clip_tower = unet.eval(), vae.eval(), clip_tower.eval()
        self.config = config
        self.compute_dtype = compute_dtype
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = next(unet.parameters()).device
        self.frame_shard = None
        if self.mesh is not None:
            self.frame_shard = FrameShard(axes(self.mesh)[0], c.num_frames)  # raises on fewer frames than data ranks

    def _sharded(self, fn, chunks: list) -> torch.Tensor:
        """torch.cat of fn(chunk) over `chunks` (all of one size). With a mesh
        each rank computes its contiguous share, a rank past the end
        repeating the last chunk so that every share has one size, and an
        all-gather joins them, cut back to the chunks' rows."""
        if self.mesh is None:
            return torch.cat([fn(c) for c in chunks])
        start, stop, _ = shard_bounds(len(chunks), self.mesh)
        mine = torch.cat([fn(chunks[min(i, len(chunks) - 1)]) for i in range(start, stop)])
        return all_gather(mine, self.mesh)[: sum(c.shape[0] for c in chunks)]

    @torch.no_grad()
    def __call__(
        self,
        image: torch.Tensor,
        plucker: torch.Tensor,
        memory_frames: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        mask_mem: bool = False,
        latents: Optional[torch.Tensor] = None,
        cond_noise: Optional[torch.Tensor] = None,
        timings: Optional[dict] = None,
    ) -> torch.Tensor:
        """Generate one clip.

        Args:
            image: (H, W, 3) first frame in [-1, 1].
            plucker: (F, 6, h, w) Pluecker embedding.
            memory_frames: (F, H, W, 3) rendered memory panoramas in [-1, 1].
            generator: draws `latents` and `cond_noise` where they are not given.
            mask_mem: zero the memory conditioning latents.
            latents: optional (F, h, w, 4) standard-normal initial noise.
            cond_noise: optional (F+1, H, W, 3) standard-normal noise added to
                the conditioning frames (scaled by noise_aug_strength).
            timings: if given, filled with each stage's host seconds
                ("encode", "denoise", "decode"); the device is synchronised
                after every stage to measure them.

        Returns:
            (F, H, W, 3) fp32 frames in [0, 1].
        """
        c = self.config
        dev = self.device
        if latents is None:
            latents = torch.randn((c.num_frames, c.latent_height, c.latent_width, 4),
                                  generator=generator, device=dev, dtype=torch.float32)
        if cond_noise is None:
            cond_noise = torch.randn((c.num_frames + 1, c.height, c.width, 3),
                                     generator=generator, device=dev, dtype=torch.float32)
        t0 = time.perf_counter()

        def mark(stage):
            nonlocal t0
            if timings is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                now = time.perf_counter()
                timings[stage] = now - t0
                t0 = now

        context_cfg, cond_cfg = self.encode(image, plucker, memory_frames, cond_noise, mask_mem)
        mark("encode")
        denoised = self.denoise(latents, context_cfg, cond_cfg)
        mark("denoise")
        frames = self.decode(denoised)
        mark("decode")
        return frames

    @torch.no_grad()
    def encode(self, image, plucker, memory_frames, cond_noise, mask_mem=False):
        """-> context_cfg (2, 1, 1024) and cond_cfg (2, F, 14, h, w) fp32."""
        c = self.config
        dev, dtype = self.device, self.compute_dtype
        f = c.num_frames
        image = image.to(dev, torch.float32)

        x224 = resize_antialiased(image[None], (224, 224))
        clip_in = clip_preprocess((x224 + 1.0) / 2.0).permute(0, 3, 1, 2)
        context = self.clip_tower(clip_in.to(dtype))[:, None, :]              # (1, 1, 1024)
        context_cfg = torch.cat([torch.zeros_like(context), context], 0)      # (2, 1, 1024)

        cond_images = torch.cat([image[None], memory_frames.to(dev, torch.float32)], 0)
        cond_images = cond_images + c.noise_aug_strength * cond_noise.to(dev, torch.float32)
        cond_images = cond_images.permute(0, 3, 1, 2)                         # (1+F, 3, H, W)
        cond_latents = self._sharded(lambda chunk: self.vae.encode_mode(chunk.to(dtype)).float(),
                                     list(cond_images.split(c.encode_chunk)))  # (1+F, 4, h, w)

        first_lat = cond_latents[0:1].expand(f, -1, -1, -1)
        mem_lat = cond_latents[1:] * (0.0 if mask_mem else 1.0)
        pl = plucker.to(dev, torch.float32)                                    # (F, 6, h, w)
        cond = torch.cat([first_lat, mem_lat, pl], 1)                          # (F, 14, h, w)
        uncond = torch.cat([torch.zeros_like(first_lat), torch.zeros_like(mem_lat), pl], 1)
        return context_cfg, torch.stack([uncond, cond], 0)

    def frame_guidance(self) -> torch.Tensor:
        """(1, F_r, 1, 1, 1): the guidance scale of each frame this rank
        denoises, linspace(min, max) over the clip's F frames taken at their
        frame indices (F_r = F without a mesh)."""
        c = self.config
        guidance = torch.linspace(c.min_guidance, c.max_guidance, c.num_frames, device=self.device)
        if self.frame_shard is not None:
            guidance = guidance[self.frame_shard.start:self.frame_shard.stop]
        return guidance.view(1, -1, 1, 1, 1)

    @torch.no_grad()
    def denoise(self, init_noise, context_cfg, cond_cfg):
        """(F, h, w, 4) standard-normal noise -> (F, 4, h, w) fp32 denoised
        latents. With a mesh this rank denoises its frames, both guidance
        halves a UNet call, and every rank ends with the whole clip's
        latents, the same bit for bit."""
        c = self.config
        dev, dtype, frames = self.device, self.compute_dtype, self.frame_shard
        time_ids = torch.tensor([[c.fps - 1, c.motion_bucket_id, c.noise_aug_strength]] * 2,
                                dtype=torch.float32, device=dev)
        sigmas = karras_sigmas(c.num_steps, c.schedule, device=dev)
        guidance = self.frame_guidance()

        lat = init_noise.to(dev, torch.float32).permute(0, 3, 1, 2) * sigmas[0]  # (F, 4, h, w)
        if frames is not None:
            lat, cond_cfg = lat[frames.start:frames.stop], cond_cfg[:, frames.start:frames.stop]
        for i in range(c.num_steps):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            lat_in = scale_model_input(lat, sigma)[None].expand(2, -1, -1, -1, -1)
            unet_in = torch.cat([lat_in, cond_cfg], dim=2)                     # (2, F_r, 18, h, w)
            out = self.unet(unet_in.to(dtype), sigma_to_timestep(sigma), context_cfg, time_ids, frames=frames).float()
            pred = out[0:1] + guidance * (out[1:2] - out[0:1])
            lat = euler_step(pred[0], lat, sigma, sigma_next)
        return lat if frames is None else gather_frames(lat, frames)

    @torch.no_grad()
    def decode(self, latents):
        """(F, 4, h, w) latents -> (F, H, W, 3) fp32 frames in [0, 1]."""
        c = self.config
        frames = self._sharded(lambda chunk: self.vae.decode(chunk.to(self.compute_dtype), c.decode_chunk).float(),
                               list((latents / c.vae_scaling).split(c.decode_chunk)))
        return torch.clamp(frames.permute(0, 2, 3, 1) / 2.0 + 0.5, 0.0, 1.0)


def empty_model(cls, config, device, dtype):
    """`cls(config)` on `device` in `dtype`, built on the meta device: its storage is uninitialised."""
    with torch.device("meta"):
        model = cls(config)
    return model.to_empty(device=device).to(dtype)


def random_model(cls, config, generator, device, dtype):
    """`cls(config)` on `device` in `dtype`, filled by `init_random_` from `generator`."""
    return init_random_(empty_model(cls, config, device, dtype), generator)


def make_random_pipeline(
    config: PipelineConfig = PipelineConfig(),
    unet_config: Optional[UNetConfig] = None,
    vae_config: Optional[VAEConfig] = None,
    clip_config: Optional[CLIPVisionConfig] = None,
    seed: int = 0,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    mesh=None,
) -> PanoDiffusionPipeline:
    """A pipeline with deterministic random weights, made on `device` from `seed`
    (the same on every rank of `mesh`, which it shards over when given).

    Modules are built on the meta device and filled in place, so the full
    1.5B-parameter UNet never passes through host memory. Each model gets
    its own stream (seed*3 + 0/1/2), as in the JAX package.
    """
    dev = resolve_device(device)

    def gen(salt):
        return torch.Generator(device=dev).manual_seed(seed * 3 + salt)

    unet = random_model(UNetSpatioTemporal, unet_config or UNetConfig(), gen(0), dev, compute_dtype)
    vae = random_model(AutoencoderKLTemporal, vae_config or VAEConfig(), gen(1), dev, compute_dtype)
    clip = random_model(CLIPVisionTower, clip_config or CLIPVisionConfig(), gen(2), dev, compute_dtype)
    return PanoDiffusionPipeline(unet, vae, clip, config, compute_dtype, mesh)
