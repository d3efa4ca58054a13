"""The PyTorch port's evolving-memory loop against `evoworld_tpu.loop`, end to end.

A tiny 3-segment `UnifiedLoop.run_episode` runs in the port: a pipeline of
the tiny preset's widths with one layer a block in the UNet and the VAE
(64x128 panoramas, 5-frame clips, 2 denoise steps, random weights drawn by
the JAX package and carried across by `params_from_jax`), the tiny VGGT
(random weights from `build_reconstructor("tiny", seed)`), a seeded random camera
path with 4 target views a segment, 16x512 perspective crops (14x518 at
VGGT's width), and the draws the JAX loop makes from its key (per segment
`rng, sub = split(rng)`; the pipeline splits `sub` into its conditioning-noise
and latents keys), made with `jax.random` and handed to the port.

The JAX package's `UnifiedLoop.run_episode` then runs on the same episode
and key, teacher-forced at two points: its navigator returns the port's
frames of each segment, and its reconstructor returns the port's VGGT
predictions for the crops it is given. So every stage of the JAX loop sees
the port's own inputs, and the test holds, stage by stage:
  - each segment's frames against the JAX pipeline (through the JAX
    navigator's `generate_segment`) on the port's start image, memory
    frames and the pose rows the JAX loop slices: atol 2e-3 in [0, 1], the
    tolerance of a whole tiny clip;
  - the pose rows, the memory flag and the carried start image that each
    loop hands its navigator: equal;
  - the perspective crops the JAX loop gives its reconstructor against the
    port's: 1e-5;
  - the memory panoramas (alignment, confidence filter, splat) and the
    memory frames of the next segment: at most 0.5% of pixels may differ by
    more than 2e-3. The splat floors arctan2 / arcsin into pixel indices and
    the crops sample across the longitude seam, so under fp32 noise a point
    near a pixel edge can land in the neighbouring pixel; such flips are
    real and rare, while a wrong alignment, filter or splat differs in most
    pixels.
Free-running, the two loops part: segment 0's frames differ by up to 2e-3,
the random VGGT turns that into ~0.7% flipped memory pixels, and the random
tiny UNet spreads those over the next clip. VGGT itself is held against the
JAX model in tests/test_torch_port_vggt.py. Both sides run in fp32, JAX at
matmul precision "highest". One layer a block, because compiling the JAX
pipeline is most of this file's time: ~15 s with one layer a block, ~28 s
with the tiny preset's two, on this file's host; the tiny preset itself is
held at this size by tests/test_torch_port_pipeline.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.diffusion.pipeline import PipelineConfig as JPipelineConfig
from evoworld_tpu.diffusion.pipeline import make_random_pipeline as j_make_random_pipeline
from evoworld_tpu.loop.navigator import Navigator as JNavigator
from evoworld_tpu.loop.unified import LoopConfig as JLoopConfig
from evoworld_tpu.loop.unified import UnifiedLoop as JUnifiedLoop
from evoworld_tpu.models.clip import CLIPVisionConfig as JClipCfg
from evoworld_tpu.models.unet import UNetConfig as JUNetCfg
from evoworld_tpu.models.vae import VAEConfig as JVAECfg
from evoworld_tpu_torch.diffusion.pipeline import PanoDiffusionPipeline, PipelineConfig
from evoworld_tpu_torch.loop.navigator import Navigator
from evoworld_tpu_torch.loop.unified import LoopConfig, UnifiedLoop
from evoworld_tpu_torch.models.clip import CLIPVisionTower
from evoworld_tpu_torch.models.unet import UNetSpatioTemporal
from evoworld_tpu_torch.models.vae import AutoencoderKLTemporal
from evoworld_tpu_torch.models.weights import params_from_jax
from evoworld_tpu_torch.runtime import PRESETS, build_reconstructor
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SIZE = dict(height=64, width=128, num_frames=5, num_steps=2)
F, H, W = SIZE["num_frames"], SIZE["height"], SIZE["width"]
LOOP = dict(num_segments=3, num_frames=F, num_target_view=F - 1, pers_height=16, pers_width=512)
FRAME_ATOL = 2e-3
MEMORY_PIXEL_ATOL, MEMORY_MAX_FLIPPED = 2e-3, 0.005


def _pipelines():
    """The JAX package's pipeline (the tiny preset's widths, one layer a block)
    and the port's with the same weights."""
    unet_cfg, vae_cfg, clip_cfg = PRESETS["tiny"]
    unet_cfg = dataclasses.replace(unet_cfg, layers_per_block=1)
    vae_cfg = dataclasses.replace(vae_cfg, layers_per_block=1)
    jpipe = j_make_random_pipeline(
        JPipelineConfig(**SIZE),
        unet_config=JUNetCfg(block_out_channels=unet_cfg.block_out_channels,
                             num_attention_heads=unet_cfg.num_attention_heads, layers_per_block=1),
        vae_config=JVAECfg(block_out_channels=vae_cfg.block_out_channels, layers_per_block=1),
        clip_config=JClipCfg(hidden_size=clip_cfg.hidden_size, num_layers=clip_cfg.num_layers,
                             num_heads=clip_cfg.num_heads, mlp_dim=clip_cfg.mlp_dim),
        compute_dtype=jnp.float32, seed=11)
    models = [UNetSpatioTemporal(unet_cfg), AutoencoderKLTemporal(vae_cfg), CLIPVisionTower(clip_cfg)]
    for module, name in zip(models, ("unet", "vae", "clip")):
        module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jpipe.params[name])), strict=True)
    return jpipe, PanoDiffusionPipeline(*models, PipelineConfig(**SIZE), compute_dtype=torch.float32)


def _episode(seed):
    """A start frame and a smooth camera path of 3 segments plus look-ahead rows."""
    rng = np.random.default_rng(seed)
    n = 3 * (F - 1) + F + 4
    steps = rng.normal(size=(n, 6)) * np.array([0.3, 0.02, 0.3, 0.5, 6.0, 0.5]) + np.array([0, 0, 0.4, 0, 0, 0])
    camera_params = np.cumsum(steps, axis=0).astype(np.float32)
    scaled = camera_params.copy()
    scaled[:, :3] *= 0.1
    return rng.uniform(-1, 1, size=(H, W, 3)).astype(np.float32), scaled, camera_params


def _jax_draws(key, num_segments):
    """The draws the JAX loop makes from `key`, as torch tensors."""
    draws = []
    for _ in range(num_segments):
        key, sub = jax.random.split(key)
        cond_key, lat_key = jax.random.split(sub)
        draws.append(dict(latents=torch.tensor(np.asarray(jax.random.normal(lat_key, (F, H // 8, W // 8, 4)))),
                          cond_noise=torch.tensor(np.asarray(jax.random.normal(cond_key, (F + 1, H, W, 3))))))
    return draws


class _Recorder:
    """Wraps a callable; keeps each call's arguments and result."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append((args, kwargs, out))
        return out


class _ForcedNavigator:
    """The JAX loop's navigator: records what the JAX loop hands it, runs the
    real JAX `generate_segment` on the port's inputs of that segment, and
    returns the port's frames."""

    def __init__(self, navigator, port_calls):
        self.navigator, self.port_calls = navigator, port_calls
        self.inputs, self.frames = [], []

    def generate_segment(self, segment, start_image, memory_frames, rng, use_memory):
        k = len(self.inputs)
        self.inputs.append((np.asarray(segment), np.asarray(start_image), np.asarray(memory_frames), use_memory))
        (_, port_start, port_memory, _), _, port_frames = self.port_calls[k]
        with jax.default_matmul_precision("highest"):
            self.frames.append(np.asarray(self.navigator.generate_segment(
                segment, jnp.asarray(port_start.numpy()), jnp.asarray(port_memory.numpy()), rng, use_memory)))
        return jnp.asarray(port_frames.numpy())


class _ForcedReconstructor:
    """The JAX loop's reconstructor: records its crops, returns the port's predictions."""

    def __init__(self, port_calls):
        self.port_calls, self.crops = port_calls, []

    def __call__(self, pers):
        self.crops.append(np.asarray(pers))
        preds = self.port_calls[len(self.crops) - 1][2]
        return {k: jnp.asarray(v.numpy()) for k, v in preds.items()}


@pytest.fixture(scope="module")
def episodes():
    jpipe, tpipe = _pipelines()
    start, scaled, camera_params = _episode(seed=13)
    key = jax.random.key(14)
    navigator = Navigator(tpipe, num_frames=F)
    navigator.generate_segment = _Recorder(navigator.generate_segment)
    recon = _Recorder(build_reconstructor("tiny", seed=15, compute_dtype=torch.float32, device="cpu"))
    loop = UnifiedLoop(navigator, recon, LoopConfig(**LOOP))
    timings = {}
    got = loop.run_episode(torch.from_numpy(start), scaled, camera_params, draws=_jax_draws(key, 3), timings=timings)

    jnav = _ForcedNavigator(JNavigator(jpipe, num_frames=F), navigator.generate_segment.calls)
    jrecon = _ForcedReconstructor(recon.calls)
    with jax.default_matmul_precision("highest"):
        want = JUnifiedLoop(jnav, jrecon, JLoopConfig(**LOOP)).run_episode(
            jnp.asarray(start), scaled, camera_params, key)
    return dict(got=got, want=want, timings=timings, jnav=jnav, jrecon=jrecon, port_nav=navigator.generate_segment,
                port_recon=recon, episode=(start, scaled, camera_params))


def _flipped_share(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)) > MEMORY_PIXEL_ATOL).any(-1).mean())


def test_tiny_episode_frames_match(episodes):
    got, jnav = episodes["got"], episodes["jnav"]
    assert [tuple(s.shape) for s in got["segments"]] == [(F, H, W, 3), (F - 1, H, W, 3), (F - 1, H, W, 3)]
    for i, (frames, want) in enumerate(zip(episodes["port_nav"].calls, jnav.frames, strict=True)):
        out = frames[2]
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=FRAME_ATOL, err_msg=f"segment {i}")
        kept = got["segments"][i]
        assert torch.equal(kept, out if i == 0 else out[1:])  # the repeated first frame dropped after segment 0
    assert set(episodes["timings"]) == {f"generate_s{i}" for i in range(3)} | {
        f"{stage}_s{i}" for i in range(2) for stage in ("pers_extract", "reconstruct", "splat_render")}


def test_tiny_episode_hands_each_stage_the_same_inputs(episodes):
    jnav, jrecon = episodes["jnav"], episodes["jrecon"]
    assert len(jnav.inputs) == 3 and len(jrecon.crops) == 2
    for i, ((segment, start, memory, use_memory), call) in enumerate(zip(
            jnav.inputs, episodes["port_nav"].calls, strict=True)):
        port_segment, port_start, port_memory, port_use_memory = call[0]
        np.testing.assert_array_equal(np.asarray(port_segment), segment, err_msg=f"segment {i} pose rows")
        assert port_use_memory == use_memory == (i > 0)
        np.testing.assert_array_equal(port_start.numpy(), start, err_msg=f"segment {i} start image")
        assert _flipped_share(port_memory, memory) <= MEMORY_MAX_FLIPPED, f"segment {i} memory frames"
    for i, (crops, call) in enumerate(zip(jrecon.crops, episodes["port_recon"].calls, strict=True)):
        np.testing.assert_allclose(call[0][0].numpy(), crops, rtol=1e-5, atol=1e-5, err_msg=f"rebuild {i} crops")


def test_tiny_episode_memories_match(episodes):
    got, want = episodes["got"], episodes["want"]
    assert len(got["memories"]) == len(want["memories"]) == 2
    for i, (a, b) in enumerate(zip(got["memories"], want["memories"], strict=True)):
        assert a.shape == (F - 1, H, W, 3) and torch.isfinite(a).all()
        assert (np.asarray(b).sum(-1) > 0).mean() > 0.02, "the reference memory is empty: the test would prove nothing"
        flipped = _flipped_share(a, b)
        assert flipped <= MEMORY_MAX_FLIPPED, f"memory {i}: {flipped:.4%} of pixels differ"


def _stand_in_pipeline():
    """A pipeline stand-in for the loop's bookkeeping: frames mixed from the
    start image, the Pluecker rays and the memory, in [0, 1]."""

    def pipeline(start, plucker, memory, generator=None, mask_mem=False, latents=None, cond_noise=None):
        rays = torch.tanh(plucker.mean(dim=(1, 2, 3)))[:, None, None, None] * 0.3
        return torch.clamp((start[None] + 1.0) / 2.0 * 0.7 + rays + (0.0 if mask_mem else memory * 0.2), 0.0, 1.0)

    pipeline.config, pipeline.device = PipelineConfig(**SIZE), torch.device("cpu")
    return pipeline


def test_streaming_and_bounded_window(episodes):
    """With a bounded reconstruction window (the newest 5 frames), an episode
    that streams to on_segment / on_memory and drops older frames from the
    device hands out what one that keeps them returns; the window covers all
    5 frames of the first rebuild and moves the second's fit."""
    start, scaled, camera_params = episodes["episode"]
    loops = [UnifiedLoop(Navigator(_stand_in_pipeline(), num_frames=F), episodes["port_recon"].fn,
                         LoopConfig(**LOOP, max_recon_frames=max_frames, trim_residency=trim))
             for max_frames, trim in ((0, True), (F, True), (F, False))]
    full = loops[0].run_episode(torch.from_numpy(start), scaled, camera_params)
    seen = {"segments": [], "memories": []}
    out = loops[1].run_episode(torch.from_numpy(start), scaled, camera_params,
                               on_segment=lambda i, f: seen["segments"].append(f),
                               on_memory=lambda i, m: seen["memories"].append(m))
    assert out == {"segments": [], "memories": []}
    kept = loops[2].run_episode(torch.from_numpy(start), scaled, camera_params)
    for name in seen:
        assert len(seen[name]) == len(kept[name]) > 0
        for a, b in zip(seen[name], kept[name], strict=True):
            assert torch.equal(a, b)
    assert torch.equal(kept["memories"][0], full["memories"][0])
    assert not torch.equal(kept["memories"][1], full["memories"][1])
