"""The composed multi-GPU loop gate and the rank functions of the port's
sharded checks (counterpart of `evoworld_tpu/parallel/checks.py`).

One tiny episode of the evolving-memory loop with the mesh in all three
stages at once (the clip with its denoise split by frames, VGGT with frames
split and its global attention on the head-sharded route, the view-sharded
render), held to the same episode run in one process by
`assert_episode_close`: at least 99% of pixels within 3e-2, and no segment
pixel more than 0.2 away (a splatted point that a reordered sum moves
across a pixel edge, or past another at a z-buffer tie, changes a memory
pixel outright, so the memories get the share alone). The configurations
are the JAX gate's: `tiny_gate_pipeline_setup`, `tiny_gate_vggt`.

The rank functions take the rank's `parallel.mesh.Mesh` first, as
`parallel/launch.py::spawn` calls them, and return CPU tensors.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def tiny_gate_pipeline_setup(n_devices: int):
    """(num_frames, PipelineConfig, make_random_pipeline keyword arguments) of the gate's tiny pipeline."""
    from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
    from evoworld_tpu_torch.models.clip import CLIPVisionConfig
    from evoworld_tpu_torch.models.unet import UNetConfig
    from evoworld_tpu_torch.models.vae import VAEConfig

    f = n_devices
    cfg = PipelineConfig(height=64, width=128, num_frames=f, num_steps=2, decode_chunk=f, encode_chunk=f + 1)
    kwargs = dict(
        unet_config=UNetConfig(block_out_channels=(32, 64, 128, 128), num_attention_heads=(2, 4, 8, 8),
                               layers_per_block=1),
        vae_config=VAEConfig(block_out_channels=(32, 64, 128, 128)),
        clip_config=CLIPVisionConfig(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128),
        compute_dtype=torch.float32,
        seed=7,
    )
    return f, cfg, kwargs


def tiny_gate_vggt(n_devices: int, device: str | torch.device = "cpu", dtype: torch.dtype = torch.float32):
    """The gate's tiny VGGT, random from seed 3; heads == n_devices, so the
    global attention takes the head-sharded route."""
    from evoworld_tpu_torch.models.vggt.aggregator import AggregatorConfig
    from evoworld_tpu_torch.models.vggt.model import VGGT, VGGTConfig
    from evoworld_tpu_torch.models.weights import init_random_

    with torch.device("meta"):
        model = VGGT(VGGTConfig(aggregator=AggregatorConfig(
            embed_dim=8 * n_devices, depth=4, num_heads=n_devices, num_register_tokens=2,
            output_layers=(0, 1, 2, 3), patch_encoder_depth=1)))
    dev = torch.device(device)
    return init_random_(model.to_empty(device=dev), torch.Generator(device=dev).manual_seed(3)).to(dtype)


def _gate_reconstructor(n_devices: int, mesh, dev: torch.device):
    """The gate's tiny VGGT as a reconstructor whose global attention takes
    the mesh route from 16 tokens (the tiny sequences are far below 4096)."""
    from evoworld_tpu_torch.models.vggt.model import make_reconstructor
    from evoworld_tpu_torch.ops.attention import head_sharded_attention

    base = make_reconstructor(tiny_gate_vggt(n_devices, dev).requires_grad_(False), torch.float32, mesh=mesh)

    def recon(images):
        with head_sharded_attention(None, 16):  # a threshold for the aggregator's own context; routes nothing
            return base(images)

    return recon


def run_composed_loop(n_devices: int, mesh=None, device: str | torch.device = "cpu", memories=None) -> dict:
    """The tiny 2-segment episode, sharded over `mesh` (None: one process).
    Returns the `run_episode` dict with CPU tensors. With `memories` (another
    run's renders) the episode is teacher-forced at the memory: each rebuild
    still renders (and returns) its own, but the next segment is conditioned
    on the given one, so that a segment is compared with another run's given
    the same conditioning."""
    from evoworld_tpu_torch.diffusion.pipeline import make_random_pipeline
    from evoworld_tpu_torch.loop.navigator import Navigator
    from evoworld_tpu_torch.loop.unified import LoopConfig, UnifiedLoop

    dev = torch.device(device)
    f, pipe_cfg, pipe_kwargs = tiny_gate_pipeline_setup(n_devices)
    pipe = make_random_pipeline(pipe_cfg, device=dev, mesh=mesh, **pipe_kwargs)
    recon = _gate_reconstructor(n_devices, mesh, dev)
    loop_cfg = LoopConfig(num_segments=2, num_frames=f, num_target_view=f - 1, pers_height=48, pers_width=64)
    n_poses = 2 * (f - 1) + f + 5
    poses = np.zeros((n_poses, 6), np.float32)
    poses[:, 2] = np.arange(n_poses) * 0.4
    start = torch.full((64, 128, 3), 0.1, device=dev)
    loop = UnifiedLoop(Navigator(pipe, num_frames=f), recon, loop_cfg, mesh=mesh)
    own = []
    if memories is not None:
        rebuild = loop.rebuild_memory

        def forced(*args, **kwargs):
            own.append(rebuild(*args, **kwargs))
            return memories[len(own) - 1].to(dev)

        loop.rebuild_memory = forced
    out = loop.run_episode(start, poses * 0.1, poses, draws=torch.Generator(device=dev).manual_seed(0))
    if memories is not None:
        out["memories"] = own
    return {k: [t.cpu() for t in v] for k, v in out.items()}


def assert_episode_close(ref: dict, got: dict) -> None:
    """Sharded episode == one-process episode, up to splat flips in the memory."""
    if len(got["segments"]) != 2 or len(got["memories"]) != 1:
        raise AssertionError(f"{len(got['segments'])} segments and {len(got['memories'])} memories, expected 2 and 1")
    for name, max_abs in (("segments", 0.2), ("memories", None)):
        for i, (a, b) in enumerate(zip(ref[name], got[name])):
            diff = np.abs(np.asarray(a) - np.asarray(b))
            frac = (diff <= 3e-2).mean()
            if frac < 0.99:
                raise AssertionError(f"{name} {i}: only {frac:.4f} of pixels within 3e-2")
            if max_abs is not None and diff.max() > max_abs:
                raise AssertionError(f"{name} {i}: max abs diff {diff.max():.3f}")


def attention_rank(mesh, cases: list) -> dict:
    """Each case (name, q, k, v numpy (B, S, H, D)) through
    `multi_head_attention` under `head_sharded_attention(mesh, 1)` (head
    sharding where the mesh size divides H, else the ring) on this rank's
    device -> {name: output, "_mesh": (data, model, rank, backend)}."""
    from evoworld_tpu_torch.ops.attention import head_sharded_attention, multi_head_attention

    out = {"_mesh": (mesh.data, mesh.model, mesh.rank, mesh.backend)}
    for name, q, k, v in cases:
        with torch.no_grad(), head_sharded_attention(mesh, min_seq=1):
            out[name] = multi_head_attention(*(torch.as_tensor(t, device=mesh.device) for t in (q, k, v))).cpu()
    return out


def render_rank(mesh, points, colors, valid, poses, height: int, width: int) -> torch.Tensor:
    """`memory/render.py::render_memory_panoramas` of numpy inputs, views split over `mesh`."""
    from evoworld_tpu_torch.memory.render import render_memory_panoramas

    args = [torch.as_tensor(a, device=mesh.device) for a in (points, colors, valid, poses)]
    return render_memory_panoramas(*args, height, width, mesh=mesh).cpu()


def gate_clip(n_devices: int, mesh=None, device: str | torch.device = "cpu") -> torch.Tensor:
    """One clip of the gate's tiny pipeline on fixed inputs and draws (sharded over `mesh` when given)."""
    from evoworld_tpu_torch.diffusion.pipeline import make_random_pipeline

    dev = torch.device(device)
    f, cfg, kwargs = tiny_gate_pipeline_setup(n_devices)
    pipe = make_random_pipeline(cfg, device=dev, mesh=mesh, **kwargs)
    g = torch.Generator().manual_seed(5)
    image = torch.rand((cfg.height, cfg.width, 3), generator=g) * 2 - 1
    plucker = torch.randn((f, 6, cfg.latent_height, cfg.latent_width), generator=g)
    memory = torch.rand((f, cfg.height, cfg.width, 3), generator=g) * 2 - 1
    latents = torch.randn((f, cfg.latent_height, cfg.latent_width, 4), generator=g)
    cond_noise = torch.randn((f + 1, cfg.height, cfg.width, 3), generator=g)
    return pipe(*(t.to(dev) for t in (image, plucker, memory)), latents=latents.to(dev),
                cond_noise=cond_noise.to(dev)).cpu()


def serving_clip_rank(mesh, models: dict, frames: int, inputs: dict, control: bool = False) -> dict:
    """One clip of the gate's tiny pipeline at `frames` frames, its weights
    `models` ({"unet" | "vae" | "clip": state dict}), on the numpy `inputs`
    (image, plucker, memory_frames, latents, cond_noise), sharded over `mesh`
    (None: one process). Returns the clip, each UNet call's [batch, frames,
    first frame, last frame + 1] (the shard's; None for the frames of a
    call without one) and, with `control`, the clip of a pipeline whose
    ranks read guidance from their own first frame: the clip's first
    frames' guidance, not their own (a wrong split the checks must catch)."""
    from evoworld_tpu_torch.diffusion.pipeline import PanoDiffusionPipeline, empty_model
    from evoworld_tpu_torch.models.clip import CLIPVisionTower
    from evoworld_tpu_torch.models.unet import UNetSpatioTemporal
    from evoworld_tpu_torch.models.vae import AutoencoderKLTemporal

    dev = torch.device("cpu") if mesh is None else mesh.device
    _, cfg, kwargs = tiny_gate_pipeline_setup(frames)
    built = {}
    for name, cls, key in (("unet", UNetSpatioTemporal, "unet_config"), ("vae", AutoencoderKLTemporal, "vae_config"),
                           ("clip", CLIPVisionTower, "clip_config")):
        built[name] = empty_model(cls, kwargs[key], dev, torch.float32)
        built[name].load_state_dict(models[name])
    args = [torch.as_tensor(inputs[k]).to(dev) for k in ("image", "plucker", "memory_frames")]
    draws = {k: torch.as_tensor(inputs[k]).to(dev) for k in ("latents", "cond_noise")}

    def clip(cls):
        pipe = cls(built["unet"], built["vae"], built["clip"], cfg, torch.float32, mesh)
        calls = []

        def record(module, call_args, call_kwargs):
            shard = call_kwargs.get("frames")
            calls.append([*call_args[0].shape[:2], *((shard.start, shard.stop) if shard else (None, None))])

        hook = pipe.unet.register_forward_pre_hook(record, with_kwargs=True)
        try:
            return pipe(*args, **draws).cpu(), calls
        finally:
            hook.remove()

    class LocalGuidance(PanoDiffusionPipeline):
        def frame_guidance(self):  # the clip's first F_r frames' guidance, whichever frames the rank holds
            c, count = self.config, super().frame_guidance().shape[1]
            whole = torch.linspace(c.min_guidance, c.max_guidance, c.num_frames, device=self.device)
            return whole[:count].view(1, -1, 1, 1, 1)

    out, calls = clip(PanoDiffusionPipeline)
    result = {"clip": out, "unet_calls": calls}
    if control:
        result["control"] = clip(LocalGuidance)[0]
    return result


def gate_reconstruct(n_devices: int, frames: int, mesh=None, device: str | torch.device = "cpu") -> dict:
    """The gate's tiny VGGT on `frames` fixed 16x512 crops (one patch row at
    width 518), sharded over `mesh` when given, its global attention on the
    mesh routes from 16 tokens."""
    dev = torch.device(device)
    recon = _gate_reconstructor(n_devices, mesh, dev)
    crops = torch.rand((frames, 16, 512, 3), generator=torch.Generator().manual_seed(6))
    return {k: v.cpu() for k, v in recon(crops.to(dev)).items()}


def sharded_serving_rank(mesh, n_devices: int, vggt_frames: int) -> dict:
    """The clip, VGGT and the composed loop of the gate on this rank, sharded over `mesh`."""
    return {"clip": gate_clip(n_devices, mesh, mesh.device),
            "vggt": gate_reconstruct(n_devices, vggt_frames, mesh, mesh.device),
            "loop": run_composed_loop(n_devices, mesh, mesh.device)}


def _launch_counts() -> list:
    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward

    return [flash_attention.launches, flash_attention_backward.launches]


def _reset_launch_counts() -> None:
    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward

    flash_attention.launches = flash_attention_backward.launches = 0


def route_rank(mesh, shape: tuple, dtype: str, seed: int) -> dict:
    """Self-attention of (B, S, H, D) draws (the same on every rank) in
    `dtype` through the mesh route on this rank's card: its flash launches
    (counted from 0 around the routed call alone), its milliseconds (a
    second, warm call between barriers), and its errors over the RMS of the
    plain version in fp32 on the same inputs, and against the one-process
    kernel's output."""
    import torch.distributed as dist

    from evoworld_tpu_torch.ops.attention import head_sharded_attention, multi_head_attention
    from evoworld_tpu_torch.ops.flash_attention import flash_attention_forward, flash_attention_plain

    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(getattr(torch, dtype)) for _ in range(3))
    scale = 1.0 / shape[-1] ** 0.5
    with torch.no_grad(), head_sharded_attention(mesh):
        _reset_launch_counts()
        out = multi_head_attention(q, k, v)
        torch.cuda.synchronize(dev)
        launches = _launch_counts()
        dist.barrier()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        again = multi_head_attention(q, k, v)
        end.record()
        end.synchronize()
        dist.barrier()
        single = flash_attention_forward(q, k, v, scale, shape[1])[0]
        plain = flash_attention_plain(q.float(), k.float(), v.float(), scale)
    err = (out.float() - plain).abs()
    rms = plain.pow(2).mean().sqrt()
    return dict(route="head_sharded" if shape[2] % mesh.size == 0 else "ring", world_size=mesh.size, rank=mesh.rank,
                shape=list(shape), dtype=dtype, launches=launches, ms=start.elapsed_time(end),
                max_abs_err=err.max().item(), max_rel_err=(err.max() / rms).item(),
                mean_rel_err=(err.mean() / rms).item(), max_abs_vs_one_process=(out - single).abs().max().item(),
                repeat_equal=bool(torch.equal(out, again)), finite=bool(torch.isfinite(out).all()))


def gate_rank(mesh, n_devices: int) -> dict:
    """The composed loop gate's sharded episode on this rank's device, with
    TF32 off (full fp32, as the one-process side runs it), and its flash launches."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    _reset_launch_counts()
    out = run_composed_loop(n_devices, mesh, mesh.device)
    return {"loop": out, "launches": _launch_counts()}


def episode_rank(mesh, steps: int, num_segments: int, seed: int, scaled, camera_params) -> dict:
    """A full-width episode (`LoopConfig()` but `num_segments`, 1024x576,
    `steps` denoise steps, bf16, the pipeline and VGGT-1B random from `seed`)
    sharded over `mesh`, on the camera rows given: seconds, stage seconds,
    peak memory, flash launches, each output's shape, finiteness and SHA-256
    (the ranks' outputs are compared by it), and on rank 0 the first
    segment's frames (to hold against the same episode in one process)."""
    import dataclasses
    import hashlib
    import time

    from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
    from evoworld_tpu_torch.loop.navigator import Navigator
    from evoworld_tpu_torch.loop.unified import LoopConfig, UnifiedLoop
    from evoworld_tpu_torch.runtime import build_pipeline, build_reconstructor

    dev = mesh.device
    cfg, loop_cfg = PipelineConfig(num_steps=steps), dataclasses.replace(LoopConfig(), num_segments=num_segments)
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, "full", seed=seed, compute_dtype=torch.bfloat16, device=dev, mesh=mesh)
    recon = build_reconstructor("full", seed=seed, compute_dtype=torch.bfloat16, device=dev, mesh=mesh)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    start = torch.rand((cfg.height, cfg.width, 3), generator=g, device=dev) * 2 - 1
    loop = UnifiedLoop(Navigator(pipe, num_frames=loop_cfg.num_frames), recon, loop_cfg, mesh=mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    _reset_launch_counts()
    t0 = time.perf_counter()
    out = loop.run_episode(start, scaled, camera_params, draws=g, timings=timings)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    outputs = [("segment", t) for t in out["segments"]] + [("memory", t) for t in out["memories"]]
    return dict(rank=mesh.rank, world_size=mesh.size, steps=steps, num_segments=num_segments, build_s=build_s,
                seconds=seconds, stage_seconds=timings, peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
                launches=_launch_counts(), first_segment=out["segments"][0].cpu() if mesh.rank == 0 else None,
                outputs=[dict(kind=kind, shape=list(t.shape), finite=bool(torch.isfinite(t).all()),
                              sha256=hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest())
                         for kind, t in outputs])


def cli_rank(mesh, module: str, argv: list) -> list:
    """`evoworld_tpu_torch.cli.<module>.main(argv)` on this rank's device,
    as `torchrun --nproc-per-node W -m evoworld_tpu_torch.cli.<module>` runs it."""
    import importlib

    return importlib.import_module(f"evoworld_tpu_torch.cli.{module}").main(argv, device=str(mesh.device))


def train_step_rank(mesh, models: dict, config: dict, micro_batches: list, draws: list,
                    zero_min_size: int = 1 << 16, shard_frames: bool = False, tp_min_size: int = 1 << 16) -> dict:
    """One sharded `train_step` over `mesh` (None: one process) from the given
    models (`models`: {"unet" | "vae" | "clip": (config, state dict)}, fp32)
    on the global `micro_batches` with their global `draws` (numpy), the
    `TrainConfig` fields `config`, the ZeRO rule from `zero_min_size`
    elements, frames sharded where `shard_frames`, and on a model axis of
    more than 1 the tensor-parallel rule from `tp_min_size` elements.
    Returns the loss and gradient norm, the gradients the optimizer was
    given (a sharded leaf's: this rank's piece at ZeRO-2, a split one's:
    this model rank's slice), which leaves the ZeRO rule shards, which the
    tensor-parallel rule splits, the updated trainable parameters (split
    ones: the slice), the optimizer's `state_dict()` (moments gathered over
    the data ranks) and what this rank stores: each UNet parameter's shape
    and each trainable one's moment's."""
    from evoworld_tpu_torch.models.clip import CLIPVisionTower
    from evoworld_tpu_torch.models.unet import UNetSpatioTemporal
    from evoworld_tpu_torch.models.vae import AutoencoderKLTemporal
    from evoworld_tpu_torch.train.train_step import TrainConfig, make_train_state, train_step

    built = {}
    for name, cls in (("unet", UNetSpatioTemporal), ("vae", AutoencoderKLTemporal), ("clip", CLIPVisionTower)):
        cfg, state = models[name]
        built[name] = cls(cfg)
        built[name].load_state_dict(state)
    cfg = TrainConfig(**config)
    state = make_train_state(cfg, built["unet"], torch.float32, mesh, zero_min_size, tp_min_size)
    names = [n for n, p in built["unet"].named_parameters() if p.requires_grad]
    given = {}
    step = state.optimizer.step

    def recording_step(grads=None):
        params = state.optimizer.param_groups[0]["params"]
        if grads is None:  # one process: the accumulated .grad (a missing one counts as zeros)
            grads_ = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        given.update(zip(names, [g.clone() for g in (grads if grads is not None else grads_)]))
        return step(grads)

    state.optimizer.step = recording_step
    as_torch = [{k: torch.as_tensor(v) for k, v in tree.items()} for tree in micro_batches]
    metrics = train_step(state, built["vae"].requires_grad_(False), built["clip"].requires_grad_(False), as_torch,
                         cfg, torch.float32, draws=[{k: torch.as_tensor(v) for k, v in d.items()} for d in draws],
                         mesh=mesh, shard_frames=shard_frames)
    params = dict(built["unet"].named_parameters())
    moments = {n: tuple(state.optimizer.state[params[n]]["mu"].shape) for n in names}
    return dict(metrics, grads=given, sharded=[n for n, s in zip(names, state.optimizer.sharded) if s],
                split=[n for n, d in (state.split or {}).items() if d is not None],
                params={n: params[n].detach().clone() for n in names}, opt_state=state.optimizer.state_dict(),
                stored={n: tuple(p.shape) for n, p in params.items()}, moments=moments)


def probed_train_cli(argv: list, dev: torch.device) -> tuple[dict, object]:
    """`cli.train.main(argv)` on `dev` with each step probed: (its final
    step, seconds and, per step, the seconds, flash launches (forward,
    backward) and peak memory (CUDA); the final TrainState)."""
    import time

    from evoworld_tpu_torch.cli import train as train_cli
    from evoworld_tpu_torch.train import trainer

    step_fn, steps, on_card = trainer.train_step, [], dev.type == "cuda"

    def probed(*args, **kwargs):
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_launch_counts()
        t0 = time.perf_counter()
        out = step_fn(*args, **kwargs)
        if on_card:
            torch.cuda.synchronize(dev)
        steps.append(dict(out, seconds=time.perf_counter() - t0, launches=_launch_counts(),
                          peak_memory_bytes=torch.cuda.max_memory_allocated(dev) if on_card else None))
        return out

    trainer.train_step = probed
    try:
        t0 = time.perf_counter()
        state = train_cli.main(argv, device=str(dev))
    finally:
        trainer.train_step = step_fn
    return dict(step=state.step, seconds=time.perf_counter() - t0, steps=steps), state


def train_cli_rank(mesh, runs: list, watch: str) -> dict:
    """`probed_train_cli` for each argv of `runs` in turn on this rank's
    device, as `torchrun` runs `cli.train`; and every file or directory this
    rank opened for writing, created, renamed or removed under `watch`
    (Python's audit events: a writer in C goes unseen)."""
    import sys

    import torch.distributed as dist

    root = os.path.abspath(watch)
    writes = []

    def audit(event, args):
        if event == "open" and args[1] is not None and any(c in str(args[1]) for c in "wax+"):
            paths = [args[0]]
        elif event in ("os.mkdir", "os.remove", "os.rmdir", "os.rename", "os.replace"):
            paths = list(args[:2]) if event in ("os.rename", "os.replace") else [args[0]]
        else:
            return
        for path in paths:
            if isinstance(path, (str, bytes, os.PathLike)) and os.path.abspath(os.fsdecode(path)).startswith(root):
                writes.append((event, os.path.relpath(os.fsdecode(path), root)))

    sys.addaudithook(audit)
    results = []
    for argv in runs:
        results.append(probed_train_cli(argv, mesh.device)[0])
        dist.barrier()
    return dict(rank=mesh.rank, runs=results, writes=writes)


def reproject_rank(mesh, argv: list) -> dict:
    """`cli.reproject.main(argv)` on this rank's device, as `torchrun` runs it:
    its records, flash launches, seconds, peak memory (CUDA), and how many
    times this rank wrote an episode's renders."""
    import time

    from evoworld_tpu_torch.cli import reproject

    dev, save, saved = mesh.device, reproject.save_frames, []

    def counting(*args, **kwargs):
        saved.append(args[1])
        return save(*args, **kwargs)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    reproject.save_frames = counting
    try:
        t0 = time.perf_counter()
        records = reproject.main(argv, device=str(dev))
        seconds = time.perf_counter() - t0
    finally:
        reproject.save_frames = save
    return dict(rank=mesh.rank, records=records, launches=_launch_counts(), seconds=seconds, saved=saved,
                peak_memory_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)


def route_inputs(shape: tuple, dtype: str, seed: int, device) -> list:
    """q, k, v (in `dtype`) and the output's cotangent (fp32) of a routed
    attention's gradient check: normal draws in fp32 from `seed` on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    drawn = [torch.randn(shape, generator=g, device=device) for _ in range(4)]
    return [t.to(getattr(torch, dtype)) for t in drawn[:3]] + [drawn[3]]


def route_grad_rank(mesh, shape: tuple, dtype: str, seed: int, min_seq=None) -> dict:
    """The gradient of sum(out * cotangent) through the mesh route of
    `multi_head_attention` (`head_sharded_attention(mesh, min_seq)`) on
    `route_inputs` (the same on every rank), on this rank's device: the flash
    launches of the forward and backward (counted from 0 around them), their
    seconds (between barriers), each gradient's SHA-256 and finiteness, and
    on rank 0 dq, dk and dv on the CPU. On a card, first `route_rank`'s
    check of the route's forward alone ("forward")."""
    import hashlib
    import time

    import torch.distributed as dist

    from evoworld_tpu_torch.ops.attention import head_sharded_attention, multi_head_attention

    dev = mesh.device
    fwd = route_rank(mesh, shape, dtype, seed) if dev.type == "cuda" else None
    *qkv, cot = route_inputs(shape, dtype, seed, dev)
    qkv = [t.requires_grad_(True) for t in qkv]
    dist.barrier()
    with head_sharded_attention(mesh, min_seq):
        _reset_launch_counts()
        t0 = time.perf_counter()
        out = multi_head_attention(*qkv)
        (out.float() * cot).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
    grads = [t.grad for t in qkv]
    return dict(route="head_sharded" if shape[2] % mesh.size == 0 else "ring", world_size=mesh.size,
                rank=mesh.rank, shape=list(shape), dtype=dtype, launches=launches, seconds=seconds,
                sha256=[hashlib.sha256(g.float().cpu().numpy().tobytes()).hexdigest() for g in grads],
                finite=all(bool(torch.isfinite(g).all()) for g in grads),
                grads=[g.cpu() for g in grads] if mesh.rank == 0 else None, forward=fwd)


def _frame_layer(name: str, seed: int):
    """(module, call(module, inputs, frames) -> output, each input's frame
    dim (None: every rank takes it whole), the output's) of the per-layer
    frame-sharding checks, random from
    `seed`, fp32 on the CPU: a temporal ResNet (GroupNorm statistics and the
    (3, 1, 1) convolutions' halo) and a spatio-temporal transformer (the
    all-to-all of its temporal block, the frames' global indices)."""
    from evoworld_tpu_torch.models.layers import TemporalResnetBlock, TransformerSpatioTemporalModel

    torch.manual_seed(seed)
    if name == "temporal_resnet":
        module = TemporalResnetBlock(64, 16)

        def call(m, x, frames):
            return m(x["x"], x["temb"], frames)

        return module, call, {"x": 2, "temb": 1}, 2
    module = TransformerSpatioTemporalModel(2, 16, 32, cross_dim=24)
    with torch.no_grad():  # a blend that leans on the temporal branch
        module.time_mixer.mix_factor.fill_(-1.0)

    def call(m, x, frames):  # the context repeated over the frames, as the UNet repeats it
        b, f = x["x"].shape[:2]
        context = x["context"].expand(b, f, *x["context"].shape[2:])
        out = m(x["x"].flatten(0, 1), context.flatten(0, 1), f, None, frames)
        return out.view(b, f, *out.shape[1:])

    return module, call, {"x": 1, "context": None}, 1


def frame_layer_rank(mesh, cases: list) -> dict:
    """Each case (name, seed, inputs, cotangent: numpy, frames whole) through
    `_frame_layer`'s layer over this rank's frames (a `FrameShard` of the
    data axis; `mesh` None: one process, every frame): {name: (output,
    {input: gradient}, {parameter: gradient})}, this rank's frames of the
    output and of a frame-sharded input's gradient, and its parts of a whole
    input's and of the parameters' gradients."""
    from evoworld_tpu_torch.parallel.mesh import FrameShard, axes

    out = {}
    for name, seed, inputs, cot in cases:
        module, call, dims, out_dim = _frame_layer(name, seed)
        total = inputs["x"].shape[dims["x"]]
        frames = FrameShard(axes(mesh)[0], total) if mesh is not None and mesh.size > 1 else None
        start, count = (frames.start, frames.count) if frames is not None else (0, total)
        local = {k: (torch.as_tensor(v) if dims[k] is None else torch.as_tensor(v).narrow(dims[k], start, count))
                 .clone().requires_grad_(True) for k, v in inputs.items()}
        y = call(module, local, frames)
        (y * torch.as_tensor(cot).narrow(out_dim, start, count)).sum().backward()
        out[name] = (y.detach(), {k: t.grad for k, t in local.items()},
                     {n: p.grad for n, p in module.named_parameters()})
    return out


def _card_step(mesh, checkpoint_dir: str, frames: int, seed: int, save: str, shard_frames: bool) -> dict:
    """One full-width bf16 `train_step` (batch 1, 1024x576, `frames` frames,
    ZeRO-1, warmup 0) from the checkpoints in `checkpoint_dir`, on a batch and
    draws made from `seed` on the device, over `mesh` (None: one process)
    with frames sharded where `shard_frames`: its loss, norm, seconds, peak
    memory, flash launches and the bytes of the UNet's parameters and of
    the moments this rank stores. Where `save` is given the updated
    trainable masters and moments (split slices gathered) are written there
    by rank 0 in `torch.save`'s format, `{"params", "opt_state"}`; without
    it they are returned."""
    import time

    import numpy as np

    from evoworld_tpu_torch.parallel.collectives import all_gather
    from evoworld_tpu_torch.parallel.mesh import axes, split_sizes
    from evoworld_tpu_torch.runtime import build_trainer
    from evoworld_tpu_torch.train.train_step import TrainConfig, loss_draws, make_train_state, train_step
    from evoworld_tpu_torch.train.trainer import save_without_crc32

    dev = mesh.device if mesh is not None else torch.device("cuda", 0)
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    unet, vae, clip = build_trainer("full", seed=seed, compute_dtype=torch.bfloat16, device=dev,
                                    checkpoint_dir=checkpoint_dir, allow_random_weights=False)
    cfg = TrainConfig(warmup_steps=0)
    state = make_train_state(cfg, unet, torch.bfloat16, mesh)
    rng = np.random.default_rng(seed)
    h, w = 576, 1024
    batch = {"pixel_values": rng.random((1, frames, h, w, 3), dtype=np.float32) * 2 - 1,
             "memory_values": rng.random((1, frames, h, w, 3), dtype=np.float32) * 2 - 1,
             "plucker": rng.standard_normal((1, frames, h // 8, w // 8, 6), dtype=np.float32)}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    draws = loss_draws(batch, torch.Generator(device=dev).manual_seed(seed), dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    t0 = time.perf_counter()
    metrics = train_step(state, vae.requires_grad_(False), clip.requires_grad_(False), [batch], cfg, torch.bfloat16,
                         draws=[draws], mesh=mesh, shard_frames=shard_frames)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    opt = state.optimizer
    param_bytes = sum(p.numel() * p.element_size() for p in unet.parameters())
    moment_bytes = sum(t.numel() * t.element_size() for st in opt.state.values() for t in (st["mu"], st["nu"]))
    named = [(n, p) for n, p in unet.named_parameters() if p.requires_grad]
    sd = opt.state_dict()
    model_axis = axes(mesh)[1] if mesh is not None else None

    def whole(name, t):  # a split slice gathered over the model ranks
        return all_gather(t.contiguous(), model_axis) if state.split and state.split[name] is not None else t

    kept = {"params": {n: whole(n, p.detach()).cpu() for n, p in named},
            "opt_state": {"state": {i: {k: whole(n, sd["state"][i][k]).cpu() for k in ("mu", "nu")}
                                    for i, (n, _) in enumerate(named)},
                          "param_groups": [{"count": sd["param_groups"][0]["count"]}]}}
    result = dict(metrics, rank=mesh.rank if mesh is not None else 0, world_size=mesh.size if mesh else 1,
                  frames=frames, local_frames=split_sizes(frames, mesh.size)[mesh.rank] if shard_frames and mesh else frames,
                  seconds=seconds, peak_memory_bytes=peak, launches=launches, param_bytes=param_bytes,
                  moment_bytes=moment_bytes, split=sum(d is not None for d in (state.split or {}).values()))
    if save is None:
        result["state"] = kept
    elif mesh is None or mesh.rank == 0:
        save_without_crc32(kept, save)
    return result


def frame_step_rank(mesh, checkpoint_dir: str, frames: int, seed: int, save: str) -> dict:
    """`_card_step` with the frames sharded over `mesh`'s data axis."""
    return _card_step(mesh, checkpoint_dir, frames, seed, save, shard_frames=True)


def tp_step_rank(mesh, checkpoint_dir: str, frames: int, seed: int, save: str) -> dict:
    """`_card_step` on a tensor-parallel `mesh` (its model axis over 1)."""
    return _card_step(mesh, checkpoint_dir, frames, seed, save, shard_frames=False)


def several_rank(mesh, calls: list) -> list:
    """The rank functions of this module named in `calls`, each (name, args)
    run in turn on this rank: several checks from one spawn."""
    return [globals()[name](mesh, *args) for name, args in calls]
