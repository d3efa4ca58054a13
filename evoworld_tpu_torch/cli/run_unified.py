"""3-segment evolving-memory generation, the main entry point (counterpart of
`evoworld_tpu/cli/run_unified.py`).

Per episode: generate `loop.num_segments` clips; after each but the last,
reconstruct the frames so far (VGGT), align, and splat-render the next
segment's memory conditioning. Each segment streams to disk as it finishes:
`predictions_{s}/`, `predictions_gt_{s}/` and `rendered_panorama_{s}/` under
`<runtime.save_dir>/<episode>`, encoded by a background writer thread while
the card computes the next segment. Episodes `data.start_idx` to
`data.end_idx` (-1: all) of `data.root`.

Usage (on the card):
  python -m evoworld_tpu_torch.cli.run_unified --data.root=<dataset or episode> \\
      --runtime.save_dir=outputs/unified [--loop.num_segments=3] \\
      [--runtime.checkpoint_dir=<diffusers pipeline dir>] [--runtime.vggt_checkpoint=<model.pt>]

On several cards (or ranks sharing one), one process per rank:
  torchrun --nproc-per-node W -m evoworld_tpu_torch.cli.run_unified --data.root=... \
      [--runtime.mesh_model=M]
Each rank takes `cuda:LOCAL_RANK % device_count` (NCCL where every rank has
a card of its own, gloo where ranks share one); the clip, VGGT
(`--runtime.vggt_mesh`, on by default) and the memory renders are sharded
over the ranks, and only rank 0 writes frames and logs the episode.

From Python, `main(argv, device="cpu")` runs on the CPU. Draws come from
`torch.Generator(device).manual_seed(runtime.seed + episode index)`, the same
on every rank, so the frames are not the JAX CLI's (which draws from
jax.random).
"""

from __future__ import annotations

import os
import time

import torch

from evoworld_tpu_torch.cli.common import AsyncFrameWriter, frames_from_minus1_1, logger, parse_config
from evoworld_tpu_torch.config import compute_dtype
from evoworld_tpu_torch.data.dataset import EpisodeDataset, load_camera_poses
from evoworld_tpu_torch.loop.navigator import Navigator, calculate_segment_indices
from evoworld_tpu_torch.loop.unified import UnifiedLoop
from evoworld_tpu_torch.runtime import build_pipeline, build_reconstructor, check_compute_dtype, inference_setup


def main(argv=None, device: str | torch.device = "cuda") -> list[dict]:
    """Run the CLI; returns one record per episode: its output dir, the
    loop's stage seconds, and the host's decode, save (the inline copy and
    enqueue), writer busy and writer wait (in `close`) seconds."""
    config = parse_config(argv, __doc__)
    data, rt = config.data, config.runtime
    dtype = compute_dtype(rt)
    check_compute_dtype(device, dtype)
    dev, mesh = inference_setup(device, rt.mesh_data, rt.mesh_model)
    writes = mesh is None or mesh.rank == 0

    dataset = EpisodeDataset(
        data.root,
        height=config.pipeline.height,
        width=config.pipeline.width,
        sampling="empty_with_traj",
        pos_scale=data.pos_scale,
        single_episode=data.single_episode,
        load_complete_episode=True,
    )
    t0 = time.perf_counter()
    pipeline = build_pipeline(config.pipeline, rt.model_preset, rt.seed, dtype, dev,
                              checkpoint_dir=rt.checkpoint_dir or rt.svd_checkpoint,
                              allow_random_weights=rt.allow_random_weights, mesh=mesh)
    reconstructor = None
    if config.loop.num_segments > 1:
        reconstructor = build_reconstructor("tiny" if rt.vggt_tiny else "full", rt.seed, dtype, dev,
                                            vggt_checkpoint=rt.vggt_checkpoint,
                                            allow_random_weights=rt.allow_random_weights,
                                            mesh=mesh if rt.vggt_mesh else None)
    load_s = time.perf_counter() - t0
    navigator = Navigator(pipeline, num_frames=config.pipeline.num_frames)
    loop = UnifiedLoop(navigator, reconstructor, config.loop, mesh=mesh)

    records = []
    end = data.end_idx if data.end_idx >= 0 else len(dataset)
    for idx in range(data.start_idx, min(end, len(dataset))):
        t0 = time.perf_counter()
        sample = dataset[idx]
        host = dict(host_decode_s=time.perf_counter() - t0, host_save_s=0.0)
        name = os.path.basename(sample.episode_path.rstrip("/")) or "episode"
        logger.info(f"Episode {name}")
        camera_params = load_camera_poses(os.path.join(sample.episode_path, "camera_poses.txt"))
        ep_dir = os.path.join(rt.save_dir, name)

        def save_segment(seg_id, frames, writer):
            if not writes:
                return
            t0 = time.perf_counter()
            start = seg_id * (config.pipeline.num_frames - 1)
            writer.submit(frames, os.path.join(ep_dir, f"predictions_{seg_id}"), start)
            s, e, _ = calculate_segment_indices(seg_id, config.loop.num_target_view)
            gt = sample.pixel_values[s - 1 : e - 1] if seg_id else sample.pixel_values[0:e]
            writer.submit(frames_from_minus1_1(gt[1:] if seg_id else gt),
                          os.path.join(ep_dir, f"predictions_gt_{seg_id}"), start)
            host["host_save_s"] += time.perf_counter() - t0

        def save_memory(seg_id, mem, writer):
            if not writes:
                return
            t0 = time.perf_counter()
            writer.submit(mem, os.path.join(ep_dir, f"rendered_panorama_{seg_id}"), 0, "{:02d}.png")
            host["host_save_s"] += time.perf_counter() - t0

        timings: dict = {}
        t0 = time.perf_counter()
        with AsyncFrameWriter() as writer:
            loop.run_episode(
                torch.from_numpy(sample.pixel_values[0]).to(dev),
                sample.cam_traj,
                camera_params,
                draws=torch.Generator(device=dev).manual_seed(rt.seed + idx),
                on_segment=lambda seg_id, frames: save_segment(seg_id, frames, writer),
                on_memory=lambda seg_id, mem: save_memory(seg_id, mem, writer),
                timings=timings,
            )
            t1 = time.perf_counter()
        episode_s = time.perf_counter() - t0
        record = dict(episode=name, out_dir=ep_dir, load_s=load_s, episode_s=episode_s, stage_seconds=timings,
                      **host, writer_busy_s=writer.busy_s, writer_wait_s=episode_s - (t1 - t0))
        # The writer's encode overlaps the card's compute; only writer_wait_s
        # (the last segment's encode, after the loop) adds to the episode.
        seconds = {**timings, **{k: v for k, v in record.items() if k.endswith("_s")}}
        if writes:
            logger.info(f"Saved episode to {ep_dir}: " + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items()))
        records.append(record)
    return records


if __name__ == "__main__":
    main()
