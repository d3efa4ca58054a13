"""Single-clip generation on one episode from pre-rendered memory panoramas
(counterpart of `evoworld_tpu/cli/run_single_segment.py`).

Loads the episode (memory sampling "reprojection": the shipped rendered
panoramas after the first GT frame), builds the relative-pose Pluecker
embedding, runs one clip and writes `predictions/` and `predictions_gt/`
under `<runtime.save_dir>/<episode>`.

Usage (on the card):
  python -m evoworld_tpu_torch.cli.run_single_segment \\
      --data.root=<episode dir> --runtime.save_dir=outputs/single_segment \\
      [--pipeline.num_steps=25] [--runtime.checkpoint_dir=<diffusers pipeline dir>]

Under `torchrun --nproc-per-node W` the clip is sharded over the ranks as
`run_unified`'s is, and only rank 0 writes.

From Python, `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import os
import time

import torch

from evoworld_tpu_torch.cli.common import frames_from_minus1_1, logger, parse_config, save_frames
from evoworld_tpu_torch.config import compute_dtype
from evoworld_tpu_torch.data.dataset import EpisodeDataset
from evoworld_tpu_torch.loop.navigator import Navigator
from evoworld_tpu_torch.runtime import build_pipeline, check_compute_dtype, inference_setup


def main(argv=None, device: str | torch.device = "cuda") -> list[dict]:
    """Run the CLI; returns one record per episode (output dir and seconds)."""
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
        sequence_length=data.sequence_length,
        sampling="reprojection",
        reprojection_name=data.reprojection_name,
        memory_path=data.memory_path,
        pos_scale=data.pos_scale,
        single_episode=data.single_episode,
    )
    t0 = time.perf_counter()
    pipeline = build_pipeline(config.pipeline, rt.model_preset, rt.seed, dtype, dev,
                              checkpoint_dir=rt.checkpoint_dir or rt.svd_checkpoint,
                              allow_random_weights=rt.allow_random_weights, mesh=mesh)
    load_s = time.perf_counter() - t0
    navigator = Navigator(pipeline, num_frames=config.pipeline.num_frames)

    records = []
    for idx in range(len(dataset)):
        t0 = time.perf_counter()
        sample = dataset[idx]
        decode_s = time.perf_counter() - t0
        name = os.path.basename(sample.episode_path.rstrip("/")) or "episode"
        logger.info(f"Generating {name} ({sample.pixel_values.shape[0]} GT frames)")

        t0 = time.perf_counter()
        frames = navigator.generate_segment(
            sample.cam_traj,
            torch.from_numpy(sample.pixel_values[0]).to(dev),
            torch.from_numpy(sample.memory_values[: config.pipeline.num_frames]).to(dev),
            use_memory=True,
            generator=torch.Generator(device=dev).manual_seed(rt.seed + idx),
        )
        frames = frames.cpu()
        generate_s = time.perf_counter() - t0

        out_dir = os.path.join(rt.save_dir, name)
        t0 = time.perf_counter()
        if writes:
            save_frames(frames, os.path.join(out_dir, "predictions"))
            save_frames(frames_from_minus1_1(sample.pixel_values), os.path.join(out_dir, "predictions_gt"))
        save_s = time.perf_counter() - t0
        record = dict(episode=name, out_dir=out_dir, load_s=load_s, host_decode_s=decode_s,
                      generate_s=generate_s, host_save_s=save_s)
        if writes:
            logger.info(f"Saved to {out_dir} " + ", ".join(f"{k} {v:.3f} s" for k, v in record.items()
                                                            if k.endswith("_s")))
        records.append(record)
    return records


if __name__ == "__main__":
    main()
