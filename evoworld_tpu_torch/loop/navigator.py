"""Navigator: pose-path segmentation and per-segment clip generation
(counterpart of `evoworld_tpu/loop/navigator.py`).

Splits a pose path into 25-frame segments (stride 24), builds each segment's
relative-pose Pluecker embedding, runs the diffusion pipeline and carries the
last generated frame into the next segment; the straight-path mode rotates
the carried panorama by the yaw change between segments.

Torch and JAX draw different random numbers, so every generating call takes
its draws as an optional input (`latents` and `cond_noise` of the pipeline)
beside a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from evoworld_tpu_torch.diffusion.pipeline import PanoDiffusionPipeline
from evoworld_tpu_torch.geometry.plucker import plucker_embedding
from evoworld_tpu_torch.geometry.pose import pose_to_matrix
from evoworld_tpu_torch.geometry.rays import equirect_ray_grid
from evoworld_tpu_torch.geometry.resample import rotate_pano_yaw


def split_curve_into_segments(path: np.ndarray, segment_len: int = 25) -> List[np.ndarray]:
    """`segment_len`-frame windows overlapping by one frame; a shorter tail is kept."""
    n = len(path)
    if n < segment_len:
        return [path]
    segments = []
    start, end = 0, segment_len
    while end <= n:
        segments.append(path[start:end])
        start = end - 1
        end = start + segment_len
    if end - start > 1 and start < n:
        segments.append(path[start:])
    return segments


def split_path_into_segments(path: np.ndarray, atol: float = 1e-2) -> List[np.ndarray]:
    """Split a pose path at rotation changes (straight-path mode): poses with
    equal rotation share a segment; at a change the previous position is
    re-emitted with the new rotation as the new segment's first pose."""
    segments: List[np.ndarray] = []
    current: List[np.ndarray] = []
    last = path[0].copy()
    for step in path:
        if np.allclose(step[3:6], last[3:6], atol=atol):
            current.append(step.copy())
            last = step.copy()
            continue
        segments.append(np.stack(current))
        bridge = last.copy()
        bridge[3:6] = step[3:6]
        current = [bridge, step.copy()]
        last = step.copy()
    if current:
        segments.append(np.stack(current))
    return segments


def calculate_segment_indices(segment_id: int, num_target_view: int = 24):
    """(start, end, look_at) frame indices of a segment (1-based pose rows
    after segment 0)."""
    look_at_idx = (segment_id + 1) * num_target_view + num_target_view
    start_idx = segment_id * num_target_view + 1
    if segment_id == 0:
        start_idx -= 1
    return start_idx, start_idx + num_target_view + 1, look_at_idx


def extend_segment(segment: np.ndarray, target_len: int, step_size: float = 0.4, pos_scale: float = 0.1) -> np.ndarray:
    """Extrapolate a short segment to `target_len` poses with its last step
    (one pose: a step of `step_size * pos_scale` along its yaw)."""
    seg = np.asarray(segment, np.float32)
    if len(seg) >= target_len:
        return seg
    if len(seg) == 1:
        roty = np.deg2rad(seg[0, 4])
        delta = np.array(
            [step_size * np.sin(roty) * pos_scale, 0, step_size * np.cos(roty) * pos_scale, 0, 0, 0], np.float32
        )
    else:
        delta = seg[-1] - seg[-2]
    extra = seg[-1] + delta * np.arange(1, target_len - len(seg) + 1)[:, None]
    return np.concatenate([seg, extra.astype(np.float32)], axis=0)


@dataclasses.dataclass
class Navigator:
    """Drives the pipeline along a segmented pose path."""

    pipeline: PanoDiffusionPipeline
    num_frames: int = 25

    def __post_init__(self):
        cfg = self.pipeline.config
        self.rays = equirect_ray_grid(cfg.latent_height, cfg.latent_width, device=self.pipeline.device)

    def plucker_for_segment(self, segment: np.ndarray) -> torch.Tensor:
        """(F, 6) pose rows -> (F, 6, h, w) Pluecker embedding relative to the first pose."""
        c2w = pose_to_matrix(torch.as_tensor(np.asarray(segment, np.float32), device=self.rays.device), relative=True)
        return plucker_embedding(self.rays, c2w)

    def generate_segment(
        self,
        segment: np.ndarray,
        start_image: torch.Tensor,
        memory_frames: torch.Tensor,
        use_memory: bool,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        cond_noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """One clip: (F, 6) scaled pose rows, (H, W, 3) start image and
        (F, H, W, 3) memory frames in [-1, 1] -> (F, H, W, 3) frames in [0, 1].

        `use_memory` False masks the memory conditioning (segment 0). The
        pipeline's draws are `latents` and `cond_noise` where given, else
        drawn from `generator`.
        """
        if len(segment) < self.num_frames:
            segment = extend_segment(segment, self.num_frames)
        plucker = self.plucker_for_segment(segment[: self.num_frames])
        return self.pipeline(start_image, plucker, memory_frames, generator=generator, mask_mem=not use_memory,
                             latents=latents, cond_noise=cond_noise)

    def navigate_path(
        self,
        path: np.ndarray,
        start_image: torch.Tensor,
        memory_frames: torch.Tensor,
        draws: torch.Generator | Sequence[dict] | None = None,
        curve: bool = True,
    ) -> List[torch.Tensor]:
        """Drive the whole path segment by segment; returns each segment's
        (F, H, W, 3) frames in [0, 1].

        Curve mode uses fixed windows; straight-path mode (`curve` False)
        splits at rotation changes and rotates the carried panorama by the yaw
        change first. Segment 0 runs memory-masked. `draws`: a generator, or
        one dict of pipeline draws (`latents`, `cond_noise`) per segment.
        """
        segments = split_curve_into_segments(path, self.num_frames) if curve else split_path_into_segments(path)
        current = start_image
        current_angle = float(segments[0][0][4])
        generations: List[torch.Tensor] = []
        for seg_id, segment in enumerate(segments):
            if not curve:
                rotation = float(segment[0][4]) - current_angle
                current_angle = float(segment[-1][4])
                if rotation != 0.0:
                    current = rotate_pano_yaw(current, rotation)
            frames = self.generate_segment(np.asarray(segment), current, memory_frames, seg_id > 0,
                                           **segment_draws(draws, seg_id))
            generations.append(frames)
            current = frames[-1] * 2.0 - 1.0
        return generations


def segment_draws(draws: torch.Generator | Sequence[dict] | None, segment_id: int) -> dict:
    """The keyword arguments of `generate_segment` that carry segment
    `segment_id`'s random draws."""
    if draws is None or isinstance(draws, torch.Generator):
        return {"generator": draws}
    return dict(draws[segment_id])
