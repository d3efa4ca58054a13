"""The evolving-memory loop: generate -> reconstruct -> re-condition
(counterpart of `evoworld_tpu/loop/unified.py`).

For each segment:
  1. generate a 25-frame panoramic clip (segment 0: zero memory, masked);
  2. drop the repeated first frame after segment 0;
  3. unless it is the last segment:
     a. cut a look-at perspective crop from every generated frame (yaw
        toward pose (segment_id+1)*24+24);
     b. run the reconstructor (VGGT) on the crops;
     c. write the look-at yaws into the pose rows;
     d. align the GT cameras to the reconstruction (first/last-centre
        similarity), filter points by confidence and splat the next 24
        target views;
     e. the next segment's memory: the last generated frame + the 24 renders.
Frames, crops, point clouds and renders stay tensors on the device
throughout. The reconstructor is injected: any callable
images (S, Hp, Wp, 3) in [0, 1] -> dict(world_points (S, h, w, 3),
conf (S, h, w), extrinsic (S, 3, 4) w2c, colors optional), e.g.
`models/vggt/model.py::Reconstructor`.

In a multi-GPU run every rank runs the loop on the same inputs and draws:
the pipeline and the reconstructor shard over their own mesh, the memory
renders over the loop's (`mesh`, `memory/render.py`), and each stage hands
every rank the whole result, so the renders re-enter the pipeline on every
rank as they are.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from evoworld_tpu_torch.geometry.pose import pose_to_matrix
from evoworld_tpu_torch.geometry.resample import equi_to_pers
from evoworld_tpu_torch.loop.navigator import Navigator, calculate_segment_indices, segment_draws
from evoworld_tpu_torch.memory.pointcloud import confidence_mask
from evoworld_tpu_torch.memory.render import align_target_poses, render_memory_panoramas


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    num_segments: int = 3
    num_frames: int = 25
    num_target_view: int = 24
    pers_height: int = 384
    pers_width: int = 512
    pers_fov_x: float = 90.0
    conf_percentile: float = 50.0
    pos_scale: float = 0.1
    # Reconstruct from the newest N generated frames only (0: all of them, the
    # reference's behaviour, whose global attention grows with the episode).
    max_recon_frames: int = 0
    # With max_recon_frames set, drop frames older than the window from the
    # device as the episode advances (memory only; the result is the same).
    trim_residency: bool = True


class StageClock:
    """Seconds per named stage into `timings` (if given), the device
    synchronised at both ends of each."""

    def __init__(self, timings: Optional[dict], device: torch.device):
        self.timings, self.device = timings, device

    def __call__(self, name: str, fn: Callable):
        if self.timings is None:
            return fn()
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        self.timings[name] = time.perf_counter() - t0
        return out


class UnifiedLoop:
    """Episode-level orchestration of the evolving 3D memory."""

    def __init__(self, navigator: Navigator, reconstructor: Optional[Callable] = None,
                 config: LoopConfig = LoopConfig(), mesh=None):
        self.navigator = navigator
        self.reconstructor = reconstructor
        self.config = config
        self.mesh = mesh
        self.device = navigator.pipeline.device

    def panos_to_perspectives(self, frames: torch.Tensor, camera_params: np.ndarray, segment_id: int,
                              frame_offset: int = 0):
        """Look-at perspective crops of generated panoramas.

        Args:
            frames: (N, H, W, 3) panoramas in [0, 1].
            camera_params: (M, 6) UNSCALED OpenCV pose rows.
            frame_offset: global index of frames[0].

        Returns:
            (crops (N, Hp, Wp, 3), target yaws in degrees (N,) numpy).
        """
        cfg = self.config
        look_at_idx = (segment_id + 1) * cfg.num_target_view + cfg.num_target_view
        yaws = []
        for i in range(frames.shape[0]):
            idx = frame_offset + i
            if idx < len(camera_params):
                cur = camera_params[idx]
                look = camera_params[min(look_at_idx, len(camera_params) - 1)]
                yaws.append(math.radians(cur[4]) - math.atan2(look[0] - cur[0], look[2] - cur[2]))
            else:
                yaws.append(0.0)
        yaws = np.asarray(yaws, np.float32)
        pers = torch.stack([
            equi_to_pers(frame, yaw=float(yaw), out_height=cfg.pers_height, out_width=cfg.pers_width,
                         fov_x_deg=cfg.pers_fov_x)
            for frame, yaw in zip(frames, yaws)
        ])
        return pers, np.degrees(yaws)

    def rebuild_memory(self, all_frames: torch.Tensor, camera_params: np.ndarray, segment_id: int,
                       frames_dropped: int = 0, timings: Optional[dict] = None) -> torch.Tensor:
        """Reconstruct the generated frames and render the next segment's memory
        panoramas: (num_target_view, H, W, 3) in [0, 1].

        `frames_dropped` is the global index of all_frames[0]; pose rows and the
        alignment fit use global frame indices. `timings` collects the stage
        seconds pers_extract_s{i}, reconstruct_s{i}, splat_render_s{i}.
        """
        if self.reconstructor is None:
            raise ValueError("no reconstructor injected")
        cfg = self.config
        clock = StageClock(timings, self.device)
        _, end_idx, _ = calculate_segment_indices(segment_id, cfg.num_target_view)
        n_total = all_frames.shape[0]
        window = n_total if not cfg.max_recon_frames else min(n_total, cfg.max_recon_frames)
        offset = frames_dropped + (n_total - window)
        recon_frames = all_frames[n_total - window:]

        pers, target_yaws = clock(f"pers_extract_s{segment_id}", lambda: self.panos_to_perspectives(
            recon_frames, camera_params, segment_id, frame_offset=offset))
        preds = clock(f"reconstruct_s{segment_id}", lambda: self.reconstructor(pers))

        temp_cam = camera_params.copy()  # the look-at yaws replace the yaw column
        s = max(0, end_idx - len(target_yaws))
        temp_cam[s:end_idx, 4] = target_yaws[: end_idx - s]
        conf = preds["conf"]
        colors = preds.get("colors")
        if colors is None:
            colors = pers[:, : conf.shape[1], : conf.shape[2], :]

        def render():
            gt_c2w = pose_to_matrix(torch.as_tensor(temp_cam, dtype=torch.float32, device=self.device), relative=True)
            target_c2w = align_target_poses(gt_c2w, preds["extrinsic"], segment_id, cfg.num_target_view,
                                            recon_start=offset)
            valid = confidence_mask(conf, cfg.conf_percentile).reshape(-1)
            return render_memory_panoramas(preds["world_points"].reshape(-1, 3), colors.reshape(-1, 3), valid,
                                           target_c2w, all_frames.shape[1], all_frames.shape[2], mesh=self.mesh)

        return clock(f"splat_render_s{segment_id}", render)

    @torch.no_grad()
    def run_episode(
        self,
        start_image: torch.Tensor,
        scaled_traj: np.ndarray,
        camera_params: np.ndarray,
        draws: torch.Generator | Sequence[dict] | None = None,
        on_segment: Optional[Callable] = None,
        on_memory: Optional[Callable] = None,
        timings: Optional[dict] = None,
    ) -> Dict[str, List[torch.Tensor]]:
        """Generate `num_segments` clips with evolving 3D memory.

        Args:
            start_image: (H, W, 3) first frame in [-1, 1].
            scaled_traj: (M, 6) pose rows with pos_scale applied (conditioning).
            camera_params: (M, 6) UNSCALED pose rows (reconstruction).
            draws: a `torch.Generator`, or one dict of pipeline draws
                (`latents` (F, h, w, 4), `cond_noise` (F+1, H, W, 3)) per segment.
            on_segment: optional `(segment_id, frames)` sink; when given, frames
                stream to it and are not kept (nor, unless `on_memory` takes
                them, the memory renders).
            on_memory: optional `(segment_id, rendered)` sink (streaming mode).
            timings: if given, filled with stage seconds: generate_s{i} and
                rebuild_memory's stages, the device synchronised around each.

        Returns:
            {"segments": (F or F-1, H, W, 3) frames in [0, 1] per segment,
             "memories": (num_target_view, H, W, 3) renders per rebuild};
            both empty in streaming mode.
        """
        cfg = self.config
        clock = StageClock(timings, self.device)
        start_image = start_image.to(self.device, torch.float32)
        all_frames: Optional[torch.Tensor] = None
        frames_dropped = 0
        segments_out, memories_out = [], []
        memory_frames = torch.zeros((cfg.num_frames, *start_image.shape[:2], 3), device=self.device)
        current = start_image
        for segment_id in range(cfg.num_segments):
            start_idx, end_idx, _ = calculate_segment_indices(segment_id, cfg.num_target_view)
            # Pose rows are 1-based after segment 0, whose slice keeps all num_frames poses.
            segment = scaled_traj[start_idx - 1: end_idx - 1] if segment_id else scaled_traj[0:end_idx]
            frames = clock(f"generate_s{segment_id}", lambda: self.navigator.generate_segment(
                segment, current, memory_frames, segment_id > 0, **segment_draws(draws, segment_id)))
            new_frames = frames[1:] if segment_id > 0 else frames
            if on_segment is not None:
                on_segment(segment_id, new_frames)
            else:
                segments_out.append(new_frames)
            all_frames = new_frames if all_frames is None else torch.cat([all_frames, new_frames], 0)
            if cfg.trim_residency and cfg.max_recon_frames and all_frames.shape[0] > cfg.max_recon_frames:
                drop = all_frames.shape[0] - cfg.max_recon_frames
                frames_dropped += drop
                all_frames = all_frames[drop:]
            current = frames[-1] * 2.0 - 1.0  # carried into the next segment, in [-1, 1]

            if segment_id < cfg.num_segments - 1 and self.reconstructor is not None:
                rendered = self.rebuild_memory(all_frames, camera_params, segment_id, frames_dropped, timings)
                if on_segment is None:
                    memories_out.append(rendered)
                elif on_memory is not None:
                    on_memory(segment_id, rendered)
                memory_frames = torch.cat([current[None], rendered * 2.0 - 1.0], dim=0)
        return {"segments": segments_out, "memories": memories_out}
