"""VGGT: feed-forward multi-view reconstruction (counterpart of
`evoworld_tpu/models/vggt/model.py`, one device).

`VGGT` holds the aggregator, the camera head and the DPT depth (and point)
heads under upstream facebookresearch/vggt's names; `Reconstructor` (made by
`make_reconstructor`) is the callable the evolving-memory loop injects:
perspective crops (S, Hp, Wp, 3) in [0, 1] -> world points, confidence,
extrinsics and colours, with the depth head run over chunks of `head_chunk`
frames (its full-resolution transients grow with the frame count: 49 frames
at 392x518 at the loop's second rebuild). With a mesh (a multi-GPU run,
every rank given the same crops), the per-frame work (patch encoder, frame
attention, depth head) is split over the ranks when their count divides the
frame count, the global attention takes the mesh routes (head-sharded, or
the ring where the heads do not divide), and every rank returns the whole
result. On one CUDA device without a mesh the reconstructor parks the
model's parameters and buffers in pinned host memory between calls, as the
JAX module's host offload does (`offload_params`, on by default there): VGGT
idles while the loop's clips denoise, and its ~2.5 GB in bf16 leave the card
meanwhile. Each call copies them in (non-blocking, from pinned memory),
runs, and drops the device copies. A pin or copy that fails raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from evoworld_tpu_torch.models.vggt.aggregator import Aggregator, AggregatorConfig, frame_shard, gather_frames
from evoworld_tpu_torch.models.vggt.geometry import pose_encoding_to_extri_intri, unproject_depth_map_to_point_map
from evoworld_tpu_torch.models.vggt.heads import CameraHead, DPTConfig, DPTHead
from evoworld_tpu_torch.ops.resize import resize_half_pixel


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    aggregator: AggregatorConfig = AggregatorConfig()
    with_point_head: bool = True
    camera_trunk_depth: int = 4
    dpt_features: int = 256
    dpt_layer_dims: tuple = (256, 512, 1024, 1024)


def decode_depth(depth_out: torch.Tensor):
    """(..., 2) raw DPT output -> (depth (..., 1) = max(expm1(clip), 1e-4),
    conf (...) = 1 + exp(clip)), in fp32."""
    depth_out = depth_out.float()
    depth = torch.clamp(torch.expm1(torch.clamp(depth_out[..., 0:1], -10.0, 12.0)), min=1e-4)
    conf = 1.0 + torch.exp(torch.clamp(depth_out[..., 1], -10.0, 10.0))
    return depth, conf


class VGGT(nn.Module):
    """Aggregator + camera / depth / point heads. `forward` runs them all;
    the stages are separate methods so the reconstructor can chunk the depth
    head over frames."""

    def __init__(self, config: VGGTConfig = VGGTConfig()):
        super().__init__()
        self.config = config
        tap_dim = 2 * config.aggregator.embed_dim
        self.aggregator = Aggregator(config.aggregator)
        self.camera_head = CameraHead(dim_in=tap_dim, trunk_depth=config.camera_trunk_depth,
                                      num_heads=config.aggregator.num_heads)
        dpt = dict(features=config.dpt_features, layer_dims=tuple(config.dpt_layer_dims), dim=tap_dim)
        self.depth_head = DPTHead(DPTConfig(out_channels=2, **dpt))
        self.point_head = DPTHead(DPTConfig(out_channels=4, **dpt)) if config.with_point_head else None

    def predict_cameras(self, outputs) -> torch.Tensor:
        """Aggregator taps -> (B, S, 9) pose encoding, from the camera tokens of the last."""
        return self.camera_head(outputs[-1][:, :, 0, :])

    def tap_patch_tokens(self, outputs):
        """Strip the special tokens: 4 x (B, S, T, 2C) -> 4 x (B*S, P, 2C)."""
        if len(outputs) != 4:
            raise ValueError(f"the DPT heads take 4 aggregator taps, the config gives {len(outputs)}")
        n_special = 1 + self.config.aggregator.num_register_tokens
        return [o[:, :, n_special:].reshape(o.shape[0] * o.shape[1], -1, o.shape[-1]) for o in outputs]

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, S, H, W, 3) in [0, 1] -> pose_enc, depth, depth_conf, images
        (and world_points, world_points_conf with the point head)."""
        b, s, height, width, _ = images.shape
        outputs, patch_hw = self.aggregator(images)
        pose_enc = self.predict_cameras(outputs)
        layer_tokens = self.tap_patch_tokens(outputs)
        depth, depth_conf = decode_depth(
            self.depth_head(layer_tokens, patch_hw, (height, width)).reshape(b, s, height, width, 2))
        preds = {"pose_enc": pose_enc, "depth": depth, "depth_conf": depth_conf, "images": images}
        if self.point_head is not None:
            point_out = self.point_head(layer_tokens, patch_hw, (height, width)).reshape(b, s, height, width, 4).float()
            preds["world_points"] = point_out[..., 0:3]
            preds["world_points_conf"] = 1.0 + torch.exp(torch.clamp(point_out[..., 3], -10.0, 10.0))
        return preds


def load_and_preprocess_images(images: torch.Tensor | np.ndarray, target_width: int = 518) -> torch.Tensor:
    """(S, H, W, 3) uint8 or float in [0, 1] -> (1, S, H', W', 3) fp32 in [0, 1].

    Resized (`jax.image.resize`'s bilinear, `ops/resize.py::resize_half_pixel`)
    to width 518 and a height rounded to a multiple of the 14-pixel patch.
    """
    arr = torch.as_tensor(images)
    rescale = not arr.is_floating_point()
    arr = arr.float()
    if rescale:
        arr = arr / 255.0
    _, h, w, _ = arr.shape
    new_h = int(round(h * target_width / w / 14)) * 14
    return resize_half_pixel(arr, (new_h, target_width), "bilinear")[None]


def resolve_offload(device: torch.device, mesh=None, offload_params: Optional[bool] = None) -> bool:
    """Whether a reconstructor on `device` offloads its parameters: by
    default on one CUDA device without a mesh (skipped on meshes, as in the
    JAX package); asked for on the CPU, ValueError."""
    if offload_params and torch.device(device).type != "cuda":
        raise ValueError(f"offload_params=True needs a CUDA device (host offload has no meaning on {device})")
    if offload_params is None:
        offload_params = torch.device(device).type == "cuda"
    return offload_params and mesh is None


class Reconstructor:
    """The loop's reconstructor: (S, Hp, Wp, 3) crops in [0, 1] -> dict with
    world_points (S, h, w, 3), conf (S, h, w), extrinsic (S, 3, 4) w2c and
    colors (S, h, w, 3), at VGGT's working resolution h x w (392 x 518 for
    384 x 512 crops), by depth unprojection (the upstream loop's
    "depth_unproject" mode). The model is expected on one device in
    `compute_dtype` (its norms and LayerScales may stay fp32). `mesh`: an
    optional `parallel.mesh.Mesh` to shard over. `offload_params`: see
    `resolve_offload`; when on, the model's tensors move to pinned host
    memory here and come to the device for each call only."""

    def __init__(self, model: VGGT, compute_dtype: torch.dtype = torch.bfloat16, head_chunk: int = 8, mesh=None,
                 offload_params: Optional[bool] = None):
        self.model = model.eval()
        self.compute_dtype = compute_dtype
        self.head_chunk = head_chunk
        self.mesh = mesh
        self.device = next(model.parameters()).device
        self.offload = resolve_offload(self.device, mesh, offload_params)
        self._host = None
        if self.offload:
            self._host = [(t, torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t.data))
                          for t in self._tensors()]
            for t, host in self._host:
                t.data = host

    def _tensors(self) -> list[torch.Tensor]:
        return [*self.model.parameters(), *self.model.buffers()]

    @contextlib.contextmanager
    def _on_device(self):
        """The model's tensors on the device inside (copied from pinned host memory when offloaded)."""
        if not self.offload:
            yield
            return
        for t, host in self._host:
            t.data = host.to(self.device, non_blocking=True)
        try:
            yield
        finally:
            for t, host in self._host:
                t.data = host

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        with self._on_device():
            return self._reconstruct(images)

    def _reconstruct(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        model = self.model
        batch = load_and_preprocess_images(torch.as_tensor(images).to(self.device))
        x = batch.to(self.compute_dtype)
        s, hw = x.shape[1], tuple(x.shape[2:4])
        lo, hi = frame_shard(s, self.mesh)
        sharded = hi - lo < s
        outputs, patch_hw = model.aggregator(x, self.mesh)
        camera_tokens = outputs[-1][:, :, 0, :]  # the camera head attends over every frame's
        pose_enc = model.camera_head(gather_frames(camera_tokens, self.mesh) if sharded else camera_tokens)
        layer_tokens = model.tap_patch_tokens(outputs)
        del outputs
        chunk = max(1, min(self.head_chunk, hi - lo))
        depth_out = torch.cat([
            model.depth_head([t[i:i + chunk] for t in layer_tokens], patch_hw, hw).float()
            for i in range(0, hi - lo, chunk)
        ])
        if sharded:
            depth_out = gather_frames(depth_out[None], self.mesh)[0]
        depth, conf = decode_depth(depth_out)
        extrinsic, intrinsic = pose_encoding_to_extri_intri(pose_enc[0], hw)
        points = unproject_depth_map_to_point_map(depth, extrinsic, intrinsic)
        return {"world_points": points, "conf": conf, "extrinsic": extrinsic, "colors": batch[0]}


def make_reconstructor(model: VGGT, compute_dtype: torch.dtype = torch.bfloat16, head_chunk: int = 8, mesh=None,
                       offload_params: Optional[bool] = None) -> Reconstructor:
    """Wrap a VGGT model as the `UnifiedLoop` reconstructor (sharded over
    `mesh` when given; its parameters offloaded to the host per `resolve_offload`)."""
    return Reconstructor(model, compute_dtype, head_chunk, mesh, offload_params)
