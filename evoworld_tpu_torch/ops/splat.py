"""Point cloud -> equirectangular z-buffer splat (counterpart of
`evoworld_tpu/ops/splat.py`), in torch ops.

Every world point is projected into the render camera's spherical
coordinates and the nearest point wins each pixel. Visibility is resolved by
a sort, as in the JAX module:
    1. pack (pixel id, quantized log-depth) into one integer key: the pixel in
       the high bits, `_depth_bits_for(H*W)` bits of depth below it (11 at
       1024x576), so the first entry of each pixel's run is its nearest point
       up to the quantization. Copying the quantization keeps the winners of
       nearly coincident points the reference's;
    2. sort the keys stably, so equal keys keep point order (the JAX sort is
       unstable and leaves such ties unordered: the port breaks them by point
       index);
    3. the run starts scatter their point index into the image; depth and
       colour are gathered by the winning index.
Above 2^23 pixels the key cannot hold 8 depth bits and a two-key
lexicographic sort (pixel, exact depth) takes its place. The square
footprint (`splat_radius`) is a depth-min over shifted copies of the radius-1
image. The JAX splat is XLA, not Pallas, so it has no hand-written kernel.
"""

from __future__ import annotations

import math

import torch

from evoworld_tpu_torch.geometry.pose import invert_pose

_MIN_DEPTH_BITS = 8
_MAX_DEPTH_BITS = 14
_INT32_MAX = 2**31 - 1


def _depth_bits_for(num_px: int) -> int:
    """Widest depth quantization that still packs (pixel, depth) in int32;
    0 when even _MIN_DEPTH_BITS does not fit (the two-key sort)."""
    for bits in range(_MAX_DEPTH_BITS, _MIN_DEPTH_BITS - 1, -1):
        if (num_px + 1) << bits <= _INT32_MAX:
            return bits
    return 0


def _footprint_offsets(splat_radius: int):
    if splat_radius <= 1:
        return [(0, 0)]
    r = splat_radius - 1
    return [(dy, dx) for dy in range(0, r + 1) for dx in range(0, r + 1)]


def _shift_image(img: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """out[y, x] = img[y - dy, x - dx]; x wraps (longitude), y pads with `fill`."""
    if dx:
        img = torch.roll(img, dx, dims=1)
    if dy:
        img = torch.cat([torch.full_like(img[:dy], fill), img[:-dy]], dim=0)
    return img


def _apply_footprint(pano: torch.Tensor, depth: torch.Tensor, splat_radius: int):
    """Depth-min combine of shifted copies (= splatting every offset of the footprint)."""
    out_c, out_d = pano, depth
    for dy, dx in _footprint_offsets(splat_radius)[1:]:
        d = _shift_image(depth, dy, dx, math.inf)
        c = _shift_image(pano, dy, dx, 0.0)
        take = d < out_d
        out_d = torch.where(take, d, out_d)
        out_c = torch.where(take[..., None], c, out_c)
    return out_c, out_d


def _winner_indices(flat: torch.Tensor, depth: torch.Tensor, ok: torch.Tensor, num_px: int) -> torch.Tensor:
    """Per-pixel nearest-point index, (num_px,) int64; n where no point lands."""
    n = flat.shape[0]
    depth_bits = _depth_bits_for(num_px)
    if depth_bits:
        d_ok = torch.where(ok, depth, torch.ones_like(depth))
        log_d = torch.log(torch.clamp(d_ok, min=1e-12))
        lo = torch.where(ok, log_d, torch.full_like(log_d, math.inf)).min()
        hi = torch.where(ok, log_d, torch.full_like(log_d, -math.inf)).max()
        lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
        hi = torch.where(hi > lo, hi, lo + 1.0)
        levels = (1 << depth_bits) - 1
        q = torch.clamp(((log_d - lo) / (hi - lo) * levels).to(torch.int32), 0, levels)
        sorted_key, sorted_idx = torch.sort((flat << depth_bits) | q, stable=True)
        sorted_pix = sorted_key >> depth_bits
    else:
        by_depth = torch.sort(torch.where(ok, depth, torch.full_like(depth, math.inf)), stable=True).indices
        sorted_pix, order = torch.sort(flat[by_depth], stable=True)
        sorted_idx = by_depth[order]
    is_start = torch.ones_like(sorted_pix, dtype=torch.bool)
    is_start[1:] = sorted_pix[1:] != sorted_pix[:-1]
    buf = torch.full((num_px + 1,), n, dtype=torch.int64, device=flat.device)
    buf[sorted_pix[is_start].long()] = sorted_idx[is_start]
    return buf[:num_px]


def splat_points_to_pano(
    points: torch.Tensor,
    colors: torch.Tensor,
    c2w: torch.Tensor,
    height: int,
    width: int,
    valid: torch.Tensor | None = None,
    splat_radius: int = 1,
):
    """Render a coloured point cloud to an equirectangular panorama.

    Args:
        points: (N, 3) world points.
        colors: (N, C) colours.
        c2w: (3, 4) camera-to-world pose of the render camera.
        height, width: output size.
        valid: optional (N,) boolean mask; invalid points are dropped.
        splat_radius: 1 -> one pixel a point; r -> an r x r footprint
            (the point also covers its right and lower neighbours).

    Returns:
        (pano (H, W, C), zero where empty; depth (H, W), inf where empty;
        mask (H, W) bool coverage).
    """
    points, colors = points.float(), colors.float()
    n = points.shape[0]
    w2c = invert_pose(c2w.float())
    p_cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    depth = torch.linalg.norm(p_cam, dim=-1)
    d = p_cam / torch.clamp(depth, min=1e-12)[:, None]
    lon = torch.atan2(d[:, 0], d[:, 2])
    lat = torch.asin(torch.clamp(d[:, 1], -1.0, 1.0))
    u = torch.floor((lon / (2.0 * math.pi) + 0.5) * width).to(torch.int32)
    v = torch.floor((lat / math.pi + 0.5) * height).to(torch.int32)
    u = torch.remainder(u, width)
    v = torch.clamp(v, 0, height - 1)

    ok = depth > 1e-9
    if valid is not None:
        ok = ok & valid
    num_px = height * width
    flat = torch.where(ok, v * width + u, torch.full_like(u, num_px))  # invalid points sort to the tail

    win = _winner_indices(flat, depth, ok, num_px)
    found = win < n
    win_c = torch.clamp(win, max=n - 1)
    depth_img = torch.where(found, depth[win_c], torch.full_like(depth[win_c], math.inf)).reshape(height, width)
    pano_img = torch.where(found[:, None], colors[win_c], torch.zeros_like(colors[win_c]))
    pano_img = pano_img.reshape(height, width, colors.shape[-1])
    if splat_radius > 1:
        pano_img, depth_img = _apply_footprint(pano_img, depth_img, splat_radius)
    return pano_img, depth_img, torch.isfinite(depth_img)
