"""MP4 video read and write, and OpenCV's bilinear resize, for the scoring CLI
and the video export (`cli/calculate_scores.py`, `utils/video.py`).

`csrc/video.cpp`, built at first use with g++ into the git-ignored `build/`
(`ops/_build.py`), reads MP4 (ISO BMFF) files and decodes their video: MPEG-4
Part 2 Simple Profile (`mp4v`, what OpenCV's `mp4v` writer and FFmpeg's
default `mpeg4` encode make) in FFmpeg's own arithmetic (its integer "simple"
IDCT), and H.264 (`avc1`, `avc3`: the progressive 8-bit 4:2:0 Baseline, Main
and High profiles, what libx264 and most cameras make; `csrc/h264.h`), which
is exact by the standard; then swscale's conversion of 4:2:0 limited-range
BT.601 to RGB. It writes MP4 files of intra-only MPEG-4 Part 2 video (every
frame an I-VOP at one quantiser) that OpenCV and FFmpeg read. The machine
the port runs on has no video library (no FFmpeg, OpenCV or PyAV), so
nothing else is used. What the decoders refuse (HEVC, VP9, AV1, interlaced
or 10-bit H.264, ...) raises an error naming the file and the reason
(`_REASONS`). The C calls release the GIL (ctypes).

`resize_linear_u8` is OpenCV's `cv2.resize(..., INTER_LINEAR)` of uint8
frames in OpenCV's fixed-point arithmetic (see its docstring).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from evoworld_tpu_torch.ops import _build

SOURCE = "video.cpp"
_REASONS = {
    1: "cannot be read",
    2: "is not an MP4 (ISO base media) file",
    3: "has no video track",
    4: "holds HEVC video (hvc1, hev1), or H.264 in an avc1 sample entry without its avcC box: the decoders take "
       "MPEG-4 Part 2 (mp4v) and H.264 (avc1, avc3)",
    5: "holds video other than MPEG-4 Part 2 or H.264 (its sample entry is not mp4v, avc1 or avc3)",
    6: "holds B-VOPs, or may (low_delay = 0): the decoder takes I- and P-VOPs only",
    7: "uses S-VOPs (sprites or global motion compensation)",
    8: "uses quarter-pel motion vectors",
    9: "is interlaced",
    10: "uses data partitioning (and reversible VLCs)",
    11: "has a non-rectangular (shape-coded) video object",
    12: "is not 8-bit video (not_8_bit)",
    13: "uses scalability layers",
    14: "uses MPEG quantisation (quant_type = 1): the decoder takes H.263 quantisation only",
    15: "uses AC prediction",
    16: "uses four motion vectors in a macroblock (4MV)",
    17: "may hold resync markers (video packets; resync_marker_disable = 0)",
    18: "is truncated or corrupt",
    19: "cannot be written",
    20: "uses an MPEG-4 Part 2 tool the decoder does not take (OBMC, complexity estimation, newpred, "
        "reduced-resolution VOPs, or chroma other than 4:2:0)",
    21: "holds interlaced H.264 video (frame_mbs_only_flag = 0: field pictures or MBAFF)",
    22: "holds H.264 video with chroma other than 4:2:0 (monochrome, 4:2:2 or 4:4:4)",
    23: "holds H.264 video of more than 8 bits a sample",
    24: "holds H.264 video with separately coded colour planes (separate_colour_plane_flag)",
    25: "holds H.264 video of a profile the decoder does not take (High 10, High 4:2:2, High 4:4:4, or another "
        "outside Baseline, Main, Extended and High)",
    26: "uses H.264's lossless transform bypass (qpprime_y_zero_transform_bypass_flag)",
    27: "uses H.264 data partitioning (NAL unit types 2-4)",
    28: "holds H.264 SP or SI slices",
    29: "uses H.264 slice groups (FMO)",
    30: "may hold H.264 redundant pictures (redundant_pic_cnt_present_flag)",
    31: "has a gap in H.264 frame_num (a reference picture is missing)",
    32: "holds SVC or MVC (scalable or multiview H.264) NAL units",
    33: "has a colour description (H.264 VUI or MP4 colr box) that OpenCV converts otherwise than BT.601 at "
        "limited range (BT.709 or FCC matrix, full range, BT.2020 primaries, a log, PQ or HLG transfer, ...)",
    34: "uses H.264 memory management operation 5",
    35: "holds H.264 video that does not start at an IDR picture",
    36: "has an edit list that drops, delays or repeats frames",
    37: "holds VP9 or VP8 video (vp09, vp08)",
    38: "holds AV1 video (av01)",
    39: "is cropped on its left edge by other than a multiple of 64 samples (FFmpeg cannot cut it exactly, "
        "and OpenCV rescales the frame)",
}


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if lib.evt_read_mp4.argtypes is None:
        c_int, p_int, p_u8 = ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint8)
        lib.evt_mp4_info.argtypes = [ctypes.c_char_p, p_int, p_int, p_int, ctypes.POINTER(ctypes.c_double)]
        lib.evt_mp4_info.restype = c_int
        lib.evt_read_mp4.argtypes = [ctypes.c_char_p, p_u8, p_u8, p_u8, p_u8, c_int, c_int, c_int, p_int]
        lib.evt_read_mp4.restype = c_int
        lib.evt_save_mp4.argtypes = [ctypes.c_char_p, p_u8, c_int, c_int, c_int, ctypes.c_double, c_int]
        lib.evt_save_mp4.restype = c_int
    return lib


def _check(path: str, status: int) -> None:
    if status:
        raise IOError(f"{path} {_REASONS.get(status, f'failed ({status})')}")


def _u8(a: np.ndarray | None):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def mp4_info(path: str) -> dict:
    """{"frames", "fps", "height", "width"} of an MP4's video track: its
    sample count, its frame rate as FFmpeg's demuxer reads it from the
    sample durations, and the size its VOL header (or H.264 SPS, after its
    cropping window) gives. Raises IOError naming the file for one the
    decoder refuses."""
    frames, height, width, fps = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_double()
    _check(path, _lib().evt_mp4_info(os.fsencode(path), ctypes.byref(frames), ctypes.byref(height),
                                     ctypes.byref(width), ctypes.byref(fps)))
    return {"frames": frames.value, "fps": fps.value, "height": height.value, "width": width.value}


def _decode(path: str, planes: bool):
    info = mp4_info(path)
    t, h, w = info["frames"], info["height"], info["width"]
    rgb = np.empty((t, h, w, 3), np.uint8)
    yuv = (np.empty((t, h, w), np.uint8), np.empty((t, (h + 1) // 2, (w + 1) // 2), np.uint8),
           np.empty((t, (h + 1) // 2, (w + 1) // 2), np.uint8)) if planes else (None, None, None)
    produced = ctypes.c_int()
    _check(path, _lib().evt_read_mp4(os.fsencode(path), _u8(rgb), *map(_u8, yuv), t, h, w, ctypes.byref(produced)))
    n = produced.value
    return rgb[:n], tuple(p[:n] for p in yuv) if planes else None


def read_mp4(path: str) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB: every frame of an MP4's MPEG-4 Part 2 or
    H.264 video, as OpenCV's `VideoCapture` reads it (BGR) turned to RGB:
    H.264 frames in display order, as FFmpeg outputs them. A VOP marked not
    coded gives no frame, as in FFmpeg, so T may fall short of `mp4_info`'s
    sample count. Raises IOError naming the file and the reason for one the
    decoder refuses."""
    return _decode(path, planes=False)[0]


def read_mp4_planes(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The decoded 4:2:0 planes of every frame: Y (T, H, W) and Cb, Cr
    (T, ceil(H / 2), ceil(W / 2)), before the conversion to RGB."""
    return _decode(path, planes=True)[1]


def save_mp4(path: str, frames: np.ndarray, fps: float = 10.0) -> None:
    """Write (N, H, W, 3) uint8 RGB frames to `path` as an MP4 of intra-only
    MPEG-4 Part 2 video at `fps` frames a second (each frame an I-VOP at the
    quantiser kEncodeQuant of csrc/video.cpp, 4:2:0 limited-range BT.601),
    encoded on up to 8 threads. Raises IOError when the file cannot be
    written."""
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3 or not len(frames):
        raise ValueError(f"frames {frames.shape}: need (N, H, W, 3) with N >= 1")
    n, h, w, _ = frames.shape
    if max(h, w) > 8191 or not fps > 0:
        raise ValueError(f"an MPEG-4 VOL holds sizes below 8192 and a positive rate, got {h}x{w} at {fps}")
    status = _lib().evt_save_mp4(os.fsencode(path), _u8(frames), n, h, w, float(fps), min(os.cpu_count() or 1, 8))
    _check(path, status)


_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def _linear_taps(in_size: int, out_size: int, clamp: bool) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's INTER_LINEAR taps along one axis: (source indices (out, 2),
    int64 weights (out, 2) in 2^-11 units). Centres at (d + 0.5) * scale -
    0.5 in float32. cv::resize clamps a horizontal centre past an edge to
    that edge (`clamp`); a vertical one keeps its weights and reads its
    rows clamped to the image."""
    scale = 1.0 / (out_size / in_size)  # cv::resize's 1 / inv_scale
    f = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        low, high = s < 0, s >= in_size - 1
        f[low], s[low] = 0, 0
        f[high], s[high] = 0, in_size - 1
    one = np.float32(1 << _COEF_BITS)
    w = np.stack([np.rint((np.float32(1) - f) * one), np.rint(f * one)], -1).astype(np.int64)
    return np.clip(np.stack([s, s + 1], -1), 0, in_size - 1), w


def resize_linear_u8(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """(..., H, W, C) uint8 -> (..., height, width, C) uint8, byte for byte
    OpenCV's `cv2.resize(frame, (width, height))` (INTER_LINEAR) on each
    frame: half-pixel centres (clamped at the left and right edges), coefficients
    round(w * 2048), the horizontal pass kept in int32, and the vertical
    pass in OpenCV's SIMD rounding on saturating int16 for every value of a
    row, ((b0 >> 4) * beta0 >> 16) + ((b1 >> 4) * beta1 >> 16) + 2 >> 2 (the
    scalar (b0 * beta0 + b1 * beta1 + 2^21) >> 22 misses 9-12% of the bytes
    by one). An exact halving in both axes is OpenCV's 2x2 area mean,
    (a + b + c + d + 2) >> 2, as cv::resize takes it."""
    frames = np.asarray(frames, np.uint8)
    in_h, in_w = frames.shape[-3:-1]
    if (in_h, in_w) == (height, width):
        return frames.copy()
    if in_h == 2 * height and in_w == 2 * width:
        x = frames.astype(np.int32)
        s = x[..., 0::2, 0::2, :] + x[..., 0::2, 1::2, :] + x[..., 1::2, 0::2, :] + x[..., 1::2, 1::2, :]
        return ((s + 2) >> 2).astype(np.uint8)
    xs, xw = _linear_taps(in_w, width, clamp=True)
    ys, yw = _linear_taps(in_h, height, clamp=False)
    needed = np.unique(ys)  # the source rows the vertical pass reads
    cols = frames[..., needed, :, :]
    rows = np.zeros(frames.shape[:-3] + (in_h, width, frames.shape[-1]), np.int64)
    rows[..., needed, :, :] = cols[..., xs[:, 0], :] * xw[:, 0, None] + cols[..., xs[:, 1], :] * xw[:, 1, None]
    b0, b1 = rows[..., ys[:, 0], :, :], rows[..., ys[:, 1], :, :]
    beta0, beta1 = yw[:, 0, None, None], yw[:, 1, None, None]

    def sat16(v):
        return np.clip(v, -32768, 32767)

    out = sat16(sat16(((sat16(b0 >> 4) * beta0) >> 16) + ((sat16(b1 >> 4) * beta1) >> 16)) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(*frames.shape[:-3], height, width, frames.shape[-1])
