"""Video export helpers (counterpart of `evoworld_tpu/utils/video.py`).

`export_gif` writes through the port's C++ GIF encoder
(`data/native_io.py::save_gif`), since the machine the port runs on has no
PIL: each frame gets its own 256-colour palette and the file loops forever.
`export_mp4` writes a real MP4 through the port's intra-only MPEG-4 Part 2
encoder (`data/native_video.py::save_mp4`), which OpenCV, FFmpeg and the
port's decoder read; the machine has no imageio. Unlike the JAX function it
falls back to nothing: an encoder that fails raises.
"""

from __future__ import annotations

import numpy as np

from evoworld_tpu_torch.data.native_io import save_gif
from evoworld_tpu_torch.data.native_video import save_mp4


def _to_uint8(frames) -> np.ndarray:
    arr = np.asarray(frames)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    return arr


def export_gif(frames, path: str, fps: int = 10) -> None:
    """(N, H, W, 3) [0, 1] floats or uint8 -> animated GIF, `1000 / fps` ms a
    frame in whole hundredths of a second (PIL's rounding of `duration`)."""
    save_gif(path, _to_uint8(frames), int(int(1000 / fps) / 10))


def export_mp4(frames, path: str, fps: int = 10) -> None:
    """(N, H, W, 3) [0, 1] floats or uint8 -> an MP4 at `fps` frames a
    second, every frame an I-VOP; raises IOError when it cannot be written."""
    save_mp4(path, _to_uint8(frames), fps)


def side_by_side(a, b) -> np.ndarray:
    """Horizontally concatenate two (N, H, W, C) frame stacks."""
    return np.concatenate([np.asarray(a), np.asarray(b)], axis=2)
