"""Video export helpers (counterpart of `evoworld_tpu/utils/video.py`).

`export_gif` writes through the port's C++ GIF encoder
(`data/native_io.py::save_gif`), since the machine the port runs on has no
PIL: each frame gets its own 256-colour palette and the file loops forever.
The JAX package's `export_mp4` has no caller and is not ported (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from evoworld_tpu_torch.data.native_io import save_gif


def _to_uint8(frames) -> np.ndarray:
    arr = np.asarray(frames)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    return arr


def export_gif(frames, path: str, fps: int = 10) -> None:
    """(N, H, W, 3) [0, 1] floats or uint8 -> animated GIF, `1000 / fps` ms a
    frame in whole hundredths of a second (PIL's rounding of `duration`)."""
    save_gif(path, _to_uint8(frames), int(int(1000 / fps) / 10))


def side_by_side(a, b) -> np.ndarray:
    """Horizontally concatenate two (N, H, W, C) frame stacks."""
    return np.concatenate([np.asarray(a), np.asarray(b)], axis=2)
