"""Point-cloud export for inspection (counterpart of
`evoworld_tpu/memory/export.py`): ASCII PLY and OBJ writers whose files are
byte for byte the JAX package's on the same points.

Both take numpy arrays or tensors of any device. The text of each value is
what the JAX writers' f-strings give: a float32 coordinate prints as the
Python float it widens to (`f"{np.float32(0.1)}"` is "0.10000000149011612"),
the PLY's colours as uint8 from `colors * 255` by truncation, the OBJ's as
the clipped colours in their own type. The lines are formed from Python
scalars (`tolist`), one process writing the whole cloud.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _points_and_colors(points, colors):
    points = _host(points).astype(np.float32, copy=False).reshape(-1, 3)
    return points, np.clip(_host(colors).reshape(-1, 3), 0, 1)


def _lines(prefix: str, points: np.ndarray, colors: np.ndarray) -> str:
    return "".join(f"{prefix}{x} {y} {z} {r} {g} {b}\n"
                   for (x, y, z), (r, g, b) in zip(points.tolist(), colors.tolist()))


def save_ply(points, colors, path: str) -> None:
    """(N, 3) points + (N, 3) colours in [0, 1] -> ASCII PLY."""
    points, colors = _points_and_colors(points, colors)
    header = ("ply\nformat ascii 1.0\n"
              f"element vertex {len(points)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "end_header\n")
    with open(path, "w") as f:
        f.write(header + _lines("", points, (colors * 255).astype(np.uint8)))


def save_obj(points, colors, path: str) -> None:
    """(N, 3) points + (N, 3) colours in [0, 1] -> OBJ vertex-colour lines."""
    points, colors = _points_and_colors(points, colors)
    with open(path, "w") as f:
        f.write(_lines("v ", points, colors))
