"""Camera poses of an episode (counterpart of `evoworld_tpu/data/dataset.py::load_camera_poses`).

Numpy only: the episode's image loading (`EpisodeDataset`, PIL) is not part of
the port yet.
"""

from __future__ import annotations

import numpy as np

from evoworld_tpu_torch.geometry.pose import UNITY_TO_OPENCV


def load_camera_poses(path: str, unity_to_opencv: bool = True) -> np.ndarray:
    """Parse camera_poses.txt -> (N, 6) float32 [x, y, z, rotx, roty, rotz] rows.

    Skips the header (`Frame,PosX,...`) and short rows; applies the
    Unity->OpenCV sign convention by default.
    """
    rows = []
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.strip().split(",")]
            if not parts or not parts[0] or "frame" in parts[0].lower():
                continue
            if len(parts) >= 7:
                rows.append([float(x) for x in parts[1:7]])
    if not rows:
        raise ValueError(f"no pose rows in {path}")
    poses = np.asarray(rows, np.float32)
    if unity_to_opencv:
        poses = poses * np.asarray(UNITY_TO_OPENCV, np.float32)
    return poses
