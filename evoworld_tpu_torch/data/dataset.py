"""Episode dataset: panoramas, camera poses and memory frames (counterpart of
`evoworld_tpu/data/dataset.py`).

Host-side numpy, images through the port's own C++ loader
(`data/native_io.py`: PNG on zlib, JPEG in libjpeg's arithmetic, no PIL):

  - episodes are directories holding `panorama/{001..}.png` frames and a
    `camera_poses.txt` CSV (`Frame,PosX,PosY,PosZ,RotX,RotY,RotZ`); a missing
    `.png` falls back to the `.jpg` of the same name, decoded to the bytes
    libjpeg's default decode gives (a JPEG variant the loader does not take
    raises an error naming the file);
  - poses are converted Unity -> OpenCV by sign flips and positions scaled by
    `pos_scale` (default 0.1);
  - without `load_complete_episode` a sample is the last `sequence_length`
    frames (the validation window);
  - memory sampling "reprojection" loads the pre-rendered memory panoramas
    (`<reprojection_name>/{00..}.png`, under `memory_path/<episode>` when
    given) and prepends the episode's first GT frame; "empty_with_traj"
    yields zero memory images with the current trajectory;
  - images resize to (height, width) and rescale to [-1, 1].

Outputs are channels-last numpy arrays.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np

from evoworld_tpu_torch.data.native_io import load_image_batch
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


def dump_trajectories(root: str, episodes=None) -> dict:
    """Cache every episode's raw pose rows in `<root>/camera_trajectories.json`
    and return the mapping: {episode: {frame id: [x, y, z, rotx, roty,
    rotz]}}, the Unity rows unconverted under their frame-id strings (a
    consumer applies UNITY_TO_OPENCV itself). The JAX package's and the
    reference repo's schema, so the caches are exchangeable. `episodes`
    (default: every directory under `root` with a camera_poses.txt, sorted)."""
    import json

    if episodes is None:
        episodes = sorted(e for e in os.listdir(root) if os.path.isfile(os.path.join(root, e, "camera_poses.txt")))
    cache: dict = {}
    for e in episodes:
        poses: dict = {}
        with open(os.path.join(root, e, "camera_poses.txt")) as f:
            for line in f.readlines()[1:]:
                values = [v.strip() for v in line.strip().split(",")]
                if len(values) >= 7:
                    poses[values[0]] = [float(x) for x in values[1:7]]
        cache[e] = poses
    with open(os.path.join(root, "camera_trajectories.json"), "w") as f:
        json.dump(cache, f, indent=4)
    return cache


def load_trajectory_file(traj_file: str) -> dict:
    """A camera_trajectories.json cache -> {episode: {frame id: [pose row]}}."""
    import json

    with open(traj_file) as f:
        return json.load(f)


def trajectory_to_array(episode_poses: dict) -> np.ndarray:
    """{frame id: [pose]} -> (N, 6) float32 rows ordered by numeric frame id."""
    keys = sorted(episode_poses, key=lambda k: float(k))
    return np.asarray([episode_poses[k] for k in keys], np.float32)


def _resolve(path: str) -> str:
    if not os.path.exists(path):
        alt = os.path.splitext(path)[0] + ".jpg"
        if os.path.exists(alt):
            return alt
    return path


def _load_images(paths, height: int, width: int) -> np.ndarray:
    """(N, height, width, 3) float32 in [-1, 1]."""
    return load_image_batch([_resolve(p) for p in paths], height, width, minus1_1=True)


@dataclasses.dataclass
class EpisodeSample:
    pixel_values: np.ndarray        # (F, H, W, 3) in [-1, 1]
    cam_traj: np.ndarray            # (F, 6) scaled positions
    memory_values: np.ndarray       # (M, H, W, 3) in [-1, 1]
    memory_traj: np.ndarray         # (M, 6)
    episode_path: str


class EpisodeDataset:
    """Iterates episodes of a dataset root (or a single episode directory)."""

    def __init__(
        self,
        root: str,
        height: int = 576,
        width: int = 1024,
        sequence_length: int = 25,
        sampling: str = "reprojection",
        reprojection_name: str = "rendered_panorama_vggt_open3d",
        memory_path: Optional[str] = None,
        pos_scale: float = 0.1,
        load_complete_episode: bool = False,
        single_episode: bool = False,
    ):
        self.root = root
        self.height = height
        self.width = width
        self.sequence_length = sequence_length
        self.sampling = sampling
        self.reprojection_name = reprojection_name
        self.memory_path = memory_path
        self.pos_scale = pos_scale
        self.load_complete_episode = load_complete_episode

        if single_episode:
            self.episodes = [""]
        else:
            self.episodes = sorted(
                e for e in os.listdir(root)
                if os.path.isdir(os.path.join(root, e)) and "episode" in e
            )
            if not self.episodes and os.path.isdir(os.path.join(root, "panorama")):
                self.episodes = [""]  # root itself is an episode
        if not self.episodes:
            raise ValueError(f"no episodes under {root}")

    def __len__(self) -> int:
        return len(self.episodes)

    def episode_dir(self, idx: int) -> str:
        return os.path.join(self.root, self.episodes[idx])

    def poses(self, idx: int) -> np.ndarray:
        return load_camera_poses(os.path.join(self.episode_dir(idx), "camera_poses.txt"))

    def _frame_path(self, episode_dir: str, frame_id: int) -> str:
        return os.path.join(episode_dir, "panorama", f"{frame_id:03d}.png")

    def __getitem__(self, idx: int) -> EpisodeSample:
        ep_dir = self.episode_dir(idx)
        poses = self.poses(idx)
        n = len(poses)

        if self.load_complete_episode:
            start, end = 1, n + 1
        else:
            # The last `sequence_length` frames (the validation window).
            start = n - self.sequence_length + 1
            end = start + self.sequence_length

        frames = _load_images(
            [self._frame_path(ep_dir, i) for i in range(start, end)],
            self.height, self.width,
        )
        traj = poses[start - 1 : end - 1].copy()

        if self.sampling == "reprojection":
            memory = self._load_reprojection_memory(ep_dir)
            mem_traj = traj[: len(memory)].copy()
        elif self.sampling == "empty_with_traj":
            memory = np.zeros((traj.shape[0], self.height, self.width, 3), np.float32)
            mem_traj = traj.copy()
        else:
            raise ValueError(f"unknown sampling mode {self.sampling!r}")

        traj[:, :3] *= self.pos_scale
        mem_traj[:, :3] *= self.pos_scale
        return EpisodeSample(frames, traj, memory, mem_traj, ep_dir)

    def _load_reprojection_memory(self, ep_dir: str) -> np.ndarray:
        base = ep_dir
        if self.memory_path:
            base = os.path.join(self.memory_path, os.path.basename(ep_dir))
        mem_dir = os.path.join(base, self.reprojection_name)
        names = sorted(f for f in os.listdir(mem_dir) if f.endswith((".png", ".jpg")))
        # The episode's first GT frame goes first.
        paths = [self._frame_path(ep_dir, 1)] + [
            os.path.join(mem_dir, f"{i:02d}.png") for i in range(len(names))
        ]
        return _load_images(paths, self.height, self.width)

    def __iter__(self) -> Iterator[EpisodeSample]:
        for i in range(len(self)):
            yield self[i]
