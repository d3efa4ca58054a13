"""Per-segment equirect -> perspective crops with the frames of earlier
segments (counterpart of `evoworld_tpu/cli/pano_to_pers_per_segment.py`), for
preparing training data from generated segments.

`--data.root` names a segment directory ending in `_<k>` (e.g.
`.../predictions_1`); its frames and those of its siblings `<prefix>_0` to
`<prefix>_<k>` (deduplicated by file name) are cropped as in `pano_to_pers`,
each yaw pointing at the look-at anchor (k + 1) * 24 + 24, into
`frame_{idx:03d}.png`. The camera file (`camera_poses.txt` beside the
segment directories, read in float64 and turned to OpenCV's signs) gets
those yaws in column 4 over the segment's rows and is written space-separated
with `str` of each float64 value, on the host as in the JAX CLI, so the text
is the same. `--data.sampling=<output folder>:<output camera file>` moves
the outputs (defaults: `perspective_<k>/` and
`camera_poses_look_at_center_<k>.txt` in the episode directory).

Usage (on the card):
  python -m evoworld_tpu_torch.cli.pano_to_pers_per_segment --data.root=<.../predictions_1>

From Python, `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from evoworld_tpu_torch.cli.common import logger, parse_config
from evoworld_tpu_torch.cli.pano_to_pers import CHUNK, crop_frames
from evoworld_tpu_torch.data.native_io import save_png_batch
from evoworld_tpu_torch.device import resolve_device
from evoworld_tpu_torch.geometry.pose import UNITY_TO_OPENCV
from evoworld_tpu_torch.loop.navigator import calculate_segment_indices


def collect_image_paths(data_folder: str, segment_id: int) -> list[str]:
    """The `.png` frames of `<prefix>_0` to `<prefix>_<segment_id>`, the first
    of each file name kept."""
    data_folder = os.path.abspath(data_folder).rstrip("/")
    if segment_id == 0:
        return [os.path.join(data_folder, n) for n in sorted(os.listdir(data_folder)) if n.endswith(".png")]
    prefix = os.path.basename(data_folder).rsplit("_", 1)[0]
    root = os.path.dirname(data_folder)
    paths, seen = [], set()
    for seg in range(segment_id + 1):
        seg_dir = os.path.join(root, f"{prefix}_{seg}")
        if not os.path.isdir(seg_dir):
            continue
        for name in sorted(os.listdir(seg_dir)):
            if name.endswith(".png") and name not in seen:
                seen.add(name)
                paths.append(os.path.join(seg_dir, name))
    return paths


def read_rdf_camera_file(path: str) -> np.ndarray:
    """The camera CSV's columns after the frame number, float64, in OpenCV's signs."""
    with open(path) as f:
        rows = [[float(x) for x in line.strip().split(",")[1:]] for line in f.readlines()[1:]]
    return np.asarray(rows, np.float64) * np.asarray(UNITY_TO_OPENCV, np.float64)


def main(argv=None, device: str | torch.device = "cuda") -> dict:
    """Run the CLI; returns the output folder, camera file and frames written."""
    config = parse_config(argv, __doc__)
    dev = resolve_device(device)
    data_folder = config.data.root.rstrip("/")
    base = os.path.basename(data_folder)
    try:
        segment_id = int(base.rsplit("_", 1)[1])
    except (IndexError, ValueError):
        raise SystemExit(f"--data.root must end in _<segment_id>, got {base}")

    spec = config.data.sampling if ":" in config.data.sampling else ""
    out_folder, out_camera = (spec.split(":") + [""])[:2] if spec else ("", "")
    episode_dir = os.path.dirname(data_folder)
    out_folder = out_folder or os.path.join(episode_dir, f"perspective_{segment_id}")
    out_camera = out_camera or os.path.join(episode_dir, f"camera_poses_look_at_center_{segment_id}.txt")

    ntv = config.loop.num_target_view
    _, end_idx, look_at_idx = calculate_segment_indices(segment_id, ntv)
    cam = read_rdf_camera_file(os.path.join(episode_dir, "camera_poses.txt"))
    look = cam[min(look_at_idx, len(cam) - 1)]
    os.makedirs(out_folder, exist_ok=True)

    paths = collect_image_paths(data_folder, segment_id)
    logger.info(f"segment {segment_id}: {len(paths)} frames, look_at={min(look_at_idx, len(cam) - 1)}")
    indices = [int(os.path.basename(p).split(".")[0].split("_")[-1]) for p in paths]
    yaws = [math.radians(cam[i - 1][4]) - math.atan2(look[0] - cam[i - 1][0], look[2] - cam[i - 1][2])
            for i in indices]
    for at in range(0, len(paths), CHUNK):
        save_png_batch([os.path.join(out_folder, f"frame_{i:03d}.png") for i in indices[at:at + CHUNK]],
                       crop_frames(paths[at:at + CHUNK], yaws[at:at + CHUNK], config, dev))

    if yaws:
        lo = max(0, end_idx - len(yaws))
        cam[lo:end_idx, 4] = [math.degrees(y) for y in yaws[: end_idx - lo]]
    with open(out_camera, "w") as f:
        for i, row in enumerate(cam):
            f.write(f"{i + 1} " + " ".join(str(v) for v in row) + "\n")
    logger.info(f"wrote {len(paths)} frames -> {out_folder}; camera -> {out_camera}")
    return dict(out_folder=out_folder, out_camera=out_camera, frames=len(paths))


if __name__ == "__main__":
    main()
