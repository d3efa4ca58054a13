"""Cubemap captures -> equirectangular panoramas (counterpart of
`evoworld_tpu/cli/cube_to_pano.py`).

One `<frame>.png` panorama per captured frame, through `data/engine.py`.
Two capture layouts are recognised:

  - Unity: one directory per frame holding {front,back,left,right,top,bottom}.png;
  - UE: flat `<id>_<face>.png` files in one directory (`--data.engine=ue`
    selects Unreal Engine's sampling: top and bottom faces turned by 180
    degrees).

A frame whose panorama exists already is skipped. The faces' size is read
from the first face's header (PNG or JPEG, `data/native_io.py::image_size`).

Usage (on the card):
  python -m evoworld_tpu_torch.cli.cube_to_pano --data.root=<captures> \\
      --runtime.save_dir=<out> [--data.height=1000 --data.width=2000] [--data.engine=ue]

From Python, `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import os
import re

import torch

from evoworld_tpu_torch.cli.common import logger, parse_config, to_uint8
from evoworld_tpu_torch.data.engine import FACE_ORDER, ue_cubes_to_pano, unity_cubes_to_pano
from evoworld_tpu_torch.data.native_io import image_size, load_image_batch, save_png_batch
from evoworld_tpu_torch.device import resolve_device

_UE_FILE = re.compile(r"(\d+)_(top|bottom|left|right|front|back)\.png$")


def discover_frames(root: str) -> dict[str, list[str]]:
    """Frame name -> its 6 face paths in FACE_ORDER, in either layout."""
    frames: dict[str, list[str]] = {}
    for d in sorted(os.listdir(root)):
        if os.path.isdir(os.path.join(root, d)) and os.path.exists(os.path.join(root, d, "front.png")):
            frames[d] = [os.path.join(root, d, f"{f}.png") for f in FACE_ORDER]
    if frames:
        return frames
    flat: dict[str, dict[str, str]] = {}
    for name in os.listdir(root):
        m = _UE_FILE.match(name)
        if m:
            flat.setdefault(m.group(1), {})[m.group(2)] = os.path.join(root, name)
    for fid in sorted(flat, key=int):
        if len(flat[fid]) == 6:
            frames[fid] = [flat[fid][f] for f in FACE_ORDER]
    return frames


def main(argv=None, device: str | torch.device = "cuda") -> list[str]:
    """Run the CLI; returns the panoramas written (skipped frames left out)."""
    config = parse_config(argv, __doc__)
    dev = resolve_device(device)
    root, out_root = config.data.root, config.runtime.save_dir
    os.makedirs(out_root, exist_ok=True)
    height, width = config.data.height, config.data.width
    convert = ue_cubes_to_pano if config.data.engine == "ue" else unity_cubes_to_pano

    frames = discover_frames(root)
    if not frames:
        raise SystemExit(f"no cubemap frames (dirs or <id>_<face>.png) under {root}")
    logger.info(f"{len(frames)} cubemap frames")
    written = []
    for name, paths in frames.items():
        out_path = os.path.join(out_root, f"{name}.png")
        if os.path.exists(out_path):
            continue
        faces = load_image_batch(paths, *image_size(paths[0]), minus1_1=False)
        pano = convert(torch.from_numpy(faces).to(dev), height, width)
        save_png_batch([out_path], to_uint8(pano[None]))
        written.append(out_path)
    logger.info(f"wrote {len(written)} panoramas to {out_root}")
    return written


if __name__ == "__main__":
    main()
