"""DreamSim pair scorer (counterpart of `evoworld_tpu/cli/calculate_dreamsim.py`).

Scores two images, score = model(img1, img2), with `eval/dreamsim.py`: the
single-branch dino_vitb16 variant by default, or the three-branch ensemble
with `--runtime.dreamsim_variant=ensemble`. Weights load from
`--runtime.metric_weights_dir`: dreamsim.pt (DINO naming, the dino branch)
and, for the ensemble, dreamsim_clip.pt / dreamsim_open_clip.pt (OpenAI
`visual.*` naming); absent files leave a branch random (tagged
"random_seed0_torch"). Images are read as PNG or JPEG (by their first
bytes) through `data/native_io.py`.

Usage (on the card):
  python -m evoworld_tpu_torch.cli.calculate_dreamsim --data.root=<image1.png>:<image2.png>

From Python, `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import json
import os

import torch

from evoworld_tpu_torch.cli.common import logger, parse_config
from evoworld_tpu_torch.data.native_io import image_size, load_image_batch
from evoworld_tpu_torch.device import resolve_device
from evoworld_tpu_torch.eval.dreamsim import clip_visual_state_dict, dino_state_dict, make_dreamsim

# branch -> (weight file stem, upstream state dict -> the branch's state dict)
_BRANCH_FILES = {
    "dino_vitb16": ("dreamsim", dino_state_dict),
    "clip_vitb32": ("dreamsim_clip", clip_visual_state_dict),
    "open_clip_vitb32": ("dreamsim_open_clip", clip_visual_state_dict),
}


def load_branch_states(weights_dir: str) -> dict:
    """{branch: port-named state dict} of the DreamSim weight files in `weights_dir`."""
    states = {}
    for branch, (stem, to_port) in _BRANCH_FILES.items():
        for ext in (".pt", ".pth"):
            path = os.path.join(weights_dir, stem + ext) if weights_dir else ""
            if path and os.path.exists(path):
                sd = torch.load(path, map_location="cpu", weights_only=True)
                states[branch] = to_port({k: v.float() for k, v in sd.items()})
                logger.info(f"loaded dreamsim {branch} weights: {path}")
                break
    return states


def main(argv=None, device: str | torch.device = "cuda") -> dict:
    """Run the CLI; returns {"dreamsim": score, "weights": tag}."""
    config = parse_config(argv, __doc__)
    dev = resolve_device(device)
    spec = config.data.root
    if ":" not in spec:
        raise SystemExit("--data.root must be <image1>:<image2>")
    path1, path2 = spec.split(":", 1)

    model = make_dreamsim(config.runtime.dreamsim_variant, load_branch_states(config.runtime.metric_weights_dir),
                          device=dev)

    def load(p):
        return load_image_batch([p], *image_size(p), minus1_1=False)

    score = float(model(load(path1), load(path2))[0])
    logger.info(f"dreamsim({os.path.basename(path1)}, {os.path.basename(path2)}) = {score:.5f}")
    result = {"dreamsim": score, "weights": model.weights_tag}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
