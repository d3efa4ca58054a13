"""The port's batch video scorer (`evoworld_tpu_torch.cli.calculate_scores`)
against the JAX package's on H.264 files, on the CPU.

The JAX CLI reads every video through OpenCV, whose FFmpeg decodes H.264;
the port reads them with its own decoder (`csrc/h264.h`). Two subfolders of
`navigated.mp4` / `original.mp4` pairs are copied from the committed H.264
fixtures (`torch_port_data/make_h264_fixtures.py`: CABAC with B-frames at
64x64, CAVLC with temporal direct cropped to 200x120, Constrained Baseline
in avc3), so both CLIs resize 200x120 and 64x64 frames to 64x64 and truncate
each set to its shortest video (12 frames: the FVD branch). Both load LPIPS
and I3D from one directory of synthesized upstream state dicts made
sensitive to the frames (`metric_weights`, `assert_resolved`), and the
port's `scores.json`, on its own decode, must meet the JAX CLI's at the
harness tolerances (`assert_same_result`): the decode is exact by the
standard, so nothing of the decoder's may show in the scores.

I3D runs at the CLI's own 224 px. The JAX CLI needs cv2, so the file skips
without it.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from evoworld_tpu.cli import calculate_scores as jax_scores  # noqa: E402
from evoworld_tpu_torch.cli import calculate_scores  # noqa: E402
from tests.test_torch_port_eval_harness import assert_resolved, assert_same_result, metric_weights  # noqa: E402
from tests.test_torch_port_models import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread)

DATA = os.path.join(os.path.dirname(__file__), "torch_port_data")
PAIRS = {"ep0": ("h264_cavlc_200x120", "h264_cabac_64"), "ep1": ("h264_baseline_64", "h264_cabac_64")}


def test_main_on_h264_pairs_matches_jax(tmp_path):
    root = tmp_path / "pairs"
    for sub, (navigated, original) in PAIRS.items():
        os.makedirs(root / sub)
        shutil.copy(os.path.join(DATA, f"{navigated}.mp4"), root / sub / "navigated.mp4")
        shutil.copy(os.path.join(DATA, f"{original}.mp4"), root / sub / "original.mp4")
    # the JAX CLI's inputs, through its own cv2 loader, cut to the shortest video
    videos = {name: [jax_scores.load_video(str(root / sub / name)) for sub in sorted(PAIRS)]
              for name in ("navigated.mp4", "original.mp4")}
    t = min(len(v) for vs in videos.values() for v in vs)
    assert t == 12
    gen, gt = (np.stack([v[:t] for v in videos[name]]) for name in ("navigated.mp4", "original.mp4"))
    weights = tmp_path / "weights"
    os.makedirs(weights)
    for name, sd in metric_weights(gen, gt, ("lpips", "i3d"), i3d_size=224).items():
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, weights / f"{name}.pt")
    argv = [f"--data.root={root}", f"--runtime.metric_weights_dir={weights}"]
    with jax.default_matmul_precision("highest"):
        jax_scores.main(argv)
    theirs = json.load(open(root / "scores.json"))
    assert set(theirs) == {"fvd", "ssim", "psnr", "lpips"}
    assert_resolved(theirs)
    out = calculate_scores.main(argv, device="cpu")
    ours = json.load(open(root / "scores.json"))
    assert_same_result(ours, theirs)
    assert json.loads(json.dumps(out)) == ours
