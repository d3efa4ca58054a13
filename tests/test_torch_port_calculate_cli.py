"""The port's scoring CLIs against the JAX package's, on the CPU: tiny PNG
episodes through `calculate_metrics` (eval_score.json: the same keys and
structure, values as `test_torch_port_eval_harness.py` holds the harness) and two PNGs through `calculate_dreamsim` in both variants (the
same JSON keys, the score within 1e-4: a cosine distance of 768- or
1792-d fp32 embeddings), every net loaded by both CLIs from one directory of
synthesized upstream torch weights.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from evoworld_tpu.cli import calculate_metrics as jax_metrics
from evoworld_tpu_torch.cli import calculate_metrics
from evoworld_tpu_torch.data import native_io
from tests.test_torch_port_eval import _videos
from tests.test_torch_port_eval_harness import assert_resolved, assert_same_result, metric_weights
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """Upstream-named lpips / inception_v4 state dicts, made sensitive to the
    predictions' frames (3 frames score no FVD, so I3D stays random)."""
    root = tmp_path_factory.mktemp("metric_weights")
    for name, sd in metric_weights(*prediction_videos(3)).items():
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, root / f"{name}.pt")
    return str(root)


@pytest.fixture(scope="module")
def predictions(tmp_path_factory):
    """Two episodes' predictions_2 / predictions_gt_2 PNGs, 3 frames of 32 x 48."""
    return write_predictions(str(tmp_path_factory.mktemp("scores")), 3)


def prediction_videos(frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Two episodes' generated and GT videos of 32 x 48, [0, 1] on 8 bits."""
    gen, gt = _videos(np.random.default_rng(11), (2, frames, 32, 48, 3), noise=0.2)
    return np.round(gen * 255) / 255, np.round(gt * 255) / 255


def write_predictions(root: str, frames: int) -> str:
    gen, gt = prediction_videos(frames)
    for e in range(2):
        for sub, video in (("predictions_2", gen[e]), ("predictions_gt_2", gt[e])):
            os.makedirs(os.path.join(root, f"episode_{e:03d}", sub))
            native_io.save_png_batch([os.path.join(root, f"episode_{e:03d}", sub, f"{i:03d}.png")
                                      for i in range(frames)], np.round(video * 255).astype(np.uint8))
    return root


def test_calculate_metrics_matches_jax_cli(predictions, weights_dir, capsys):
    argv = [f"--data.root={predictions}", f"--runtime.metric_weights_dir={weights_dir}"]
    with jax.default_matmul_precision("highest"):
        jax_metrics.main(argv)
    theirs_line = capsys.readouterr().out.strip().splitlines()[-1]
    with open(os.path.join(predictions, "eval_score.json")) as f:
        theirs = json.load(f)
    scores = calculate_metrics.main(argv, device="cpu")
    ours_line = capsys.readouterr().out.strip().splitlines()[-1]
    with open(os.path.join(predictions, "eval_score.json")) as f:
        ours = json.load(f)
    assert ours["num_videos"] == theirs["num_videos"] == 2 and scores["num_videos"] == 2
    assert ours["lpips"]["weights"] == "converted"
    assert_resolved(theirs)
    assert_same_result(ours, theirs)
    ours_line, theirs_line = json.loads(ours_line), json.loads(theirs_line)
    assert ours_line.keys() == theirs_line.keys()
    for key in ours_line:
        np.testing.assert_allclose(ours_line[key], theirs_line[key], rtol=2e-3, atol=5e-4, err_msg=key)
