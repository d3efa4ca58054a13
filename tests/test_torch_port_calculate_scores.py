"""The port's batch video scorer (`evoworld_tpu_torch.cli.calculate_scores`)
against the JAX package's, on the CPU.

Pairs of `navigated.mp4` / `original.mp4` are written in each subfolder by
OpenCV's `mp4v` writer (FFmpeg's `mpeg4` encode, as the JAX package's own
test of the CLI writes them) at 72x96, so both CLIs resize to 64x64. Both
load LPIPS and I3D from one directory of synthesized upstream state dicts,
made sensitive to the frames they score (`metric_weights`; `assert_resolved`
shows each feature score far above the parity tolerance's floor), and
`scores.json` must agree:

- with the port's `load_video` patched to cv2's (the JAX CLI's own), at the
  harness tolerances the repo already holds the two packages to
  (`assert_same_result`);
- unpatched, within LOOSE: the port's decode and resize may differ from
  cv2's by MAX_LEVELS a byte and MEAN_LEVELS on average
  (`test_torch_port_video.py`), which moves PSNR, SSIM and the feature
  scores by more than the harness's own rounding;
- in both the FVD branch (2 pairs of 10 frames) and the branch that skips
  FVD (4 frames), whose warning both CLIs log.

I3D runs at the CLI's own 224 px. The JAX CLI needs cv2, so the file skips
without it.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from evoworld_tpu.cli import calculate_scores as jax_scores  # noqa: E402
from evoworld_tpu_torch.cli import calculate_scores  # noqa: E402
from tests.test_torch_port_eval import ATOL, RTOL  # noqa: E402
from tests.test_torch_port_eval_harness import assert_resolved, assert_same_result, metric_weights  # noqa: E402
from tests.test_torch_port_models import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread)
from tests.test_torch_port_video import MAX_LEVELS, MEAN_LEVELS  # noqa: E402
from tests.torch_port_data.make_mp4_fixtures import write_mp4v  # noqa: E402

HEIGHT, WIDTH = 72, 96
# The unpatched run's limits, wider than the harness's: they leave room for
# a decode up to MAX_LEVELS a byte from cv2's (MEAN_LEVELS on average), which
# moves every score by more than the two packages' own rounding. (On these
# files the port's decode equals cv2's byte for byte, so the scores meet the
# harness tolerances too.)
LOOSE = {"psnr": 0.05, "ssim": 2e-3, "features": 2e-2}


def write_pairs(root: str, frames: int, pairs: int = 2) -> str:
    """`pairs` subfolders of navigated.mp4 (a noisy copy) and original.mp4
    (smooth moving colour fields), a subfolder missing its original.mp4
    and a stray file, which both CLIs pass over."""
    rng = np.random.default_rng(frames)
    y, x = np.mgrid[0:HEIGHT, 0:WIDTH] / WIDTH
    for p in range(pairs):
        sub = os.path.join(root, f"ep{p}")
        os.makedirs(sub)
        phase = rng.uniform(0, 6, (3, 2))
        original = np.stack([np.stack([128 + 100 * np.cos(6 * x + phase[c, 0] + 0.3 * t) * np.sin(4 * y + phase[c, 1])
                                       for c in range(3)], -1) for t in range(frames)])
        navigated = original + rng.normal(0, 18, original.shape)
        for name, video in (("original.mp4", original), ("navigated.mp4", navigated)):
            write_mp4v(os.path.join(sub, name), np.clip(np.rint(video), 0, 255).astype(np.uint8))
    os.makedirs(os.path.join(root, "no_original"))
    write_mp4v(os.path.join(root, "no_original", "navigated.mp4"), np.zeros((frames, HEIGHT, WIDTH, 3), np.uint8))
    open(os.path.join(root, "notes.txt"), "w").close()
    return root


def cv2_videos(root: str) -> tuple[np.ndarray, np.ndarray]:
    """The JAX CLI's (N, F, 64, 64, 3) inputs, through its own cv2 loader."""
    subs = sorted(d for d in os.listdir(root) if os.path.exists(os.path.join(root, d, "original.mp4")))
    return tuple(np.stack([jax_scores.load_video(os.path.join(root, s, name)) for s in subs])
                 for name in ("navigated.mp4", "original.mp4"))


@pytest.fixture(scope="module", params=[10, 4], ids=["fvd", "no_fvd"])
def scored(request, tmp_path_factory):
    """(root, argv, the JAX CLI's scores.json) for pairs of `param` frames,
    with the nets' weights written beside them."""
    frames = request.param
    root = write_pairs(str(tmp_path_factory.mktemp(f"pairs{frames}")), frames)
    weights = tmp_path_factory.mktemp(f"weights{frames}")
    gen, gt = cv2_videos(root)
    for name, sd in metric_weights(gen, gt, ("lpips", "i3d"), i3d_size=224).items():
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, weights / f"{name}.pt")
    argv = [f"--data.root={root}", f"--runtime.metric_weights_dir={weights}"]
    with jax.default_matmul_precision("highest"):
        jax_scores.main(argv)
    theirs = json.load(open(os.path.join(root, "scores.json")))
    assert ("fvd" in theirs) == (frames >= 10)
    assert_resolved(theirs)
    return root, argv, theirs


def test_load_video_matches_jax(tmp_path):
    root = write_pairs(str(tmp_path), 6, pairs=1)
    for name in ("navigated.mp4", "original.mp4"):
        path = os.path.join(root, "ep0", name)
        ours, theirs = calculate_scores.load_video(path), jax_scores.load_video(path)
        assert ours.shape == theirs.shape == (6, 64, 64, 3) and ours.dtype == np.float32
        err = np.abs(ours - theirs)
        assert err.max() <= MAX_LEVELS / 255 + 1e-7 and err.mean() < MEAN_LEVELS / 255, (err.max(), err.mean())


def test_main_with_cv2_frames_matches_jax(scored, monkeypatch, capfd):
    """The port's CLI fed cv2's frames: everything after the decode."""
    root, argv, theirs = scored
    monkeypatch.setattr(calculate_scores, "load_video", jax_scores.load_video)
    out = calculate_scores.main(argv, device="cpu")
    ours = json.load(open(os.path.join(root, "scores.json")))
    assert set(ours) == ({"fvd", "ssim", "psnr", "lpips"} if "fvd" in theirs else {"ssim", "psnr", "lpips"})
    assert_same_result(ours, theirs)
    assert json.loads(json.dumps(out)) == ours
    assert ("fvd skipped" in capfd.readouterr().err) == ("fvd" not in theirs)


def test_main_matches_jax(scored):
    """The port's CLI on its own decode, within LOOSE."""
    root, argv, theirs = scored
    calculate_scores.main(argv, device="cpu")
    ours = json.load(open(os.path.join(root, "scores.json")))
    assert ours.keys() == theirs.keys()
    for key in ours:
        a, b = ours[key]["value_mean"], theirs[key]["value_mean"]
        if key == "psnr":
            assert abs(a - b) <= LOOSE["psnr"], (a, b)
        elif key == "ssim":
            assert abs(a - b) <= LOOSE["ssim"], (a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=LOOSE["features"], atol=ATOL, err_msg=key)
    assert LOOSE["features"] > RTOL


def test_no_pairs_and_no_card(tmp_path):
    with pytest.raises(SystemExit, match=f"no navigated.mp4/original.mp4 pairs under {tmp_path}"):
        calculate_scores.main([f"--data.root={tmp_path}"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            calculate_scores.main([f"--data.root={tmp_path}"])

