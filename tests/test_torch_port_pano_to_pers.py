"""The port's `pano_to_pers` and `pano_to_pers_per_segment` CLIs against the
JAX package's, on the CPU.

Both sides crop the same panoramas (PNG and JPEG, written with PIL) with the
same yaws, computed on the host in float64 from the same poses. The crops
are quantized by truncation, (clip(x, 0, 1) * 255) -> uint8, so an fp32
difference of one rounding in the bilinear sample can move a value across
an integer: the decoded crops must be equal but for at most CROP_MAX_STEPPED
of their samples, each off by one step. The camera files must be equal as
text (`{v:.6f}` of float32 poses; `str` of float64 ones). A second run of
`pano_to_pers` skips the finished episode.
"""

import os
import shutil

import jax
import numpy as np
import pytest
from PIL import Image

from evoworld_tpu.cli import pano_to_pers as j_pano_to_pers
from evoworld_tpu.cli import pano_to_pers_per_segment as j_per_segment
from evoworld_tpu_torch.cli import pano_to_pers, pano_to_pers_per_segment
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CROP_MAX_STEPPED = 0.002
LOOP = ["--loop.num_target_view=3", "--loop.pers_height=12", "--loop.pers_width=16"]


def _panorama(rng, h=24, w=48):
    """A smooth colour field with a little noise (bilinear samples of it are
    seldom exactly on an integer step)."""
    y, x = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    field = np.stack([np.sin(2 * np.pi * x + k) * np.cos(np.pi * y * (k + 1)) for k in range(3)], -1) * 0.4 + 0.5
    return np.clip((field + rng.normal(0, 0.05, field.shape)) * 255, 0, 255).astype(np.uint8)


def _camera_rows(rng, n):
    steps = rng.normal(size=(n, 6)) * np.array([0.3, 0.02, 0.3, 0.5, 9.0, 0.5]) + np.array([0, 0, 0.4, 0, 0, 0])
    return np.cumsum(steps, axis=0)


def _write_camera(path, rows):
    with open(path, "w") as f:
        f.write("Frame,PosX,PosY,PosZ,RotX,RotY,RotZ\n")
        for i, row in enumerate(rows):
            f.write(",".join([str(i + 1)] + [repr(float(v)) for v in row]) + "\n")


@pytest.fixture()
def episode(tmp_path):
    """An episode of 9 panoramas (the sixth a JPEG) and 11 camera rows."""
    rng = np.random.default_rng(0)
    ep = tmp_path / "dataset" / "episode_000"
    os.makedirs(ep / "panorama")
    for i in range(1, 10):
        img = Image.fromarray(_panorama(rng))
        img.save(ep / "panorama" / (f"{i:03d}.jpg" if i == 6 else f"{i:03d}.png"), quality=95)
    _write_camera(ep / "camera_poses.txt", _camera_rows(rng, 11))
    return ep


def _steps(a_dir, b_dir, names):
    """The share of crop samples that differ, after checking each differs by one step at most."""
    diffs = []
    for name in names:
        a, b = (np.asarray(Image.open(os.path.join(d, name)), np.int16) for d in (a_dir, b_dir))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, name
        diffs.append((a != b).mean())
    return float(np.mean(diffs))


def test_pano_to_pers_matches_jax_cli(episode, tmp_path):
    theirs = tmp_path / "jax_episode"
    shutil.copytree(episode, theirs)
    with jax.default_matmul_precision("highest"):
        j_pano_to_pers.main([f"--data.root={theirs}", *LOOP])
    # the port on the dataset directory (its one episode found below it)
    assert pano_to_pers.main([f"--data.root={episode.parent}", *LOOP], device="cpu") == 9
    ours, want = episode / "perspective_look_at_center", theirs / "perspective_look_at_center"
    names = sorted(os.listdir(want))
    assert names == sorted(os.listdir(ours)) == [f"{i:03d}.png" for i in range(1, 10)]
    assert Image.open(ours / names[0]).size == (16, 12)
    assert _steps(ours, want, names) <= CROP_MAX_STEPPED
    text = (episode / "camera_poses_look_at_center.txt").read_text()
    assert text == (theirs / "camera_poses_look_at_center.txt").read_text()
    assert text != (episode / "camera_poses.txt").read_text()
    mtimes = {n: os.path.getmtime(ours / n) for n in names}
    assert pano_to_pers.main([f"--data.root={episode}", *LOOP], device="cpu") == 0  # done: skipped
    assert mtimes == {n: os.path.getmtime(ours / n) for n in names}


def test_pano_to_pers_per_segment_matches_jax_cli(tmp_path):
    """Segment 1 of generated frames `predictions_{0,1}` (segment 0's last
    frame repeated in segment 1, kept once), both CLIs' outputs redirected
    by `--data.sampling` into directories of their own."""
    rng = np.random.default_rng(1)
    ep = tmp_path / "run" / "episode_000"
    for seg, frames in ((0, range(0, 4)), (1, range(3, 7))):
        os.makedirs(ep / f"predictions_{seg}")
        for i in frames:
            Image.fromarray(_panorama(rng)).save(ep / f"predictions_{seg}" / f"frame_{i + 1:03d}.png")
    _write_camera(ep / "camera_poses.txt", _camera_rows(rng, 12))
    outputs = {}
    for side, run in (("jax", j_per_segment.main), ("port", lambda a: pano_to_pers_per_segment.main(a, device="cpu"))):
        folder, camera = tmp_path / f"{side}_pers", tmp_path / f"{side}_camera.txt"
        with jax.default_matmul_precision("highest"):
            run([f"--data.root={ep / 'predictions_1'}", f"--data.sampling={folder}:{camera}", *LOOP])
        outputs[side] = folder, camera
    (ours, our_cam), (want, want_cam) = outputs["port"], outputs["jax"]
    names = sorted(os.listdir(want))
    assert names == sorted(os.listdir(ours)) == [f"frame_{i:03d}.png" for i in range(1, 8)]
    assert _steps(ours, want, names) <= CROP_MAX_STEPPED
    assert our_cam.read_text() == want_cam.read_text()
    assert len(our_cam.read_text().splitlines()) == 12
    # the default outputs beside the segment directories, and segment 0 alone
    result = pano_to_pers_per_segment.main([f"--data.root={ep / 'predictions_0'}", *LOOP], device="cpu")
    assert result == dict(out_folder=str(ep / "perspective_0"), frames=4,
                          out_camera=str(ep / "camera_poses_look_at_center_0.txt"))
    assert pano_to_pers_per_segment.collect_image_paths(str(ep / "predictions_1"), 1) == j_per_segment.collect_image_paths(
        str(ep / "predictions_1"), 1)
