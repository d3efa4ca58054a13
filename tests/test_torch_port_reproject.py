"""The port's `reproject` CLI against the JAX package's, end to end on the CPU.

A tiny episode (7 look-at-center crops of 16 x 512, their camera file, 4
target views) goes through both sides' `process_episode` with the same
tiny VGGT: random JAX parameters (`tests/test_torch_port_vggt.py`'s draw),
carried to the port by `vggt_params_from_jax`; both in fp32, JAX at matmul
precision "highest". Three sky modes: no mask, the weights-free heuristic
(the ONNX path missing, with its warning), and a full-width U^2-Net written
as `skyseg.onnx` by the port's ONNX writer, made sensitive to the crops
(`chip_smoke.sensitive_skyseg_onnx`). As
`tests/test_torch_port_loop.py` does for the loop:
  - VGGT's predictions on the same crops within the models' tolerance
    (rtol 2e-3 / atol 5e-4);
  - the port's rest of the episode (sky mask, alignment, confidence filter,
    splat, PNG writes) given the JAX side's predictions: the decoded renders
    may differ by more than 2e-3 (the PNG quantum is 1/255) on at most 0.5%
    of pixels, the loop tests' limit for points that land across a pixel
    edge under fp32 noise;
  - free-running, the share of such pixels is printed.
Then the CLI's own logic: `--data.start_idx` / `--data.end_idx` pick the
episodes they name, a second run skips what is done and builds no VGGT, and
an episode without crops is skipped with a warning.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from evoworld_tpu.cli import reproject as j_reproject
from evoworld_tpu.cli.common import parse_config as j_parse_config
from evoworld_tpu.models.vggt.model import VGGT as JVGGT
from evoworld_tpu.models.vggt.model import make_reconstructor as j_make_reconstructor
from evoworld_tpu_torch.cli import reproject
from evoworld_tpu_torch.cli.common import parse_config
from evoworld_tpu_torch.models.vggt.model import VGGT, make_reconstructor
from evoworld_tpu_torch.models.weights import vggt_params_from_jax
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tests.test_torch_port_vggt import TINY, _j_config, _random_tree

MODEL_TOL = dict(rtol=2e-3, atol=5e-4)
PIXEL_ATOL, MAX_FLIPPED = 2e-3, 0.005
SOURCES, TARGETS = 3, 4
ARGS = [f"--loop.num_target_view={TARGETS}", "--loop.pers_height=16", "--loop.pers_width=512",
        "--pipeline.height=32", "--pipeline.width=64"]


class _Recorder:
    """Wraps a reconstructor; keeps each call's predictions as numpy arrays."""

    def __init__(self, fn):
        self.fn, self.preds = fn, []

    def __call__(self, images):
        out = self.fn(images)
        self.preds.append({k: np.asarray(v) for k, v in out.items()})
        return out


def _write_episode(ep, seed):
    """7 crops (smooth colour fields with a bright, flat band of sky on top)
    and a smooth camera walk, in `perspective_look_at_center/` with an
    (unused) panorama directory, as `cli.pano_to_pers` leaves an episode."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(ep, "perspective_look_at_center"))
    os.makedirs(os.path.join(ep, "panorama"))
    n = SOURCES + TARGETS
    coarse = torch.from_numpy(rng.uniform(size=(n, 3, 3, 12)).astype(np.float32))
    crops = torch.nn.functional.interpolate(coarse, size=(16, 512), mode="bilinear").permute(0, 2, 3, 1).numpy()
    crops[:, :4] = [0.6, 0.75, 0.95]
    crops = np.clip(crops + rng.normal(0, 0.003, crops.shape), 0, 1)
    for i, crop in enumerate(crops):
        Image.fromarray((crop * 255).astype(np.uint8)).save(
            os.path.join(ep, "perspective_look_at_center", f"{i + 1:03d}.png"))
    steps = rng.normal(size=(n, 6)) * np.array([0.3, 0.02, 0.3, 0.5, 6.0, 0.5]) + np.array([0, 0, 0.4, 0, 0, 0])
    with open(os.path.join(ep, "camera_poses_look_at_center.txt"), "w") as f:
        f.write("Frame,PosX,PosY,PosZ,RotX,RotY,RotZ\n")
        for i, row in enumerate(np.cumsum(steps, axis=0)):
            f.write(f"{i + 1}," + ",".join(f"{v:.6f}" for v in row) + "\n")
    return crops


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("reproject")
    jmodel = JVGGT(_j_config(TINY))
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros((1, 2, 14, 28, 3))), jax.random.key(0))
    params = _random_tree(shapes, seed=0)
    tmodel = VGGT(TINY)
    tmodel.load_state_dict(vggt_params_from_jax(params), strict=True)
    episode = str(root / "episode")
    crops = _write_episode(episode, seed=1)
    onnx = str(root / "skyseg.onnx")
    chip_smoke.sensitive_skyseg_onnx(onnx, crops[:1].astype(np.float32), torch.device("cpu"), seed=2)
    return dict(root=root, episode=episode, onnx=onnx,
                jrecon=j_make_reconstructor(jmodel, params, jnp.float32, offload_params=False, head_chunk=2),
                trecon=make_reconstructor(tmodel.eval(), torch.float32, head_chunk=2))


def _renders(ep):
    out = os.path.join(ep, "rendered_panorama_vggt_open3d")
    names = sorted(os.listdir(out))
    assert names == [f"{i:02d}.png" for i in range(TARGETS)]
    return np.stack([np.asarray(Image.open(os.path.join(out, n)), np.float32) / 255.0 for n in names])


def _flipped(a, b):
    return float((np.abs(a - b) > PIXEL_ATOL).any(-1).mean())


def _memoised_masks(monkeypatch):
    """The port's sky segmentation with its masks kept per crop stack: the
    free and the teacher-forced runs mask the same crops, and the second
    reads the first's masks instead of running the full-width net again on
    the CPU."""
    made, memo = reproject.sky_segmentation, {}

    def sky_segmentation(config, device):
        seg = made(config, device)
        compute = seg.sky_masks

        def sky_masks(images):
            key = images.numpy().tobytes()
            if key not in memo:
                memo[key] = compute(images)
            return memo[key]

        seg.sky_masks = sky_masks
        return seg

    monkeypatch.setattr(reproject, "sky_segmentation", sky_segmentation)


@pytest.mark.parametrize("sky", ["off", "heuristic", "u2net"])
def test_reproject_matches_jax(setup, sky, tmp_path, capsys, monkeypatch):
    _memoised_masks(monkeypatch)
    onnx = {"off": setup["onnx"], "heuristic": str(tmp_path / "absent.onnx"), "u2net": setup["onnx"]}[sky]
    argv = ARGS + [f"--data.mask_sky={sky != 'off'}", f"--runtime.skyseg_onnx={onnx}"]
    eps = {side: str(tmp_path / side) for side in ("jax", "port", "forced")}
    for ep in eps.values():
        shutil.copytree(setup["episode"], ep)

    jrec = _Recorder(setup["jrecon"])
    with jax.default_matmul_precision("highest"):
        j_reproject.process_episode(eps["jax"], jrec, j_parse_config(argv))
    trec = _Recorder(setup["trecon"])
    config = parse_config(argv)
    timings = {}
    assert reproject.process_episode(eps["port"], trec, config, "cpu", timings)
    assert set(timings) == {"reconstruct", "render"} | ({"sky_mask"} if sky != "off" else set())
    (want,), (got,) = jrec.preds, trec.preds
    for key in ("world_points", "conf", "extrinsic", "colors"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], **MODEL_TOL, err_msg=key)

    def forced(images):
        return {k: torch.tensor(v) for k, v in want.items()}

    assert reproject.process_episode(eps["forced"], forced, config, "cpu")
    theirs = _renders(eps["jax"])
    assert (theirs.sum(-1) > 0).mean() > 0.02, "the reference memory is empty: the test would prove nothing"
    assert _flipped(_renders(eps["forced"]), theirs) <= MAX_FLIPPED
    if sky != "off":  # the zeroed confidences move the percentile filter: the mask changes the memory
        unmasked = str(tmp_path / "unmasked")
        shutil.copytree(setup["episode"], unmasked)
        assert reproject.process_episode(unmasked, forced, parse_config(ARGS + ["--data.mask_sky=false"]), "cpu")
        assert _flipped(_renders(unmasked), theirs) > 0.01
    with capsys.disabled():
        print(f"\nreproject sky={sky}: free-run flipped share {_flipped(_renders(eps['port']), theirs):.4%}")


def test_main_selects_episodes_and_skips_what_is_done(setup, tmp_path, monkeypatch):
    """Three episodes; `start_idx` / `end_idx` pick the middle one, which is
    rendered once; the rerun skips it without building VGGT; the first
    episode, without crops, is skipped with a warning."""
    data = tmp_path / "data"
    os.makedirs(data / "ep_0" / "panorama")
    for name in ("ep_1", "ep_2"):
        shutil.copytree(setup["episode"], data / name)
    builds = []

    def build(*args, **kwargs):
        builds.append(args)
        return setup["trecon"]

    monkeypatch.setattr(reproject, "build_reconstructor", build)
    argv = ARGS + [f"--data.root={data}", "--data.mask_sky=false", "--runtime.vggt_tiny=true",
                   "--runtime.compute_dtype=float32"]
    records = reproject.main(argv + ["--data.start_idx=1", "--data.end_idx=2"], device="cpu")
    assert [(os.path.basename(r["episode"]), r["rendered"]) for r in records] == [("ep_1", True)]
    assert len(builds) == 1 and builds[0][0] == "tiny"
    assert not os.path.exists(data / "ep_2" / "rendered_panorama_vggt_open3d")
    out = data / "ep_1" / "rendered_panorama_vggt_open3d"
    mtimes = {n: os.path.getmtime(out / n) for n in os.listdir(out)}
    records = reproject.main(argv + ["--data.start_idx=1"], device="cpu")
    assert [(os.path.basename(r["episode"]), r["rendered"]) for r in records] == [("ep_1", False), ("ep_2", True)]
    assert mtimes == {n: os.path.getmtime(out / n) for n in os.listdir(out)}
    assert reproject.main(argv + ["--data.end_idx=2"], device="cpu") == [
        dict(episode=str(data / "ep_0"), rendered=False, stage_seconds={}),
        dict(episode=str(data / "ep_1"), rendered=False, stage_seconds={})]
    assert len(builds) == 2  # the second run rendered ep_2; the third built nothing
