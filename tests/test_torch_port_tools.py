"""The port's last single-card tools against `evoworld_tpu`: the parity gate
(`cli/validate_parity.py`), the PIL-exact BILINEAR resize behind its
`--parity.resize_reference`, the PLY / OBJ writers, `latent_mse`, the CLI
log line and the checkpoint artifacts.

Tolerances: the gate's helpers and the writers exactly (the same text, the
same exit code, the same bytes); the resize byte for byte against PIL;
PSNR within 1e-5 and LPIPS (nets made sensitive to the frames) within rtol
2e-3 / atol 5e-4, the metric nets' tolerance; `latent_mse` within 1e-6
relative. No test reaches the network: `push_to_hub` is called with
`huggingface_hub` made unimportable.
"""

import io
import json
import logging
import os
import sys
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from evoworld_tpu.cli import calculate_metrics as jmetrics_cli
from evoworld_tpu.cli import validate_parity as jvp
from evoworld_tpu.eval import harness as jh
from evoworld_tpu.eval import inception_v4 as ji4
from evoworld_tpu.memory import export as jexport
from evoworld_tpu.utils import artifacts as jartifacts
from evoworld_tpu.utils import logging as jlogging
from evoworld_tpu_torch.cli import calculate_metrics as tmetrics_cli
from evoworld_tpu_torch.cli import validate_parity as tvp
from evoworld_tpu_torch.eval import harness as th
from evoworld_tpu_torch.eval import inception_v4 as ti4
from evoworld_tpu_torch.memory import export as texport
from evoworld_tpu_torch.utils import artifacts as tartifacts
from evoworld_tpu_torch.utils import logging as tlogging
from tests.test_torch_port_cli import TINY_ARGS, episode  # noqa: F401  (fixture)
from tests.test_torch_port_eval import ATOL, RTOL
from tests.test_torch_port_eval_harness import metric_weights
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _write_pngs(directory, frames):
    os.makedirs(directory, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(directory, f"{i:03d}.png"))
    return str(directory)


# ---- the BILINEAR resize of --parity.resize_reference ---------------------------------------

@pytest.mark.parametrize("src_hw, dst_hw", [((1000, 2000), (576, 1024)), ((37, 53), (20, 31)),
                                             ((13, 17), (29, 41)), ((64, 128), (64, 100)),
                                             ((101, 99), (50, 99)), ((300, 200), (7, 5))])
def test_pil_bilinear_resize_is_byte_equal_to_pil(src_hw, dst_hw):
    """Down, up, one axis only and extreme reductions, on noise (every tap matters)."""
    img = np.random.default_rng(sum(src_hw)).integers(0, 256, (*src_hw, 3), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((dst_hw[1], dst_hw[0]), Image.BILINEAR))
    np.testing.assert_array_equal(tmetrics_cli.pil_bilinear_resize(img, dst_hw), ref)


def test_read_video_dir_resizes_as_the_jax_cli(tmp_path):
    """Frames of two sizes, one at the target: the JAX CLI's PIL route and the port agree exactly."""
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (45, 70, 3), dtype=np.uint8), rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)]
    path = _write_pngs(tmp_path / "ref", frames)
    ref = jmetrics_cli._read_video_dir(path, 2, size_hw=(32, 48))
    np.testing.assert_array_equal(tmetrics_cli.read_video_dir(path, 2, size_hw=(32, 48)), ref)


# ---- validate_parity's helpers ----------------------------------------------------------

def test_load_png_dir_matches_jax_and_refuses_a_size_mismatch(tmp_path):
    rng = np.random.default_rng(2)
    path = _write_pngs(tmp_path / "ref", rng.integers(0, 256, (3, 40, 56, 3), dtype=np.uint8))
    np.testing.assert_array_equal(tvp._load_png_dir(path, 2, (40, 56)), jvp._load_png_dir(path, 2, (40, 56)))
    with pytest.raises(SystemExit) as port:
        tvp._load_png_dir(path, 2, (32, 48))
    with pytest.raises(SystemExit) as ref:
        jvp._load_png_dir(path, 2, (32, 48))
    assert str(port.value) == str(ref.value) and "56x40" in str(port.value)
    np.testing.assert_array_equal(tvp._load_png_dir(path, 2, (32, 48), allow_resize=True),
                                  jvp._load_png_dir(path, 2, (32, 48), allow_resize=True))
    with pytest.raises(SystemExit, match="need 5 frames, found 3"):
        tvp._load_png_dir(path, 5, (40, 56))


def test_score_matches_jax():
    """PSNR and LPIPS of the same frames through both harnesses, the LPIPS net made sensitive to them."""
    rng = np.random.default_rng(3)
    gen = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    gt = np.clip(gen + 0.1 * rng.normal(size=gen.shape), 0, 1).astype(np.float32)
    weights = metric_weights(gen[None], gt[None], names=("lpips",))
    ref = jvp._score(gen, gt, jh.FeatureNets(weights), ("psnr", "lpips"))
    out = tvp._score(gen, gt, th.FeatureNets(weights, device="cpu"), ("psnr", "lpips"))
    assert out.keys() == ref.keys() and ref["lpips"] > 100 * ATOL
    np.testing.assert_allclose(out["psnr"], ref["psnr"], rtol=1e-5)
    np.testing.assert_allclose(out["lpips"], ref["lpips"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("content", [{"psnr": {"value_mean": 21.5}, "lpips": {"value_mean": 0.25}},
                                     {"psnr": {"value_mean": 21.5}}, {"psnr": 3.0, "lpips": {}}])
def test_reference_scores_from_json_matches_jax(tmp_path, capsys, content):
    """Scores read alike; a missing or misshapen entry is the same FAIL line and exit code 1."""
    path = tmp_path / "eval_score.json"
    path.write_text(json.dumps(content))
    results = []
    for mod in (tvp, jvp):
        try:
            results.append(("ok", mod._reference_scores_from_json(str(path), ("psnr", "lpips"))))
        except SystemExit as e:
            results.append(("exit", e.code, capsys.readouterr().out))
    assert results[0] == results[1]
    if results[0][0] == "exit":
        assert results[0][1] == 1 and results[0][2].startswith("PARITY GATE: FAIL (")


@pytest.mark.parametrize("ours, theirs", [({"psnr": 20.0, "lpips": 0.3}, {"psnr": 20.1, "lpips": 0.3}),
                                          ({"psnr": 20.0, "lpips": 0.3}, {"psnr": 20.5, "lpips": 0.2}),
                                          ({"psnr": 0.0, "lpips": 0.0}, {"psnr": 0.0, "lpips": 0.0})])
def test_gate_matches_jax(ours, theirs):
    lines = ([], [])
    failed = [mod._gate(ours, theirs, ("psnr", "lpips"), 0.01, "src", log=log.append)
              for mod, log in zip((tvp, jvp), lines)]
    assert failed[0] == failed[1] and lines[0] == lines[1]


def test_dry_run_passes_against_its_own_frames_and_fails_against_perturbed_ones(episode, tmp_path, capsys):  # noqa: F811
    """A tiny dry run gates against itself (PASS), against the frames it wrote
    (PASS, through `--parity.reference_frames`), and against those frames
    perturbed (FAIL, exit code 1, the JAX CLI's)."""
    out = tmp_path / "out"
    args = [f"--data.root={episode}", f"--runtime.save_dir={out}", "--parity.dry_run=true", "--parity.metrics=psnr",
            *TINY_ARGS]
    result = tvp.main(args, device="cpu")
    assert result["failed"] == [] and result["ours"] == result["theirs"]
    assert capsys.readouterr().out.strip().endswith(
        "PARITY GATE: PASS (psnr within 1.0%) (DRY RUN — random weights; re-run with real checkpoints)")
    pred = out / "validate_parity" / "predictions"
    assert len(os.listdir(pred)) == 5
    result = tvp.main(args + [f"--parity.reference_frames={pred}"], device="cpu")
    assert result["failed"] == [] and result["theirs"]["psnr"] != result["ours"]["psnr"]  # read back as 8-bit PNGs
    np.testing.assert_allclose(result["theirs"]["psnr"], result["ours"]["psnr"], rtol=1e-3)

    rng = np.random.default_rng(4)
    frames = np.stack([np.asarray(Image.open(pred / n)) for n in sorted(os.listdir(pred))])
    noisy = np.clip(frames.astype(np.int16) + rng.integers(-60, 61, frames.shape), 0, 255).astype(np.uint8)
    bad = _write_pngs(tmp_path / "perturbed", noisy)
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        tvp.main(args + [f"--parity.reference_frames={bad}"], device="cpu")
    assert e.value.code == 1
    assert capsys.readouterr().out.strip().startswith("PARITY GATE: FAIL (psnr outside 1.0%)")


# ---- export, latent MSE, logging, artifacts ---------------------------------------------

@pytest.mark.parametrize("color_dtype", [np.float32, np.float64])
def test_ply_and_obj_are_byte_equal_to_jax(tmp_path, color_dtype):
    """Float32 points (their text through an f-string is the widened Python
    float), colours clipped to [0, 1] with values past both ends, PLY
    colours truncated to uint8; a torch tensor input writes the same file."""
    rng = np.random.default_rng(5)
    pts = (rng.normal(size=(200, 3)) * [1e-6, 1.0, 3e4]).astype(np.float32)
    cols = rng.uniform(-0.2, 1.2, size=(200, 3)).astype(color_dtype)
    for name, jfn, tfn in (("c.ply", jexport.save_ply, texport.save_ply), ("c.obj", jexport.save_obj, texport.save_obj)):
        jfn(pts, cols, str(tmp_path / ("j" + name)))
        tfn(pts, cols, str(tmp_path / ("t" + name)))
        tfn(torch.from_numpy(pts), torch.from_numpy(cols), str(tmp_path / ("tt" + name)))
        ref = (tmp_path / ("j" + name)).read_bytes()
        assert (tmp_path / ("t" + name)).read_bytes() == ref
        assert (tmp_path / ("tt" + name)).read_bytes() == ref


def test_export_of_a_cloud_of_many_points_is_byte_equal_to_jax(tmp_path):
    """70,000 points (the size the tools phase's rehearsal writes): the JAX writers' PLY and OBJ bytes."""
    rng = np.random.default_rng(7)
    n = 70000
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    for name, jfn, tfn in (("c.ply", jexport.save_ply, texport.save_ply), ("c.obj", jexport.save_obj, texport.save_obj)):
        jfn(pts, cols, str(tmp_path / ("j" + name)))
        tfn(pts, cols, str(tmp_path / ("t" + name)))
        assert (tmp_path / ("t" + name)).read_bytes() == (tmp_path / ("j" + name)).read_bytes()


def test_latent_mse_matches_jax():
    rng = np.random.default_rng(6)
    a, b = (rng.normal(size=(4, 1536)).astype(np.float32) for _ in range(2))
    ref = float(ji4.latent_mse(a, b))
    out = ti4.latent_mse(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32 and ref > 1.0
    np.testing.assert_allclose(out.item(), ref, rtol=1e-6)


@pytest.mark.parametrize("level", [logging.DEBUG, logging.INFO, logging.WARNING, logging.ERROR, logging.CRITICAL, 5])
def test_colored_formatter_matches_jax(level):
    record = logging.LogRecord("evoworld", level, __file__, 1, "a message %d", (7,), None)
    fmt = "%(asctime)s - %(levelname)s - %(message)s"
    assert tlogging.ColoredFormatter(fmt).format(record) == jlogging.ColoredFormatter(fmt).format(record)


class _Tty(io.StringIO):
    def isatty(self):
        return True


@pytest.mark.parametrize("stream_cls", [io.StringIO, _Tty])
def test_cli_log_line_format(monkeypatch, stream_cls):
    """The CLIs' log line is the JAX logger's "<time> - <LEVEL> - <message>",
    in its level's colour on a terminal and plain elsewhere, and follows the
    current `sys.stderr`."""
    logger = tlogging.get_logger("evoworld_tpu_torch.test_tools")
    assert tlogging.get_logger("evoworld_tpu_torch.test_tools") is logger and len(logger.handlers) == 1
    stream = stream_cls()
    monkeypatch.setattr(sys, "stderr", stream)
    logger.warning("a warning line")
    line = stream.getvalue()
    body = line[len("\033[33m"):-len("\033[0m\n")] if stream_cls is _Tty else line[:-1]
    assert line.startswith("\033[33m") == (stream_cls is _Tty)
    assert body.endswith(" - WARNING - a warning line") and len(body.split(" - ")[0]) == 23  # asctime


def test_package_checkpoint_matches_jax(tmp_path):
    """The same MANIFEST.json and the same tar members (names, sizes, contents)."""
    trees = []
    for name in ("j", "t"):
        ckpt = tmp_path / name / "ckpt"
        os.makedirs(ckpt / "unet")
        (ckpt / "model.bin").write_bytes(bytes(range(256)) * 3)
        (ckpt / "unet" / "a.safetensors").write_bytes(b"\x01" * 1000)
        (ckpt / "unet" / "config.json").write_text('{"x": 1}')
        trees.append(ckpt)
    jartifacts.package_checkpoint(str(trees[0]), str(tmp_path / "j.tar.gz"), note="n")
    assert tartifacts.package_checkpoint(str(trees[1]), str(tmp_path / "t.tar.gz"), note="n") == str(tmp_path / "t.tar.gz")
    assert (trees[0] / "MANIFEST.json").read_bytes() == (trees[1] / "MANIFEST.json").read_bytes()
    members = []
    for name in ("j", "t"):
        with tarfile.open(tmp_path / f"{name}.tar.gz") as tar:
            members.append(sorted((m.name, m.size, tar.extractfile(m).read() if m.isfile() else None)
                                  for m in tar.getmembers()))
    assert members[0] == members[1] and any(m[0] == "ckpt/MANIFEST.json" for m in members[0])


def test_push_to_hub_raises_as_jax_without_huggingface_hub(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # import fails; nothing reaches the network
    errors = []
    for mod in (tartifacts, jartifacts):
        with pytest.raises(RuntimeError) as e:
            mod.push_to_hub(str(tmp_path), "org/repo")
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "package_checkpoint()" in errors[0]
