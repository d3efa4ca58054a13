"""The port's production CLIs and what they stand on, against `evoworld_tpu`.

- Config tree: every section and field of the JAX package's tree with the
  same default, and `apply_overrides` giving the same values on the same argv.
- Image IO (`data/native_io.py`, `csrc/imageio.cpp`): a PNG at the target
  size decodes to exactly the floats of the JAX package's PIL route
  (`data/dataset.py::_load_image`) for every colour type PIL writes; a
  resize gives exactly what `native/imageio.cpp`, built from the repository's
  file with g++ into the test's directory, gives (skipped where libpng's
  header is missing); the PNG writer round-trips; a JPEG decodes to PIL's
  bytes and one the decoder does not take (CMYK) is refused by name
  (`tests/test_torch_port_imageio.py` holds the JPEG decoder in full).
- `EpisodeDataset` equals the JAX package's on a synthetic episode, in both
  memory samplings, exactly, and on an episode of `.jpg` frames.
- `AsyncFrameWriter`'s repairs: the first error is the one raised, it is
  raised once (no self-chained traceback), float64 frames are scaled in
  float32, and a writer never closed warns. The log follows `sys.stderr`.
- Both CLIs on a tiny synthetic episode (tiny presets, fp32, 64x128, 5
  frames, 2 steps, 2 segments, `device="cpu"`) write exactly the PNGs of the
  port's own `Navigator.generate_segment` / `UnifiedLoop.run_episode` given
  the same generator and the same uint8 conversion. (The JAX CLIs draw from
  jax.random, so their frames cannot be compared bit for bit; the parts
  under the CLIs are held against JAX in the other test_torch_port files.)
"""

import ctypes
import dataclasses
import gc
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

from evoworld_tpu import config as jconfig
from evoworld_tpu.data import dataset as jdataset
from evoworld_tpu_torch import config as tconfig
from evoworld_tpu_torch.cli import common, run_single_segment, run_unified
from evoworld_tpu_torch.data import native_io
from evoworld_tpu_torch.data.dataset import EpisodeDataset, load_camera_poses
from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
from evoworld_tpu_torch.loop.navigator import Navigator, calculate_segment_indices
from evoworld_tpu_torch.loop.unified import LoopConfig, UnifiedLoop
from evoworld_tpu_torch.runtime import build_pipeline, build_reconstructor
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

H, W, FRAMES, MEMORY = 64, 128, 13, 4
SEED = 42  # runtime.seed's default
TINY_ARGS = ["--runtime.model_preset=tiny", "--runtime.vggt_tiny=true", "--runtime.compute_dtype=float32",
             f"--pipeline.height={H}", f"--pipeline.width={W}", "--pipeline.num_frames=5", "--pipeline.num_steps=2",
             "--loop.num_frames=5", "--loop.num_target_view=4", "--loop.num_segments=2", "--loop.pers_height=16",
             "--loop.pers_width=512", "--data.sequence_length=5"]


def _png_stack(directory):
    names = sorted(os.listdir(directory))
    return names, np.stack([np.asarray(Image.open(os.path.join(directory, n)).convert("RGB")) for n in names])


@pytest.fixture(scope="module")
def episode(tmp_path_factory):
    """A synthetic episode at the target size: panoramas, memory renders and a seeded camera walk."""
    root = tmp_path_factory.mktemp("case_000")
    rng = np.random.default_rng(0)
    os.makedirs(root / "panorama")
    os.makedirs(root / "rendered_panorama_vggt_open3d")
    native_io.save_png_batch([str(root / "panorama" / f"{i:03d}.png") for i in range(1, FRAMES + 1)],
                             rng.integers(0, 256, (FRAMES, H, W, 3), dtype=np.uint8))
    native_io.save_png_batch([str(root / "rendered_panorama_vggt_open3d" / f"{i:02d}.png") for i in range(MEMORY)],
                             rng.integers(0, 256, (MEMORY, H, W, 3), dtype=np.uint8))
    poses = np.cumsum(rng.normal(size=(FRAMES, 6)) * [0.05, 0, 0.05, 0, 3, 0] + [0, 0, 0.4, 0, 0, 0], axis=0)
    with open(root / "camera_poses.txt", "w") as f:
        f.write("Frame,PosX,PosY,PosZ,RotX,RotY,RotZ\n")
        for i, row in enumerate(poses):
            f.write(",".join([str(i + 1)] + [f"{x:.6f}" for x in row]) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def jpg_episode(tmp_path_factory, episode):
    """The same episode with its panoramas and memory renders as JPEGs at the
    target size (4:2:0, quality 90): `_resolve` falls back to each `.jpg`."""
    root = tmp_path_factory.mktemp("case_jpg")
    for sub in ("panorama", "rendered_panorama_vggt_open3d"):
        os.makedirs(root / sub)
        for name in sorted(os.listdir(os.path.join(episode, sub))):
            img = Image.open(os.path.join(episode, sub, name)).filter(ImageFilter.GaussianBlur(2))
            img.save(root / sub / name.replace(".png", ".jpg"), quality=90)
    shutil.copy(os.path.join(episode, "camera_poses.txt"), root / "camera_poses.txt")
    return str(root)


def test_config_tree_matches_jax():
    """Every section, field and default, but `data.root`: the JAX tree's
    default names a directory of the machine it was written on, the port's
    is empty (a run names its data)."""
    got, want = dataclasses.asdict(tconfig.EvoWorldConfig()), dataclasses.asdict(jconfig.EvoWorldConfig())
    assert got["data"].pop("root") == "" and want["data"].pop("root")
    assert got == want


@pytest.mark.parametrize("argv", [
    ["--runtime.seed=7", "--data.root", "/data/ep", "--runtime.vggt_tiny=yes", "--pipeline.num_steps=25"],
    ["--loop.conf_percentile=40.5", "--runtime.checkpoint_dir=/ckpt", "--data.single_episode=false", "--data.root=x",
     "--trainer.use_ema=1", "--train.lr_schedule=constant"],
])
def test_apply_overrides_matches_jax(argv):
    got = tconfig.apply_overrides(tconfig.EvoWorldConfig(), argv)
    want = jconfig.apply_overrides(jconfig.EvoWorldConfig(), argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for bad in (["--nosection=1"], ["--runtime.nofield=1"], ["positional"]):
        with pytest.raises(SystemExit):
            tconfig.apply_overrides(tconfig.EvoWorldConfig(), bad)


@pytest.mark.parametrize("cli", [run_single_segment, run_unified])
def test_cli_refuses_non_bf16_on_cuda_before_reading(cli, tmp_path, capsys, monkeypatch):
    """Before any file is read (the data root does not exist): a compute
    dtype the CLIs do not name (float64) is refused by name, and fp32 on
    CUDA, which the card's kernels now take as they take bf16 and fp16,
    passes the runtime's dtype check and meets the missing card; `--help`
    prints the defaults and exits 0."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = f"--data.root={tmp_path / 'missing'}"
    with pytest.raises(SystemExit, match="float64"):
        cli.main(["--runtime.compute_dtype=float64", missing], device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--runtime.compute_dtype=float32", missing], device="cuda")
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["--help"], device="cpu")
    assert exit_info.value.code == 0 and '"compute_dtype": "bfloat16"' in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1"])
def test_decode_at_target_size_matches_jax_pil_route(tmp_path, mode):
    """PIL writes each colour type with its adaptive row filters; both routes
    read the same floats (grey replicated, alpha dropped, palettes looked up)."""
    rng = np.random.default_rng(1)
    rgb = Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    img = rgb.quantize(64) if mode == "P" else rgb.convert(mode)
    path = str(tmp_path / f"{mode}.png")
    img.save(path)
    want = jdataset._load_image(path, H, W)
    got = native_io.load_image_batch([path], H, W)[0]
    np.testing.assert_array_equal(got, want)


def test_resize_matches_native_imageio(tmp_path):
    """Down- and upsampling, [-1, 1] and [0, 1]: bit for bit the JAX package's
    native loader, built here from native/imageio.cpp with its Makefile's flags."""
    lib_path = tmp_path / "libevoworld_io.so"
    src = os.path.join(os.path.dirname(__file__), "..", "native", "imageio.cpp")
    build = subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", src, "-o", str(lib_path), "-shared", "-lpng",
                            "-ljpeg", "-lpthread"], capture_output=True, text=True)
    if build.returncode != 0 and ("png.h" in build.stderr or "jpeglib.h" in build.stderr):
        pytest.skip("libpng or libjpeg headers missing: native/imageio.cpp cannot be built here")
    assert build.returncode == 0, build.stderr
    lib = ctypes.CDLL(str(lib_path))
    lib.ev_load_image.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int]
    path = str(tmp_path / "src.png")
    native_io.save_png_batch([path], np.random.default_rng(2).integers(0, 256, (1, 37, 53, 3), dtype=np.uint8))
    for th, tw in ((20, 31), (70, 90), (37, 90)):
        for minus1_1 in (True, False):
            want = np.empty((th, tw, 3), np.float32)
            assert lib.ev_load_image(path.encode(), want.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), th, tw,
                                     int(minus1_1)) == 0
            np.testing.assert_array_equal(native_io.load_image_batch([path], th, tw, minus1_1)[0], want)
    del lib
    gc.collect()


def test_png_writer_round_trips_and_jpeg_is_refused(tmp_path, episode):
    """PNGs written and read back; a JPEG beside them decodes to PIL's bytes
    (the loader took none before the JPEG decoder), while a JPEG the decoder
    does not take (CMYK) and a missing file are refused by name."""
    frames = np.random.default_rng(3).integers(0, 256, (3, 9, 17, 3), dtype=np.uint8)
    paths = [str(tmp_path / f"{i}.png") for i in range(3)]
    native_io.save_png_batch(paths, frames)
    np.testing.assert_array_equal(np.stack([np.asarray(Image.open(p)) for p in paths]), frames)
    back = native_io.load_image_batch(paths, 9, 17, minus1_1=False)
    np.testing.assert_array_equal(back, frames.astype(np.float32) / 255.0)
    jpg = str(tmp_path / "frame.jpg")
    Image.fromarray(frames[0]).save(jpg)
    both = native_io.load_image_batch([paths[0], jpg], 9, 17, minus1_1=False)
    np.testing.assert_array_equal(both[1], np.asarray(Image.open(jpg).convert("RGB")).astype(np.float32) / 255.0)
    cmyk = str(tmp_path / "ink.jpg")
    Image.fromarray(np.zeros((9, 17, 4), np.uint8), "CMYK").save(cmyk)
    with pytest.raises(IOError, match="ink.jpg is a JPEG with neither 1 nor 3 components"):
        native_io.load_image_batch([paths[0], cmyk], 9, 17)
    with pytest.raises(IOError, match="cannot be read"):
        native_io.load_image_batch([str(tmp_path / "missing.png")], 9, 17)


@pytest.mark.parametrize("sampling,complete,frames", [
    pytest.param("reprojection", False, "png", id="reprojection-False"),
    pytest.param("empty_with_traj", True, "png", id="empty_with_traj-True"),
    pytest.param("reprojection", False, "jpg", id="reprojection-False-jpg"),
])
def test_episode_dataset_matches_jax(episode, jpg_episode, sampling, complete, frames, tmp_path):
    """The validation window (last `sequence_length` frames) with the memory
    renders after the first GT frame, or the whole episode with zero memory;
    positions scaled by pos_scale. A `memory_path` holding the renders under
    the episode's name reads the same. With `.jpg` frames and renders both
    packages fall back to them, and the port decodes libjpeg's bytes."""
    episode = jpg_episode if frames == "jpg" else episode
    kw = dict(height=H, width=W, sequence_length=5, sampling=sampling, pos_scale=0.25,
              load_complete_episode=complete, single_episode=True)
    got, want = EpisodeDataset(episode, **kw)[0], jdataset.EpisodeDataset(episode, **kw)[0]
    for field in ("pixel_values", "cam_traj", "memory_values", "memory_traj", "episode_path"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.pixel_values.shape[0] == (FRAMES if complete else 5)
    assert got.memory_values.shape[0] == (FRAMES if complete else MEMORY + 1)
    np.testing.assert_array_equal(load_camera_poses(os.path.join(episode, "camera_poses.txt")),
                                  jdataset.load_camera_poses(os.path.join(episode, "camera_poses.txt")))
    if sampling == "reprojection":
        os.symlink(episode, tmp_path / "episode_0")
        moved = EpisodeDataset(str(tmp_path), **{**kw, "single_episode": False}, memory_path=str(tmp_path))
        assert moved.episodes == ["episode_0"]
        np.testing.assert_array_equal(moved[0].memory_values, got.memory_values)


def test_jpg_fallback_is_refused_by_name(tmp_path):
    """The `.jpg` fallback of a missing `.png` is read as the JAX package
    reads it; a CMYK one is refused by name, never skipped."""
    os.makedirs(tmp_path / "panorama")
    gradient = np.linspace(0, 255, H * W * 3).reshape(H, W, 3).astype(np.uint8)
    Image.fromarray(gradient).save(tmp_path / "panorama" / "001.jpg", quality=85)
    (tmp_path / "camera_poses.txt").write_text("Frame,PosX,PosY,PosZ,RotX,RotY,RotZ\n1,0,0,0,0,0,0\n")
    kw = dict(height=H, width=W, sampling="empty_with_traj", load_complete_episode=True, single_episode=True)
    got = EpisodeDataset(str(tmp_path), **kw)[0].pixel_values
    np.testing.assert_array_equal(got, jdataset.EpisodeDataset(str(tmp_path), **kw)[0].pixel_values)
    Image.fromarray(np.zeros((H, W, 4), np.uint8), "CMYK").save(tmp_path / "panorama" / "001.jpg")
    with pytest.raises(IOError, match="001.jpg is a JPEG with neither 1 nor 3 components"):
        EpisodeDataset(str(tmp_path), **kw)[0]


def test_writer_raises_the_first_error_once(tmp_path):
    """Two failing jobs: close() raises the first (the directory under a file),
    not the second (a bad frame shape). Raised by submit, it is not raised
    again by the context manager's close (no self-chained traceback)."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(NotADirectoryError) as first:
        with common.AsyncFrameWriter(max_pending=4) as writer:
            writer.submit(np.zeros((1, 4, 4, 3)), str(blocker / "sub"))
            writer.submit(np.zeros((1, 4, 4, 2)), str(tmp_path / "ok"))
            writer._q.join()
    assert first.value.__context__ is None
    with pytest.raises(NotADirectoryError) as once:
        with common.AsyncFrameWriter() as writer:
            writer.submit(np.zeros((1, 4, 4, 3)), str(blocker / "sub"))
            writer._q.join()
            writer.submit(np.zeros((1, 4, 4, 3)), str(tmp_path / "late"))
    assert once.value.__context__ is None and not os.path.exists(tmp_path / "late")


def test_writer_scales_in_float32(tmp_path):
    """float64 frames are multiplied by 255 in float32 (as the JAX package
    does): values whose float64 product falls just under an integer truncate
    one step higher than a float64 product would."""
    values = (np.arange(256) / 255.0).astype(np.float64)
    frames = np.broadcast_to(values[None, :, None, None], (1, 256, 1, 3)).copy()
    with common.AsyncFrameWriter() as writer:
        writer.submit(frames, str(tmp_path))
    got = np.asarray(Image.open(tmp_path / "000.png"))[:, 0, 0]
    want = np.clip(values.astype(np.float32) * np.float32(255.0), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert writer.busy_s > 0


def test_unclosed_writer_warns():
    writer = common.AsyncFrameWriter()
    with pytest.warns(ResourceWarning, match="never closed"):
        writer._finalizer()
    writer.close()
    closed = common.AsyncFrameWriter()
    closed.close()
    assert not closed._finalizer.alive


def test_cli_log_follows_the_current_stderr(monkeypatch):
    """The CLIs' log lines go to whatever `sys.stderr` is when they are
    logged, not to the stream of the first `parse_config`: under a test
    runner's capture that stream is closed by the next test, and every line
    logged to it after raised "I/O operation on closed file" inside logging."""
    import io
    import sys

    common.parse_config([])
    for _ in range(2):
        stream = io.StringIO()
        monkeypatch.setattr(sys, "stderr", stream)
        common.logger.info("a line for this stream")
        assert stream.getvalue().endswith("a line for this stream\n")
        stream.close()


def _pipeline():
    return build_pipeline(PipelineConfig(height=H, width=W, num_frames=5, num_steps=2), "tiny", seed=SEED,
                          compute_dtype=torch.float32, device="cpu")


def test_run_single_segment_writes_the_navigators_frames(episode, tmp_path):
    records = run_single_segment.main([f"--data.root={episode}", f"--runtime.save_dir={tmp_path}", *TINY_ARGS],
                                      device="cpu")
    sample = EpisodeDataset(episode, H, W, sequence_length=5, sampling="reprojection", single_episode=True)[0]
    frames = Navigator(_pipeline(), num_frames=5).generate_segment(
        sample.cam_traj, torch.from_numpy(sample.pixel_values[0]), torch.from_numpy(sample.memory_values[:5]),
        use_memory=True, generator=torch.Generator().manual_seed(SEED))
    out = records[0]["out_dir"]
    names, got = _png_stack(os.path.join(out, "predictions"))
    assert names == [f"{i:03d}.png" for i in range(5)]
    np.testing.assert_array_equal(got, common.to_uint8(frames))
    np.testing.assert_array_equal(_png_stack(os.path.join(out, "predictions_gt"))[1],
                                  common.to_uint8(common.frames_from_minus1_1(sample.pixel_values)))


def test_run_unified_writes_the_loops_frames(episode, tmp_path):
    records = run_unified.main([f"--data.root={episode}", f"--runtime.save_dir={tmp_path}", *TINY_ARGS],
                               device="cpu")
    sample = EpisodeDataset(episode, H, W, sampling="empty_with_traj", load_complete_episode=True,
                            single_episode=True)[0]
    loop = UnifiedLoop(Navigator(_pipeline(), num_frames=5),
                       build_reconstructor("tiny", seed=SEED, compute_dtype=torch.float32, device="cpu"),
                       LoopConfig(num_frames=5, num_target_view=4, num_segments=2, pers_height=16, pers_width=512))
    out = loop.run_episode(torch.from_numpy(sample.pixel_values[0]), sample.cam_traj,
                           load_camera_poses(os.path.join(episode, "camera_poses.txt")),
                           draws=torch.Generator().manual_seed(SEED))
    ep_dir = records[0]["out_dir"]
    for seg, frames in enumerate(out["segments"]):
        names, got = _png_stack(os.path.join(ep_dir, f"predictions_{seg}"))
        assert names == [f"{seg * 4 + i:03d}.png" for i in range(len(frames))]
        np.testing.assert_array_equal(got, common.to_uint8(frames))
        start, end, _ = calculate_segment_indices(seg, 4)
        gt = sample.pixel_values[start - 1 : end - 1][1:] if seg else sample.pixel_values[0:end]
        np.testing.assert_array_equal(_png_stack(os.path.join(ep_dir, f"predictions_gt_{seg}"))[1],
                                      common.to_uint8(common.frames_from_minus1_1(gt)))
    names, got = _png_stack(os.path.join(ep_dir, "rendered_panorama_0"))
    assert names == [f"{i:02d}.png" for i in range(4)]
    np.testing.assert_array_equal(got, common.to_uint8(out["memories"][0]))
    stages = records[0]["stage_seconds"]
    assert {"generate_s0", "reconstruct_s0", "splat_render_s0", "generate_s1"} <= set(stages)
    assert records[0]["writer_busy_s"] > 0
