"""The port's training CLI (`evoworld_tpu_torch.cli.train`) on the CPU at the
tiny preset: its refusals against the JAX CLI's, a run with validation,
checkpointing and EMA then a resume, validation rendering with the EMA
parameters (those of the step-2 checkpoint, not its raw ones), the
validation GIF as PIL decodes it,
the validation scores against the JAX package's `batch_video_metrics` of
the same frames (1e-5), and validation leaving training untouched (the
checkpoint of a run that validates every step equals, bit for bit, one of a
run that never does).
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from evoworld_tpu.cli import train as jax_train
from evoworld_tpu.eval.metrics import batch_video_metrics as jax_batch_video_metrics
from evoworld_tpu_torch.cli import train
from evoworld_tpu_torch.data import native_io
from evoworld_tpu_torch.loop.navigator import Navigator
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

H, W, FRAMES, MEMORY = 64, 128, 6, 4
TINY = ["--runtime.model_preset=tiny", "--runtime.compute_dtype=float32", f"--pipeline.height={H}",
        f"--pipeline.width={W}", "--data.sequence_length=3", "--pipeline.num_frames=3", "--pipeline.decode_chunk=3",
        "--pipeline.num_steps=2", "--train.warmup_steps=1", "--trainer.log_steps=1",
        "--trainer.checkpointing_steps=2", "--trainer.use_ema=true", "--trainer.prefetch_depth=0"]


@pytest.fixture(scope="module")
def episode(tmp_path_factory):
    """A synthetic episode: smooth panoramas with a little noise, memory renders, a seeded camera walk."""
    root = tmp_path_factory.mktemp("case_train")
    rng = np.random.default_rng(0)
    os.makedirs(root / "panorama")
    os.makedirs(root / "rendered_panorama_vggt_open3d")
    coarse = torch.from_numpy(rng.random((FRAMES + MEMORY, 3, 4, 8), dtype=np.float32))
    fine = torch.nn.functional.interpolate(coarse, size=(H, W), mode="bicubic").permute(0, 2, 3, 1).numpy()
    frames = (np.clip(fine + 0.03 * rng.normal(size=fine.shape), 0, 1) * 255).astype(np.uint8)
    native_io.save_png_batch([str(root / "panorama" / f"{i:03d}.png") for i in range(1, FRAMES + 1)], frames[:FRAMES])
    native_io.save_png_batch([str(root / "rendered_panorama_vggt_open3d" / f"{i:02d}.png") for i in range(MEMORY)],
                             frames[FRAMES:])
    poses = np.cumsum(rng.normal(size=(FRAMES, 6)) * [0.05, 0, 0.05, 0, 3, 0] + [0, 0, 0.4, 0, 0, 0], axis=0)
    with open(root / "camera_poses.txt", "w") as f:
        f.write("Frame,PosX,PosY,PosZ,RotX,RotY,RotZ\n")
        for i, row in enumerate(poses):
            f.write(",".join([str(i + 1)] + [f"{x:.6f}" for x in row]) + "\n")
    return str(root)


@pytest.mark.parametrize("flag", ["--trainer.output_dir=elsewhere", "--trainer.max_steps=7"])
def test_refuses_derived_flags_as_the_jax_cli(flag):
    with pytest.raises(SystemExit) as ours:
        train.main([flag], device="cpu")
    with pytest.raises(SystemExit) as theirs:
        jax_train.main([flag])
    assert str(ours.value) == str(theirs.value) and "derived here" in str(ours.value)


@pytest.fixture(scope="module")
def run(episode, tmp_path_factory):
    """Two steps (checkpoint, validation at 2), then a resume to 3; the
    validation clip's frames and the UNet's trainable parameters as it
    renders captured from the navigator."""
    out = str(tmp_path_factory.mktemp("train_out"))
    clips, rendered_with = [], []

    class Capturing(Navigator):
        def generate_segment(self, *args, **kwargs):
            unet = self.pipeline.unet.unet  # the training UNet inside train.AutocastUNet
            rendered_with.append({n: p.detach().clone() for n, p in unet.named_parameters() if p.requires_grad})
            clips.append(super().generate_segment(*args, **kwargs))
            return clips[-1]

    argv = [f"--data.root={episode}", f"--runtime.save_dir={out}", "--trainer.validation_steps=2", *TINY]
    mp = pytest.MonkeyPatch()
    mp.setattr(train, "Navigator", Capturing)
    try:
        first = train.main(argv + ["--train.total_steps=2"], device="cpu")
        first_step = first.step
        resumed = train.main(argv + ["--train.total_steps=3"], device="cpu")
    finally:
        mp.undo()
    return dict(out=out, clips=clips, rendered_with=rendered_with, first_step=first_step, resumed=resumed,
                episode=episode)


def _gif_frames(path):
    im = Image.open(path)
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB"), np.float32) / 255.0)
    return im, np.stack(frames)


def test_trains_validates_and_resumes(run):
    out = run["out"]
    assert run["first_step"] == 2 and run["resumed"].step == 3
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["2.pt", "3.pt"]
    with open(os.path.join(out, "train_metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3]
    ckpt2 = torch.load(os.path.join(out, "checkpoints", "2.pt"), weights_only=True)
    ckpt3 = torch.load(os.path.join(out, "checkpoints", "3.pt"), weights_only=True)
    decay = 0.9999
    for name, ema in ckpt3["ema"].items():  # the resume carried the checkpoint's EMA one step on
        want = (ckpt2["ema"][name].float() * decay + ckpt3["params"][name].float() * (1 - decay)).to(ema.dtype)
        assert torch.equal(ema, want), name
    assert len(run["clips"]) == 1  # validation at step 2 only


def test_validation_renders_with_the_ema(run):
    """The UNet validated at step 2 held the EMA of the step-2 checkpoint in
    every trainable parameter, and so not the raw parameters saved beside it."""
    (rendered,) = run["rendered_with"]
    ckpt2 = torch.load(os.path.join(run["out"], "checkpoints", "2.pt"), weights_only=True)
    assert rendered and rendered.keys() <= ckpt2["ema"].keys()
    for name, p in rendered.items():
        assert torch.equal(p, ckpt2["ema"][name]), name
    assert any(not torch.equal(p, ckpt2["params"][name]) for name, p in rendered.items())


def test_validation_gif_decodes(run, tmp_path):
    """PIL reads the port's GIF: 3 frames of GT | generated, 100 ms, looping,
    within PIL's own GIF's error + 0.01 of the frames."""
    from evoworld_tpu_torch.utils.video import _to_uint8, side_by_side

    episode = run["episode"]
    frames = run["clips"][0].numpy()
    gt = native_io.load_image_batch([os.path.join(episode, "panorama", f"{i:03d}.png") for i in (4, 5, 6)], H, W,
                                    minus1_1=False)
    source = _to_uint8(side_by_side(gt, frames))
    im, decoded = _gif_frames(os.path.join(run["out"], "validation_000002.gif"))
    assert decoded.shape == (3, H, 2 * W, 3)
    assert im.info["duration"] == 100 and im.info["loop"] == 0
    pil_path = str(tmp_path / "pil.gif")
    pil = [Image.fromarray(f) for f in source]
    pil[0].save(pil_path, save_all=True, append_images=pil[1:], duration=100, loop=0)
    reference = source.astype(np.float32) / 255.0
    ours_err = np.abs(decoded - reference).mean()
    pil_err = np.abs(_gif_frames(pil_path)[1] - reference).mean()
    assert ours_err <= pil_err + 0.01, (ours_err, pil_err)


def test_validation_scores_match_jax_metrics(run):
    episode = run["episode"]
    frames = run["clips"][0].numpy()
    gt = native_io.load_image_batch([os.path.join(episode, "panorama", f"{i:03d}.png") for i in (4, 5, 6)], H, W,
                                    minus1_1=True)
    gt = np.clip(gt / 2 + 0.5, 0, 1)
    ref = jax_batch_video_metrics(frames[None], gt[None])
    with open(os.path.join(run["out"], "validation_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows[0]["step"] == 2 and rows[1] == {"step": 2, "artifact": "validation_gif",
                                                "path": os.path.join(run["out"], "validation_000002.gif")}
    np.testing.assert_allclose(rows[0]["val_psnr"], ref["psnr"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(rows[0]["val_ssim"], ref["ssim"], atol=1e-5, rtol=0)


def test_validation_leaves_training_untouched(episode, tmp_path):
    """A run that validates after every step ends with the same checkpoint,
    bit for bit, as one that never validates: masters, EMA, optimizer state."""
    ckpts = {}
    for every in (1, 1000):
        out = str(tmp_path / f"every_{every}")
        train.main([f"--data.root={episode}", f"--runtime.save_dir={out}", f"--trainer.validation_steps={every}",
                    "--train.total_steps=2", *TINY], device="cpu")
        ckpts[every] = torch.load(os.path.join(out, "checkpoints", "2.pt"), weights_only=True)
    assert os.path.exists(str(tmp_path / "every_1" / "validation_000001.gif"))
    a, b = ckpts[1], ckpts[1000]
    for part in ("params", "ema"):
        assert a[part].keys() == b[part].keys()
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part
    assert a["opt_state"]["param_groups"] == b["opt_state"]["param_groups"]
    for i, state in a["opt_state"]["state"].items():
        assert all(torch.equal(v, b["opt_state"]["state"][i][k]) for k, v in state.items())
