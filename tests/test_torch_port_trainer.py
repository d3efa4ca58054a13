"""The PyTorch port's trainer loop: EMA and resume on tiny models.

The port's twin of tests/test_trainer_loop.py: two steps (two micro-batches
each) with EMA and a checkpoint, then a resumed run to step 3 whose EMA
continues from the checkpoint's (not from the parameters), with the
optimizer's update count and the keep-limit carried across. `episode_batches` is held against the JAX
package's on the same fake dataset (Pluecker rays 1e-5).
"""

import types

import numpy as np
import pytest
import torch

from evoworld_tpu.train.trainer import episode_batches as j_episode_batches
from evoworld_tpu_torch.runtime import build_trainer
from evoworld_tpu_torch.train.train_step import TrainConfig
from evoworld_tpu_torch.train.trainer import CheckpointManager, TrainerConfig, episode_batches, train
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F, H, W = 3, 64, 128


class FakeDataset:
    height, width = H, W

    def __len__(self):
        return 2

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return types.SimpleNamespace(
            pixel_values=rng.uniform(-1, 1, (F, H, W, 3)).astype(np.float32),
            memory_values=rng.uniform(-1, 1, (F, H, W, 3)).astype(np.float32),
            cam_traj=rng.uniform(-1, 1, (F, 6)).astype(np.float32),
        )


def test_episode_batches_match_jax():
    got = next(episode_batches(FakeDataset(), 2, (H // 8, W // 8), seed=3))
    want = next(j_episode_batches(FakeDataset(), 2, (H // 8, W // 8), seed=3))
    for key in ("pixel_values", "memory_values", "plucker"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key], np.float32), rtol=1e-5, atol=1e-5)


def _run(tmp_path, max_steps, checkpointing_steps):
    unet, vae, clip = build_trainer("tiny", seed=0, compute_dtype=torch.float32, device="cpu")
    tcfg = TrainerConfig(output_dir=str(tmp_path), max_steps=max_steps, checkpointing_steps=checkpointing_steps,
                         log_steps=1, use_ema=True, ema_decay=0.5, gradient_accumulation_steps=2)
    state = train(unet, vae, clip, FakeDataset(), TrainConfig(total_steps=4, warmup_steps=1), tcfg,
                  compute_dtype=torch.float32)
    return state


def test_train_loop_ema_and_resume(tmp_path):
    state = _run(tmp_path, max_steps=2, checkpointing_steps=2)
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in state.unet.parameters())
    ckpts = CheckpointManager(str(tmp_path / "checkpoints"))
    assert ckpts.all_steps() == [2]
    first = torch.load(tmp_path / "checkpoints" / "2.pt", weights_only=True)
    # The returned UNet holds the EMA (swapped in for export); the checkpoint the raw params.
    for name, p in state.unet.state_dict().items():
        assert torch.equal(p, first["ema"][name])
    assert any(not torch.equal(first["ema"][n], first["params"][n]) for n in first["params"])

    state3 = _run(tmp_path, max_steps=3, checkpointing_steps=10)
    assert state3.step == 3
    assert ckpts.all_steps() == [2, 3]
    third = torch.load(tmp_path / "checkpoints" / "3.pt", weights_only=True)
    assert third["opt_state"]["param_groups"][0]["count"] == 3
    # Resumed EMA: step 3's is the mean of step 2's EMA and step 3's params (decay 0.5).
    for name, e in third["ema"].items():
        torch.testing.assert_close(e, 0.5 * first["ema"][name] + 0.5 * third["params"][name], rtol=1e-6, atol=1e-7)
    log = (tmp_path / "train_metrics.jsonl").read_text().splitlines()
    assert len(log) == 3  # one record per step over both runs

    _run(tmp_path, max_steps=4, checkpointing_steps=10)
    assert ckpts.all_steps() == [3, 4]  # keep-limit 2


def test_build_trainer_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_trainer("tiny")


def test_build_trainer_dtype_policy():
    unet, vae, clip = build_trainer("tiny", device="cpu", compute_dtype=torch.bfloat16)
    assert unet.config.remat
    assert {p.dtype for p in unet.parameters() if p.requires_grad} == {torch.float32}
    assert {p.dtype for p in unet.parameters() if not p.requires_grad} == {torch.bfloat16}
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for m in (vae, clip) for p in m.parameters())
