"""The evaluation metrics on the card, with the caller's TF32 switched on.

The harness keeps its own precision whatever the caller set: on the card,
with `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` on, SSIM must match the CPU within 1e-5
(its variance terms cancel), LPIPS and the latent MSE of nets made sensitive
to the frames (`chip_smoke.sensitive_metric_weights`) within
`chip_smoke.EVAL_FEATURE_RTOL`, and the flags must come back as they were.
The tests carry the `cuda` marker and skip without a card. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_eval_card.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from evoworld_tpu_torch.eval import harness
from evoworld_tpu_torch.eval.metrics import batch_video_metrics


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the test holds the card against the CPU")
    return torch.device("cuda")


def _frames(n: int, noise: float):
    """(n, 576, 1024, 3) smooth [0, 1] frames and a noisy copy."""
    rng = np.random.default_rng(0)
    coarse = torch.from_numpy(rng.random((n, 3, 9, 16), dtype=np.float32))
    gt = torch.nn.functional.interpolate(coarse, size=(576, 1024), mode="bicubic").clamp(0, 1).permute(0, 2, 3, 1)
    gen = (gt + noise * torch.from_numpy(rng.normal(size=gt.shape).astype(np.float32))).clamp(0, 1)
    return gen, gt


def _with_tf32(fn):
    """fn() with the caller's TF32 flags on; they must come back on."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        out = fn()
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return out


@pytest.mark.cuda
def test_ssim_with_tf32_on_matches_the_cpu(cuda):
    gen, gt = _frames(4, 0.02)
    ref = batch_video_metrics(gen[None], gt[None])
    out = _with_tf32(lambda: batch_video_metrics(gen[None].to(cuda), gt[None].to(cuda)))
    np.testing.assert_allclose(out["ssim_per_frame"], ref["ssim_per_frame"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["psnr_per_frame"], ref["psnr_per_frame"], atol=1e-5, rtol=2e-6)


@pytest.mark.cuda
def test_feature_metrics_with_tf32_on_match_the_cpu(cuda):
    """LPIPS, the latent MSE and FVD of 2 videos of 10 frames, the nets made
    sensitive to them: the card with TF32 on against the CPU. Without the
    harness's fp32 guard, FVD and the latent MSE miss by ~1e-3 (PERF.md)."""
    gen, gt = (v.reshape(2, 10, 576, 1024, 3).numpy() for v in _frames(20, 0.1))
    weights = chip_smoke.sensitive_metric_weights(gen, gt, cuda)
    nets = harness.FeatureNets(weights, device=cuda)
    cpu_nets = harness.FeatureNets(weights, device="cpu")
    for metric in (harness.calculate_lpips, harness.calculate_latent_mse, harness.calculate_fvd_batch):
        out = _with_tf32(lambda: metric(gen, gt, nets))
        ref = metric(gen, gt, cpu_nets)
        assert min(abs(v) for v in ref["value"].values()) > chip_smoke.EVAL_FEATURE_FLOOR, ref["value"]
        for t, v in ref["value"].items():
            assert abs(out["value"][t] - v) <= chip_smoke.EVAL_FEATURE_RTOL * abs(v), (metric.__name__, t, out, ref)
