"""The data-preparation path's sky mask on the card against the CPU.

A full-width random U^2-Net made sensitive to four 384 x 512 crops
(`chip_smoke.sensitive_skyseg_onnx`, written as skyseg.onnx by the port's
ONNX writer) masks them on the card, with the caller's TF32 switched on,
and on the CPU; the net runs in fp32 under `eval.metrics.full_fp32` either
way, so the masks may differ only where a min-max normalized value floors
either way: on at most `chip_smoke.PREP_MASK_MAX_FLIPPED` of the pixels.
Each mask must cover part of its crop. The test carries the `cuda` marker
and skips without a card. The file imports no JAX:

    python -m pytest tests/test_torch_port_prep_card.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from evoworld_tpu_torch.memory.skyseg import SkySegmentation


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the test holds the card against the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sky_mask_on_the_card_matches_the_cpu(cuda, tmp_path):
    rng = np.random.default_rng(0)
    coarse = torch.from_numpy(rng.random((4, 3, 6, 8), dtype=np.float32))
    crops = torch.nn.functional.interpolate(coarse, size=(384, 512), mode="bicubic").clamp(0, 1).permute(0, 2, 3, 1)
    path = str(tmp_path / "skyseg.onnx")
    chip_smoke.sensitive_skyseg_onnx(path, crops.numpy(), cuda, seed=1)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        card = SkySegmentation(path, cuda).sky_masks(crops).cpu()
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    cpu = SkySegmentation(path, "cpu").sky_masks(crops)
    assert card.shape == cpu.shape == (4, 384, 512)
    for c in card:
        assert 0.02 < (c == 0).float().mean() < 0.98
    assert (card != cpu).float().mean() <= chip_smoke.PREP_MASK_MAX_FLIPPED
