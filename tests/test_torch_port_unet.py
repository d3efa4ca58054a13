"""Parity of the PyTorch port's spatio-temporal UNet with `evoworld_tpu`.

A tiny-width UNet (the configs of tests/test_models.py) with Flax weights
carried across by `params_from_jax`; fp32 on both sides, JAX at matmul
precision "highest". Kept apart from tests/test_torch_port_models.py so each
file stays near a minute on the CPU.
"""

import numpy as np
import torch

from evoworld_tpu.models.unet import UNetConfig as JUNetCfg
from evoworld_tpu.models.unet import UNetSpatioTemporal as JUNet
from evoworld_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporal
from tests.test_torch_port_models import ATOL, RTOL, _jax_init, _japply, _port, _rand
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TINY_UNET = dict(block_out_channels=(32, 64, 128, 128), num_attention_heads=(2, 4, 8, 8))


def test_unet():
    rng = np.random.default_rng(6)
    b, f, h, w = 2, 3, 16, 24
    sample = _rand(rng, b, f, h, w, 18)
    ctx = _rand(rng, b, 1, 1024)
    time_ids = np.asarray([[6.0, 127.0, 0.02]] * b, np.float32)
    t = np.float32(1.3)
    jm = JUNet(JUNetCfg(**TINY_UNET))
    params = _jax_init(jm, sample, t, ctx, time_ids, perturb=0.02)
    want = _japply(jm, params, sample, t, ctx, time_ids)
    tm = _port(UNetSpatioTemporal(UNetConfig(**TINY_UNET)), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(sample.transpose(0, 1, 4, 2, 3).copy()), torch.tensor(t),
                 torch.from_numpy(ctx), torch.from_numpy(time_ids))
    got = got.numpy().transpose(0, 1, 3, 4, 2)
    assert got.shape == (b, f, h, w, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
