"""The arithmetic of the fp32 forward kernel (`csrc/flash_attn_fp32.cu`:
every fp32 operand split into three bf16 planes, six bf16 products a product)
on the CPU, before any card run: `flash_attention_split_plain`, which
computes attention the way the kernel does, against the JAX package's own
routes for the same function in fp32, `_xla_attention` under matmul
precision "highest" and the Pallas `flash_attention` in interpret mode at a
length that no block divides, under the limits `chip_smoke.py` holds the
fp32 kernels to: 2e-4 (max) and 1e-5 (mean) of the reference output's RMS.
With one plane (plain bf16 products) the same function fails them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.ops.attention import _xla_attention
from evoworld_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from evoworld_tpu_torch.ops import flash_attention as fa
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

FP32_MAX_REL_ERR, FP32_MEAN_REL_ERR = 2e-4, 1e-5  # chip_smoke.py's
B, S, H, KV_LEN = 1, 300, 2, 261  # 300 = 2 x 128 + 44 and 261 = 4 x 64 + 5: no block or tile divides either


def _rel_errors(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    err = np.abs(got.astype(np.float64) - want)
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    return float(err.max() / rms), float(err.mean() / rms)


def _within(errs: tuple[float, float]) -> bool:
    return errs[0] <= FP32_MAX_REL_ERR and errs[1] <= FP32_MEAN_REL_ERR


@pytest.fixture(scope="module", params=[64, 512], ids=["d64", "d512"])
def case(request):
    """Inputs from a seed, the split function's output in 3 and 1 planes, and
    the two JAX references over the kept keys."""
    d = request.param
    rng = np.random.default_rng(d)
    q, k, v = (rng.normal(size=(B, S, H, d)).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = {parts: fa.flash_attention_split_plain(tq, tk, tv, scale, KV_LEN, parts=parts).numpy() for parts in (3, 1)}
    kq, kk, kv = (jnp.asarray(a) for a in (q, k[:, :KV_LEN], v[:, :KV_LEN]))
    with jax.default_matmul_precision("highest"):
        xla = np.asarray(_xla_attention(kq, kk, kv, scale))
        pallas = np.asarray(jax_flash_attention(kq, kk, kv, scale, block_q=128, block_k=128, interpret=True))
    return got, {"xla": xla, "pallas": pallas}


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_three_planes_keep_to_fp32_limits(case, route):
    """Six bf16 products a product land within fp32's limits of each JAX route."""
    got, refs = case
    errs = _rel_errors(got[3], refs[route])
    assert _within(errs), errs


def test_one_plane_fails_fp32_limits(case):
    """Plain bf16 products (one plane) miss fp32's limits against `_xla_attention`:
    the limits tell the split from a single bf16 pass."""
    got, refs = case
    errs = _rel_errors(got[1], refs["xla"])
    assert not _within(errs), errs


def test_split_planes_are_bf16_and_sum_back():
    """hi, mid and lo are bf16 values, each at most 2^-8 of the one before,
    and their sum is the fp32 input within 2^-24 of its magnitude (the dropped
    remainder), on values spread over many binades."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.uniform(-6, 6, size=4096)).astype(np.float32))
    planes = fa._split_planes(x, 3)
    for p in planes:
        assert torch.equal(p, p.to(torch.bfloat16).float())
    for big, small in zip(planes, planes[1:]):
        assert bool((small.abs() <= big.abs() * 2.0 ** -8).all())
    total = planes[0].double() + planes[1].double() + planes[2].double()
    assert bool(((total - x.double()).abs() <= x.double().abs() * 2.0 ** -24).all())
