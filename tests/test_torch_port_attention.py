"""Parity of the PyTorch port's attention with `evoworld_tpu`.

`flash_attention_plain` (the CPU counterpart of the Hopper kernel) is held
against the Pallas kernel `evoworld_tpu.ops.flash_attention.flash_attention`
run in interpret mode and against the plain `_xla_attention`, in fp32 at
matmul precision "highest", to 1e-5. The CUDA kernel's own tests are in
tests/test_torch_port_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.ops.attention import _xla_attention
from evoworld_tpu.ops.attention import multi_head_attention as j_mha
from evoworld_tpu.ops.flash_attention import flash_attention as j_flash
from evoworld_tpu_torch import runtime
from evoworld_tpu_torch.ops import attention as tattn
from evoworld_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_forward,
    flash_attention_plain,
    kernel_head_dim,
)
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b, sq, skv, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, d)).astype(np.float32) for s in (sq, skv, skv))


def _j(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return np.array(fn(*(jnp.asarray(a) for a in args), **kw))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize(
    "b,sq,skv,h,d,use_exp2",
    [
        (2, 200, 333, 2, 64, False),   # ragged: neither length divides the block
        (2, 200, 333, 2, 64, True),
        (1, 130, 260, 1, 512, False),  # the VAE's head dim
        (1, 130, 260, 1, 512, True),
        (1, 256, 256, 3, 128, False),
    ],
)
def test_plain_matches_pallas_kernel_and_xla(b, sq, skv, h, d, use_exp2):
    q, k, v = _qkv(b, sq, skv, h, d)
    want = _j(j_flash, q, k, v, block_q=128, block_k=128, interpret=True, use_exp2=use_exp2)
    ref = _j(_xla_attention, q, k, v, scale=1.0 / np.sqrt(d))
    got = flash_attention_plain(*_t(q, k, v), use_exp2=use_exp2).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("kv_len", [1, 100, 257])
def test_plain_kv_len_mask(kv_len):
    """Keys at or past kv_len are masked: the same as attending to k[:, :kv_len]."""
    q, k, v = _qkv(1, 64, 300, 2, 64, seed=1)
    want = _j(j_flash, q, k[:, :kv_len], v[:, :kv_len], block_q=128, block_k=128, interpret=True)
    got = flash_attention(*_t(q, k, v), kv_len=kv_len).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = _qkv(1, 50, 70, 2, 64, seed=2)
    before = flash_attention.launches
    got = flash_attention(*_t(q, k, v)).numpy()
    assert flash_attention.launches == before  # the count moves only on a kernel launch
    np.testing.assert_allclose(got, flash_attention_plain(*_t(q, k, v)).numpy(), rtol=0, atol=0)


@pytest.mark.parametrize(
    "sq,skv,impl",
    [(25, 25, "auto"), (257, 257, "auto"), (64, 1, "auto"), (40, 60, "auto"), (300, 300, "flash")],
)
def test_multi_head_attention_routes(sq, skv, impl):
    """auto on the CPU: the one-key broadcast shortcut, else plain attention;
    impl="flash" takes the flash wrapper. Each matches the JAX route."""
    q, k, v = _qkv(2, sq, skv, 3, 64, seed=3)
    if impl == "flash":  # the JAX flash route runs the Pallas kernel; interpret it on the CPU
        want = _j(j_flash, q, k, v, scale=1.0 / 8.0, interpret=True)
    else:
        want = _j(j_mha, q, k, v, impl=impl)
    got = tattn.multi_head_attention(*_t(q, k, v), impl=impl).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_long_sequence_on_cpu_stays_plain(monkeypatch):
    """The kernel route is for CUDA tensors only; CPU tensors of any length stay plain."""
    calls = []
    monkeypatch.setattr(tattn, "flash_attention", lambda *a, **kw: calls.append(1))
    q = torch.zeros(1, tattn.FLASH_MIN_SEQ, 1, 8)
    k = torch.zeros(1, 4, 1, 8)
    out = tattn.multi_head_attention(q, k, k)
    assert out.shape == q.shape and not calls


def test_unknown_impl_raises():
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError):
        tattn.multi_head_attention(q, q, q, impl="builtin")


@pytest.mark.parametrize("d,d_kernel", [(16, 64), (80, 128), (200, 512)])
def test_padded_head_dim_equals_the_unpadded_plain_route(d, d_kernel):
    """A head dim without a kernel is zero-padded to the next kernel's and the
    output sliced back (the scale stays the true D's): zero columns leave
    Q K^T and P V as they were. The same on the CPU, where the padded call
    runs the plain version."""
    assert kernel_head_dim(d) == d_kernel
    q, k, v = _t(*_qkv(2, 70, 90, 3, d, seed=4))
    got = flash_attention(q, k, v, kv_len=80)
    assert got.shape == q.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), flash_attention_plain(q, k, v, kv_len=80).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [16, 80, 200])
def test_padded_head_dim_backward_equals_the_unpadded_plain_route(d):
    q, k, v = _t(*_qkv(2, 70, 90, 3, d, seed=5))
    do = torch.from_numpy(np.random.default_rng(6).normal(size=q.shape).astype(np.float32))
    out, lse = flash_attention_forward(q, k, v, d ** -0.5, 80, with_lse=True)  # padded to 64 / 128 / 512
    np.testing.assert_allclose(out.numpy(), flash_attention_plain(q, k, v, kv_len=80).numpy(), rtol=1e-6, atol=1e-6)
    got = flash_attention_backward(q, k, v, out, do, lse, kv_len=80)
    want = flash_attention_backward_plain(q, k, v, out, do, lse, kv_len=80)
    for a, b, t in zip(got, want, (q, k, v), strict=True):
        assert a.shape == t.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("build", ["build_pipeline", "build_trainer", "build_reconstructor"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_build_refuses_non_bf16_on_cuda_before_anything(monkeypatch, build, dtype):
    """The Hopper kernels take bf16, fp16 and fp32: a CUDA build in fp32 or
    fp16 passes the dtype check and meets the missing card (the missing-CUDA
    RuntimeError), before any weight is drawn, as bf16 does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for drawing in ("init_random_", "make_random_pipeline", "random_model"):
        monkeypatch.setattr(runtime, drawing, lambda *a, **kw: pytest.fail("weights drawn"))
    runtime.check_compute_dtype("cuda", dtype)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(runtime, build)(compute_dtype=dtype, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):  # bf16 passes the check and meets the missing card
        getattr(runtime, build)(compute_dtype=torch.bfloat16, device="cuda")


@pytest.mark.parametrize("build", ["build_pipeline", "build_trainer", "build_reconstructor"])
def test_build_refuses_float64_on_cuda_before_anything(monkeypatch, build):
    """A dtype without kernels (float64) is refused by name, with ValueError,
    before the device is resolved (so with no card: not the missing-CUDA
    RuntimeError) and before any weight is drawn; the CPU takes it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for drawing in ("init_random_", "make_random_pipeline", "random_model"):
        monkeypatch.setattr(runtime, drawing, lambda *a, **kw: pytest.fail("weights drawn"))
    with pytest.raises(ValueError, match="float64"):
        runtime.check_compute_dtype("cuda", torch.float64)
    with pytest.raises(ValueError, match="float64"):
        getattr(runtime, build)(compute_dtype=torch.float64, device="cuda")
    runtime.check_compute_dtype("cpu", torch.float64)
