"""The port's fp32 attention route (`csrc/flash_attn_fp32.cu` on the card)
off the card: the wrappers' checks on fp32 CPU tensors, and the fp32 route of
`multi_head_attention` and `FlashAttentionFunction` on the CPU (where the
wrappers run their plain versions) against the JAX package's `_xla_attention`
and `jax.vjp` of it, in fp32 at matmul precision "highest", to 1e-5, at the
kernels' three head dims with a key-length mask. The CUDA kernels' own tests
are in tests/test_torch_port_kernel.py (`fp32` cases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.ops.attention import _xla_attention
from evoworld_tpu_torch.ops import attention as tattn
from evoworld_tpu_torch.ops import flash_attention as fa
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = dict(rtol=1e-5, atol=1e-5)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in shapes)


def test_wrapper_checks_admit_fp32_and_refuse_the_rest_by_name():
    """The checks a CUDA call meets, on CPU tensors: fp32 passes, also as a
    view whose rows are a whole 16 bytes (4 elements) apart; float64, an
    fp32/bf16 mix and an fp32 view whose rows are 66 elements apart are each
    refused by name, and none of them launches anything."""
    q = torch.zeros((1, 64, 2, 68))[..., :64]  # rows 68 elements apart: a multiple of 4
    fa._check(q, q, q, 64)
    lse = torch.zeros((1, 2, 64))
    fa._check(q, q, q, 64, grads={"o": q, "do": q, "lse": lse})
    before = (fa.flash_attention.launches, fa.flash_attention_backward.launches)
    with pytest.raises(ValueError, match="float64"):
        fa._check(q.double(), q.double(), q.double(), 64)
    with pytest.raises(ValueError, match="bfloat16 and q torch.float32"):
        fa._check(q, q.bfloat16(), q, 64)
    with pytest.raises(ValueError, match="do is torch.bfloat16"):
        fa._check(q, q, q, 64, grads={"o": q, "do": q.bfloat16(), "lse": lse})
    loose = torch.zeros((1, 64, 2, 66))[..., :64]
    with pytest.raises(ValueError, match=r"q \(torch.float32\) strides .* multiples of 4 elements"):
        fa._check(loose, q, q, 64)
    assert fa._aligned(q) and not fa._aligned(loose)
    assert (fa.flash_attention.launches, fa.flash_attention_backward.launches) == before


@pytest.mark.parametrize("d", [64, 128, 512])
def test_fp32_multi_head_attention_matches_xla(d):
    """`multi_head_attention(impl="flash")` and `flash_attention` with a
    key-length mask, in fp32, against `_xla_attention` over the kept keys."""
    b, sq, skv, h, kv_len = 2, 130, 200, 2, 157
    q, k, v = _arrays(d, (b, sq, h, d), (b, skv, h, d), (b, skv, h, d))
    scale = 1.0 / np.sqrt(d)
    with jax.default_matmul_precision("highest"):
        full = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
        kept = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k[:, :kv_len]), jnp.asarray(v[:, :kv_len]),
                                         scale))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn.multi_head_attention(tq, tk, tv, impl="flash")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), full, **TOL)
    np.testing.assert_allclose(fa.flash_attention(tq, tk, tv, kv_len=kv_len).numpy(), kept, **TOL)


@pytest.mark.parametrize("d", [64, 128, 512])
def test_fp32_function_gradients_match_jax_vjp(d):
    """Under grad, fp32 `flash_attention` goes through
    `FlashAttentionFunction`; its output and dQ, dK, dV match `jax.vjp` of
    `_xla_attention` over the kept keys, and dK, dV rows past `kv_len` are
    zero."""
    b, sq, skv, h, kv_len = 1, 100, 180, 2, 129
    q, k, v, do = _arrays(d + 1, (b, sq, h, d), (b, skv, h, d), (b, skv, h, d), (b, sq, h, d))
    scale = 1.0 / np.sqrt(d)
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(lambda q_, k_, v_: _xla_attention(q_, k_, v_, scale),
                           jnp.asarray(q), jnp.asarray(k[:, :kv_len]), jnp.asarray(v[:, :kv_len]))
        want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, kv_len=kv_len)
    assert type(got.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(tq.grad.numpy(), want[0], **TOL)
    np.testing.assert_allclose(tk.grad[:, :kv_len].numpy(), want[1], **TOL)
    np.testing.assert_allclose(tv.grad[:, :kv_len].numpy(), want[2], **TOL)
    assert not tk.grad[:, kv_len:].any() and not tv.grad[:, kv_len:].any()
