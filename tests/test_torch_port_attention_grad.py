"""Gradients of the PyTorch port's flash attention against `evoworld_tpu`.

`flash_attention_backward_plain` (the CPU counterpart of the Hopper backward
kernel, `csrc/flash_attn_bwd.cu`) is held against `jax.vjp` of the JAX
package's plain `_xla_attention`, in fp32 at matmul precision "highest", to
1e-5, with and without a key-length mask (dK and dV rows past `kv_len` are
zero). Under grad, `flash_attention` goes through `FlashAttentionFunction`
on every device, and its gradients match plain autograd through
`ops/attention.py::plain_attention`. The CUDA kernels' own tests are in
tests/test_torch_port_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.ops.attention import _xla_attention
from evoworld_tpu_torch.ops import attention as tattn
from evoworld_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_forward,
)
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = dict(rtol=1e-5, atol=1e-5)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in shapes)


@pytest.mark.parametrize("d", [64, 128, 512])
@pytest.mark.parametrize("kv_len", [None, 157, 129])  # 129: one key past the kernel's 128-key tile
def test_plain_backward_matches_jax_vjp(d, kv_len):
    b, sq, skv, h = 2, 130, 300, 2
    q, k, v, do = _arrays(d + (kv_len or 0), (b, sq, h, d), (b, skv, h, d), (b, skv, h, d), (b, sq, h, d))
    n = kv_len or skv
    scale = 1.0 / np.sqrt(d)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda q_, k_, v_: _xla_attention(q_, k_, v_, scale),
                         jnp.asarray(q), jnp.asarray(k[:, :n]), jnp.asarray(v[:, :n]))
        want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attention_forward(tq, tk, tv, scale, n, with_lse=True)
    dq, dk, dv = (g.numpy() for g in flash_attention_backward_plain(tq, tk, tv, out, tdo, lse, scale, n))
    np.testing.assert_allclose(dq, want[0], **TOL)
    np.testing.assert_allclose(dk[:, :n], want[1], **TOL)
    np.testing.assert_allclose(dv[:, :n], want[2], **TOL)
    assert not dk[:, n:].any() and not dv[:, n:].any()


@pytest.mark.parametrize("d,kv_len,use_exp2", [(64, None, False), (64, 90, True), (512, 120, False)])
def test_function_matches_plain_autograd(d, kv_len, use_exp2):
    """Under grad, out.grad_fn is the Function; gradients match autograd through plain attention."""
    q, k, v, do = _arrays(7, (1, 100, 2, d), (1, 150, 2, d), (1, 150, 2, d), (1, 100, 2, d))
    n = kv_len or 150
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = flash_attention.launches, flash_attention_backward.launches
    out = flash_attention(tq, tk, tv, kv_len=n, use_exp2=use_exp2)
    assert type(out.grad_fn) is FlashAttentionFunction._backward_cls
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert (flash_attention.launches, flash_attention_backward.launches) == before  # plain versions on the CPU
    ref = tattn.plain_attention(tq, tk[:, :n], tv[:, :n], 1.0 / np.sqrt(d))
    want = torch.autograd.grad(ref, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), **TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_no_grad_call_builds_no_graph():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _arrays(8, *[(1, 40, 1, 64)] * 3))
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    assert flash_attention(q.detach(), k.detach(), v.detach()).grad_fn is None


def test_flash_route_differentiates_through_the_function():
    """multi_head_attention(impl="flash") under grad runs the Function; its
    gradients match the plain route's (impl="auto" on the CPU)."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _arrays(9, *[(2, 64, 3, 64)] * 3))
    out = tattn.multi_head_attention(q, k, v, impl="flash")
    assert type(out.grad_fn) is FlashAttentionFunction._backward_cls
    got = torch.autograd.grad(out.pow(2).sum(), (q, k, v))
    want = torch.autograd.grad(tattn.multi_head_attention(q, k, v).pow(2).sum(), (q, k, v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
