"""The port's Hopper flash-attention kernels (forward and backward) on the card.

Held against `flash_attention_plain` and `flash_attention_backward_plain`
(fp32 on the same bf16 inputs) with the limits `chip_smoke.py` uses: the error over the RMS of the plain output at
most 0.1 (max) and 0.01 (mean). Keys and values past `kv_len` are set so
large (K = 10, V = 100) that a missed mask would swamp the output. Every test
carries the `cuda` marker and skips without a card. The file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_kernel.py --noconftest -q
"""

import pytest
import torch

from evoworld_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_forward,
    flash_attention_plain,
)

MAX_REL_ERR, MEAN_REL_ERR = 0.1, 0.01


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the flash kernel has no CPU mode")
    return torch.device("cuda")


def _rel_errors(out, ref):
    err = (out.float() - ref).abs()
    rms = ref.pow(2).mean().sqrt()
    return (err.max() / rms).item(), (err.mean() / rms).item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,skv,kv_len,h,d,use_exp2",
    [(2, 300, 333, 333, 2, 64, False), (1, 1041, 1041, 1041, 16, 64, True), (1, 200, 177, 177, 1, 512, False),
     (2, 130, 130, 130, 2, 128, True), (2, 300, 500, 200, 2, 64, False), (1, 200, 400, 150, 1, 512, True),
     (2, 130, 300, 77, 2, 128, False),
     # key-tile edges of the wgmma kernel (128 keys a tile): kv_len a whole
     # tile, one key past it, under half a tile
     (2, 300, 400, 128, 2, 64, False), (2, 200, 400, 129, 2, 128, True), (1, 130, 300, 50, 3, 64, False),
     # VGGT's ragged length, keys padded to 5632
     (1, 5205, 5632, 5205, 16, 64, False),
     # 4 x 4 x 16 blocks of 128 queries: more than one wave of 132 SMs
     (4, 2048, 2048, 2048, 4, 64, False)],
)
def test_kernel_matches_plain_on_card(cuda, b, sq, skv, kv_len, h, d, use_exp2):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=cuda).bfloat16() for s in (sq, skv, skv))
    k[:, kv_len:], v[:, kv_len:] = 10.0, 100.0
    out = flash_attention(q, k, v, kv_len=kv_len, use_exp2=use_exp2)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q.float(), k.float(), v.float(), kv_len=kv_len, use_exp2=use_exp2)
    max_rel, mean_rel = _rel_errors(out, ref)
    assert max_rel <= MAX_REL_ERR and mean_rel <= MEAN_REL_ERR


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_reads_strided_views_and_rejects_bad_inputs(cuda, d):
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((1, 500, 3, 4, d), generator=g, device=cuda).bfloat16()
    q, k, v = qkv.unbind(2)  # strided views of one packed tensor
    ref = flash_attention_plain(q.float(), k.float(), v.float())
    max_rel, mean_rel = _rel_errors(flash_attention(q, k, v), ref)
    assert max_rel <= MAX_REL_ERR and mean_rel <= MEAN_REL_ERR
    with pytest.raises(ValueError):
        flash_attention(q.float(), k.float(), v.float())  # fp32: the kernel takes bf16 only
    with pytest.raises(ValueError):
        flash_attention(q[..., :48], k[..., :48], v[..., :48])  # head dim 48


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,skv,kv_len,h,d",
    [(2, 300, 333, 333, 2, 64), (1, 1041, 1041, 1041, 4, 64), (2, 300, 500, 200, 2, 64),
     (2, 130, 300, 77, 2, 128), (1, 257, 257, 257, 3, 128),
     # tile edges of the D = 64 fused pass (128 keys a block, 64 queries a tile)
     (1, 200, 128, 128, 2, 64),     # kv_len a whole 128-key tile
     (1, 200, 300, 129, 2, 64),     # one key past a tile; the third key tile is all padding
     (2, 64, 130, 50, 3, 64),       # under half a key tile; Sq a whole 64-query tile
     (1, 65, 256, 256, 2, 64),      # one query past a tile
     (1, 1, 130, 130, 2, 64),       # a single query
     (2, 200, 400, 250, 2, 64),     # kv_len < Skv inside the second key tile, Skv inside the fourth
     (4, 1024, 2048, 2048, 4, 64)],  # 16 x 4 x 4 blocks: more than one wave of 132 SMs
)
def test_backward_kernel_matches_plain_on_card(cuda, b, sq, skv, kv_len, h, d):
    """dQ, dK, dV on strided views (q a head-major transpose, k and v halves of
    one packed tensor), with keys past `kv_len` that must get zero rows.

    With a single query dK and dV are one row of P times dO: their largest
    entries are many times their RMS, so there, beside the RMS-relative limits,
    each entry is allowed two bf16 steps of its own size (P and the output are
    each rounded to bf16, 2^-8 of the value at most, on both sides).
    """
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((b, h, sq, d), generator=g, device=cuda).bfloat16().transpose(1, 2)
    k, v = torch.randn((b, skv, 2, h, d), generator=g, device=cuda).bfloat16().unbind(2)
    k[:, kv_len:], v[:, kv_len:] = 10.0, 100.0
    out, lse = flash_attention_forward(q, k, v, d ** -0.5, kv_len, with_lse=True)
    do = torch.randn(out.shape, generator=g, device=cuda).bfloat16()
    before = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, out, do, lse, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == before + 1
    ref = flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(), do.float(), lse,
                                         kv_len=kv_len)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        err, rms = (a.float() - r).abs(), r.pow(2).mean().sqrt()
        assert bool((err <= MAX_REL_ERR * rms + (2.0 ** -6 * r.abs() if sq == 1 else 0.0)).all()), name
        assert (err.mean() / rms).item() <= MEAN_REL_ERR, name
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


def _backward_inputs(cuda, seed, b, sq, skv, kv_len, h, d=64):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((b, skv, h, d), generator=g, device=cuda).bfloat16() for _ in range(2))
    k[:, kv_len:], v[:, kv_len:] = 10.0, 100.0
    out, lse = flash_attention_forward(q, k, v, d ** -0.5, kv_len, with_lse=True)
    do = torch.randn(out.shape, generator=g, device=cuda).bfloat16()
    return q, k, v, out, do, lse


@pytest.mark.cuda
def test_fused_backward_twice_repeats_on_card(cuda):
    """Two calls on the same inputs: dK and dV are equal bit for bit. dQ is
    summed across key tiles with global fp32 reductions in no fixed order,
    which can move a sum across a bf16 rounding boundary: one bf16 step (2^-7
    of the value), beside 1e-4 of dQ's RMS for sums that nearly cancel. A dQ
    buffer that was not zeroed would double dQ in the second call."""
    q, k, v, out, do, lse = _backward_inputs(cuda, 6, 2, 1000, 1100, 1041, 4)
    first = flash_attention_backward(q, k, v, out, do, lse, kv_len=1041)
    second = flash_attention_backward(q, k, v, out, do, lse, kv_len=1041)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    dq = first[0].float()
    gap = (second[0].float() - dq).abs()
    assert bool((gap <= 2.0 ** -7 * dq.abs() + 1e-4 * dq.pow(2).mean().sqrt()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("use_exp2,d", [(False, 64), (True, 64), (False, 128)])
def test_forward_kernel_log_sum_exp_on_card(cuda, use_exp2, d):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((2, s, 2, d), generator=g, device=cuda).bfloat16() for s in (200, 300, 300))
    _, lse = flash_attention_forward(q, k, v, 0.125, 250, use_exp2, with_lse=True)
    want = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q.float(), k[:, :250].float()) * 0.125, dim=-1)
    assert lse.shape == (2, 2, 200) and (lse - want).abs().max().item() < 1e-3


@pytest.mark.cuda
def test_autograd_function_uses_the_backward_kernel_and_d512_raises(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn((1, 300, 2, 64), generator=g, device=cuda).bfloat16().requires_grad_() for _ in range(3))
    before = flash_attention_backward.launches
    out = flash_attention(q, k, v)
    out.float().pow(2).sum().backward()
    assert flash_attention_backward.launches == before + 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
    big = torch.randn((1, 64, 1, 512), device=cuda).bfloat16().requires_grad_()
    with pytest.raises(RuntimeError, match="backward"):
        flash_attention(big, big, big)
