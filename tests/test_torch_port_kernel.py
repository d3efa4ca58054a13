"""The port's Hopper flash-attention kernels (forward and backward) on the card.

Held against `flash_attention_plain` and `flash_attention_backward_plain`
(fp32 on the same bf16, fp16 or fp32 inputs: every test runs in each of the
kernels' element types, at the true head dim where the wrapper pads it) with the limits `chip_smoke.py` uses: the error over the RMS of the plain output at
most 0.1 (max) and 0.01 (mean) in bf16 and fp16, and fp32's own limits,
FP32_MAX_REL_ERR and FP32_MEAN_REL_ERR, for the kernels of
`csrc/flash_attn_fp32.cu` (six bf16 wgmma products over a three-part split
of each fp32 operand; the plain version in full fp32: torch's default
of no TF32 in matmuls). Keys and values past `kv_len` are set so
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
FP32_MAX_REL_ERR, FP32_MEAN_REL_ERR = 2e-4, 1e-5  # chip_smoke.py's
FP32_LSE_ATOL = 1e-4  # chip_smoke.py's
DTYPES = [pytest.param(torch.bfloat16, id="bf16"), pytest.param(torch.float16, id="fp16"),
          pytest.param(torch.float32, id="fp32")]
# The backward's kernels by element type, as named in a profiler trace.
FP32_BWD = ("flash_fp32_bwd_delta", "flash_fp32_bwd_dkdv", "flash_fp32_bwd_dq")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the flash kernel has no CPU mode")
    return torch.device("cuda")


def _rel_errors(out, ref):
    err = (out.float() - ref).abs()
    rms = ref.pow(2).mean().sqrt()
    return (err.max() / rms).item(), (err.mean() / rms).item()


def _limits(dtype):
    """(max, mean) error over the plain output's RMS that `dtype`'s kernels keep to."""
    return (FP32_MAX_REL_ERR, FP32_MEAN_REL_ERR) if dtype == torch.float32 else (MAX_REL_ERR, MEAN_REL_ERR)


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
     (4, 2048, 2048, 2048, 4, 64, False),
     # edges of the D = 512 kernel (64 queries a block, 64 keys a tile): a
     # single query; 3 query tiles, the last one ragged, with kv_len one key
     # past two tiles and two heads; kv_len under one tile; kv_len a whole tile
     (1, 1, 300, 300, 1, 512, False), (2, 130, 200, 129, 2, 512, True), (1, 64, 100, 50, 2, 512, False),
     (2, 200, 128, 64, 1, 512, False),
     # 3 x 2 x 37 blocks: more than one wave of 132 SMs
     (3, 2340, 2340, 2340, 2, 512, False),
     # head dims without a kernel of their own, zero-padded to 64 and 128
     (2, 300, 333, 333, 2, 16, False), (1, 200, 177, 150, 2, 80, True),
     # VGGT's global attention at the loop's two rebuilds: 25 and 49 frames x 1041 tokens
     # (51009 = 398 x 128 + 65: the last query and key tiles are ragged), and
     # at reproject's 73 source frames of a 97-frame episode (75993 = 593 x 128 + 89)
     (1, 26025, 26025, 26025, 16, 64, False), (1, 51009, 51009, 51009, 16, 64, False),
     (1, 75993, 75993, 75993, 16, 64, False)],
)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_card(cuda, dtype, b, sq, skv, kv_len, h, d, use_exp2):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=cuda).to(dtype) for s in (sq, skv, skv))
    k[:, kv_len:], v[:, kv_len:] = 10.0, 100.0
    out = flash_attention(q, k, v, kv_len=kv_len, use_exp2=use_exp2)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q.float(), k.float(), v.float(), kv_len=kv_len, use_exp2=use_exp2)
    max_rel, mean_rel = _rel_errors(out, ref)
    max_lim, mean_lim = _limits(dtype)
    assert max_rel <= max_lim and mean_rel <= mean_lim


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 512])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_reads_strided_views_and_rejects_bad_inputs(cuda, dtype, d):
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((1, 500, 3, 4, d), generator=g, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)  # strided views of one packed tensor
    ref = flash_attention_plain(q.float(), k.float(), v.float())
    max_rel, mean_rel = _rel_errors(flash_attention(q, k, v), ref)
    max_lim, mean_lim = _limits(dtype)
    assert max_rel <= max_lim and mean_rel <= mean_lim
    before = flash_attention.launches
    with pytest.raises(ValueError, match="float64"):
        flash_attention(q.double(), k.double(), v.double())  # the kernels take bf16, fp16 or fp32
    other = torch.float16 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match="one element type"):
        flash_attention(q, k.to(other), v)  # a mix of the two types is refused by name
    with pytest.raises(ValueError, match="one element type"):
        flash_attention_backward(q, k, v, q, q.to(other), torch.zeros((1, 4, 500), device=cuda), kv_len=500)
    loose = torch.zeros((1, 64, 2, d + 2), device=cuda).to(dtype)[..., :d]  # rows not a whole 16 bytes apart
    with pytest.raises(ValueError, match="strides"):
        flash_attention(loose, loose, loose)
    assert flash_attention.launches == before
    wide = torch.zeros((1, 64, 1, 520), device=cuda).to(dtype)
    with pytest.raises(ValueError):
        flash_attention(wide, wide, wide)  # head dim 520: no kernel holds it


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 512])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_twice_is_bit_identical_on_card(cuda, dtype, d):
    """The forward sums in a fixed order (no atomics, no reductions across
    blocks), so a second call on the same inputs repeats the output bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((2, 1041, 2, d), generator=g, device=cuda).to(dtype) for _ in range(3))
    first = flash_attention(q, k, v, kv_len=1000)
    second = flash_attention(q, k, v, kv_len=1000)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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
     (4, 1024, 2048, 2048, 4, 64),  # 16 x 4 x 4 blocks: more than one wave of 132 SMs
     (1, 300, 333, 300, 2, 16),     # head dim 16, zero-padded to the D = 64 kernel
     # the D = 128 fused pass (K and V read from shared memory, dQ split by
     # columns between the two consumers)
     (2, 200, 400, 250, 2, 128),    # kv_len < Skv inside the second key tile, Skv inside the fourth
     (1, 65, 256, 256, 2, 128),     # one query past a tile
     (1, 1, 130, 130, 2, 128),      # a single query
     (1, 300, 333, 300, 2, 80),     # head dim 80, zero-padded to the D = 128 pass
     # the D = 512 sweeps (64-key blocks of the dV and dK sweeps, 64-query
     # blocks of the dQ sweep; streamed tiles of 64 queries in the dV sweep,
     # of 32 queries in the dK sweep and of 32 keys in the dQ sweep)
     (1, 1, 300, 300, 1, 512),      # a single query: one 64-query and one 32-query tile, mostly padding
     (1, 200, 300, 129, 2, 512),    # one key past a 64-key block, and past four 32-key tiles
     (2, 200, 400, 250, 1, 512),    # kv_len < Skv; the last key blocks all padding
     (2, 1100, 1100, 1100, 2, 512),  # 18 x 2 x 2 blocks a sweep: more than one wave of 132 SMs
     (1, 97, 97, 65, 1, 512),       # Sq one past three 32-query tiles, kv_len one past two 32-key tiles
     (1, 150, 150, 150, 1, 200)],   # head dim 200, zero-padded to the D = 512 sweeps
)
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_kernel_matches_plain_on_card(cuda, dtype, b, sq, skv, kv_len, h, d):
    """dQ, dK, dV on strided views (q a head-major transpose, k and v halves of
    one packed tensor), with keys past `kv_len` that must get zero rows.

    With a single query dK and dV are one row of P times dO: their largest
    entries are many times their RMS, so there, beside the RMS-relative limits,
    each entry is allowed two bf16 steps of its own size (P and the output are
    each rounded to bf16, 2^-8 of the value at most, on both sides); in fp32,
    whose kernels split each operand into two TF32 parts (about 21 bits),
    2^-18 of its size.
    """
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((b, h, sq, d), generator=g, device=cuda).to(dtype).transpose(1, 2)
    k, v = torch.randn((b, skv, 2, h, d), generator=g, device=cuda).to(dtype).unbind(2)
    k[:, kv_len:], v[:, kv_len:] = 10.0, 100.0
    out, lse = flash_attention_forward(q, k, v, d ** -0.5, kv_len, with_lse=True)
    do = torch.randn(out.shape, generator=g, device=cuda).to(dtype)
    before = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, out, do, lse, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == before + 1
    ref = flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(), do.float(), lse,
                                         kv_len=kv_len)
    max_lim, mean_lim = _limits(dtype)
    step = 2.0 ** -18 if dtype == torch.float32 else 2.0 ** -6
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        err, rms = (a.float() - r).abs(), r.pow(2).mean().sqrt()
        assert bool((err <= max_lim * rms + (step * r.abs() if sq == 1 else 0.0)).all()), name
        assert (err.mean() / rms).item() <= mean_lim, name
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


def _backward_inputs(cuda, dtype, seed, b, sq, skv, kv_len, h, d=64):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((b, skv, h, d), generator=g, device=cuda).to(dtype) for _ in range(2))
    k[:, kv_len:], v[:, kv_len:] = 10.0, 100.0
    out, lse = flash_attention_forward(q, k, v, d ** -0.5, kv_len, with_lse=True)
    do = torch.randn(out.shape, generator=g, device=cuda).to(dtype)
    return q, k, v, out, do, lse


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 512])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_backward_twice_repeats_on_card(cuda, dtype, d):
    """Two calls on the same inputs: dK and dV are equal bit for bit. The
    fused pass (D = 64, 128) sums dQ across key tiles with global fp32
    reductions in no fixed order, which can move a sum across a bf16
    rounding boundary: one bf16 step (2^-7 of the value), beside 1e-4 of
    dQ's RMS for sums that nearly cancel; a dQ buffer that was not zeroed
    would double dQ in the second call. The D = 512 sweeps and the fp32
    kernels sum nothing across blocks, so there dQ repeats bit for bit too."""
    q, k, v, out, do, lse = _backward_inputs(cuda, dtype, 6, 2, 1000, 1100, 1041, 4, d)
    first = flash_attention_backward(q, k, v, out, do, lse, kv_len=1041)
    second = flash_attention_backward(q, k, v, out, do, lse, kv_len=1041)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    if d == 512 or dtype == torch.float32:
        assert torch.equal(first[0], second[0])
    dq = first[0].float()
    gap = (second[0].float() - dq).abs()
    assert bool((gap <= 2.0 ** -7 * dq.abs() + 1e-4 * dq.pow(2).mean().sqrt()).all())


_WIDE = ("flash_bwd_wide_dv", "flash_bwd_wide_dk", "flash_bwd_wide_dq")
_PAIR = ("flash_bwd_dkdv", "flash_bwd_dq")  # the mma.sync pair the D = 512 sweeps replaced


@pytest.mark.cuda
@pytest.mark.parametrize("d,design,others", [
    (64, ("flash_bwd_fused", "flash_bwd_delta", "flash_bwd_store_dq"), _WIDE + _PAIR),
    (128, ("flash_bwd_fused", "flash_bwd_delta", "flash_bwd_store_dq"), _WIDE + _PAIR),
    (512, _WIDE + ("flash_bwd_delta",), ("flash_bwd_fused", "flash_bwd_store_dq") + _PAIR),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_trace_names_its_design_on_card(cuda, dtype, d, design, others):
    """A profiler trace of one backward call holds its head dim's kernels and
    none of the other designs': the fused pass at D = 64 and 128, the three
    wgmma sweeps at D = 512, never the mma.sync pair they replaced. Every
    flash kernel in it is the instantiation of the inputs' element type. In
    fp32 the trace holds the three fp32 kernels at every head dim, and no
    other flash kernel."""
    from torch.profiler import ProfilerActivity, profile

    if dtype == torch.float32:
        design, others = FP32_BWD, design + others

    q, k, v, out, do, lse = _backward_inputs(cuda, dtype, 7, 1, 300, 300, 300, 2, d)
    flash_attention_backward(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention_backward(q, k, v, out, do, lse)
        torch.cuda.synchronize()
    keys = [ev.key for ev in prof.key_averages()]
    names = " ".join(keys)
    assert all(n in names for n in design), names
    assert not any(n in names for n in others), names
    flash = [key for key in keys if "flash_" in key]
    if dtype == torch.float32:
        assert flash and all("flash_fp32_" in key for key in flash), flash
        return
    want, other = ("__half", "__nv_bfloat16") if dtype == torch.float16 else ("__nv_bfloat16", "__half")
    assert flash and all(want in key and other not in key for key in flash), flash


@pytest.mark.cuda
@pytest.mark.parametrize("use_exp2,d", [(False, 64), (True, 64), (False, 128), (False, 512), (True, 512)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_kernel_log_sum_exp_on_card(cuda, dtype, use_exp2, d):
    """The row log-sum-exp of both forward kernels (flash_fwd_wide's at D = 512,
    whose 200 queries end inside a 64-row block) against torch's, within 1e-3;
    the fp32 kernel's within FP32_LSE_ATOL (torch's own fp32 logsumexp sits
    1.3e-5 from it at D = 512)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((2, s, 2, d), generator=g, device=cuda).to(dtype) for s in (200, 300, 300))
    _, lse = flash_attention_forward(q, k, v, 0.125, 250, use_exp2, with_lse=True)
    want = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q.float(), k[:, :250].float()) * 0.125, dim=-1)
    limit = FP32_LSE_ATOL if dtype == torch.float32 else 1e-3
    assert lse.shape == (2, 2, 200) and (lse - want).abs().max().item() < limit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_function_uses_the_backward_kernel_and_d512_raises(cuda, dtype):
    """A gradient through `flash_attention` launches the backward kernel once
    at D = 64 and at D = 512; what raises is a head dim past every kernel's
    (520), before any launch."""
    g = torch.Generator(device=cuda).manual_seed(4)
    for d in (64, 512):
        q, k, v = (torch.randn((1, 300, 2, d), generator=g, device=cuda).to(dtype).requires_grad_()
                   for _ in range(3))
        before = flash_attention_backward.launches
        out = flash_attention(q, k, v)
        out.float().pow(2).sum().backward()
        assert flash_attention_backward.launches == before + 1
        assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
    big = torch.randn((1, 64, 1, 520), device=cuda).to(dtype).requires_grad_()
    before = flash_attention_backward.launches
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(big, big, big)
    assert flash_attention_backward.launches == before
