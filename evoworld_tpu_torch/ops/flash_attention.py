"""Flash attention and its gradient: the hand-written Hopper kernels and their plain versions.

Counterpart of two TPU kernels that compute the same function, exact
non-causal softmax(Q K^T * scale) V over (B, S, H, D):
  - `evoworld_tpu/ops/attention.py::_builtin_flash` (JAX's shipped Pallas TPU
    kernel, the production route for sequences of 4096 tokens or more), whose
    custom_vjp runs two backward Pallas kernels (dK/dV and dQ);
  - `evoworld_tpu/ops/flash_attention.py::flash_attention` / `_flash_kernel`
    (the package's own streaming kernel with a `kv_len` mask and `use_exp2`;
    it has no backward).

`flash_attention` is differentiable on every device. When a gradient is
needed it goes through `FlashAttentionFunction`, which saves q, k, v, the
output and its per-row log-sum-exp; its backward is `flash_attention_backward`.
For CUDA tensors the forward launches `csrc/flash_attn_fwd.cu` and the
backward `csrc/flash_attn_bwd.cu`; tensors on the CPU take
`flash_attention_plain` and `flash_attention_backward_plain`. On a CUDA tensor
each wrapper launches its kernel or raises; it never falls back.

Both directions are bound by bf16 tensor-core operations at the paths' 9216
tokens, with one exp2 per score beside them. Which head dim takes which kernel:
  - forward, D = 64 and 128: `flash_fwd_wgmma` (wgmma, a TMA ring of K and V
    tiles, a producer warpgroup and two consumers); D = 512: `flash_fwd_split`
    (mma.sync, the warps split D);
  - backward, D = 64 (every attention with a gradient on the port's paths):
    `flash_bwd_fused`, one pass per 128-key tile whose two consumer
    warpgroups keep their K and V fragments and their dK and dV sums in
    registers, stream query tiles through a TMA ring, do the five products
    with wgmma and exp2 once, and add the tile's part of dQ into a zeroed
    fp32 buffer with asynchronous bulk reductions, between `flash_bwd_delta`
    (rowsum(dO * O) and the log-sum-exp in the exp2 domain) and
    `flash_bwd_store_dq` (scale, to bf16). The order of those fp32 sums is
    not fixed, so dQ may differ in its last bf16 bit between two calls; dK
    and dV are repeatable;
  - backward, D = 128 (no path runs it): the mma.sync kernels `flash_bwd_dkdv`
    and `flash_bwd_dq`, which recompute the scores in each and need no
    reduction across blocks;
  - backward, D = 512: no kernel; a CUDA call that needs a gradient raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from evoworld_tpu_torch.ops import _build

SOURCE = "flash_attn_fwd.cu"
BWD_SOURCE = "flash_attn_bwd.cu"
HEAD_DIMS = (64, 128, 512)
BWD_HEAD_DIMS = (64, 128)
_LOG2_E = 1.4426950408889634  # log2(e)
_GRID_LIMIT = 65535  # heads on grid.y, batch on grid.z
_ENCODE_ERROR = 10000  # the C entry points return this + the CUresult when a TMA tensor map fails
_BWD_QUERY_TILE = 64  # the fused backward's fp32 scratch is padded to whole query tiles
_PLAIN_BLOCK_K = 512  # keys per step of the plain versions


def _plain_forward(q, k, v, scale, kv_len, use_exp2):
    """Blockwise online softmax -> (out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) fp32)."""
    b, sq, h, d = q.shape
    exp = torch.exp2 if use_exp2 else torch.exp
    eff_scale = scale * _LOG2_E if use_exp2 else scale

    qf = q.transpose(1, 2).float()                     # (B, H, Sq, D)
    m = torch.full((b, h, sq, 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for j in range(0, kv_len, _PLAIN_BLOCK_K):
        kb = k[:, j:min(j + _PLAIN_BLOCK_K, kv_len)].transpose(1, 2).float()
        vb = v[:, j:min(j + _PLAIN_BLOCK_K, kv_len)].transpose(1, 2)
        s = torch.matmul(qf, kb.transpose(-1, -2)).mul_(eff_scale)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = exp(s - m_new)
        alpha = exp(m - m_new)
        m = m_new
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(vb.dtype).float(), vb.float())
    out = acc / torch.clamp(l, min=1e-30)
    lse = (m + torch.log2(l)) * math.log(2.0) if use_exp2 else m + torch.log(l)
    return out.to(q.dtype).transpose(1, 2), lse[..., 0]


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    kv_len: int | None = None,
    use_exp2: bool = False,
) -> torch.Tensor:
    """Blockwise online-softmax attention in torch (the arithmetic of `_flash_kernel`).

    Scores, running max, normaliser and accumulator are fp32; probabilities
    are cast to v's dtype before the P V product, as in the TPU kernel. Keys
    at or past `kv_len` are left out. Returns (B, Sq, H, D) in q's dtype.
    """
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    kv_len = k.shape[1] if kv_len is None else kv_len
    return _plain_forward(q, k, v, scale, kv_len, use_exp2)[0]


def flash_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    scale: float | None = None,
    kv_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV of attention in blockwise fp32 torch (the arithmetic of `flash_attn_bwd.cu`).

    Recomputes P = exp(Q K^T * scale - lse) one block of keys at a time from
    the forward's row log-sum-exp `lse` (B, H, Sq); delta = rowsum(dO * O);
    dS = P * (dO V^T - delta). P and dS are cast to q's dtype before their
    products, as the kernel rounds them to bf16 operands. Rows of dK and dV at
    or past `kv_len` are zero. Returns three tensors in q's dtype, shaped like
    q, k and v.
    """
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    kv_len = k.shape[1] if kv_len is None else kv_len
    qf = q.transpose(1, 2).float()                                       # (B, H, Sq, D)
    dof = do.transpose(1, 2).float()
    delta = (dof * o.transpose(1, 2).float()).sum(-1, keepdim=True)      # (B, H, Sq, 1)
    lse = lse.float()[..., None]
    dq = torch.zeros_like(qf)
    dk = torch.zeros(k.transpose(1, 2).shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.transpose(1, 2).shape, dtype=torch.float32, device=q.device)
    for j in range(0, kv_len, _PLAIN_BLOCK_K):
        e = min(j + _PLAIN_BLOCK_K, kv_len)
        kb = k[:, j:e].transpose(1, 2).float()
        vb = v[:, j:e].transpose(1, 2).float()
        p = torch.exp(torch.matmul(qf, kb.transpose(-1, -2)).mul_(scale) - lse)
        ds = p * (torch.matmul(dof, vb.transpose(-1, -2)) - delta)
        p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
        dv[:, :, j:e] = torch.matmul(p.transpose(-1, -2), dof)
        dk[:, :, j:e] = torch.matmul(ds.transpose(-1, -2), qf).mul_(scale)
        dq += torch.matmul(ds, kb).mul_(scale)
    return tuple(t.to(q.dtype).transpose(1, 2) for t in (dq, dk, dv))


def _check_layout(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be (B, S, H, D), got {tuple(t.shape)}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"{name} strides {t.stride()}: need D stride 1, others multiples of 8")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int, grads: dict | None = None) -> None:
    """Raise on anything the CUDA kernels do not take.

    `grads` holds the backward's extra inputs (`o`, `do`: like q; `lse`:
    fp32 contiguous (B, H, Sq)); with it the head dim must be one the
    backward kernel takes.
    """
    extra = {n: t for n, t in (grads or {}).items() if n != "lse"}
    for name, t in (("q", q), ("k", k), ("v", v), *extra.items()):
        _check_layout(name, t, q.device)
    b, sq, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not 1 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [1, {k.shape[1]}]")
    if sq < 1 or b > _GRID_LIMIT or h > _GRID_LIMIT:
        raise ValueError(f"shape {tuple(q.shape)} outside the launch grid")
    if grads is None:
        return
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"no backward kernel for head dim {d} (takes {BWD_HEAD_DIMS})")
    for name, t in extra.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must be shaped like q {tuple(q.shape)}")
    lse = grads["lse"]
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq) or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 {(b, h, sq)}, got {lse.dtype} {tuple(lse.shape)}")


def _fwd_fn():
    fn = _build.load(SOURCE).flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int]
            + [ctypes.c_longlong] * 12
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = _build.load(BWD_SOURCE).flash_attn_bwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 12
            + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def flash_attention_forward(q, k, v, scale, kv_len, use_exp2=False, with_lse=False):
    """(output, row log-sum-exp fp32 (B, H, Sq) or None): the forward kernel, or its
    plain version for CPU tensors; no autograd. `with_lse` on CUDA needs a head
    dim the backward kernel takes."""
    if q.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            out, lse = _plain_forward(q, k, v, scale, kv_len, use_exp2)
        return out, (lse if with_lse else None)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    b, sq, h, d = q.shape
    if with_lse and d not in BWD_HEAD_DIMS:
        raise RuntimeError(f"flash_attention: a gradient is needed, but no backward kernel takes head dim {d}")
    _check(q, k, v, kv_len)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    fn = _fwd_fn()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, sq, h, d, kv_len, scale, int(use_exp2),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"flash_attn_fwd could not encode a TMA tensor map: CUresult {err - _ENCODE_ERROR}")
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with cudaError {err}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    scale: float | None = None,
    kv_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV from the forward's inputs, output `o`, row log-sum-exp `lse` and `do`.

    CUDA tensors go to the Hopper kernels of `csrc/flash_attn_bwd.cu` (bf16;
    the fused wgmma pass at D = 64, the mma.sync pair at D = 128); one launch
    counts every kernel of a call. At D = 64 the call allocates a zeroed fp32
    buffer shaped like q (padded to whole 64-query tiles) that the fused pass
    sums dQ into; dQ may differ in its last bf16 bit between two calls. CPU
    tensors go to `flash_attention_backward_plain`. Returns contiguous tensors
    shaped like q, k and v.
    """
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if q.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            return flash_attention_backward_plain(q, k, v, o, do, lse, scale, kv_len)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_backward: no kernel for device {q.device}")
    if do.dtype == q.dtype and (do.stride(-1) != 1 or any(s % 8 for s in do.stride()[:3]) or do.data_ptr() % 16):
        do = do.contiguous()  # e.g. the expanded gradient of a sum
    _check(q, k, v, kv_len, grads={"o": o, "do": do, "lse": lse})
    b, sq, h, _ = q.shape
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    if d == 64:
        sq_pad = -(-sq // _BWD_QUERY_TILE) * _BWD_QUERY_TILE
        delta, lse2 = torch.empty((2, b, h, sq_pad), dtype=torch.float32, device=q.device)
        dq_acc = torch.zeros((b, h, sq_pad, d), dtype=torch.float32, device=q.device)
    else:
        sq_pad, lse2, dq_acc = sq, None, None
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    fn = _bwd_fn()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if lse2 is None else lse2.data_ptr(),
            None if dq_acc is None else dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, sq_pad, k.shape[1], h, d, kv_len, scale, strides,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"flash_attn_bwd could not encode a TMA tensor map: CUresult {err - _ENCODE_ERROR}")
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed with cudaError {err}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the flash backward: saves q, k, v, the output and its row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_len, use_exp2):
        out, lse = flash_attention_forward(q, k, v, scale, kv_len, use_exp2, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.kv_len = scale, kv_len
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, do, lse, ctx.scale, ctx.kv_len)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    kv_len: int | None = None,
    use_exp2: bool = False,
) -> torch.Tensor:
    """Exact attention over (B, S, H, D) tensors; keys at or past `kv_len` masked.

    CUDA tensors go to the Hopper kernel (bf16, D in 64/128/512, strided
    layouts allowed as long as D is contiguous); CPU tensors to
    `flash_attention_plain`. Under grad with an input that requires it, the
    call goes through `FlashAttentionFunction` (on CUDA only at D 64/128).
    Returns (B, Sq, H, D) in q's dtype.
    """
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, scale, kv_len, use_exp2)
    return flash_attention_forward(q, k, v, scale, kv_len, use_exp2, with_lse=False)[0]


flash_attention.launches = 0
flash_attention_backward.launches = 0
