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
backward `csrc/flash_attn_bwd.cu` (fp32: both `csrc/flash_attn_fp32.cu`);
tensors on the CPU take `flash_attention_plain` and
`flash_attention_backward_plain`. On a CUDA tensor each wrapper launches its
kernel or raises; it never falls back.

The kernels take bf16, fp16 or fp32 (q, k, v, o, dO and the gradients all of
one of the three; the log-sum-exp and the scratch fp32). bf16 and fp16 share
one design: each kernel of `csrc/flash_attn_fwd.cu` and `csrc/flash_attn_bwd.cu`
is one source templated over the element type, and the wrapper passes the
type's code (`_ELEM_CODES`). Both directions are bound by tensor-core operations
(the same dense rate in bf16 and fp16 on an H100) at the paths' 9216
tokens, with one exp2 per score beside them. Which head dim takes which kernel:
  - forward, D = 64 and 128: `flash_fwd_wgmma` (wgmma, a TMA ring of K and V
    tiles, a producer warpgroup and two consumers); D = 512: `flash_fwd_wide`
    (the same shape of block with 64 query rows; the two consumers split D,
    each owning 256 output columns and half of the Q K^T contraction, and
    swap their fp32 partial scores through shared memory; K and V come in
    64-column TMA boxes). Both write the row log-sum-exp when asked;
  - backward, D = 64 (every attention with a gradient on the port's paths)
    and 128: `flash_bwd_fused`, one pass per 128-key tile whose two consumer
    warpgroups keep their dK and dV sums in registers (at D = 64 their K and
    V fragments too; at D = 128 K and V stay in shared memory), stream query
    tiles through a TMA ring, do the five products with wgmma and exp2 once,
    and add the tile's part of dQ into a zeroed fp32 buffer with
    asynchronous bulk reductions (at D = 128 each consumer its 64 columns),
    between `flash_bwd_delta` (rowsum(dO * O) and the log-sum-exp in the
    exp2 domain) and `flash_bwd_store_dq` (scale, to the input type). The
    order of those fp32 sums is not fixed, so dQ may differ in its last bit
    between two calls; dK and dV are repeatable;
  - backward, D = 512 (no path runs it): after `flash_bwd_delta`, three
    wgmma sweeps with `flash_fwd_wide`'s block, `flash_bwd_wide_dv` (K
    resident, 64-query tiles), `flash_bwd_wide_dk` (K and V resident, 32-query
    tiles) and `flash_bwd_wide_dq` (Q and dO resident, 32-key tiles), 8
    products where the function needs 5; in each the two consumers own 256
    columns of the gradient and half of each score's 512-deep sum, and swap
    their partial sums. No sweep sums across blocks, so all three gradients
    repeat bit for bit.
fp32 has a design of its own, `csrc/flash_attn_fp32.cu` with its own C entry
points: wgmma takes fp32 only as one TF32 pass (10 mantissa bits, fp16's
width) with both shared operands K-major, so every fp32 operand is split
into three bf16 planes (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
mid)) and each product is six bf16 wgmma products (lo*hi, hi*lo, mid*mid,
mid*hi, hi*mid, hi*hi, fp32 sums; about 24 bits of each operand kept), the
other operand read MN-major through the transpose bit where a product needs
it. A splitter warpgroup copies fp32 chunks of 64 x 64 and writes each
element's planes once into shared memory; two consumer warpgroups run the
products and split P and dS in their registers; each tile's product with P
or dS starts from zero and is added into its sum on the CUDA cores:
  - forward `flash_fp32_fwd` (128 queries a block with Q resident at D = 64
    and 128; at D = 512 64 queries, the consumers splitting D and swapping
    partial scores, as `flash_fwd_wide` splits it), writing the
    log-sum-exp when asked;
  - backward `flash_fp32_bwd_delta`, then `flash_fp32_bwd_dkdv` (a block per
    key tile, query tiles streamed; at D = 512 dV and dK from separate
    blocks) and `flash_fp32_bwd_dq` (a block per query tile, key tiles
    streamed), D split across the consumers at 128 and 512: no sums across
    blocks and no atomics, so dQ, dK and dV repeat bit for bit.
`flash_attention_split_plain` computes the forward the way the fp32 kernel
does, for the tests.
Other head dims are zero-padded along D up to the smallest kernel head dim
that holds them (`kernel_head_dim`: 64, 128 or 512, in both directions) and
the output is sliced back; the scale stays that of the true D. Zero columns
leave Q K^T and P V as they were, so this is the same kernel, at (padded D /
D) times the work: 4x at the tiny VGGT's D = 16.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from evoworld_tpu_torch.ops import _build

SOURCE = "flash_attn_fwd.cu"
BWD_SOURCE = "flash_attn_bwd.cu"
FP32_SOURCE = "flash_attn_fp32.cu"  # the fp32 forward and backward, entry points of their own
HEAD_DIMS = (64, 128, 512)  # head dims of the forward and of the backward kernels
_LOG2_E = 1.4426950408889634  # log2(e)
_GRID_LIMIT = 65535  # heads on grid.y, batch on grid.z
_ENCODE_ERROR = 10000  # the C entry points return this + the CUresult when a TMA tensor map fails
_BWD_QUERY_TILE = 64  # the backward's fp32 scratch (delta, L in the exp2 domain) is padded to whole query tiles
_FUSED_BWD_DIMS = (64, 128)  # head dims of the fused pass, which sums dQ in an fp32 buffer (512: the wide sweeps)
_PLAIN_BLOCK_K = 512  # keys per step of the plain versions
# The element types of the bf16/fp16 kernels and the C entry points' code for
# each (ElemCode in csrc/flash_attn_common.cuh); fp32 goes to FP32_SOURCE.
_ELEM_CODES = {torch.bfloat16: 0, torch.float16: 1}
_KERNEL_DTYPES = (*_ELEM_CODES, torch.float32)


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


# The fp32 forward's six bf16 products of a split pair a b, small first:
# (plane of a, plane of b), planes 0 hi, 1 mid, 2 lo (csrc/flash_attn_fp32.cu,
# `part_a` / `part_b`).
_SPLIT_PRODUCTS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
_SPLIT_CHUNK = 64  # columns of a chunk of the kernel's contraction, and keys a tile


def _split_planes(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), as fp32:
    the first `parts` of them, each rounded to nearest even, each
    subtraction exact in fp32."""
    planes = []
    for _ in range(parts):
        plane = x.to(torch.bfloat16).float()
        planes.append(plane)
        x = x - plane
    return planes


def _split_matmul(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """a @ b as the fp32 sum of the products of `_SPLIT_PRODUCTS` between the
    `parts`-plane splits of a and b (parts = 1: one bf16 product), in order."""
    pa, pb = _split_planes(a, parts), _split_planes(b, parts)
    out = None
    for i, j in _SPLIT_PRODUCTS:
        if i < parts and j < parts:
            term = torch.matmul(pa[i], pb[j])
            out = term if out is None else out + term
    return out


def flash_attention_split_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    kv_len: int | None = None,
    parts: int = 3,
) -> torch.Tensor:
    """fp32 attention computed the way `flash_fp32_fwd` computes it; for the
    tests (no path calls it).

    Every operand of the two products (Q, K, P, V) is split into `parts`
    bf16 planes (`_split_planes`: 3 in the kernel; 1 is plain bf16) and each
    product is summed from the plane products of `_SPLIT_PRODUCTS`. S is
    summed over 64-column chunks, each chunk's products from zero; the online
    softmax runs in the exp2 domain over 64-key tiles; each tile's P V starts
    from zero and is added into O. Keys at or past `kv_len` are left out.
    Returns (B, Sq, H, D) fp32.
    """
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    kv_len = k.shape[1] if kv_len is None else kv_len
    qf, kf, vf = (t.transpose(1, 2).float() for t in (q, k[:, :kv_len], v[:, :kv_len]))  # (B, H, S, D)
    m = torch.full((*qf.shape[:3], 1), -1e30, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    for j in range(0, kv_len, _SPLIT_CHUNK):
        kt, vt = kf[:, :, j:j + _SPLIT_CHUNK], vf[:, :, j:j + _SPLIT_CHUNK]
        s = None
        for c in range(0, d, _SPLIT_CHUNK):
            part = _split_matmul(qf[..., c:c + _SPLIT_CHUNK], kt[..., c:c + _SPLIT_CHUNK].transpose(-1, -2), parts)
            s = part if s is None else s + part
        s = s * (scale * _LOG2_E)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        m = m_new
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + _split_matmul(p, vt, parts)
    return (o / l).transpose(1, 2)


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
    products, as the bf16 and fp16 kernels round them to their operands (a
    no-op in fp32); dK's scale is applied in fp32 before the final cast, as
    in the kernel. Rows of dK and dV at or past `kv_len` are zero. Returns
    three tensors in q's dtype, shaped like q, k and v.
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


def _aligned(t: torch.Tensor) -> bool:
    """D contiguous, every other stride a whole 16 bytes (8 bf16 / fp16 or 4
    fp32 elements), and a 16-byte aligned base: what the kernels' copies take."""
    step = 16 // t.element_size()
    return t.stride(-1) == 1 and not any(s % step for s in t.stride()[:3]) and t.data_ptr() % 16 == 0


def _check_layout(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    if t.device != q.device:
        raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if t.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name} must be bfloat16, float16 or float32, got {t.dtype}")
    if t.dtype != q.dtype:
        raise ValueError(f"{name} is {t.dtype} and q {q.dtype}: the kernels take one element type for all inputs")
    if t.dim() != 4:
        raise ValueError(f"{name} must be (B, S, H, D), got {tuple(t.shape)}")
    if not _aligned(t):
        raise ValueError(f"{name} ({t.dtype}) strides {t.stride()}: need D stride 1, others multiples of "
                         f"{16 // t.element_size()} elements (16 bytes), and a 16-byte aligned base")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int, grads: dict | None = None) -> None:
    """Raise on anything the CUDA kernels do not take.

    Every input is bfloat16, every input float16 or every input float32: a
    mix, or another dtype (float64), is refused by name. `grads` holds the
    backward's extra inputs (`o`, `do`: like q; `lse`: fp32 contiguous (B, H, Sq)).
    """
    extra = {n: t for n, t in (grads or {}).items() if n != "lse"}
    for name, t in (("q", q), ("k", k), ("v", v), *extra.items()):
        _check_layout(name, t, q)
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
    for name, t in extra.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must be shaped like q {tuple(q.shape)}")
    lse = grads["lse"]
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq) or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 {(b, h, sq)}, got {lse.dtype} {tuple(lse.shape)}")


def kernel_head_dim(d: int) -> int | None:
    """The smallest head dim of a kernel that holds `d`, or None where none does."""
    return next((k for k in HEAD_DIMS if d <= k), None)


def _pad_head_dim(tensors, d_to: int):
    """Zero-pad each (B, S, H, D) tensor along D to `d_to`."""
    return [F.pad(t, (0, d_to - t.shape[-1])) for t in tensors]


def _fwd_fn():
    fn = _build.load(SOURCE).flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
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
            + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _fp32_fwd_fn():
    fn = _build.load(FP32_SOURCE).flash_attn_fp32_fwd
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


def _fp32_bwd_fn():
    fn = _build.load(FP32_SOURCE).flash_attn_fp32_bwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 11
            + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def flash_attention_forward(q, k, v, scale, kv_len, use_exp2=False, with_lse=False):
    """(output, row log-sum-exp fp32 (B, H, Sq) or None): the forward kernel, or its
    plain version for CPU tensors; no autograd. A head dim without a kernel of
    its own is zero-padded to `kernel_head_dim` and the output sliced back."""
    d = q.shape[-1]
    d_kernel = kernel_head_dim(d)
    if d_kernel is not None and d_kernel != d:
        out, lse = flash_attention_forward(*_pad_head_dim((q, k, v), d_kernel), scale, kv_len, use_exp2, with_lse)
        return out[..., :d].contiguous(), lse
    if q.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            out, lse = _plain_forward(q, k, v, scale, kv_len, use_exp2)
        return out, (lse if with_lse else None)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    b, sq, h, d = q.shape
    _check(q, k, v, kv_len)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    fp32 = q.dtype == torch.float32
    fn = _fp32_fwd_fn() if fp32 else _fwd_fn()
    code = () if fp32 else (_ELEM_CODES[q.dtype],)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, sq, h, d, kv_len, scale, int(use_exp2), *code,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"flash_attn_fwd could not encode a TMA tensor map: CUresult {err - _ENCODE_ERROR}")
    if err != 0:
        raise RuntimeError(f"{'flash_attn_fp32_fwd' if fp32 else 'flash_attn_fwd'} launch failed with cudaError {err}")
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

    CUDA tensors go to the Hopper kernels of `csrc/flash_attn_bwd.cu` (bf16
    or fp16, all inputs of one type; the fused wgmma pass at D = 64 and 128,
    the three wide sweeps at D = 512) or of `csrc/flash_attn_fp32.cu` (fp32);
    one launch counts every kernel of a call. Each call allocates fp32 delta
    and L scratch padded to whole 64-query tiles; in bf16
    and fp16 at D = 64 and 128 also a zeroed fp32 buffer shaped like q (padded
    the same way) that the fused pass sums dQ into, so that dQ may differ in
    its last bit between two calls (fp32 sums nothing across blocks and
    repeats all three). CPU tensors go to `flash_attention_backward_plain`.
    Returns contiguous tensors shaped like q, k and v. A head dim without a
    kernel of its own is zero-padded to `kernel_head_dim` and the gradients
    sliced back.
    """
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    d_kernel = kernel_head_dim(d)
    if d_kernel is not None and d_kernel != d:
        grads = flash_attention_backward(*_pad_head_dim((q, k, v, o, do), d_kernel), lse, scale, kv_len)
        return tuple(g[..., :d].contiguous() for g in grads)
    if q.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            return flash_attention_backward_plain(q, k, v, o, do, lse, scale, kv_len)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_backward: no kernel for device {q.device}")
    if do.dtype == q.dtype and not _aligned(do):
        do = do.contiguous()  # e.g. the expanded gradient of a sum
    _check(q, k, v, kv_len, grads={"o": o, "do": do, "lse": lse})
    b, sq, h, _ = q.shape
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    sq_pad = -(-sq // _BWD_QUERY_TILE) * _BWD_QUERY_TILE
    delta, lse2 = torch.empty((2, b, h, sq_pad), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    if q.dtype == torch.float32:
        with torch.cuda.device(q.device):
            err = _fp32_bwd_fn()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), lse2.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b, sq, sq_pad, k.shape[1], h, d, kv_len, scale, strides,
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"flash_attn_fp32_bwd launch failed with cudaError {err}")
        flash_attention_backward.launches += 1
        return dq, dk, dv
    dq_acc = torch.zeros((b, h, sq_pad, d), dtype=torch.float32, device=q.device) if d in _FUSED_BWD_DIMS else None
    fn = _bwd_fn()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), lse2.data_ptr(), None if dq_acc is None else dq_acc.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, sq_pad, k.shape[1], h, d, kv_len, _ELEM_CODES[q.dtype], scale, strides,
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

    CUDA tensors go to the Hopper kernels (bf16, fp16 or fp32, q, k and v of
    one type; D up to 512, padded to 64,
    128 or 512, strided layouts allowed as long as D is contiguous); CPU
    tensors to `flash_attention_plain`. Under grad with an input that requires it, the
    call goes through `FlashAttentionFunction`.
    Returns (B, Sq, H, D) in q's dtype.
    """
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, scale, kv_len, use_exp2)
    return flash_attention_forward(q, k, v, scale, kv_len, use_exp2, with_lse=False)[0]


flash_attention.launches = 0
flash_attention_backward.launches = 0
