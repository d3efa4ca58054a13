"""Flash attention: the hand-written Hopper kernel and its plain version.

Counterpart of two TPU kernels that compute the same function, exact
non-causal softmax(Q K^T * scale) V over (B, S, H, D):
  - `evoworld_tpu/ops/attention.py::_builtin_flash` (JAX's shipped Pallas TPU
    kernel, the production route for sequences of 4096 tokens or more);
  - `evoworld_tpu/ops/flash_attention.py::flash_attention` / `_flash_kernel`
    (the package's own streaming kernel with a `kv_len` mask and `use_exp2`).

`flash_attention` launches `csrc/flash_attn_fwd.cu` for CUDA tensors and
takes `flash_attention_plain` only for tensors on the CPU. On a CUDA tensor
it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from evoworld_tpu_torch.ops import _build

SOURCE = "flash_attn_fwd.cu"
HEAD_DIMS = (64, 128, 512)
_LOG2_E = 1.4426950408889634  # log2(e)
_GRID_LIMIT = 65535  # heads on grid.y, batch on grid.z
_PLAIN_BLOCK_K = 512  # keys per step of the plain version's online softmax


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
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    kv_len = skv if kv_len is None else kv_len
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
    return out.to(q.dtype).transpose(1, 2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int) -> None:
    """Raise on anything the CUDA kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got {tuple(t.shape)}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} strides {t.stride()}: need D stride 1, others multiples of 8")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    b, sq, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not 1 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [1, {k.shape[1]}]")
    if sq < 1 or b > _GRID_LIMIT or h > _GRID_LIMIT:
        raise ValueError(f"shape {tuple(q.shape)} outside the launch grid")


def _kernel_fn():
    fn = _build.load(SOURCE).flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int]
            + [ctypes.c_longlong] * 12
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


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
    `flash_attention_plain`. Returns (B, Sq, H, D) in q's dtype.
    """
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, kv_len=kv_len, use_exp2=use_exp2)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v, kv_len)
    b, sq, h, _ = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, h, d, kv_len, scale, int(use_exp2),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
