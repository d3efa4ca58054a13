"""Attention dispatch (counterpart of `evoworld_tpu/ops/attention.py`).

Routes of `multi_head_attention` on (B, S, H, D) tensors:
  - one key (the SVD cross-attention on one CLIP token): softmax over one key
    is 1, so the output is V broadcast over the queries; exact;
  - CUDA tensors with 4096 tokens or more (UNet level-0 and VAE mid-block
    attention at 9216 tokens): the hand-written Hopper flash kernel, and
    under grad its backward kernel through `FlashAttentionFunction` (never a
    fallback to plain attention on CUDA);
  - `impl="flash"`: the flash wrapper on any device (its plain version on
    the CPU);
  - everything else (2304-token level-1 attention, 25-frame temporal
    attention, CLIP's 257 tokens): plain attention with fp32 logits and
    softmax and matmuls in the input dtype.
The JAX package's mesh routes (head-sharded and ring attention) are not part
of this single-card port.
"""

from __future__ import annotations

import math

import torch

from evoworld_tpu_torch.ops.flash_attention import flash_attention

FLASH_MIN_SEQ = 4096


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain attention; logits and softmax in fp32, matmuls in the input dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float().mul_(scale)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    del logits
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, impl: str = "auto"
) -> torch.Tensor:
    """Scaled dot-product attention over explicit heads.

    Args:
        q: (B, Sq, H, D) queries.
        k, v: (B, Skv, H, D) keys and values.
        impl: "auto" or "flash".

    Returns:
        (B, Sq, H, D) in q's dtype.
    """
    if impl not in ("auto", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "auto" and k.shape[1] == 1 and v.shape[-1] == q.shape[-1]:
        return v.expand(q.shape).to(q.dtype)
    if impl == "flash" or (q.is_cuda and q.shape[1] >= FLASH_MIN_SEQ):
        return flash_attention(q, k, v, scale=scale)
    return plain_attention(q, k, v, scale).to(q.dtype)
