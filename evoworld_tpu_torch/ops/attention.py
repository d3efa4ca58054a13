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
Inside `head_sharded_attention(mesh)` (a multi-GPU run; the
reconstructor's global attention), self-attention with at least
FLASH_MIN_SEQ tokens (or the context's `min_seq`) over inputs that every
rank of `mesh` holds whole takes a mesh route instead, and every rank gets
the whole output:
  - heads divisible by the mesh size: each rank runs the flash forward on its
    slice of heads and an all-gather joins them;
  - otherwise: ring attention over sequence shards (`ops/ring_attention.py`).
Both differentiate as the JAX package's `_head_sharded` and
`seq_sharded_ring` do, and every rank gets the whole dq, dk and dv: the
head-sharded route's backward runs the flash backward on this rank's heads
(from the output and log-sum-exp its forward kept) and all-gathers the
three gradients over heads; the ring's is its own backward
(`ops/ring_attention.py`). The gradient of the output must be the same on
every rank, as it is where every rank computes the same loss from it.
"""

from __future__ import annotations

import contextlib
import math

import torch

from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward, flash_attention_forward

FLASH_MIN_SEQ = 4096
_HEAD_SHARD = (None, None)  # (mesh, min_seq) of the innermost `head_sharded_attention`


@contextlib.contextmanager
def head_sharded_attention(mesh, min_seq: int | None = None):
    """Route long self-attention over `mesh` (None: no routing) while the
    context is active. The inputs of every routed attention must be the same
    on every rank. A mesh of one rank runs the flash forward on all heads
    (the route's arithmetic, without a collective).

    `min_seq` lowers the threshold (FLASH_MIN_SEQ tokens; VGGT's global
    attention has 26,025 and up). Left None, a context keeps the threshold
    of the one around it: a tiny gate wraps a reconstructor call in
    `head_sharded_attention(None, 16)`, which routes nothing itself, and
    the aggregator's `head_sharded_attention(mesh)` around its global blocks
    then routes from 16 tokens."""
    global _HEAD_SHARD
    prev = _HEAD_SHARD
    _HEAD_SHARD = (mesh, prev[1] if min_seq is None else min_seq)
    try:
        yield
    finally:
        _HEAD_SHARD = prev


class _HeadSharded(torch.autograd.Function):
    """Each rank's slice of H / W heads through the flash forward, joined by an
    all-gather; the backward runs the flash backward on the same heads and
    all-gathers dq, dk and dv (one collective)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, mesh):
        heads = _heads(q.shape[2], mesh)
        grad = any(ctx.needs_input_grad[:3])
        out, lse = flash_attention_forward(q[:, :, heads], k[:, :, heads], v[:, :, heads], scale, k.shape[1],
                                           with_lse=grad)
        if grad:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.scale, ctx.mesh = scale, mesh
        return _join_heads(out, mesh)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        heads = _heads(q.shape[2], ctx.mesh)
        grads = flash_attention_backward(q[:, :, heads], k[:, :, heads], v[:, :, heads], out, do[:, :, heads], lse,
                                         ctx.scale, k.shape[1])
        full = _join_heads(torch.stack(grads, dim=-2), ctx.mesh)                 # (B, S, H, 3, D)
        return full[..., 0, :], full[..., 1, :], full[..., 2, :], None, None


def _heads(h: int, mesh) -> slice:
    hl = h // mesh.size
    return slice(mesh.rank * hl, (mesh.rank + 1) * hl)


def _join_heads(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's (B, S, H / W, ...) joined along heads, in rank order."""
    from evoworld_tpu_torch.parallel.collectives import all_gather

    return all_gather(x.movedim(2, 0).contiguous(), mesh).movedim(0, 2)


def head_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, mesh) -> torch.Tensor:
    """Each rank's slice of H / W heads through the flash forward, joined by
    an all-gather; differentiable (`_HeadSharded`)."""
    return _HeadSharded.apply(q, k, v, scale, mesh)


def _mesh_route(q, k, v, scale, mesh):
    if q.shape[2] % mesh.size == 0:
        return head_sharded(q, k, v, scale, mesh)
    from evoworld_tpu_torch.ops.ring_attention import seq_sharded_ring

    return seq_sharded_ring(q, k, v, scale, mesh)


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
    mesh, min_seq = _HEAD_SHARD
    if mesh is not None and impl == "auto" and q.shape[1] == k.shape[1] >= (min_seq or FLASH_MIN_SEQ):
        return _mesh_route(q, k, v, scale, mesh)
    if impl == "flash" or (q.is_cuda and q.shape[1] >= FLASH_MIN_SEQ):
        return flash_attention(q, k, v, scale=scale)
    return plain_attention(q, k, v, scale).to(q.dtype)
