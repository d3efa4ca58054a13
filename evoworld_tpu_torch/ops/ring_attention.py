"""Ring attention: exact self-attention over sequence shards, one per rank
(counterpart of `evoworld_tpu/ops/ring_attention.py`).

The route for long self-attention whose head count the mesh does not divide
(`ops/attention.py`): each rank holds S_local = ceil(S / W) rows of q, k and
v (the sequence padded at its end, keys at or past `kv_valid` = S masked),
runs the flash forward of its queries against the key block it holds, sends
that block one hop round the ring while it computes, and merges the blocks'
partial outputs by their row log-sum-exp. After W steps every query shard
has met every key shard, which is full attention.

Each block is one call of `ops/flash_attention.py::flash_attention_forward`
with `kv_len = clamp(kv_valid - origin * S_local, 0, S_local)` and
`with_lse=True`: the hand-written Hopper kernel on the card, its plain
version on the CPU. A block that is all padding (`kv_len == 0`) makes no
call (the kernel's softmax over no keys would be 0/0): it contributes
lse = `_NEG`, which the merge leaves without effect, as the JAX package's
masked block does. The output of each block is in the input's type (the
kernel's), the merge in fp32.

The gradient (`_Ring`, the counterpart of the reverse mode of the JAX ring's
`lax.scan`): each rank keeps its query shard's merged output and its
**global** row log-sum-exp from the forward, and goes round the ring again.
At each block it calls `ops/flash_attention.py::flash_attention_backward`
once, with that output and log-sum-exp (so that delta = rowsum(dO * O) and
P = exp(S - lse) are the global ones, and the block's parts add up to the
whole gradient) and the forward's clamped `kv_len`; an all-padding block
makes no call. dQ sums in fp32 on the rank. Each block's dK and dV sum in
fp32 too, and travel round the ring with the block: after W hops they are
back on the rank that owns it, whole. An all-gather then hands every rank the
whole dq, dk and dv, as the forward hands it the whole output.
"""

from __future__ import annotations

import torch

from evoworld_tpu_torch.ops.flash_attention import flash_attention_backward, flash_attention_forward
from evoworld_tpu_torch.parallel.collectives import RingExchange, all_gather
from evoworld_tpu_torch.parallel.mesh import Mesh

_NEG = -1e30  # a finite -inf: keeps exp and logaddexp free of NaN for a row with no keys yet


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, mesh: Mesh,
                   kv_valid: int, with_lse: bool = False):
    """Exact attention of this rank's (B, S_local, H, D) query shard over the
    ring's key and value shards; the global sequence is mesh.size * S_local
    rows, padded at its end, of which the first `kv_valid` are real keys.
    Padded query rows compute garbage for the caller to cut. Returns
    (B, S_local, H, D) in q's dtype, and with `with_lse` the rows' fp32
    log-sum-exp over every key (B, H, S_local) too."""
    b, sq, h, d = q.shape
    s_loc = k.shape[1]
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, sq), _NEG, dtype=torch.float32, device=q.device)
    kb, vb = k.contiguous(), v.contiguous()
    for i in range(mesh.size):
        # Begin the rotation first: the transfer of the block to the next rank overlaps this block's compute.
        sends = [RingExchange(kb, mesh), RingExchange(vb, mesh)] if i < mesh.size - 1 else None
        kv_len = _block_len(mesh, i, s_loc, kv_valid)
        if kv_len > 0:
            ob, lb = flash_attention_forward(q, kb, vb, scale, kv_len, with_lse=True)
            new_lse = torch.logaddexp(lse, lb)
            o = (o * torch.exp(lse - new_lse).transpose(1, 2)[..., None]
                 + ob.float() * torch.exp(lb - new_lse).transpose(1, 2)[..., None])
            lse = new_lse
        if sends is not None:
            kb, vb = (s.wait() for s in sends)
    return (o.to(q.dtype), lse) if with_lse else o.to(q.dtype)


def _block_len(mesh: Mesh, i: int, s_loc: int, kv_valid: int) -> int:
    """The real keys of the block held at step i (blocks move +1 a step: the
    one held then started on rank - i)."""
    origin = (mesh.rank - i) % mesh.size
    return min(max(kv_valid - origin * s_loc, 0), s_loc)


def ring_attention_backward(q, k, v, o, do, lse, scale: float, mesh: Mesh, kv_valid: int):
    """(dq, dk, dv) of this rank's shards: dq for its queries over every key
    block, dk and dv of its own key block summed over every query shard.
    `o` and `lse` are the forward's merged output and global log-sum-exp."""
    s_loc = k.shape[1]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkb = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dvb = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    kb, vb = k.contiguous(), v.contiguous()
    for i in range(mesh.size):
        sends = [RingExchange(kb, mesh), RingExchange(vb, mesh)] if i < mesh.size - 1 else None
        kv_len = _block_len(mesh, i, s_loc, kv_valid)
        if kv_len > 0:
            gq, gk, gv = flash_attention_backward(q, kb, vb, o, do, lse, scale, kv_len)
            dq += gq.float()
            dkb += gk.float()
            dvb += gv.float()
        # The block's sums go on with it; the W-th hop brings them home.
        back = [RingExchange(dkb, mesh), RingExchange(dvb, mesh)]
        dkb, dvb = (x.wait() for x in back)
        if sends is not None:
            kb, vb = (x.wait() for x in sends)
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t


def _join_rows(x: torch.Tensor, mesh: Mesh, s: int) -> torch.Tensor:
    """Every rank's (B, S_local, ...) rows joined in rank order, cut to `s`."""
    return all_gather(x.transpose(0, 1).contiguous(), mesh).transpose(0, 1)[:, :s]


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, mesh):
        s, w = q.shape[1], mesh.size
        s_loc = -(-s // w)
        rows = slice(mesh.rank * s_loc, (mesh.rank + 1) * s_loc)
        qr, kr, vr = (_pad_rows(t, s_loc * w - s)[:, rows] for t in (q, k, v))
        grad = any(ctx.needs_input_grad[:3])
        out = ring_attention(qr, kr, vr, scale, mesh, kv_valid=s, with_lse=grad)
        if grad:
            out, lse = out
            ctx.save_for_backward(qr, kr, vr, out, lse)
            ctx.scale, ctx.mesh, ctx.s = scale, mesh, s
        return _join_rows(out, mesh, s)

    @staticmethod
    def backward(ctx, do):
        qr, kr, vr, out, lse = ctx.saved_tensors
        mesh, s, s_loc = ctx.mesh, ctx.s, qr.shape[1]
        rows = slice(mesh.rank * s_loc, (mesh.rank + 1) * s_loc)
        dor = _pad_rows(do, s_loc * mesh.size - s)[:, rows]
        grads = ring_attention_backward(qr, kr, vr, out, dor, lse, ctx.scale, mesh, kv_valid=s)
        full = _join_rows(torch.stack(grads, dim=-2), mesh, s)                   # (B, S, H, 3, D)
        return full[..., 0, :], full[..., 1, :], full[..., 2, :], None, None


def seq_sharded_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, mesh: Mesh) -> torch.Tensor:
    """Ring attention over (B, S, H, D) self-attention inputs that every rank
    holds whole: pad S to a multiple of the mesh size, run the ring on this
    rank's rows, all-gather the rows and cut the padding. Returns the whole
    (B, S, H, D) output, in q's dtype, on every rank; differentiable, every
    rank getting the whole gradients (`_Ring`)."""
    return _Ring.apply(q, k, v, scale, mesh)
