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
kernel's), the merge in fp32. Forward only: the ring has no gradient here.
"""

from __future__ import annotations

import torch

from evoworld_tpu_torch.ops.flash_attention import flash_attention_forward
from evoworld_tpu_torch.parallel.collectives import RingExchange, all_gather
from evoworld_tpu_torch.parallel.mesh import Mesh

_NEG = -1e30  # a finite -inf: keeps exp and logaddexp free of NaN for a row with no keys yet


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, mesh: Mesh,
                   kv_valid: int) -> torch.Tensor:
    """Exact attention of this rank's (B, S_local, H, D) query shard over the
    ring's key and value shards; the global sequence is mesh.size * S_local
    rows, padded at its end, of which the first `kv_valid` are real keys.
    Padded query rows compute garbage for the caller to cut. Returns
    (B, S_local, H, D) in q's dtype."""
    b, sq, h, d = q.shape
    s_loc = k.shape[1]
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, sq), _NEG, dtype=torch.float32, device=q.device)
    kb, vb = k.contiguous(), v.contiguous()
    for i in range(mesh.size):
        # Begin the rotation first: the transfer of the block to the next rank overlaps this block's compute.
        sends = [RingExchange(kb, mesh), RingExchange(vb, mesh)] if i < mesh.size - 1 else None
        origin = (mesh.rank - i) % mesh.size  # blocks move +1 a step: the one held now started on rank - i
        kv_len = min(max(kv_valid - origin * s_loc, 0), s_loc)
        if kv_len > 0:
            ob, lb = flash_attention_forward(q, kb, vb, scale, kv_len, with_lse=True)
            new_lse = torch.logaddexp(lse, lb)
            o = (o * torch.exp(lse - new_lse).transpose(1, 2)[..., None]
                 + ob.float() * torch.exp(lb - new_lse).transpose(1, 2)[..., None])
            lse = new_lse
        if sends is not None:
            kb, vb = (s.wait() for s in sends)
    return o.to(q.dtype)


def seq_sharded_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, mesh: Mesh) -> torch.Tensor:
    """Ring attention over (B, S, H, D) self-attention inputs that every rank
    holds whole: pad S to a multiple of the mesh size, run the ring on this
    rank's rows, all-gather the rows and cut the padding. Returns the whole
    (B, S, H, D) output, in q's dtype, on every rank."""
    s = q.shape[1]
    w = mesh.size
    s_loc = -(-s // w)
    pad = s_loc * w - s
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    rows = slice(mesh.rank * s_loc, (mesh.rank + 1) * s_loc)
    out = ring_attention(q[:, rows], k[:, rows], v[:, rows], scale, mesh, kv_valid=s)
    full = all_gather(out.transpose(0, 1).contiguous(), mesh)           # (W * S_local, B, H, D)
    return full.transpose(0, 1)[:, :s]
