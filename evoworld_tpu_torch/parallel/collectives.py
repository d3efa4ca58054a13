"""The collectives of the port's sharded paths, over the default process
group (a `Mesh`: every rank) or one axis of the mesh (an `Axis`, from
`parallel/mesh.py::axes`): `all_gather` (joined along the leading axis),
`RingExchange` (send to the next rank, receive from the previous),
`gather_frames` (a clip's frame shards joined in frame order, the serving
denoise's one collective after its last step), and the
training step's `all_reduce_mean`, `all_reduce_sum` and `reduce_scatter`
(the mean or sum over the ranks, whole or this rank's row of it).

The model-parallel half of training differentiates through collectives,
each a `torch.autograd.Function` over the ones above:
  - `gather_along(x, axis, dim)`: every rank's `x` joined along `dim`
    (contiguous, as a kernel downstream takes it); its backward takes this
    rank's slice of the gradient;
  - `copy_to(x, axis)`: the identity, whose backward sums the gradient over
    the axis (the input of a layer whose output features are split);
  - `sum_over(x, axis)`: the sum over the axis, whose backward sums too;
  - `frames_to_tokens` / `tokens_to_frames`: an all-to-all between a
    (B, F_local, S, C) frame shard and a (B, F, S_local, C) token shard, the
    splits uneven where the counts do not divide;
  - `halo`: the previous rank's last frame and the next rank's first, zeros
    at the clip's two ends; its backward sends each halo's gradient back to
    the rank that owns the frame.

On NCCL, CUDA tensors pass straight through. On gloo, which takes CUDA
tensors only for broadcast and all-reduce, a CUDA tensor is staged through
pinned host memory and the result copied back to its device. The gathers,
the exchanges and the ring move bytes, so any dtype goes (bf16 included);
the reductions take floating tensors. There is no fallback: a collective
that fails raises.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from evoworld_tpu_torch.parallel.mesh import Axis, FrameShard, Mesh, split_sizes

def _group(ranks: Mesh | Axis):
    return getattr(ranks, "group", None)


def _staged(ranks: Mesh | Axis, x: torch.Tensor) -> bool:
    return ranks.backend != "nccl" and x.is_cuda


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _host_copy(x: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    return buf


def all_gather(x: torch.Tensor, ranks: Mesh | Axis) -> torch.Tensor:
    """Every rank's `x` (one shape on all ranks), joined along dim 0 in rank order."""
    if ranks.size == 1:
        return x
    src = _host_copy(_bytes(x)) if _staged(ranks, x) else _bytes(x)
    out = torch.empty((ranks.size, src.numel()), dtype=torch.uint8, device=src.device)
    if ranks.backend == "nccl":
        dist.all_gather_into_tensor(out, src, group=_group(ranks))
    else:
        dist.all_gather(list(out.unbind(0)), src, group=_group(ranks))
    out = out.view(x.dtype).reshape(ranks.size * x.shape[0], *x.shape[1:])
    return out.to(x.device, non_blocking=True) if out.device != x.device else out


def gather_frames(x: torch.Tensor, frames: FrameShard) -> torch.Tensor:
    """Every rank's run of a clip's frames (`x`: this rank's, along dim 0)
    joined in frame order over `frames.axis`: the short runs padded to the
    longest for one all-gather and cut after it, so that every rank holds
    the same bytes."""
    if frames.axis.size == 1:
        return x
    most = max(frames.sizes)
    if x.shape[0] < most:
        x = torch.cat([x, x.new_zeros(most - x.shape[0], *x.shape[1:])])
    whole = all_gather(x, frames.axis)
    return torch.cat([whole[r * most:r * most + n] for r, n in enumerate(frames.sizes)])


class RingExchange:
    """`x` sent to rank + 1 and the same shape received from rank - 1 of the
    default group, begun at construction (the caller computes meanwhile) and
    finished by `wait()`."""

    def __init__(self, x: torch.Tensor, mesh: Mesh):
        self.device, self.dtype, self.shape = x.device, x.dtype, x.shape
        src = _host_copy(_bytes(x)) if _staged(mesh, x) else _bytes(x)
        self.buf = torch.empty_like(src)
        nxt, prv = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size
        if mesh.backend == "nccl":
            self.works = dist.batch_isend_irecv([dist.P2POp(dist.isend, src, nxt), dist.P2POp(dist.irecv, self.buf, prv)])
        else:
            self.works = [dist.isend(src, nxt), dist.irecv(self.buf, prv)]
        self.src = src  # held until the send completes

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        out = self.buf.view(self.dtype).reshape(self.shape)
        return out.to(self.device, non_blocking=True) if out.device != self.device else out


def all_reduce_sum(x: torch.Tensor, ranks: Mesh | Axis) -> torch.Tensor:
    """In place: `x` becomes the sum of every rank's `x`; returns it. Gloo
    sums CUDA tensors itself (through host memory)."""
    if ranks.size > 1:
        dist.all_reduce(x, group=_group(ranks))
    return x


def all_reduce_mean(x: torch.Tensor, ranks: Mesh | Axis) -> torch.Tensor:
    """In place: `x` becomes the mean of every rank's `x`; returns it."""
    if ranks.size > 1:
        all_reduce_sum(x, ranks).div_(ranks.size)
    return x


def reduce_scatter(x: torch.Tensor, axis: Axis, mean: bool = True) -> torch.Tensor:
    """This rank's row of the mean (or with `mean` False the sum) over `axis`
    of every rank's `x` (size, n): NCCL's reduce-scatter. On gloo, which has
    no reduce-scatter of CUDA tensors, `x` is summed whole (staged through
    pinned host memory) and the row taken: the same values, `size` times the
    traffic."""
    if x.shape[0] != axis.size:
        raise ValueError(f"reduce_scatter takes ({axis.size}, n) rows, got {tuple(x.shape)}")
    if axis.size == 1:
        return x[0]
    if axis.backend == "nccl":
        out = torch.empty_like(x[0])
        dist.reduce_scatter_tensor(out, x.contiguous(), group=_group(axis))
    else:
        src = _host_copy(x) if _staged(axis, x) else x.clone()
        dist.all_reduce(src, group=_group(axis))
        out = src[axis.rank].to(x.device, non_blocking=True)
    return out.div_(axis.size) if mean else out


def exchange(pieces: Sequence[torch.Tensor], recv_shapes: Sequence[tuple], axis: Axis) -> list[torch.Tensor]:
    """All-to-all: `pieces[r]` goes to rank r, and the piece rank r sends
    here arrives shaped `recv_shapes[r]` (any of them empty); every piece of
    one dtype. One `all_to_all_single` of bytes."""
    dtype, device = pieces[0].dtype, pieces[0].device
    size = pieces[0].element_size()
    send = torch.cat([_bytes(p) for p in pieces])
    recv_counts = [size * int(torch.Size(s).numel()) for s in recv_shapes]
    if _staged(axis, send):
        send = _host_copy(send)
    out = torch.empty(sum(recv_counts), dtype=torch.uint8, device=send.device)
    dist.all_to_all_single(out, send, recv_counts, [p.numel() * size for p in pieces], group=_group(axis))
    if out.device != device:
        out = out.to(device, non_blocking=True)
    return [b.view(dtype).reshape(s) for b, s in zip(out.split(recv_counts), recv_shapes)]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x.movedim(dim, 0), axis).movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.axis.size, ctx.dim)[ctx.axis.rank], None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.axis), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_sum(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.axis), None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, recv_shapes, *pieces):
        ctx.axis, ctx.send_shapes, ctx.recv_shapes = axis, [p.shape for p in pieces], recv_shapes
        return tuple(exchange(pieces, recv_shapes, axis))

    @staticmethod
    def backward(ctx, *grads):
        like = next(g for g in grads if g is not None)
        grads = [g if g is not None else like.new_zeros(s) for g, s in zip(grads, ctx.recv_shapes)]
        return (None, None, *exchange(grads, ctx.send_shapes, ctx.axis))


def gather_along(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every rank's `x` (one shape on all) joined along `dim` in rank order;
    the gradient of this rank's slice is its part of the output's gradient."""
    return x if axis.size == 1 else _Gather.apply(x, axis, dim)


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """`x`, whose gradient is summed over `axis` (each rank's is partial)."""
    return x if axis.size == 1 else _Copy.apply(x, axis)


def sum_over(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of every rank's `x` over `axis`, differentiable."""
    return x if axis.size == 1 else _Sum.apply(x, axis)


def frames_to_tokens(x: torch.Tensor, frames: FrameShard) -> torch.Tensor:
    """(B, F_local, S, C), this rank's frames, to (B, F, S_local, C), every
    frame of this rank's run of tokens (`split_sizes` of S over the ranks)."""
    b, f_loc, s, c = x.shape
    tokens = split_sizes(s, frames.axis.size)
    r = frames.axis.rank
    pieces = list(x.split(tokens, dim=2))
    recv = [(b, n, tokens[r], c) for n in frames.sizes]
    return torch.cat(_Exchange.apply(frames.axis, recv, *pieces), dim=1)


def tokens_to_frames(x: torch.Tensor, frames: FrameShard, seq: int) -> torch.Tensor:
    """The inverse of `frames_to_tokens`: (B, F, S_local, C) to (B, F_local, S, C)."""
    b, _, _, c = x.shape
    tokens = split_sizes(seq, frames.axis.size)
    pieces = list(x.split(frames.sizes, dim=1))
    recv = [(b, frames.count, n, c) for n in tokens]
    return torch.cat(_Exchange.apply(frames.axis, recv, *pieces), dim=2)


def halo(x: torch.Tensor, frames: FrameShard, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(the previous rank's last frame, the next rank's first frame) of `x`,
    this rank's frames along `dim`, each one frame wide; zeros where this
    rank holds the clip's first or last frame."""
    r, size = frames.axis.rank, frames.axis.size
    one, none = list(x.shape), list(x.shape)
    one[dim], none[dim] = 1, 0
    pieces = [x.new_empty(none)] * size
    recv = [tuple(none)] * size
    if r > 0:
        pieces[r - 1], recv[r - 1] = x.narrow(dim, 0, 1), tuple(one)
    if r < size - 1:
        pieces[r + 1], recv[r + 1] = x.narrow(dim, x.shape[dim] - 1, 1), tuple(one)
    got = _Exchange.apply(frames.axis, recv, *pieces)
    prev = got[r - 1] if r > 0 else x.new_zeros(one)
    nxt = got[r + 1] if r < size - 1 else x.new_zeros(one)
    return prev, nxt
