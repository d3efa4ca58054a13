"""The collectives of the port's sharded paths, over the default process
group: `all_gather` (joined along the leading axis), `RingExchange` (send to
the next rank, receive from the previous), and the training step's
`all_reduce_mean` and `reduce_scatter_mean` (the mean over the ranks, whole
or this data rank's dim-0 piece of it).

On NCCL, CUDA tensors pass straight through. On gloo, which takes CUDA
tensors only for broadcast and all-reduce, a CUDA tensor is staged through
pinned host memory and the result copied back to its device. The gathers and
the ring move bytes, so any dtype goes (bf16 included); the reductions take
floating tensors. There is no fallback: a collective that fails raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from evoworld_tpu_torch.parallel.mesh import Mesh


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend != "nccl" and x.is_cuda


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _host_copy(x: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    return buf


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's `x` (one shape on all ranks), joined along dim 0 in rank order."""
    if mesh.size == 1:
        return x
    src = _host_copy(_bytes(x)) if _staged(mesh, x) else _bytes(x)
    out = torch.empty((mesh.size, src.numel()), dtype=torch.uint8, device=src.device)
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, src)
    else:
        dist.all_gather(list(out.unbind(0)), src)
    out = out.view(x.dtype).reshape(mesh.size * x.shape[0], *x.shape[1:])
    return out.to(x.device, non_blocking=True) if out.device != x.device else out


class RingExchange:
    """`x` sent to rank + 1 and the same shape received from rank - 1, begun
    at construction (the caller computes meanwhile) and finished by `wait()`."""

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



def all_reduce_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """In place: `x` becomes the mean of every rank's `x`; returns it. Model
    ranks hold their data peer's values, so this is the mean over the data
    axis too. Gloo sums CUDA tensors itself (through host memory)."""
    if mesh.size > 1:
        dist.all_reduce(x)
        x.div_(mesh.size)
    return x


def reduce_scatter_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This data rank's row of the mean of every rank's `x` (D, n), D the
    data axis: NCCL's reduce-scatter where every rank is a data rank. On
    gloo, which has no reduce-scatter of CUDA tensors, and where model ranks
    repeat a data rank, `x` is summed whole (staged through pinned host
    memory on gloo) and the row taken: the same values, D times the traffic."""
    if x.shape[0] != mesh.data:
        raise ValueError(f"reduce_scatter_mean takes ({mesh.data}, n) rows, got {tuple(x.shape)}")
    if mesh.size == 1:
        return x[0]
    if mesh.backend == "nccl" and mesh.model == 1:
        out = torch.empty_like(x[0])
        dist.reduce_scatter_tensor(out, x.contiguous())
        return out.div_(mesh.size)
    src = _host_copy(x) if _staged(mesh, x) else x.clone()
    dist.all_reduce(src)
    return src[mesh.data_rank].to(x.device, non_blocking=True).div_(mesh.size)
