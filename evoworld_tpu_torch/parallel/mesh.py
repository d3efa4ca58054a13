"""The ranks of a multi-GPU run (counterpart of `evoworld_tpu/parallel/mesh.py`).

The JAX package runs one controller over a device mesh and lets GSPMD place
the collectives; the port runs one process per rank (`torchrun`, or
`parallel/launch.py`) and names its collectives (`parallel/collectives.py`).
What carries over is the meaning: a sharded run returns what the unsharded
run returns, every rank holding the whole result.

`init_distributed` brings the process group up; `make_mesh(data, model)`
describes the world as the JAX package's mesh does (`data` 0 or None: every
rank on the data axis). Every serving route of the JAX package flattens the
two axes, and so does the port: a `Mesh` of data x model ranks shards over
all of them.

The backend follows the devices, never an error: NCCL when every rank of a
host has a card of its own, gloo when ranks share a card (NCCL refuses two
ranks on one device) or run on the CPU. Gloo takes CUDA tensors only for
broadcast and all-reduce, so `parallel/collectives.py` stages its
all-gathers and ring exchanges through pinned host memory there.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """data x model ranks of the default process group; this process is `rank` on `device`."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        return self.data * self.model


def backend_for(device: torch.device, local_world_size: int) -> str:
    """NCCL when each of the host's ranks has a CUDA device of its own, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def rank_device(device: str | torch.device, local_rank: int) -> torch.device:
    """This rank's device: `cuda:local_rank % device_count` for CUDA (raising
    where there is no card: a rank never carries on on the CPU), else the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run the ranks on the CPU explicitly")
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    if dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}")
    return dev


def init_distributed(
    device: str | torch.device = "cuda",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    local_world_size: Optional[int] = None,
) -> torch.device:
    """Bring up the default process group; returns this rank's device.

    Under `torchrun` every argument comes from the environment (`env://`,
    WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE); a caller that spawns
    its own ranks passes them (e.g. `init_method="file://<path>"`). The
    backend is `backend_for` this rank's device and the host's rank count.
    A group that does not come up raises: nothing runs unsharded instead.
    """
    env = os.environ
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env["RANK"]) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size)) if local_world_size is None else local_world_size
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(dev, local_world_size)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank)
    return dev


def make_mesh(device: str | torch.device, data: Optional[int] = None, model: int = 1) -> Mesh:
    """The data x model mesh over the process group's ranks (`data` 0 or
    None: the world over `model`), this rank on `device`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    model = model or 1
    if not data:
        data = world // model
    if data * model != world:
        raise ValueError(f"a {data}x{model} mesh over {world} ranks")
    rank = dist.get_rank() if dist.is_initialized() else 0
    backend = dist.get_backend() if dist.is_initialized() else "none"
    return Mesh(data, model, rank, torch.device(device), backend)


def shard_bounds(n: int, mesh: Mesh) -> tuple[int, int, int]:
    """(start, stop, per-rank count) of this rank's contiguous share of `n`
    items, `n` padded up to a multiple of the mesh size (stop may pass `n`)."""
    per = -(-n // mesh.size)
    return mesh.rank * per, (mesh.rank + 1) * per, per


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's share of the leading axis, padded by repeating the last
    row up to a multiple of the mesh size (the JAX `P("data")` batch spec)."""
    start, stop, _ = shard_bounds(x.shape[0], mesh)
    if stop > x.shape[0]:
        x = torch.cat([x, x[-1:].expand(stop - x.shape[0], *x.shape[1:])])
    return x[start:stop]

