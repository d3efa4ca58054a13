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

The backend follows the devices, never an error: NCCL when no two ranks
hold the same physical card, gloo when ranks share one (NCCL refuses two
ranks on one device) or run on the CPU. The ranks tell their cards apart by
UUID, exchanged through the rendezvous store before the group comes up, so a
launcher that shows each rank one card (`CUDA_VISIBLE_DEVICES` per task)
gets NCCL too. Gloo takes CUDA tensors only for broadcast and all-reduce, so
`parallel/collectives.py` stages its other collectives through pinned host
memory there.

The training step's ZeRO rule (`zero_sharded`, the JAX package's
`zero_shard_specs`): a tensor of at least `min_size` elements whose dim 0
divides the data axis is split on dim 0 over the data ranks, every model
rank of a data rank holding the same piece; everything else is replicated.

The model-parallel half of training works on the mesh's two axes as groups
of ranks (`axes`: the data ranks of this rank's model index, the model
ranks of this rank's data index; `Axis`). Its rules:
  - `FrameShard`: the frames of a clip split over an axis in contiguous,
    possibly uneven runs (`split_sizes`: 13 + 12 for 25 frames over 2), the
    frame-sharded training step's layout (the JAX package constrains the
    frame axis to "data");
  - `shard_params_tp` (the JAX package's rule of the same name): a weight
    of at least `min_size` elements whose output features (torch's dim 0 of
    a Linear or Conv weight, Flax's last kernel dim) divide the model axis
    is split on them over the model ranks; everything else is replicated.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

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

    @property
    def data_rank(self) -> int:
        """This rank's place on the data axis (ranks run model-fastest, as the JAX mesh's devices)."""
        return self.rank // self.model


#: The JAX package's `zero_shard_specs` threshold: smaller tensors replicate.
ZERO_MIN_SIZE = 1 << 16
#: The JAX package's `shard_params_tp` threshold.
TP_MIN_SIZE = 1 << 16


@dataclasses.dataclass(frozen=True)
class Axis:
    """A group of `size` ranks that a collective runs over, this process
    `rank` among them; `group` is the process group (None: the default one)."""

    size: int
    rank: int
    backend: str
    group: object = None


_GROUPS: dict = {}  # (data, model) -> {("data", model index) | ("model", data index): process group}


def axes(mesh: Mesh) -> tuple[Axis, Axis]:
    """(the data axis, the model axis) of this rank: the data ranks that share
    its model index and the model ranks that share its data index. Where one
    axis is the whole world it runs on the default group and the other is
    this rank alone; otherwise every rank creates every group once, in the
    same order (the data groups, then the model groups), as
    `torch.distributed.new_group` asks."""
    d, m = mesh.data, mesh.model
    if m == 1 or d == 1:
        world, alone = Axis(mesh.size, mesh.rank, mesh.backend), Axis(1, 0, mesh.backend)
        return (world, alone) if m == 1 else (alone, world)
    if (d, m) not in _GROUPS:
        groups = {("data", j): dist.new_group([i * m + j for i in range(d)]) for j in range(m)}
        groups.update({("model", i): dist.new_group([i * m + j for j in range(m)]) for i in range(d)})
        _GROUPS[d, m] = groups
    groups = _GROUPS[d, m]
    model_rank = mesh.rank % m
    return (Axis(d, mesh.data_rank, mesh.backend, groups["data", model_rank]),
            Axis(m, model_rank, mesh.backend, groups["model", mesh.data_rank]))


def split_sizes(n: int, parts: int) -> list[int]:
    """`n` items in `parts` contiguous runs, the first `n % parts` one longer."""
    return [n // parts + (r < n % parts) for r in range(parts)]


@dataclasses.dataclass(frozen=True)
class FrameShard:
    """This rank's frames [start, stop) of `total`, split over `axis` by
    `split_sizes`; the spatio-temporal layers take it as `frames=`."""

    axis: Axis
    total: int

    def __post_init__(self):
        if self.total < self.axis.size:
            raise ValueError(f"{self.total} frames cannot be split over {self.axis.size} ranks")

    @property
    def sizes(self) -> list[int]:
        return split_sizes(self.total, self.axis.size)

    @property
    def start(self) -> int:
        return sum(self.sizes[:self.axis.rank])

    @property
    def stop(self) -> int:
        return self.start + self.sizes[self.axis.rank]

    @property
    def count(self) -> int:
        return self.sizes[self.axis.rank]


def shard_params_tp(module: torch.nn.Module, mesh: Optional[Mesh], min_size: int = TP_MIN_SIZE
                    ) -> dict[str, Optional[int]]:
    """{parameter name: the dim it splits on over the model ranks, or None}:
    dim 0 of a weight with at least two dims and `min_size` elements whose
    dim 0 the model axis divides (a Linear's or Conv's output features,
    `models/weights.py::params_from_jax`'s image of Flax's last kernel dim)."""
    m = mesh.model if mesh is not None else 1
    return {name: 0 if (m > 1 and p.dim() >= 2 and p.numel() >= min_size and p.shape[0] % m == 0) else None
            for name, p in module.named_parameters()}


def zero_sharded(x: torch.Tensor, mesh: Optional[Mesh], min_size: int = ZERO_MIN_SIZE) -> bool:
    """Whether the ZeRO rule splits `x` on dim 0 over the data ranks of `mesh`."""
    return (mesh is not None and mesh.data > 1 and x.dim() >= 1 and x.numel() >= min_size
            and x.shape[0] % mesh.data == 0)


def backend_for(device: torch.device, uuids: Sequence[str]) -> str:
    """NCCL when the ranks' CUDA devices (`uuids`, one a rank) are all different cards, else gloo."""
    if device.type == "cuda" and len(set(uuids)) == len(uuids):
        return "nccl"
    return "gloo"


def device_uuid(device: torch.device) -> str:
    """The physical card behind `device` (the same whatever the rank's `CUDA_VISIBLE_DEVICES`)."""
    return str(torch.cuda.get_device_properties(device).uuid)


def exchange(store, rank: int, world_size: int, value: str) -> list[str]:
    """Every rank's `value` in rank order, through the rendezvous `store`
    (each rank sets its own, then waits for the others')."""
    store.set(f"evoworld_device_uuid/{rank}", value)
    return [store.get(f"evoworld_device_uuid/{r}").decode() for r in range(world_size)]


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
) -> torch.device:
    """Bring up the default process group; returns this rank's device.

    Under `torchrun` every argument comes from the environment (`env://`,
    WORLD_SIZE, RANK, LOCAL_RANK); a caller that spawns its own ranks passes
    them (e.g. `init_method="file://<path>"`). The ranks meet at the
    rendezvous store first and swap their cards' UUIDs there; the backend is
    `backend_for` this rank's device and those UUIDs. A group that does not
    come up raises: nothing runs unsharded instead.
    """
    env = os.environ
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env["RANK"]) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    dev = rank_device(device, local_rank)
    store, rank, world_size = next(dist.rendezvous(init_method or "env://", rank, world_size))
    uuids = []
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        uuids = exchange(store, rank, world_size, device_uuid(dev))
    backend = backend_for(dev, uuids)
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg", store), world_size=world_size, rank=rank)
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


def shard_bounds(n: int, mesh: Mesh, over_data: bool = False) -> tuple[int, int, int]:
    """(start, stop, per-rank count) of this rank's contiguous share of `n`
    items, `n` padded up to a multiple of the mesh size (stop may pass `n`).
    `over_data`: the share of this rank's place on the data axis instead,
    which must divide `n` (model ranks take their data peer's share)."""
    ranks, rank = (mesh.data, mesh.data_rank) if over_data else (mesh.size, mesh.rank)
    if over_data and n % ranks:
        raise ValueError(f"{n} rows do not split over {ranks} data ranks")
    per = -(-n // ranks)
    return rank * per, (rank + 1) * per, per


def shard_batch(x: torch.Tensor, mesh: Mesh, over_data: bool = False) -> torch.Tensor:
    """This rank's share of the leading axis (`shard_bounds`), padded by
    repeating the last row up to a multiple of the mesh size (the JAX
    `P("data")` batch spec, as the render's poses are split). `over_data`:
    this data rank's rows, which the data axis must divide, as a view: a
    training batch's (model ranks taking their data peer's rows, as the JAX
    package's replicated params do) or a `zero_sharded` tensor's piece."""
    start, stop, _ = shard_bounds(x.shape[0], mesh, over_data)
    if stop > x.shape[0]:
        x = torch.cat([x, x[-1:].expand(stop - x.shape[0], *x.shape[1:])])
    return x[start:stop]
