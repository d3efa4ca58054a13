"""Tensor-parallel weights: column parallelism over the model ranks (the
layout of the JAX package's `evoworld_tpu/parallel/mesh.py::shard_params_tp`,
whose collectives GSPMD inserts).

`column_parallel_(module, split, axis)` keeps, on each model rank, only its
run of output features of every weight that `split`
(`parallel/mesh.py::shard_params_tp`) splits: the rank's slice of dim 0,
whatever the parameter's dtype (the fp32 masters of trainable weights and
the compute-dtype copies of frozen ones alike), so that its optimizer
moments and gradients are slices too. Each such `nn.Linear`, `nn.Conv2d`
or `nn.Conv3d` then computes its slice of the output features and an
all-gather over the model ranks joins the slices before anything reads
them; that is exact wherever a slice cuts, across a head (to_q at 5 x 64
over 2 ranks) or across GEGLU's two halves. The layer's input goes through
`copy_to`, whose backward sums the input's gradient over the model ranks
(each rank's is partial: its slice of features only). A bias is 1-D and
replicated, added after the gather.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from evoworld_tpu_torch.parallel.collectives import copy_to, gather_along
from evoworld_tpu_torch.parallel.mesh import Axis


class ColumnParallelLinear(nn.Linear):
    """nn.Linear holding its slice of output features; output whole."""

    tp_axis: Axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gather_along(F.linear(copy_to(x, self.tp_axis), self.weight), self.tp_axis, -1)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class ColumnParallelConv2d(nn.Conv2d):
    """nn.Conv2d holding its slice of output channels; output whole."""

    tp_axis: Axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gather_along(self._conv_forward(copy_to(x, self.tp_axis), self.weight, None), self.tp_axis, 1)
        return y if self.bias is None else y + self.bias.to(y.dtype).view(1, -1, 1, 1)


class ColumnParallelConv3d(nn.Conv3d):
    """nn.Conv3d holding its slice of output channels; output whole."""

    tp_axis: Axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gather_along(self._conv_forward(copy_to(x, self.tp_axis), self.weight, None), self.tp_axis, 1)
        return y if self.bias is None else y + self.bias.to(y.dtype).view(1, -1, 1, 1, 1)


_COLUMN_PARALLEL = {nn.Linear: ColumnParallelLinear, nn.Conv2d: ColumnParallelConv2d, nn.Conv3d: ColumnParallelConv3d}


def column_parallel_(module: nn.Module, split: Mapping[str, Optional[int]], axis: Axis) -> nn.Module:
    """In place: every parameter that `split` splits (on dim 0) keeps this
    rank's slice of `axis` only, and its layer becomes column parallel.
    Refuses a split parameter that is not the weight of a Linear or Conv.
    Returns `module`."""
    if axis.size == 1:
        return module
    for name, dim in split.items():
        if dim is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        if leaf != "weight" or type(owner) not in _COLUMN_PARALLEL or dim != 0:
            raise ValueError(f"{name} ({type(owner).__name__}.{leaf}, dim {dim}): only the output features of a "
                             "Linear or Conv weight split")
        p = getattr(owner, leaf)
        p.data = p.data.chunk(axis.size, dim)[axis.rank].clone()
        owner.__class__ = _COLUMN_PARALLEL[type(owner)]
        owner.tp_axis = axis
    return module
