"""Tensor-parallel training on a 2 x 2 (data x model) mesh of CPU ranks over gloo.

- The rule: `parallel/mesh.py::shard_params_tp` on the tiny UNet of
  `tests/test_torch_port_mesh_train.py` against the JAX package's
  `shard_params_tp` on the same UNet's Flax parameters (4 CPU devices, a
  model axis of 2, 1024 elements, the multichip dry run's threshold): the
  same tensors split, and each on the torch dim that
  `models/weights.py::params_from_jax` maps Flax's last kernel dim to
  (each Flax kernel marked along its last dim, then converted).
- The step: one spawn of 4 ranks (`parallel/launch.py`, model-fastest, as
  the JAX mesh's devices; `parallel.checks.several_rank`) runs
  `train_step(..., mesh)` at ZeRO-1 and ZeRO-2 with the rule from 1024
  elements on a global batch of 2 (a row a data rank), against the same
  step in one process: loss and gradient norm rtol 1e-5; gradients within
  1e-4 of each tensor's largest value plus 1e-6, and updated masters atol
  3e-7, each split tensor joined over its model ranks
  (`tests/test_torch_port_mesh_train.py`'s tolerances). A model rank holds
  only its slice of each split tensor, frozen copies, masters and moments
  alike, and the ZeRO rule then splits the slices over the data ranks.
  An input gradient not summed over the model ranks moves every gradient
  upstream of a split layer by a large share of its size.
"""

import jax
import numpy as np
import pytest
import torch

from evoworld_tpu.parallel.mesh import make_mesh as jmake_mesh
from evoworld_tpu.parallel.mesh import shard_params_tp as jshard_params_tp
from evoworld_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporal
from evoworld_tpu_torch.models.weights import params_from_jax
from evoworld_tpu_torch.parallel.checks import train_step_rank
from evoworld_tpu_torch.parallel.launch import Ranks
from evoworld_tpu_torch.parallel.mesh import Mesh, shard_params_tp, zero_sharded
from tests.test_torch_port_mesh_train import (GRAD_ATOL, GRAD_RTOL, MASTER_ATOL, MIN_SIZE, STEP, STEP_RTOL, UNET,
                                              _global_batch, _models)
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tests.test_torch_port_train import jax_draws

DATA, MODEL = 2, 2
TP_MIN = 1 << 10


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _, port = _models()
    batch = _global_batch()
    draws = jax_draws(jax.random.key(9), b=2, f=2, h=64, w=128)
    calls = [("train_step_rank", (port, dict(STEP, zero_stage=stage), [batch], [draws], MIN_SIZE, False, TP_MIN))
             for stage in (1, 2)]
    job = Ranks("evoworld_tpu_torch.parallel.checks:several_rank", DATA * MODEL, str(tmp_path_factory.mktemp("tp")),
                device="cpu", args=(calls,), mesh_model=MODEL)
    one = train_step_rank(None, port, STEP, [batch], [draws], MIN_SIZE)
    return dict(ranks=job.results(), one=one)


def test_the_rule_splits_what_the_jax_rule_splits_on_flax_last_dim():
    jax_side, _ = _models()
    uparams = jax_side[3]
    specs = jshard_params_tp(uparams, jmake_mesh(jax.devices()[:DATA * MODEL], model=MODEL), min_size=TP_MIN)

    def mark(leaf, sharding):  # 1 + the index along Flax's last dim where the JAX rule splits, else 0
        spec = tuple(sharding.spec)
        if spec and spec[-1] == "model":
            return np.broadcast_to(1 + np.arange(leaf.shape[-1], dtype=np.float32), leaf.shape).copy()
        return np.zeros(leaf.shape, np.float32)

    marked = params_from_jax(jax.tree.map(mark, uparams, specs))
    rule = shard_params_tp(UNetSpatioTemporal(UNetConfig(**UNET)), Mesh(DATA, MODEL, 0, torch.device("cpu"), "gloo"),
                           TP_MIN)
    assert set(marked) == set(rule)
    split = [n for n, d in rule.items() if d is not None]
    assert split and len(split) < len(rule)  # the rule splits some tensors and replicates others
    for name, t in marked.items():
        if rule[name] is None:
            assert not t.any(), name
        else:
            assert rule[name] == 0
            index = torch.arange(1, t.shape[0] + 1, dtype=t.dtype).view(-1, *[1] * (t.dim() - 1))
            assert torch.equal(t, index.expand_as(t)), name


def _joined(ranks, stage, kind, name, data_rank):
    """A tensor of data rank `data_rank`'s model ranks, joined: a split
    slice over the model ranks (at ZeRO-2 a sharded gradient's pieces over
    the data ranks first), else the model rank 0's."""
    res = [r[stage - 1] for r in ranks]

    def piece(j):
        if kind == "grads" and stage >= 2 and name in res[0]["sharded"]:
            return torch.cat([res[d * MODEL + j][kind][name] for d in range(DATA)])
        return res[data_rank * MODEL + j][kind][name]

    if name in res[0]["split"]:
        return torch.cat([piece(j) for j in range(MODEL)])
    return piece(0)


@pytest.mark.parametrize("stage", [1, 2])
def test_tensor_parallel_step_matches_the_one_process_step(runs, stage):
    ranks, one = runs["ranks"], runs["one"]
    assert ranks[0][stage - 1]["split"]
    for r in ranks:
        np.testing.assert_allclose(r[stage - 1]["loss"], one["loss"], rtol=STEP_RTOL)
        np.testing.assert_allclose(r[stage - 1]["grad_norm"], one["grad_norm"], rtol=STEP_RTOL)
    for d in range(DATA):
        for name, p in one["params"].items():
            np.testing.assert_allclose(_joined(ranks, stage, "params", name, d).numpy(), p.numpy(), rtol=0,
                                       atol=MASTER_ATOL, err_msg=name)
    for name, g in one["grads"].items():
        np.testing.assert_allclose(_joined(ranks, stage, "grads", name, 0).numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_ATOL + GRAD_RTOL * float(g.abs().max()), err_msg=name)


def test_a_model_rank_stores_only_its_slices(runs):
    ranks, one = runs["ranks"], runs["one"]
    whole = dict(UNetSpatioTemporal(UNetConfig(**UNET)).named_parameters())
    res = ranks[1][0]
    split = set(res["split"])
    trainable_split = split & set(one["params"])
    assert trainable_split and split - trainable_split  # trainable masters and frozen copies both split
    mesh = Mesh(DATA, MODEL, 1, torch.device("cpu"), "gloo")
    for name, p in whole.items():
        want = (p.shape[0] // MODEL, *p.shape[1:]) if name in split else tuple(p.shape)
        assert res["stored"][name] == want, name
        if name in one["params"]:  # a trainable tensor's moments: its ZeRO piece of what the rank stores
            local = torch.empty(want)
            rows = want[0] // DATA if zero_sharded(local, mesh, MIN_SIZE) else want[0]
            assert res["moments"][name] == (rows, *want[1:]), name
