"""The frame-sharded UNet layers and training step, on CPU ranks over gloo.

One spawn of W = 2 ranks (`parallel/launch.py`, `parallel.checks.several_rank`)
runs, in turn: each cross-frame layer over a frame shard of F = 5 frames
(3 + 2, uneven; `parallel.checks.frame_layer_rank`: a temporal ResNet, whose
GroupNorm statistics and (3, 1, 1) convolutions cross the shard, and a
spatio-temporal transformer, whose temporal block runs on token shards
after an all-to-all and whose frames take their global positional index),
forward and backward; then `train_step(..., mesh, shard_frames=True)` at
ZeRO-1 and ZeRO-2 with F = 4 and F = 5 (batch 1, the models of
`tests/test_torch_port_mesh_train.py`, the ZeRO rule from 1024 elements).
The parent meanwhile runs every layer and step in one process, and JAX's
`make_sharded_train_step(shard_frames=True)` at F = 5 on 2 CPU devices
(fp32, matmul precision "highest", JAX's draws).

Tolerances:
- layers: the ranks' outputs and input gradients joined over the frames,
  and their parameter gradients summed, against the one-process layer's:
  rtol 2e-5 / atol 1e-5 (fp32 sums in another order);
- the step against the one-process step: loss and gradient norm rtol
  1e-5; gradients within 1e-4 of each tensor's largest value plus 1e-6;
  updated masters atol 3e-7 (`tests/test_torch_port_mesh_train.py`'s);
- against JAX's frame-sharded step: loss 1e-5, gradient norm rtol 2e-3,
  masters atol 1e-6 (`tests/test_torch_port_train_step.py`'s).
A halo left out, GroupNorm statistics of the rank's frames alone, or
frame indices counted from the rank's first frame each move the layers'
outputs by a large share of their size.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.parallel.mesh import make_mesh as jmake_mesh
from evoworld_tpu.train import train_step as jts
from evoworld_tpu_torch.models.weights import params_from_jax
from evoworld_tpu_torch.parallel.checks import _frame_layer, frame_layer_rank, train_step_rank
from evoworld_tpu_torch.parallel.launch import Ranks
from tests.test_torch_port_mesh_train import GRAD_ATOL, GRAD_RTOL, MASTER_ATOL, MIN_SIZE, STEP_RTOL, _models
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tests.test_torch_port_train import jax_draws

H, W = 64, 128
FRAMES = (4, 5)
STEP = dict(total_steps=10, warmup_steps=0, learning_rate=1e-4, adam_eps=1e-4)
STEPS = [(f, stage) for f in FRAMES for stage in (1, 2)]
LAYER_RTOL, LAYER_ATOL = 2e-5, 1e-5


def _layer_cases():
    rng = np.random.default_rng(3)
    b, f = 2, 5

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return [("temporal_resnet", 1, {"x": normal(b, 64, f, 3, 4), "temb": normal(b, f, 16)}, normal(b, 64, f, 3, 4)),
            ("spatio_temporal", 2, {"x": normal(b, f, 32, 3, 4), "context": normal(b, 1, 2, 24)},
             normal(b, f, 32, 3, 4))]


def _batch(f):
    rng = np.random.default_rng(5 + f)
    return {"pixel_values": rng.uniform(-1, 1, (1, f, H, W, 3)).astype(np.float32),
            "memory_values": rng.uniform(-1, 1, (1, f, H, W, 3)).astype(np.float32),
            "plucker": rng.normal(size=(1, f, H // 8, W // 8, 6)).astype(np.float32)}


def _draws(f):
    return jax_draws(jax.random.key(10 + f), b=1, f=f, h=H, w=W)


def _jax_frame_step(jax_side, f):
    junet, jvae, jclip, uparams, frozen = jax_side
    cfg = jts.TrainConfig(**STEP)
    opt = jts.make_optimizer(cfg, uparams)
    state = jts.TrainState(jax.tree.map(jnp.asarray, uparams), opt.init(uparams), jnp.zeros((), jnp.int32))
    step = jts.make_sharded_train_step(junet, jvae, jclip, frozen, opt, cfg, jmake_mesh(jax.devices()[:2], data=2),
                                       compute_dtype=jnp.float32, shard_frames=True)
    with jax.default_matmul_precision("highest"):
        new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in _batch(f).items()}, jax.random.key(10 + f))
    return float(metrics["loss"]), float(metrics["grad_norm"]), params_from_jax(jax.tree.map(np.asarray,
                                                                                            new_state.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_side, port = _models()
    cases = _layer_cases()
    calls = [("frame_layer_rank", (cases,))]
    calls += [("train_step_rank", (port, dict(STEP, zero_stage=stage), [_batch(f)], [_draws(f)], MIN_SIZE, True))
              for f, stage in STEPS]
    job = Ranks("evoworld_tpu_torch.parallel.checks:several_rank", 2, str(tmp_path_factory.mktemp("frames")),
                device="cpu", args=(calls,))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # JAX compiles its frame-sharded step meanwhile
        jax_step = pool.submit(_jax_frame_step, jax_side, 5)
        one_layers = frame_layer_rank(None, cases)
        one = {f: train_step_rank(None, port, STEP, [_batch(f)], [_draws(f)], MIN_SIZE) for f in FRAMES}
        ranks = job.results()
        jax_step = jax_step.result()
    return dict(ranks=ranks, one=one, one_layers=one_layers, cases=cases, jax=jax_step)


@pytest.mark.parametrize("name", ["temporal_resnet", "spatio_temporal"])
def test_frame_sharded_layer_matches_the_one_process_layer(runs, name):
    index = [c[0] for c in runs["cases"]].index(name)
    _, seed, inputs, _ = runs["cases"][index]
    _, _, dims, out_dim = _frame_layer(name, seed)
    ranks = [r[0][name] for r in runs["ranks"]]
    y, in_grads, param_grads = runs["one_layers"][name]
    assert [r[0].shape[out_dim] for r in ranks] == [3, 2]  # 5 frames split unevenly
    np.testing.assert_allclose(torch.cat([r[0] for r in ranks], out_dim).numpy(), y.numpy(),
                               rtol=LAYER_RTOL, atol=LAYER_ATOL)
    for k, g in in_grads.items():
        got = torch.cat([r[1][k] for r in ranks], dims[k]) if dims[k] is not None else sum(r[1][k] for r in ranks)
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=LAYER_RTOL, atol=LAYER_ATOL, err_msg=k)
    for n, g in param_grads.items():
        np.testing.assert_allclose(sum(r[2][n] for r in ranks).numpy(), g.numpy(), rtol=LAYER_RTOL,
                                   atol=LAYER_ATOL, err_msg=n)


@pytest.mark.parametrize("f, stage", STEPS)
def test_frame_sharded_step_matches_the_one_process_step(runs, f, stage):
    i = 1 + STEPS.index((f, stage))
    one = runs["one"][f]
    ranks = [r[i] for r in runs["ranks"]]
    if stage >= 2:  # the pieces, not the whole gradients, reach the optimizer
        assert ranks[0]["sharded"] and ranks[0]["grads"][ranks[0]["sharded"][0]].shape[0] * 2 == \
            one["params"][ranks[0]["sharded"][0]].shape[0]
    for res in ranks:
        np.testing.assert_allclose(res["loss"], one["loss"], rtol=STEP_RTOL)
        np.testing.assert_allclose(res["grad_norm"], one["grad_norm"], rtol=STEP_RTOL)
        for name, p in one["params"].items():
            np.testing.assert_allclose(res["params"][name].numpy(), p.numpy(), rtol=0, atol=MASTER_ATOL, err_msg=name)
    for name, g in one["grads"].items():
        pieces = [r["grads"][name] for r in ranks]
        got = torch.cat(pieces) if stage >= 2 and name in ranks[0]["sharded"] else pieces[0]
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=0, atol=GRAD_ATOL + GRAD_RTOL * float(g.abs().max()),
                                   err_msg=name)


def test_frame_sharded_step_matches_jax(runs):
    loss, grad_norm, want = runs["jax"]
    for r in runs["ranks"]:
        res = r[1 + STEPS.index((5, 1))]
        np.testing.assert_allclose(res["loss"], loss, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["grad_norm"], grad_norm, rtol=2e-3)
        for name, p in res["params"].items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
