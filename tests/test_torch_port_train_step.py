"""One training step of the PyTorch port with gradient accumulation against JAX's step.

Two micro-batches through `evoworld_tpu.train.train_step.make_sharded_train_step`
(accum_steps=2, fp32, matmul precision "highest") and through the port's
`train_step`, with the same tiny models and weights and the same random
draws (each micro-batch's key split from the step's as the JAX step splits
it): mean loss 1e-5, gradient norm rtol 2e-3, updated parameters 1e-6 after
clipping, AdamW and the schedule. Adam's eps is 1e-4 here: its first update
is g / (|g| + eps), whose slope 1 / eps at g = 0 would turn the two
frameworks' ~1e-9 differences in near-zero gradients into 10% of a step. The helpers are those of
tests/test_torch_port_train.py; the files are apart so that each runs near a
minute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from evoworld_tpu.train import train_step as jts
from evoworld_tpu_torch.models.weights import params_from_jax
from evoworld_tpu_torch.train import train_step as tts
from tests.test_torch_port_train import RTOL, _batch, _torch, jax_draws, jax_models
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def test_train_step_with_accumulation_matches_jax_step():
    (junet, jvae, jclip, uparams, frozen), port = jax_models()
    cfg = dict(total_steps=10, warmup_steps=0, learning_rate=1e-4, adam_eps=1e-4)
    jcfg = jts.TrainConfig(**cfg)
    micro = [_batch(5), _batch(6)]
    step_rng = jax.random.key(9)
    keys = jax.random.split(step_rng, 2)
    opt = jts.make_optimizer(jcfg, uparams)
    state = jts.TrainState(jax.tree.map(jnp.asarray, uparams), opt.init(uparams), jnp.zeros((), jnp.int32))
    step = jts.make_sharded_train_step(junet, jvae, jclip, frozen, opt, jcfg, compute_dtype=jnp.float32,
                                       accum_steps=2)
    stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in micro]) for k in micro[0]}
    with jax.default_matmul_precision("highest"):
        new_state, metrics = step(state, stacked, step_rng)
    want = params_from_jax(jax.tree.map(np.asarray, new_state.params))

    unet, vae, clip = port()
    tstate = tts.make_train_state(tts.TrainConfig(**cfg), unet, torch.float32)
    got = tts.train_step(tstate, vae, clip, [_torch(m) for m in micro], tts.TrainConfig(**cfg), torch.float32,
                         draws=[_torch(jax_draws(k)) for k in keys])
    assert tstate.step == 1
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(metrics["grad_norm"]), rtol=RTOL)
    init = params_from_jax(jax.tree.map(np.asarray, uparams))
    mask = tts.trainable_mask(unet)
    for name, p in unet.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
        assert torch.equal(p, init[name]) != mask[name], name  # trainable leaves moved, frozen ones did not
    assert tstate.optimizer.param_groups[0]["count"] == 1
