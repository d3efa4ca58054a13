"""One tiny training step of the port at compute dtype fp16 against the
JAX package's step at fp16 and at fp32, on the CPU, under the rule and
tolerances of `test_torch_port_fp16.py` (the loss and the trainable
gradients' global norm; the models there cut to one layer per block).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch

from evoworld_tpu.models.clip import CLIPVisionConfig as JClipCfg
from evoworld_tpu.models.clip import CLIPVisionTower as JClip
from evoworld_tpu.models.unet import UNetConfig as JUNetCfg
from evoworld_tpu.models.unet import UNetSpatioTemporal as JUNet
from evoworld_tpu.models.vae import AutoencoderKLTemporal as JVAE
from evoworld_tpu.models.vae import VAEConfig as JVAECfg
from evoworld_tpu.models.weights import host_random_params
from evoworld_tpu.train import train_step as jts
from evoworld_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower
from evoworld_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporal
from evoworld_tpu_torch.models.vae import AutoencoderKLTemporal, VAEConfig
from evoworld_tpu_torch.models.weights import params_from_jax
from evoworld_tpu_torch.train import train_step as tts
from tests.test_torch_port_fp16 import MICRO_CLIP, MICRO_UNET, MICRO_VAE, STEP_TOL, _f16_values, assert_fp16_rule, rel_err
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tests.test_torch_port_train import _torch, jax_draws

B, F, H, W = 1, 2, 64, 128


def _train_batch(seed):
    rng = np.random.default_rng(seed)
    return {"pixel_values": rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
            "memory_values": rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
            "plucker": rng.normal(size=(B, F, H // 8, W // 8, 6)).astype(np.float32)}


def test_tiny_training_step_fp16_against_jax():
    """The loss and the trainable gradients' global norm of one step at
    compute dtype fp16 (fp32 masters, fp16 frozen leaves, fp16 autocast)
    against JAX's step at fp16 and at fp32 on the same values and draws."""
    key = jax.random.key(0)
    junet, jvae, jclip = JUNet(JUNetCfg(**MICRO_UNET)), JVAE(JVAECfg(**MICRO_VAE)), JClip(JClipCfg(**MICRO_CLIP))
    shapes = jax.eval_shape(junet.init, key, jnp.zeros((1, F, H // 8, W // 8, 18)), jnp.asarray(1.0),
                            jnp.zeros((1, 1, 1024)), jnp.zeros((1, 3)))
    rng = np.random.default_rng(11)
    uparams = _f16_values(jax.tree.map(lambda x: x + 0.02 * rng.normal(size=x.shape),
                                       host_random_params(shapes, 0, jnp.float32, as_numpy=True)))
    frozen = _f16_values({
        "vae": host_random_params(jax.eval_shape(functools.partial(jvae.init, num_frames=1), key,
                                                 jnp.zeros((1, H, W, 3))), 1, jnp.float32),
        "clip": host_random_params(jax.eval_shape(jclip.init, key, jnp.zeros((1, 224, 224, 3))), 2, jnp.float32),
    })
    cfg = dict(total_steps=10, warmup_steps=0, learning_rate=1e-4)
    batch, step_key = _train_batch(5), jax.random.key(9)

    def jax_step(dtype, batch_):
        jcfg = jts.TrainConfig(**cfg)
        opt = jts.make_optimizer(jcfg, uparams)
        state = jts.TrainState(jax.tree.map(jnp.asarray, uparams), opt.init(uparams), jnp.zeros((), jnp.int32))
        frozen_d = jax.tree.map(lambda x: jnp.asarray(x, dtype), frozen)
        step = jts.make_sharded_train_step(junet, jvae, jclip, frozen_d, opt, jcfg, compute_dtype=dtype,
                                           compiler_options={"xla_backend_optimization_level": 0})
        with jax.default_matmul_precision("highest"):
            _, metrics = step(state, jax.tree.map(jnp.asarray, batch_), step_key)
        return np.array([float(metrics["loss"]), float(metrics["grad_norm"])])

    def port_step(batch_):
        tunet = UNetSpatioTemporal(UNetConfig(**MICRO_UNET))
        tunet.load_state_dict(params_from_jax(uparams), strict=True)
        tvae = AutoencoderKLTemporal(VAEConfig(**MICRO_VAE))
        tvae.load_state_dict(params_from_jax(frozen["vae"]), strict=True)
        tclip = CLIPVisionTower(CLIPVisionConfig(**MICRO_CLIP))
        tclip.load_state_dict(params_from_jax(frozen["clip"]), strict=True)
        tunet = tts.freeze_master_cast(tunet, torch.float16)
        state = tts.make_train_state(tts.TrainConfig(**cfg), tunet, torch.float16)
        out = tts.train_step(state, tvae.half().requires_grad_(False), tclip.half().requires_grad_(False),
                             [_torch(batch_)], tts.TrainConfig(**cfg), torch.float16,
                             draws=[_torch(jax_draws(step_key))])
        return np.array([out["loss"], out["grad_norm"]])

    got = port_step(batch)
    # The two JAX steps trace and compile in two threads: XLA's compile
    # releases the interpreter lock, so they overlap.
    with ThreadPoolExecutor(2) as pool:
        want16, want32 = pool.map(lambda dtype: jax_step(dtype, batch), (jnp.float16, jnp.float32))
    assert_fp16_rule(got, want16, want32, STEP_TOL, "loss, grad_norm")
    moved = port_step({**batch, "pixel_values": -batch["pixel_values"]})
    assert rel_err(moved, got) > 10 * STEP_TOL[1]


