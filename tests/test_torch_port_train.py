"""Parity of the PyTorch port's training step with `evoworld_tpu/train/train_step.py`.

Tiny models (the widths of tests/test_trainer_loop.py) with Flax weights
carried across by `params_from_jax`; fp32 on both sides, JAX at matmul
precision "highest". Every random draw of the JAX loss is made with
`jax.random` exactly as `edm_loss` makes it and handed to the port's
`edm_loss` as its `draws`. Tolerances: loss 1e-5; trainable gradients rtol
2e-3 / atol 5e-4 (as the model tests); the optimizer against optax 1e-6;
the learning-rate schedule rtol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from evoworld_tpu.diffusion import scheduler as jsched
from evoworld_tpu.models.clip import CLIPVisionConfig as JClipCfg
from evoworld_tpu.models.clip import CLIPVisionTower as JClip
from evoworld_tpu.models.unet import UNetConfig as JUNetCfg
from evoworld_tpu.models.unet import UNetSpatioTemporal as JUNet
from evoworld_tpu.models.vae import AutoencoderKLTemporal as JVAE
from evoworld_tpu.models.vae import VAEConfig as JVAECfg
from evoworld_tpu.models.weights import host_random_params
from evoworld_tpu.train import train_step as jts
from evoworld_tpu_torch.diffusion import scheduler as tsched
from evoworld_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower
from evoworld_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporal
from evoworld_tpu_torch.models.vae import AutoencoderKLTemporal, VAEConfig
from evoworld_tpu_torch.models.weights import params_from_jax
from evoworld_tpu_torch.train import train_step as tts
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TINY_UNET = dict(block_out_channels=(32, 64, 128, 128), num_attention_heads=(2, 4, 8, 8))
TINY_VAE = dict(block_out_channels=(32, 64, 128, 128))
TINY_CLIP = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128)
B, F, H, W = 1, 2, 64, 128
RTOL, ATOL = 2e-3, 5e-4


def jax_draws(key, b=B, f=F, h=H, w=W) -> dict:
    """The draws of `evoworld_tpu.train.train_step.edm_loss` for `key`, as numpy."""
    r_lat, r_noise, r_csig, r_cnoise, r_sig, r_drop, r_clipz = jax.random.split(key, 7)
    lh, lw = h // 8, w // 8
    normal = lambda k, s: np.asarray(jax.random.normal(k, s, jnp.float32))  # noqa: E731
    return {
        "latent_eps": normal(r_lat, (b * f, lh, lw, 4)),
        "noise": normal(r_noise, (b, f, lh, lw, 4)),
        "cond_sigma_eps": normal(r_csig, (b,)),
        "cond_noise": normal(r_cnoise, (b, 1 + f, h, w, 3)),
        "sigma_eps": normal(r_sig, (b,)),
        "drop": np.asarray(jax.random.uniform(r_drop, (b,))),
        "cond_latent_eps": normal(r_clipz, (b * (1 + f), lh, lw, 4)),
    }


def _torch(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "pixel_values": rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
        "memory_values": rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
        "plucker": rng.normal(size=(B, F, H // 8, W // 8, 6)).astype(np.float32),
    }


def jax_models():
    """Tiny JAX modules with host-random params (`host_random_params`, every
    UNet leaf then perturbed so neutral values hide no wrong mapping), and a
    function making the port's modules with the same weights."""
    key = jax.random.key(0)
    junet, jvae, jclip = JUNet(JUNetCfg(**TINY_UNET)), JVAE(JVAECfg(**TINY_VAE)), JClip(JClipCfg(**TINY_CLIP))
    shapes = jax.eval_shape(junet.init, key, jnp.zeros((1, F, H // 8, W // 8, 18)), jnp.asarray(1.0),
                            jnp.zeros((1, 1, 1024)), jnp.zeros((1, 3)))
    rng = np.random.default_rng(11)
    uparams = jax.tree.map(lambda x: x + 0.02 * rng.normal(size=x.shape).astype(np.float32),
                           host_random_params(shapes, 0, jnp.float32, as_numpy=True))
    frozen = {
        "vae": host_random_params(jax.eval_shape(functools.partial(jvae.init, num_frames=1), key,
                                                 jnp.zeros((1, H, W, 3))), 1, jnp.float32),
        "clip": host_random_params(jax.eval_shape(jclip.init, key, jnp.zeros((1, 224, 224, 3))), 2, jnp.float32),
    }

    def port():
        unet = UNetSpatioTemporal(UNetConfig(**TINY_UNET))
        unet.load_state_dict(params_from_jax(uparams), strict=True)
        vae = AutoencoderKLTemporal(VAEConfig(**TINY_VAE))
        vae.load_state_dict(params_from_jax(jax.tree.map(np.asarray, frozen["vae"])), strict=True)
        clip = CLIPVisionTower(CLIPVisionConfig(**TINY_CLIP))
        clip.load_state_dict(params_from_jax(jax.tree.map(np.asarray, frozen["clip"])), strict=True)
        return tts.freeze_master_cast(unet, torch.float32), vae.requires_grad_(False), clip.requires_grad_(False)

    return (junet, jvae, jclip, uparams, frozen), port


@pytest.fixture(scope="module")
def models():
    return jax_models()


def test_trainable_mask_selects_the_images_of_jax_trainable_leaves(models):
    (_, _, _, uparams, _), port = models
    jmask = params_from_jax(jax.tree.map(lambda p, m: np.full(p.shape, m, np.float32), uparams,
                                         jts.trainable_mask(uparams)))
    want = {name for name, m in jmask.items() if m.flatten()[0]}
    got = tts.trainable_mask(port()[0])
    assert set(got) == set(jmask)
    assert {name for name, m in got.items() if m} == want
    assert "down_blocks.0.attentions.0.transformer_blocks.0.norm1.weight" in want
    assert "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight" not in want


def test_freeze_master_cast_dtypes(models):
    unet = tts.freeze_master_cast(models[1]()[0], torch.bfloat16)
    mask = tts.trainable_mask(unet)
    for name, p in unet.named_parameters():
        assert (p.dtype, p.requires_grad) == ((torch.float32, True) if mask[name] else (torch.bfloat16, False))


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedule_matches_optax(schedule):
    cfg = dict(learning_rate=3e-4, warmup_steps=5, total_steps=40, lr_schedule=schedule)
    want = jts.make_lr_schedule(jts.TrainConfig(**cfg))
    got = tts.make_lr_schedule(tts.TrainConfig(**cfg))
    for count in (0, 1, 3, 5, 6, 20, 40, 45):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_grad_norm", [1.0, 100.0])  # clipped, and not
def test_optimizer_matches_optax_chain(max_grad_norm):
    """clip_by_global_norm + adamw with a warmup-cosine schedule, three updates
    on a tiny tree, against the port's AdamW, to 1e-6."""
    rng = np.random.default_rng(5)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[3.0 * rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3)]
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10, max_grad_norm=max_grad_norm)
    jcfg, tcfg = jts.TrainConfig(**kw), tts.TrainConfig(**kw)
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     optax.adamw(jts.make_lr_schedule(jcfg), b1=jcfg.adam_b1, b2=jcfg.adam_b2,
                                 eps=jcfg.adam_eps, weight_decay=jcfg.weight_decay))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = tts.AdamW(tp, tts.make_lr_schedule(tcfg), tcfg.adam_b1, tcfg.adam_b2, tcfg.adam_eps,
                    tcfg.weight_decay, tcfg.max_grad_norm)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        for a, w in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_edm_helpers_match_jax():
    sigma = np.asarray([0.01, 0.5, 2.0, 80.0], np.float32)
    for got, want in zip(tsched.edm_precondition(torch.from_numpy(sigma)), jsched.edm_precondition(jnp.asarray(sigma))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(tsched.edm_loss_weight(torch.from_numpy(sigma)).numpy(),
                               np.asarray(jsched.edm_loss_weight(jnp.asarray(sigma))), rtol=1e-6)
    draw = tsched.rand_log_normal((20000,), 0.7, 1.6, torch.Generator().manual_seed(0))
    assert draw.dtype == torch.float32 and draw.min() > 0
    assert abs(draw.log().mean().item() - 0.7) < 0.05 and abs(draw.log().std().item() - 1.6) < 0.05


def test_edm_loss_and_gradients_match_jax(models):
    (junet, jvae, jclip, uparams, frozen), port = models
    cfg = dict(total_steps=10, warmup_steps=1, vae_encode_chunk=2)
    batch, key = _batch(3), jax.random.key(4)
    with jax.default_matmul_precision("highest"):
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jts.edm_loss(
            junet, jvae, jclip, p, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, key,
            jts.TrainConfig(**cfg), jnp.float32)))(uparams)
    want = params_from_jax(jax.tree.map(np.asarray, grads))
    unet, vae, clip = port()
    got = tts.edm_loss(unet, vae, clip, _torch(batch), tts.TrainConfig(**cfg), torch.float32,
                       draws=_torch(jax_draws(key)))
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5, atol=1e-5)
    got.backward()
    mask = tts.trainable_mask(unet)
    checked = 0
    for name, p in unet.named_parameters():
        if not mask[name]:
            assert p.grad is None
            continue
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        np.testing.assert_allclose(g, want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
        checked += 1
    assert checked == sum(mask.values())
    norm1 = unet.down_blocks[0].attentions[0].transformer_blocks[0].norm1.weight
    assert norm1.grad is not None and norm1.grad.abs().max() > 0


def test_unet_remat_keeps_outputs_and_gradients():
    """Block checkpointing recomputes the same forward: identical output and gradients."""
    torch.manual_seed(0)
    sample = torch.randn(1, F, 18, H // 8, W // 8)
    ctx, time_ids = torch.randn(1, 1, 1024), torch.tensor([[6.0, 127.0, 0.02]])
    results = []
    for remat in (False, True):
        torch.manual_seed(1)
        unet = tts.freeze_master_cast(UNetSpatioTemporal(UNetConfig(**TINY_UNET, remat=remat)), torch.float32)
        out = unet(sample, torch.tensor(0.3), ctx, time_ids)
        out.pow(2).mean().backward()
        results.append((out.detach(), {n: p.grad for n, p in unet.named_parameters() if p.grad is not None}))
    (out0, g0), (out1, g1) = results
    assert torch.equal(out0, out1) and g0.keys() == g1.keys() and len(g0) > 0
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-5, atol=1e-7)
