"""Parity of the PyTorch port's layers and models with `evoworld_tpu`.

The same numpy-seeded inputs go through each Flax module (fp32, matmul
precision "highest") and its port (fp32, CPU), with the Flax weights carried
across by `evoworld_tpu_torch.models.weights.params_from_jax`. Tolerance
rtol 2e-3 / atol 5e-4, as in tests/test_torch_unet_parity.py. Layouts: the
JAX modules are channels-last, the port's channels-first.
"""

import jax
import numpy as np
import pytest
import torch

from evoworld_tpu.models import layers as jl
from evoworld_tpu.models.clip import CLIPVisionConfig as JClipCfg
from evoworld_tpu.models.clip import CLIPVisionTower as JClip
from evoworld_tpu.models.vae import AutoencoderKLTemporal as JVAE
from evoworld_tpu.models.vae import VAEAttention as JVAEAttention
from evoworld_tpu.models.vae import VAEConfig as JVAECfg
from evoworld_tpu.models.weights import host_random_params
from evoworld_tpu_torch.models import layers as tl
from evoworld_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower
from evoworld_tpu_torch.models.vae import AutoencoderKLTemporal, VAEAttention, VAEConfig
from evoworld_tpu_torch.models.weights import params_from_jax

RTOL, ATOL = 2e-3, 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread while a port module's tests run (the port's test
    files import this fixture). Under the tier-1 command six pytest workers
    share the host's cores, and torch's default of one thread a core
    oversubscribes them: two `tests/test_models.py` cases beside five port
    files took 468 s with the default and 215 s with one torch thread each
    (227 s alone), on an 8-core host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
TINY_VAE = dict(block_out_channels=(32, 64, 128, 128))
TINY_CLIP = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128)


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _jit_call(fn, *args, **kw):
    """`fn(*args, **kw)` under `jax.jit`, with the Python scalars and None
    among `args` (frame counts, absent inputs) and every keyword held static:
    one compile costs far less on the CPU than an eager model's op-by-op
    dispatch (the tiny UNet's apply takes over a minute eagerly)."""
    static = (bool, int, float, str, type(None))
    dynamic = [i for i, a in enumerate(args) if not isinstance(a, static)]

    def call(*arrays):
        full = list(args)
        for i, a in zip(dynamic, arrays):
            full[i] = a
        return fn(*full, **kw)

    return jax.jit(call)(*(args[i] for i in dynamic))


def _jax_init(module, *args, seed=0, perturb=0.0):
    """Flax parameters of `module` for `args` without running its init: the
    init's shapes (`jax.eval_shape`) filled host-side by the JAX package's
    role-aware `host_random_params` (fan-in-scaled normal kernels, neutral
    norms, biases and mix factors), since an eager init of the tiny UNet
    takes minutes on the CPU and a jitted one longer. `perturb` adds noise
    to every leaf so the neutral values (norm scale 1, bias 0, mix 0.5) do
    not hide a wrong mapping."""
    shapes = jax.eval_shape(lambda key: module.init(key, *args), jax.random.key(seed))
    params = host_random_params(shapes, seed, np.float32, as_numpy=True)
    if perturb:
        rng = np.random.default_rng(seed + 100)
        params = jax.tree.map(lambda x: x + perturb * rng.normal(size=x.shape).astype(np.float32), params)
    return params


def _japply(module, params, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return np.asarray(_jit_call(module.apply, params, *args, **kw))


def _port(module, params):
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("flavour", ["unet", "vae_decoder"])
def test_spatio_temporal_res_block(flavour):
    rng = np.random.default_rng(0)
    f, c_in, c_out, temb_ch = 3, 32, 64, 16
    x = _rand(rng, 2 * f, 8, 8, c_in)
    if flavour == "unet":
        jm = jl.SpatioTemporalResBlock(c_out, eps=1e-5, temporal_eps=1e-5)
        tm = tl.SpatioTemporalResBlock(c_in, c_out, temb_ch, eps=1e-5, temporal_eps=1e-5)
        temb = _rand(rng, 2 * f, temb_ch)
        ind = np.zeros((2, f), np.float32)
        ind[1, 0] = 1.0  # one image-only frame exercises the indicator path
        jargs, targs = (x, temb, f, ind), (_nchw(x), torch.from_numpy(temb), f, torch.from_numpy(ind))
    else:
        jm = jl.SpatioTemporalResBlock(c_out, eps=1e-6, temporal_eps=1e-5, merge_strategy_switch=True,
                                       merge_alpha_init=0.0)
        tm = tl.SpatioTemporalResBlock(c_in, c_out, None, eps=1e-6, temporal_eps=1e-5,
                                       merge_strategy_switch=True, merge_alpha_init=0.0)
        jargs, targs = (x, None, f), (_nchw(x), None, f)
    params = _jax_init(jm, *jargs, perturb=0.05)
    want = _japply(jm, params, *jargs)
    with torch.no_grad():
        got = _nhwc(_port(tm, params)(*targs))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_transformer_spatio_temporal_model():
    rng = np.random.default_rng(1)
    f, ch, heads = 3, 64, 4
    x = _rand(rng, 2 * f, 4, 6, ch)
    ctx = _rand(rng, 2 * f, 1, 48)
    ind = np.zeros((2, f), np.float32)
    jm = jl.TransformerSpatioTemporalModel(heads, ch // heads, cross_dim=48)
    params = _jax_init(jm, x, ctx, f, ind, perturb=0.05)
    want = _japply(jm, params, x, ctx, f, ind)
    tm = _port(tl.TransformerSpatioTemporalModel(heads, ch // heads, ch, cross_dim=48), params)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x), torch.from_numpy(ctx), f, torch.from_numpy(ind)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("asymmetric", [False, True])
def test_down_and_upsample(asymmetric):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 8, 12, 32)
    jd = jl.Downsample2D(32, asymmetric_padding=asymmetric)
    pd = _jax_init(jd, x)
    ju = jl.Upsample2D(32)
    pu = _jax_init(ju, x, seed=1)
    td = _port(tl.Downsample2D(32, asymmetric_padding=asymmetric), pd)
    tu = _port(tl.Upsample2D(32), pu)
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(td(_nchw(x))), _japply(jd, pd, x), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_nhwc(tu(_nchw(x))), _japply(ju, pu, x), rtol=RTOL, atol=ATOL)


def test_vae_attention_head_dim_512():
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 4, 6, 512)
    jm = JVAEAttention(512)
    params = _jax_init(jm, x, perturb=0.02)
    tm = _port(VAEAttention(512), params)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    np.testing.assert_allclose(got, _japply(jm, params, x), rtol=RTOL, atol=ATOL)


def test_clip_tower():
    rng = np.random.default_rng(4)
    pixels = _rand(rng, 2, 224, 224, 3)
    jm = JClip(JClipCfg(**TINY_CLIP))
    params = _jax_init(jm, pixels, perturb=0.02)
    want = _japply(jm, params, pixels)
    tm = _port(CLIPVisionTower(CLIPVisionConfig(**TINY_CLIP)), params)
    with torch.no_grad():
        got = tm(_nchw(pixels)).numpy()
    assert got.shape == (2, 1024)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_vae_encode_and_decode():
    rng = np.random.default_rng(5)
    imgs = _rand(rng, 2, 32, 48, 3)
    jm = JVAE(JVAECfg(**TINY_VAE))
    params = _jax_init(jm, imgs, 2, perturb=0.02)
    tm = _port(AutoencoderKLTemporal(VAEConfig(**TINY_VAE)), params)
    z_want = _japply(jm, params, imgs, method=JVAE.encode_mode)
    lat = _rand(rng, 4, 4, 6, 4)
    x_want = _japply(jm, params, lat, 2, method=JVAE.decode)
    with torch.no_grad():
        z_got = _nhwc(tm.encode_mode(_nchw(imgs)))
        x_got = _nhwc(tm.decode(_nchw(lat), 2))
    np.testing.assert_allclose(z_got, z_want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x_got, x_want, rtol=RTOL, atol=ATOL)


def test_init_random_follows_host_random_params_roles():
    """Norm weights 1, mix_factor 0.5, biases 0, weights normal with std sqrt(1/fan_in)
    over torch's OIHW layout; the same generator seed gives the same values."""
    from evoworld_tpu_torch.models.weights import init_random_

    def make(seed):
        vae = AutoencoderKLTemporal(VAEConfig(**TINY_VAE))
        return init_random_(vae, torch.Generator().manual_seed(seed))

    vae = make(0)
    dec = vae.decoder
    assert torch.equal(dec.conv_norm_out.weight, torch.ones_like(dec.conv_norm_out.weight))
    assert torch.equal(dec.mid_block.resnets[0].time_mixer.mix_factor, torch.tensor([0.5]))
    assert not dec.conv_in.bias.any() and not vae.quant_conv.bias.any()
    w = vae.encoder.down_blocks[1].resnets[0].conv1.weight  # (64, 32, 3, 3): fan_in 288
    assert abs(w.std().item() - (1.0 / 288) ** 0.5) < 0.1 * (1.0 / 288) ** 0.5
    assert all(torch.equal(a, b) for a, b in zip(vae.state_dict().values(), make(0).state_dict().values()))
    assert not torch.equal(w, make(1).encoder.down_blocks[1].resnets[0].conv1.weight)
