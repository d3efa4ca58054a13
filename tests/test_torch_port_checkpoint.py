"""Checkpoint loading of the PyTorch port against `evoworld_tpu`'s converters.

Random state dicts of the tiny presets under the upstream names (diffusers
for the UNet and VAE, transformers for CLIP, facebookresearch/vggt for VGGT)
are drawn from a seeded numpy generator and written with the port's own
safetensors writer (the UNet in two shards, its `conv_in` at SVD's 8 input
channels) and as a VGGT `model.pt`. The port loads them by name
(`build_pipeline(checkpoint_dir=...)`, `build_reconstructor(vggt_checkpoint=...)`);
the JAX package converts the same arrays (`convert_unet_state_dict`,
`convert_vae_state_dict`, `convert_clip_state_dict`,
`load_vggt_torch_checkpoint`) into trees for its tiny models, built once per
module: JAX's `build_pipeline` hard-codes the full widths, so it is not
called. Every key each converter reads is a key the port filled, and the
other way round. VAE and CLIP outputs agree at the models' tolerance, rtol
2e-3 / atol 5e-4 (fp32 on both sides, JAX at matmul precision "highest").
The UNet and VGGT are held exactly on their weights: the JAX package's
converted trees, carried back by `params_from_jax` / `vggt_params_from_jax`,
are the port's loaded tensors bit for bit, bridges whose outputs
tests/test_torch_port_unet.py and tests/test_torch_port_vggt.py hold against
the JAX models (compiling those here again would double this file's time).
The port's safetensors reader and writer are held against the `safetensors`
package exactly.
"""

import logging
import os

import jax
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from evoworld_tpu.models.clip import CLIPVisionConfig as JClipCfg
from evoworld_tpu.models.clip import CLIPVisionTower as JClip
from evoworld_tpu.models.vae import AutoencoderKLTemporal as JVAE
from evoworld_tpu.models.vae import VAEConfig as JVAECfg
from evoworld_tpu.models.vggt.weights import load_vggt_torch_checkpoint
from evoworld_tpu.models.weights import convert_clip_state_dict, convert_unet_state_dict, convert_vae_state_dict
from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
from evoworld_tpu_torch.models.clip import CLIPVisionTower
from evoworld_tpu_torch.models.unet import UNetSpatioTemporal
from evoworld_tpu_torch.models.vae import AutoencoderKLTemporal
from evoworld_tpu_torch.models.vggt.model import VGGT
from evoworld_tpu_torch.models.weights import load_safetensors, params_from_jax, save_safetensors, vggt_params_from_jax
from evoworld_tpu_torch.runtime import PRESETS, VGGT_PRESETS, build_pipeline, build_reconstructor
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

RTOL, ATOL = 2e-3, 5e-4
SVD_IN_CHANNELS = 8
UNET_CFG, VAE_CFG, CLIP_CFG = PRESETS["tiny"]
PIPE_CFG = PipelineConfig(height=64, width=128, num_frames=5, num_steps=2)


@pytest.fixture
def port_log(caplog):
    """caplog on the port's logger, which stops propagating once the CLIs
    have given it a handler of its own."""
    logger = logging.getLogger("evoworld_tpu_torch")
    logger.addHandler(caplog.handler)
    yield caplog
    logger.removeHandler(caplog.handler)


class _Recording(dict):
    """A state dict that records which keys a converter reads."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _upstream_state(module: torch.nn.Module, seed: int) -> dict[str, np.ndarray]:
    """Random fp32 arrays for every entry of `module`'s state dict: weights of
    rank >= 2 normal with std 1/sqrt(fan_in), norm weights 1 + 0.1 N, other
    vectors 0.1 N (so biases, tokens and LayerScales are nonzero)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in module.state_dict().items():
        draw = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        if t.dim() >= 2 and not name.endswith(("token", "tokens", "pos_embed", "class_embedding")):
            out[name] = draw / np.float32(np.sqrt(np.prod(t.shape[1:])))
        elif "norm" in name and name.endswith("weight"):
            out[name] = 1.0 + 0.1 * draw
        else:
            out[name] = 0.1 * draw
    return out


def _meta(cls, cfg):
    with torch.device("meta"):
        return cls(cfg)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A diffusers-layout pipeline directory of the tiny preset: the upstream
    arrays by model, and the directory."""
    root = tmp_path_factory.mktemp("svd")
    states = {
        "unet": _upstream_state(_meta(UNetSpatioTemporal, UNET_CFG), seed=1),
        "vae": _upstream_state(_meta(AutoencoderKLTemporal, VAE_CFG), seed=2),
        "image_encoder": _upstream_state(_meta(CLIPVisionTower, CLIP_CFG), seed=3),
    }
    states["unet"]["conv_in.weight"] = np.ascontiguousarray(states["unet"]["conv_in.weight"][:, :SVD_IN_CHANNELS])
    for sub, state in states.items():
        os.makedirs(root / sub)
        names = sorted(state)
        shards = [names[: len(names) // 2], names[len(names) // 2:]] if sub == "unet" else [names]
        for i, shard in enumerate(shards):
            save_safetensors({n: torch.from_numpy(state[n]) for n in shard},
                             str(root / sub / f"model-{i:05d}-of-{len(shards):05d}.safetensors"))
    return states, str(root)


@pytest.fixture(scope="module")
def loaded(checkpoint):
    return build_pipeline(PIPE_CFG, "tiny", seed=0, compute_dtype=torch.float32, device="cpu",
                          checkpoint_dir=checkpoint[1], allow_random_weights=False)


def _converted(convert, state):
    rec = _Recording(state)
    tree = convert(rec)
    assert rec.read == set(state), "the converter and the port read different keys"
    return tree


def _japply(fn, *args):
    """`fn(*args)` jitted: one compile costs less than an eager model's many
    small ones (the tiny VAE 5 s against 13 s on the CPU)."""
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(fn)(*args))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_unet_from_checkpoint_matches_jax(checkpoint, loaded):
    """Two shards merged; conv_in zero-padded from 8 to 18 input channels
    (the JAX converter's `expand_conv_in_kernel`), so the 10 new channels
    contribute nothing. The UNet is held on its weights, bit for bit: the
    JAX package's converted tree, carried back by `params_from_jax`, is the
    port's loaded state, a bridge whose outputs tests/test_torch_port_unet.py
    holds against the JAX UNet (compiling the JAX UNet here too would take
    a third of this file's time)."""
    states, _ = checkpoint
    w = loaded.unet.conv_in.weight.detach()
    assert w.shape[1] == 18 and not w[:, SVD_IN_CHANNELS:].any()
    np.testing.assert_array_equal(w[:, :SVD_IN_CHANNELS].numpy(), states["unet"]["conv_in.weight"])
    back = params_from_jax(_converted(convert_unet_state_dict, states["unet"]))
    own = loaded.unet.state_dict()
    assert sorted(back) == sorted(own)
    for name, value in own.items():
        np.testing.assert_array_equal(back[name].numpy(), value.numpy(), err_msg=name)


def test_vae_from_checkpoint_matches_jax(checkpoint, loaded):
    states, _ = checkpoint
    params = _converted(convert_vae_state_dict, states["vae"])
    jm = JVAE(JVAECfg(block_out_channels=VAE_CFG.block_out_channels))
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    lat = rng.normal(size=(2, 2, 2, 4)).astype(np.float32)
    with torch.no_grad():
        z = loaded.vae.encode_mode(_nchw(imgs)).numpy().transpose(0, 2, 3, 1)
        x = loaded.vae.decode(_nchw(lat), 2).numpy().transpose(0, 2, 3, 1)
    z_want = _japply(lambda p, a: jm.apply(p, a, method=JVAE.encode_mode), params, imgs)
    x_want = _japply(lambda p, a: jm.apply(p, a, 2, method=JVAE.decode), params, lat)
    np.testing.assert_allclose(z, z_want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x, x_want, rtol=RTOL, atol=ATOL)


def test_clip_from_checkpoint_matches_jax(checkpoint, loaded):
    states, _ = checkpoint
    params = _converted(convert_clip_state_dict, states["image_encoder"])
    jm = JClip(JClipCfg(hidden_size=CLIP_CFG.hidden_size, num_layers=CLIP_CFG.num_layers,
                        num_heads=CLIP_CFG.num_heads, mlp_dim=CLIP_CFG.mlp_dim))
    pixels = np.random.default_rng(4).normal(size=(2, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        got = loaded.clip_tower(_nchw(pixels)).numpy()
    np.testing.assert_allclose(got, _japply(jm.apply, params, pixels), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def vggt_state():
    """Upstream-named arrays of the tiny VGGT (its DPT heads are full width)."""
    return _upstream_state(_meta(VGGT, VGGT_PRESETS["tiny"]), seed=7)


def test_vggt_from_checkpoint_matches_jax(tmp_path, vggt_state):
    """An upstream-named `model.pt` (under "model", with the training-only mask
    token that both loaders drop): the port's model holds the file's tensors,
    and the JAX package's conversion of the same file, carried back, is the
    same tensors bit for bit."""
    tiny = VGGT_PRESETS["tiny"]
    state = dict(vggt_state)
    state["aggregator.patch_embed.mask_token"] = np.zeros((1, tiny.aggregator.embed_dim), np.float32)
    path = str(tmp_path / "model.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, path)
    recon = build_reconstructor("tiny", seed=0, compute_dtype=torch.float32, device="cpu", vggt_checkpoint=path,
                                allow_random_weights=False)
    own = recon.model.state_dict()
    assert set(own) == set(state) - {"aggregator.patch_embed.mask_token"}
    for name, value in own.items():
        np.testing.assert_array_equal(value.numpy(), state[name], err_msg=name)
    params, report = load_vggt_torch_checkpoint(path, output_layers=tiny.aggregator.output_layers)
    assert report == []
    back = vggt_params_from_jax(params)
    assert sorted(back) == sorted(own)
    for name, value in own.items():
        np.testing.assert_array_equal(back[name].numpy(), value.numpy(), err_msg=name)


def test_vggt_checkpoint_mismatch_is_logged_or_refused(tmp_path, port_log, vggt_state):
    """A key the model lacks and one it misses: logged, and the model keeps its
    random values there, unless `allow_random_weights` is False (ValueError)."""
    state = {k: torch.from_numpy(v) for k, v in vggt_state.items()}
    state.pop("camera_head.trunk.0.norm1.weight")
    state["track_head.proj.weight"] = torch.zeros(2, 2)
    path = str(tmp_path / "model.pt")
    torch.save(state, path)
    with port_log.at_level("WARNING", logger="evoworld_tpu_torch"):
        recon = build_reconstructor("tiny", seed=0, compute_dtype=torch.float32, device="cpu", vggt_checkpoint=path)
    assert "missing camera_head.trunk.0.norm1.weight" in port_log.text
    assert "unexpected track_head.proj.weight" in port_log.text
    np.testing.assert_array_equal(recon.model.state_dict()["aggregator.camera_token"].numpy(),
                                  state["aggregator.camera_token"].numpy())
    with pytest.raises(ValueError):
        build_reconstructor("tiny", compute_dtype=torch.float32, device="cpu", vggt_checkpoint=path,
                            allow_random_weights=False)


def test_incomplete_checkpoint_falls_back_or_refuses(tmp_path, port_log):
    """A pipeline directory without `image_encoder/`: a warning and the random
    pipeline of the seed; with `allow_random_weights` False, FileNotFoundError,
    as for no directory and for a VGGT checkpoint that does not exist."""
    os.makedirs(tmp_path / "unet")
    os.makedirs(tmp_path / "vae")
    save_safetensors({"x": torch.zeros(1)}, str(tmp_path / "unet" / "a.safetensors"))
    save_safetensors({"x": torch.zeros(1)}, str(tmp_path / "vae" / "a.safetensors"))
    with port_log.at_level("WARNING", logger="evoworld_tpu_torch"):
        pipe = build_pipeline(PIPE_CFG, "tiny", seed=5, compute_dtype=torch.float32, device="cpu",
                              checkpoint_dir=str(tmp_path))
    assert "incomplete" in port_log.text
    rand = build_pipeline(PIPE_CFG, "tiny", seed=5, compute_dtype=torch.float32, device="cpu")
    assert torch.equal(pipe.unet.conv_in.weight, rand.unet.conv_in.weight)
    for ckpt in (str(tmp_path), None, str(tmp_path / "nowhere")):
        with pytest.raises(FileNotFoundError):
            build_pipeline(PIPE_CFG, "tiny", compute_dtype=torch.float32, device="cpu", checkpoint_dir=ckpt,
                           allow_random_weights=False)
    with pytest.raises(FileNotFoundError):
        build_reconstructor("tiny", compute_dtype=torch.float32, device="cpu",
                            vggt_checkpoint=str(tmp_path / "model.pt"), allow_random_weights=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_and_writer_match_the_package(tmp_path, dtype):
    """Files of the `safetensors` package read back exactly through the port's
    reader, and the port's files through the package (odd sizes leave later
    tensors at offsets that are not multiples of their element size)."""
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=g).to(dtype), "b": torch.randn(7, generator=g).to(dtype),
               "c.scalar": torch.tensor(2.5).to(dtype), "d.empty": torch.zeros(0, 4).to(dtype),
               "e.bytes": torch.arange(5, dtype=torch.uint8), "f.after_bytes": torch.randn(2, 3, generator=g)}
    safetensors.torch.save_file(tensors, str(tmp_path / "package.safetensors"))
    save_safetensors(tensors, str(tmp_path / "port.safetensors"))
    for got in (load_safetensors(str(tmp_path / "package.safetensors")),
                safetensors.torch.load_file(str(tmp_path / "port.safetensors"))):
        assert sorted(got) == sorted(tensors)
        for name, t in tensors.items():
            assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    if dtype != torch.bfloat16:  # numpy has no bf16
        arrays = {k: v.numpy() for k, v in tensors.items()}
        safetensors.numpy.save_file(arrays, str(tmp_path / "numpy.safetensors"))
        for name, t in load_safetensors(str(tmp_path / "numpy.safetensors")).items():
            np.testing.assert_array_equal(t.numpy(), arrays[name])
