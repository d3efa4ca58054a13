"""The PyTorch port's single-clip pipeline against `evoworld_tpu`, and the
port's purity rules.

A whole tiny clip (the JAX package's tiny widths, 64x128, 5 frames, 2 steps)
runs through `evoworld_tpu.diffusion.pipeline.PanoDiffusionPipeline` in fp32
at matmul precision "highest" and through the port in fp32 on the CPU, with
the JAX weights carried across by `params_from_jax`. Both sides get the same
initial latents and the same conditioning noise: the draw the JAX pipeline
makes itself when `latents` is given, jax.random.normal(rng, (F+1, H, W, 3)).
Frames in [0, 1] agree to atol 2e-3.
"""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.diffusion.pipeline import PipelineConfig as JPipelineConfig
from evoworld_tpu.diffusion.pipeline import make_random_pipeline as j_make_random_pipeline
from evoworld_tpu.models.clip import CLIPVisionConfig as JClipCfg
from evoworld_tpu.models.unet import UNetConfig as JUNetCfg
from evoworld_tpu.models.vae import VAEConfig as JVAECfg
from evoworld_tpu_torch.diffusion.pipeline import PanoDiffusionPipeline, PipelineConfig
from evoworld_tpu_torch.models.clip import CLIPVisionTower
from evoworld_tpu_torch.models.unet import UNetSpatioTemporal
from evoworld_tpu_torch.models.vae import AutoencoderKLTemporal
from evoworld_tpu_torch.models.weights import params_from_jax
from evoworld_tpu_torch.runtime import PRESETS, build_pipeline
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZE = dict(height=64, width=128, num_frames=5, num_steps=2)
F, H, W = SIZE["num_frames"], SIZE["height"], SIZE["width"]


@pytest.fixture(scope="module")
def clip_inputs_and_pipelines():
    unet_cfg, vae_cfg, clip_cfg = PRESETS["tiny"]
    jpipe = j_make_random_pipeline(
        JPipelineConfig(**SIZE),
        unet_config=JUNetCfg(block_out_channels=unet_cfg.block_out_channels,
                             num_attention_heads=unet_cfg.num_attention_heads),
        vae_config=JVAECfg(block_out_channels=vae_cfg.block_out_channels),
        clip_config=JClipCfg(hidden_size=clip_cfg.hidden_size, num_layers=clip_cfg.num_layers,
                             num_heads=clip_cfg.num_heads, mlp_dim=clip_cfg.mlp_dim),
        compute_dtype=jnp.float32,
        seed=5,
    )
    models = {"unet": UNetSpatioTemporal(unet_cfg), "vae": AutoencoderKLTemporal(vae_cfg),
              "clip": CLIPVisionTower(clip_cfg)}
    for name, module in models.items():
        module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jpipe.params[name])), strict=True)
    tpipe = PanoDiffusionPipeline(models["unet"], models["vae"], models["clip"], PipelineConfig(**SIZE),
                                  compute_dtype=torch.float32)

    rng = np.random.default_rng(0)
    inputs = dict(
        image=rng.uniform(-1, 1, size=(H, W, 3)).astype(np.float32),
        plucker=rng.normal(size=(F, 6, H // 8, W // 8)).astype(np.float32),
        memory_frames=rng.uniform(-1, 1, size=(F, H, W, 3)).astype(np.float32),
        latents=rng.normal(size=(F, H // 8, W // 8, 4)).astype(np.float32),
    )
    return inputs, jpipe, tpipe


@pytest.mark.parametrize("mask_mem", [False, True])
def test_tiny_clip_matches_jax_pipeline(clip_inputs_and_pipelines, mask_mem):
    inputs, jpipe, tpipe = clip_inputs_and_pipelines
    key = jax.random.key(7)
    cond_noise = np.array(jax.random.normal(key, (F + 1, H, W, 3), jnp.float32))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jpipe(*(jnp.asarray(inputs[k]) for k in ("image", "plucker", "memory_frames")),
                                key, mask_mem=mask_mem, latents=jnp.asarray(inputs["latents"])))
    got = tpipe(**{k: torch.from_numpy(v) for k, v in inputs.items()}, mask_mem=mask_mem,
                cond_noise=torch.from_numpy(cond_noise)).numpy()
    assert got.shape == (F, H, W, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_build_pipeline_tiny_on_cpu_draws_its_own_noise():
    pipe = build_pipeline(PipelineConfig(**SIZE), model_preset="tiny", device="cpu", compute_dtype=torch.float32)
    rng = np.random.default_rng(1)
    args = (torch.from_numpy(rng.uniform(-1, 1, size=(H, W, 3)).astype(np.float32)),
            torch.zeros(F, 6, H // 8, W // 8), torch.zeros(F, H, W, 3))
    a = pipe(*args, generator=torch.Generator().manual_seed(3), mask_mem=True)
    b = pipe(*args, generator=torch.Generator().manual_seed(3), mask_mem=True)
    assert a.shape == (F, H, W, 3) and torch.isfinite(a).all()
    assert torch.equal(a, b)  # the same generator seed gives the same clip


def test_build_pipeline_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_pipeline()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_pipeline(device="cuda")


def _port_sources():
    return sorted((REPO / "evoworld_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax():
    banned = ("jax", "flax", "evoworld_tpu")
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if any(name == b or name.startswith(b + ".") for b in banned):
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} imports {name}")
    assert not offenders, offenders


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import evoworld_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'evoworld_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
