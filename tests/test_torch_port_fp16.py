"""The port in fp16 (`runtime.compute_dtype` float16) against the JAX package
in fp16 and in fp32, on the CPU.

Every input is drawn from a seeded numpy generator and every weight is
rounded to a value fp16 holds, so that the fp16 runs (port and JAX) and the
JAX fp32 run start from the same values; only the arithmetic's precision
differs. For each output y:

    err(port fp16, JAX fp32) <= 2 * err(JAX fp16, JAX fp32) + FLOOR
    err(port fp16, JAX fp16) <= BOUND

with err the largest absolute difference over the RMS of the second argument
(frames in [0, 1]: the largest absolute difference). The two fp16 sides
round at different places (XLA's fp16 dots and convolutions against torch's
CPU kernels, which accumulate in fp32), so BOUND is set from their measured
gap with room, and FLOOR is the same order. Each random net is shown to be
sensitive to its input: a second input moves its output by more than ten
times BOUND.

Covered: the plain flash forward (with its log-sum-exp and a `kv_len`
mask) against `_xla_attention` and the Pallas kernel in interpret mode; the
plain backward against `jax.vjp` of the JAX attention; a tiny clip through
`build_pipeline(compute_dtype=torch.float16, device="cpu")` from an fp16
checkpoint written by `cli.convert_checkpoint.halve`, against
`make_random_pipeline(compute_dtype=jnp.float16)`; one tiny training step
(fp32 masters, fp16 frozen leaves and autocast); a tiny VGGT reconstruction
through `build_reconstructor(compute_dtype=torch.float16)`. The models are
the JAX package's tiny widths cut to one layer per block (two UNet levels)
so that the JAX compiles stay short; the step and VGGT are in
`test_torch_port_fp16_train.py` and `test_torch_port_fp16_vggt.py`, which
use this file's rule and tolerances, so that each file runs under a minute
with a cold JAX cache.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.diffusion.pipeline import PanoDiffusionPipeline as JPipeline
from evoworld_tpu.diffusion.pipeline import PipelineConfig as JPipelineConfig
from evoworld_tpu.diffusion.pipeline import make_random_pipeline as j_make_random_pipeline
from evoworld_tpu.models.clip import CLIPVisionConfig as JClipCfg
from evoworld_tpu.models.unet import UNetConfig as JUNetCfg
from evoworld_tpu.models.vae import VAEConfig as JVAECfg
from evoworld_tpu.ops.attention import _xla_attention
from evoworld_tpu.ops.flash_attention import flash_attention as j_flash
from evoworld_tpu_torch import runtime
from evoworld_tpu_torch.cli import convert_checkpoint
from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
from evoworld_tpu_torch.models.clip import CLIPVisionConfig
from evoworld_tpu_torch.models.unet import UNetConfig
from evoworld_tpu_torch.models.vae import VAEConfig
from evoworld_tpu_torch.models.weights import params_from_jax, save_safetensors
from evoworld_tpu_torch.ops.flash_attention import flash_attention_backward, flash_attention_forward
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# (FLOOR, BOUND) per output, relative to the reference's RMS (frames: absolute).
# Measured here (err(port fp16, JAX fp16); JAX fp16's own error; the port's
# against JAX fp32): attention outputs up to 8.5e-3 (XLA's fp16 route rounds
# the scores to fp16 before the softmax; 6.9e-3; 2.8e-3), against the Pallas
# kernel in interpret mode 2.6e-3; gradients up to 1.6e-2 (1.3e-2; 5.8e-3);
# frames 9.3e-3 (6.2e-3; 7.2e-3); loss and gradient norm 4.2e-4 (4.8e-4;
# 7.8e-5); VGGT's world points 1.0e-2 (8.9e-3; 6.9e-3).
ATTN_TOL = (2e-3, 1.5e-2)
ATTN_GRAD_TOL = (4e-3, 3e-2)
CLIP_TOL = (4e-3, 2e-2)
STEP_TOL = (1e-3, 2e-3)
VGGT_TOL = (1e-2, 3e-2)

# The JAX package's tiny widths (runtime "tiny" preset), cut to two UNet
# levels and one layer per block.
MICRO_UNET = dict(block_out_channels=(32, 64), num_attention_heads=(2, 4), layers_per_block=1,
                  cross_attn_blocks=(True, False))
MICRO_VAE = dict(block_out_channels=(32, 64, 128, 128), layers_per_block=1)
MICRO_CLIP = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.sqrt((b ** 2).mean()), 1e-30))


def assert_fp16_rule(port16, jax16, jax32, tol, name, relative=True):
    """The file's rule (see the docstring); returns the port's error against JAX fp16."""
    err = rel_err if relative else (lambda a, b: float(np.abs(np.asarray(a, np.float64) - b).max()))
    floor, bound = tol
    own, port32, port_jax16 = err(jax16, jax32), err(port16, jax32), err(port16, jax16)
    assert np.isfinite(np.asarray(port16, np.float64)).all(), name
    assert port32 <= 2 * own + floor, f"{name}: port fp16 vs JAX fp32 {port32}, JAX fp16's own {own}"
    assert port_jax16 <= bound, f"{name}: port fp16 vs JAX fp16 {port_jax16} > {bound}"
    return port_jax16


def _f16_values(tree):
    """Every float leaf rounded to the nearest value fp16 holds, kept in fp32."""
    return jax.tree.map(lambda x: np.asarray(x, np.float32).astype(np.float16).astype(np.float32), tree)


def _qkv(b, sq, skv, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float16) for s in (sq, skv, skv)]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,kv_len", [(64, 300), (128, 257), (512, 200)])
def test_plain_flash_forward_fp16_against_jax(d, kv_len):
    """Output and log-sum-exp of the plain forward on fp16 inputs (keys past
    `kv_len` masked) against `_xla_attention` and the Pallas kernel (fp16,
    interpret mode) and `_xla_attention` in fp32 on the same values."""
    q, k, v = _qkv(2, 130, 333, 2, d, seed=d)
    scale = d ** -0.5
    out, lse = flash_attention_forward(*(torch.from_numpy(x) for x in (q, k, v)), scale, kv_len, with_lse=True)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    kv = (k[:, :kv_len], v[:, :kv_len])
    with jax.default_matmul_precision("highest"):
        j16 = np.asarray(_xla_attention(jnp.asarray(q), *map(jnp.asarray, kv), scale))
        pallas16 = np.asarray(j_flash(jnp.asarray(q), *map(jnp.asarray, kv), block_q=128, block_k=128,
                                      interpret=True))
        j32 = np.asarray(_xla_attention(*(jnp.asarray(x, jnp.float32) for x in (q, *kv)), scale))
        logits = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q, jnp.float32), jnp.asarray(kv[0], jnp.float32))
        lse32 = np.asarray(jax.nn.logsumexp(logits * scale, axis=-1))
    assert j16.dtype == pallas16.dtype == np.float16
    got = out.float().numpy()
    assert_fp16_rule(got, j16, j32, ATTN_TOL, "xla")
    assert_fp16_rule(got, pallas16, j32, ATTN_TOL, "pallas")
    np.testing.assert_allclose(lse.numpy(), lse32, rtol=0, atol=1e-4)  # fp32 sums over fp16 inputs
    shuffled = flash_attention_forward(*(torch.from_numpy(x) for x in (q, v, k)), scale, kv_len)[0]
    assert rel_err(shuffled.float(), got) > 10 * ATTN_TOL[1]


@pytest.mark.parametrize("d,kv_len", [(64, 300), (512, 200)])
def test_plain_flash_backward_fp16_against_jax_vjp(d, kv_len):
    """dQ, dK, dV of the plain backward on fp16 inputs against `jax.vjp` of
    `_xla_attention` in fp16 and in fp32 on the same values; dK and dV rows
    past `kv_len` are zero on every side."""
    q, k, v = _qkv(1, 96, 333, 2, d, seed=10 + d)
    do = np.random.default_rng(3).normal(size=q.shape).astype(np.float16)
    scale = d ** -0.5
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = flash_attention_forward(tq, tk, tv, scale, kv_len, with_lse=True)
    got = flash_attention_backward(tq, tk, tv, out, tdo, lse, scale, kv_len)

    def jax_grads(dtype):
        def attn(q_, k_, v_):
            return _xla_attention(q_, k_[:, :kv_len], v_[:, :kv_len], scale)

        with jax.default_matmul_precision("highest"):
            _, vjp = jax.vjp(attn, *(jnp.asarray(x, dtype) for x in (q, k, v)))
            return [np.asarray(g) for g in vjp(jnp.asarray(do, dtype))]

    want16, want32 = jax_grads(jnp.float16), jax_grads(jnp.float32)
    for name, a, b16, b32 in zip(("dq", "dk", "dv"), got, want16, want32):
        assert a.dtype == torch.float16 and b16.dtype == np.float16
        assert_fp16_rule(a.float().numpy(), b16, b32, ATTN_GRAD_TOL, name)
        if name != "dq":
            assert not a[:, kv_len:].any() and not b16[:, kv_len:].any()
    other = flash_attention_backward(tq, tk, tv, out, -tdo.flip(1), lse, scale, kv_len)
    assert rel_err(other[0].float(), got[0].float()) > 10 * ATTN_GRAD_TOL[1]


# ---------------------------------------------------------------------------
# The clip
# ---------------------------------------------------------------------------

CLIP_SIZE = dict(height=64, width=128, num_frames=3, num_steps=1, encode_chunk=2, decode_chunk=3)


@pytest.fixture(scope="module")
def micro_preset():
    """The micro configurations as a runtime preset, so that the entry points build them."""
    preset = (UNetConfig(**MICRO_UNET), VAEConfig(**MICRO_VAE), CLIPVisionConfig(**MICRO_CLIP))
    runtime.PRESETS["micro"] = preset
    yield "micro"
    del runtime.PRESETS["micro"]


def test_tiny_clip_fp16_through_build_pipeline_against_jax(tmp_path, micro_preset):
    jpipe16 = j_make_random_pipeline(
        JPipelineConfig(**CLIP_SIZE), unet_config=JUNetCfg(**MICRO_UNET), vae_config=JVAECfg(**MICRO_VAE),
        clip_config=JClipCfg(**MICRO_CLIP), compute_dtype=jnp.float16, seed=5)
    params32 = _f16_values(jpipe16.params)  # the fp16 weights' values, in fp32
    jpipe32 = JPipeline(jpipe16.unet, jpipe16.vae, jpipe16.clip_tower, params32, JPipelineConfig(**CLIP_SIZE),
                        compute_dtype=jnp.float32)
    # An fp32 checkpoint directory of those values, halved to fp16 by the port's converter.
    for sub, name in (("unet", "unet"), ("vae", "vae"), ("image_encoder", "clip")):
        os.makedirs(tmp_path / "fp32" / sub)
        os.makedirs(tmp_path / "fp16" / sub)
        src, dst = (str(tmp_path / d / sub / "model.safetensors") for d in ("fp32", "fp16"))
        save_safetensors(params_from_jax(params32[name]), src)
        convert_checkpoint.halve(src, dst, "fp16")
    pipe = runtime.build_pipeline(PipelineConfig(**CLIP_SIZE), micro_preset, compute_dtype=torch.float16,
                                  device="cpu", checkpoint_dir=str(tmp_path / "fp16"), allow_random_weights=False)
    assert {p.dtype for p in pipe.unet.parameters()} == {torch.float16}

    f, h, w = CLIP_SIZE["num_frames"], CLIP_SIZE["height"], CLIP_SIZE["width"]
    rng = np.random.default_rng(0)
    inputs = dict(image=rng.uniform(-1, 1, size=(h, w, 3)).astype(np.float32),
                  plucker=rng.normal(size=(f, 6, h // 8, w // 8)).astype(np.float32),
                  memory_frames=rng.uniform(-1, 1, size=(f, h, w, 3)).astype(np.float32),
                  latents=rng.normal(size=(f, h // 8, w // 8, 4)).astype(np.float32))
    key = jax.random.key(7)
    cond_noise = np.array(jax.random.normal(key, (f + 1, h, w, 3), jnp.float32))

    def jax_clip(jpipe):
        with jax.default_matmul_precision("highest"):
            return np.asarray(jpipe(*(jnp.asarray(inputs[k]) for k in ("image", "plucker", "memory_frames")),
                                    key, latents=jnp.asarray(inputs["latents"])), np.float32)

    def port_clip(**change):
        args = {k: torch.from_numpy(v) for k, v in {**inputs, **change}.items()}
        return pipe(**args, cond_noise=torch.from_numpy(cond_noise)).numpy()

    got = port_clip()
    assert got.shape == (f, h, w, 3) and 0.0 <= got.min() and got.max() <= 1.0
    assert_fp16_rule(got, jax_clip(jpipe16), jax_clip(jpipe32), CLIP_TOL, "frames", relative=False)
    moved = port_clip(image=-inputs["image"])
    assert np.abs(moved - got).max() > 10 * CLIP_TOL[1]
