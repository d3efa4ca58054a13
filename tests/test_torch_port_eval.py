"""Parity of the port's evaluation modules with `evoworld_tpu.eval`.

The same numpy-seeded inputs go through each JAX function (fp32, matmul
precision "highest") and its port (fp32, CPU): PSNR and SSIM within 1e-5,
the Frechet distance within 1e-9 relative, the resizes within 1e-5, and the
feature nets (LPIPS-Alex, Inception-v4 at 299, I3D at 64 px over 10 frames,
DINO ViT-B/16 and both CLIP ViT-B/32 branches) within rtol 2e-3 / atol 5e-4,
the tolerance of the port's other model tests. The nets' weights are the
JAX package's seed-0 host-random ones (`host_random_params`, the vector
leaves then perturbed so that neutral values hide no wrong mapping) carried
across by the port's `*_params_from_jax`, then made sensitive to their input
(`sensitive_`, the recipe of `chip_smoke.py`'s phase 13): drawn at random, the deep nets' outputs would come from
their last biases alone, and a wrong early layer would stay inside the
tolerance. Each test asserts that its outputs differ between two inputs by
far more than the tolerance, and reads the weights back into JAX variables
through the JAX package's own converter, which `*_params_from_jax` must
invert exactly.
`tests/test_torch_port_eval_harness.py` holds the nets loaded from
torch-named state dicts and the whole harness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from evoworld_tpu.eval import dreamsim as jd
from evoworld_tpu.eval import feature_nets as jf
from evoworld_tpu.eval import inception_v4 as ji4
from evoworld_tpu.eval import metrics as jm
from evoworld_tpu.eval import weights as jw
from evoworld_tpu.models.clip import CLIPVisionTower as JClip
from evoworld_tpu.models.weights import host_random_params
from evoworld_tpu_torch.eval import dreamsim as td
from evoworld_tpu_torch.eval import feature_nets as tf
from evoworld_tpu_torch.eval import inception_v4 as ti4
from evoworld_tpu_torch.eval import metrics as tm
from evoworld_tpu_torch.eval import weights as tw
from evoworld_tpu_torch.eval.harness import _inception_preprocess
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

RTOL, ATOL = 2e-3, 5e-4


def _jax_vars(module, *args, seed=0):
    """The JAX package's seed-0 host-random variables of `module`, the vector
    leaves perturbed (its kernels are random already; norm scales 1 and
    biases 0 would hide a wrong mapping)."""
    shapes = jax.eval_shape(lambda key: module.init(key, *args), jax.random.key(seed))
    variables = host_random_params(shapes, seed, np.float32, as_numpy=True)
    rng = np.random.default_rng(seed + 1)

    def perturb(path, x):
        if x.ndim >= 2:
            return x
        return (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def sensitive_(model: torch.nn.Module, *inputs) -> dict[str, np.ndarray]:
    """`chip_smoke.sensitive_metric_net_` (the phase-13 nets' recipe) on numpy
    inputs: the net's output made to depend on its input, its state dict
    returned as numpy."""
    state = chip_smoke.sensitive_metric_net_(model, *[torch.as_tensor(np.asarray(a)) for a in inputs])
    return {k: v.numpy() for k, v in state.items()}


def assert_sensitive(out: np.ndarray) -> None:
    """The outputs for two inputs (the leading axis) differ by far more than
    the parity tolerance."""
    assert np.abs(out[0] - out[1]).max() > 100 * ATOL, np.abs(out[0] - out[1]).max()


def _apply(module, variables, *args):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(module.apply)(variables, *args))


def _videos(rng, shape, noise: float = 0.05):
    """Smooth [0, 1] frames and a noisy copy (an SSIM that is neither 0 nor 1)."""
    coarse = rng.random((shape[0] * shape[1], 3, 5, 7), dtype=np.float32)
    fine = torch.nn.functional.interpolate(torch.from_numpy(coarse), size=shape[2:4], mode="bicubic")
    gt = fine.clamp(0, 1).permute(0, 2, 3, 1).reshape(shape).numpy()
    gen = np.clip(gt + noise * rng.normal(size=shape).astype(np.float32), 0, 1)
    return gen, gt


@pytest.mark.parametrize("shape", [(2, 3, 40, 56, 3), (1, 2, 72, 128, 3)])
def test_psnr_ssim_match_jax(shape):
    gen, gt = _videos(np.random.default_rng(0), shape)
    ref = jm.batch_video_metrics(gen, gt)
    out = tm.batch_video_metrics(gen, gt)
    assert out.keys() == ref.keys()
    for key in ("psnr", "ssim"):
        np.testing.assert_allclose(out[key], ref[key], atol=1e-5, rtol=0)
        np.testing.assert_allclose(out[f"{key}_per_frame"], ref[f"{key}_per_frame"], atol=1e-5, rtol=0)
    same = tm.batch_video_metrics(gt, gt)
    assert same["psnr"] == 100.0 and abs(same["ssim"] - 1.0) < 1e-6


def test_ssim_keeps_fp32_whatever_the_tf32_flags():
    """SSIM gives the caller's TF32 flags back and its value does not move.
    On the CPU the flags change nothing; `test_torch_port_eval_card.py`
    holds the precision itself on the card."""
    gen, gt = _videos(np.random.default_rng(1), (1, 2, 40, 56, 3))
    before = tm.ssim(torch.from_numpy(gen), torch.from_numpy(gt))
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        after = tm.ssim(torch.from_numpy(gen), torch.from_numpy(gt))
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert torch.equal(before, after)


@pytest.mark.parametrize("n", [1, 4])
def test_frechet_distance_matches_jax(n):
    """n = 1 takes the single-sample branch (the means' term only)."""
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(n, 16)), rng.normal(size=(5, 16)) + 0.3
    np.testing.assert_allclose(tm.frechet_distance(a, b), jm.frechet_distance(a, b), rtol=1e-9)


def test_i3d_preprocess_and_resizes_match_jax():
    rng = np.random.default_rng(3)
    videos = rng.random((2, 3, 40, 70, 3), dtype=np.float32)
    ref = np.asarray(jf.i3d_preprocess(jnp.asarray(videos), 32))
    np.testing.assert_allclose(tf.i3d_preprocess(torch.from_numpy(videos), 32).numpy(), ref, atol=1e-5, rtol=0)
    frames = rng.random((2, 330, 420, 3), dtype=np.float32)  # downsampled to 299 and 224: the antialiased kernel
    from evoworld_tpu.eval.harness import _inception_preprocess as j_inception_preprocess

    np.testing.assert_allclose(_inception_preprocess(torch.from_numpy(frames)).numpy(),
                               np.asarray(j_inception_preprocess(frames)), atol=1e-5, rtol=0)
    ref224 = np.asarray(jax.image.resize(jnp.asarray(frames), (2, 224, 224, 3), "bilinear"))
    from evoworld_tpu_torch.ops.resize import resize_half_pixel

    np.testing.assert_allclose(resize_half_pixel(torch.from_numpy(frames), (224, 224)).numpy(), ref224,
                               atol=1e-5, rtol=0)


def _port_net(model, state):
    tw.load_net_(model, state)
    return model.eval()


def _run_port(model, *args):
    with torch.no_grad():
        return model(*[torch.from_numpy(np.asarray(a)) for a in args]).numpy()


def _carried(jmodel, tmodel, to_port, convert, *args):
    """The JAX seed-0 variables of `jmodel` in the port's `tmodel`, made
    sensitive to `args`; and the same weights read back into JAX variables
    by the JAX package's converter, which `to_port` must invert exactly."""
    state = sensitive_(_port_net(tmodel, to_port(_jax_vars(jmodel, *args))), *args)
    variables = convert(state)
    back = to_port(variables)
    assert back.keys() == state.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)
    return tmodel, variables


def _check_net(jmodel, tmodel, to_port, convert, *args):
    model, variables = _carried(jmodel, tmodel, to_port, convert, *args)
    out = _run_port(model, *args)
    assert_sensitive(out)
    np.testing.assert_allclose(out, _apply(jmodel, variables, *args), rtol=RTOL, atol=ATOL)
    return out


def net_inputs(name: str) -> list[np.ndarray]:
    """Two inputs for each metric net: LPIPS two pairs of smooth images at
    64 px, the second pair with 10 times the noise; I3D two 10-frame videos
    at 64 px; Inception-v4 two images at 299."""
    rng = np.random.default_rng({"lpips": 4, "i3d": 5, "inception_v4": 6}[name])
    if name == "lpips":
        gen, gt = _videos(rng, (2, 1, 64, 64, 3))
        noise = (gen[:, 0] - gt[:, 0]) * np.float32([1, 10])[:, None, None, None]
        return [gt[:, 0] * 2 - 1, (gt[:, 0] + noise) * 2 - 1]
    if name == "i3d":
        return [rng.uniform(-1, 1, (2, 10, 64, 64, 3)).astype(np.float32)]
    return [rng.normal(size=(2, 299, 299, 3)).astype(np.float32)]


def _check_net(jmodel, tmodel, to_port, convert, name):
    args = net_inputs(name)
    model, variables = _carried(jmodel, tmodel, to_port, convert, *args)
    out = _run_port(model, *args)
    assert_sensitive(out)
    np.testing.assert_allclose(out, _apply(jmodel, variables, *args), rtol=RTOL, atol=ATOL)
    return out


def test_lpips_matches_jax():
    _check_net(jf.LPIPSAlex(), tf.LPIPSAlex(), tw.lpips_params_from_jax, jw.convert_lpips_state_dict, "lpips")


def test_i3d_matches_jax():
    _check_net(jf.InceptionI3D(), tf.InceptionI3D(), tw.i3d_params_from_jax, jw.convert_i3d_state_dict, "i3d")


def test_inception_v4_matches_jax():
    out = _check_net(ji4.InceptionV4Features(), ti4.InceptionV4Features(), tw.inception_v4_params_from_jax,
                     jw.convert_inception_v4_state_dict, "inception_v4")
    assert out.shape == (2, 1536)


@pytest.mark.parametrize("branch", ["dino_vitb16", "clip_vitb32", "open_clip_vitb32"])
def test_dreamsim_branches_match_jax(branch):
    images = np.random.default_rng(7).normal(size=(2, 224, 224, 3)).astype(np.float32)
    if branch == "dino_vitb16":
        jmodel, to_port = jd.DinoViT(), tw.dino_params_from_jax
    else:
        jmodel = JClip(jd._clip_b32_config("quick_gelu" if branch == "clip_vitb32" else "gelu"))
        to_port = tw.clip_b32_params_from_jax
    variables = _jax_vars(jmodel, images)
    out = _run_port(td.make_branch(branch, to_port(variables), 0, "cpu"), images)
    assert_sensitive(out)
    np.testing.assert_allclose(out, _apply(jmodel, variables, images), rtol=RTOL, atol=ATOL)
