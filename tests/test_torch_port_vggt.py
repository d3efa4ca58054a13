"""The PyTorch port's VGGT against `evoworld_tpu.models.vggt`, in fp32.

The JAX package's tiny VGGT (`evoworld_tpu/runtime.py`'s smoke widths: embed
64, 4 frame/global pairs, 4 heads, one patch-encoder block, the full-width
DPT heads) gets random parameters from a seeded numpy generator; the port
loads them through `vggt_params_from_jax`. Both sides run in fp32, JAX at
matmul precision "highest". Tolerance rtol 2e-3 / atol 5e-4 for the model
and the reconstructor (the models' tolerance of the port); the resizes,
rotary embedding and camera geometry are held to 1e-5. The weight bridge is
held exactly: the port's upstream-named state dict goes through
`convert_vggt_state_dict` into a JAX tree and back to the same tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.models.vggt import geometry as jgeo
from evoworld_tpu.models.vggt.aggregator import rope_2d as j_rope_2d
from evoworld_tpu.models.vggt.model import VGGT as JVGGT
from evoworld_tpu.models.vggt.model import load_and_preprocess_images as j_preprocess
from evoworld_tpu.models.vggt.model import make_reconstructor as j_make_reconstructor
from evoworld_tpu.models.vggt.model import VGGTConfig as JVGGTConfig
from evoworld_tpu.models.vggt.aggregator import AggregatorConfig as JAggregatorConfig
from evoworld_tpu.models.vggt.weights import convert_vggt_state_dict
from evoworld_tpu.ops.resize import resize_bilinear_align_corners as j_resize_ac
from evoworld_tpu_torch.models.vggt import geometry as tgeo
from evoworld_tpu_torch.models.vggt.aggregator import rope_2d
from evoworld_tpu_torch.models.vggt.model import VGGT, load_and_preprocess_images, make_reconstructor
from evoworld_tpu_torch.models.weights import vggt_params_from_jax
from evoworld_tpu_torch.ops.resize import resize_bilinear_align_corners, resize_half_pixel
from evoworld_tpu_torch.runtime import VGGT_PRESETS, build_reconstructor
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MODEL_TOL = dict(rtol=2e-3, atol=5e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
TINY = VGGT_PRESETS["tiny"]


def _j_config(cfg):
    a = cfg.aggregator
    return JVGGTConfig(aggregator=JAggregatorConfig(
        embed_dim=a.embed_dim, depth=a.depth, num_heads=a.num_heads, num_register_tokens=a.num_register_tokens,
        output_layers=a.output_layers, patch_encoder_depth=a.patch_encoder_depth))


def _random_tree(shapes, seed):
    """Every leaf drawn from a seeded numpy generator: kernels normal with std
    1/sqrt(fan_in), norm scales 1 + 0.1 N, LayerScales 0.1 + 0.02 N, other
    leaves 0.1 N (so biases and tokens are nonzero)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(s.shape)
        draw = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) if len(shape) in (2, 4) else shape[-2]
            return draw / np.float32(np.sqrt(fan_in))
        if name == "scale":
            return 1.0 + 0.1 * draw
        if name in ("ls1", "ls2"):
            return 0.1 + 0.02 * draw
        return 0.1 * draw

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tiny_models():
    jmodel = JVGGT(_j_config(TINY))
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros((1, 2, 28, 42, 3))), jax.random.key(0))
    params = _random_tree(shapes, seed=0)
    tmodel = VGGT(TINY)
    tmodel.load_state_dict(vggt_params_from_jax(params), strict=True)
    return jmodel, params, tmodel.eval()


def _images(s, h, w, seed):
    return np.random.default_rng(seed).uniform(size=(1, s, h, w, 3)).astype(np.float32)


def test_tiny_vggt_forward_matches(tiny_models):
    """Aggregator taps and every head, at a 2 x 3 patch grid (the positional
    embedding is resized from 37 x 37, a bicubic downsample with antialias)."""
    jmodel, params, tmodel = tiny_models
    images = _images(3, 28, 42, seed=1)
    with jax.default_matmul_precision("highest"):
        j_out, want = jax.jit(lambda p, x: (jmodel.apply(p, x, method="aggregate")[0], jmodel.apply(p, x)))(
            params, jnp.asarray(images))
    with torch.no_grad():
        t_out, patch_hw = tmodel.aggregator(torch.from_numpy(images))
        got = tmodel(torch.from_numpy(images))
    assert patch_hw == (2, 3) and len(t_out) == 4
    for a, b in zip(t_out, j_out, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **MODEL_TOL)
    for key in ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **MODEL_TOL, err_msg=key)


def test_tiny_reconstructor_matches(tiny_models):
    """`make_reconstructor` end to end: preprocessing of 16 x 512 crops to
    14 x 518, the chunked depth head (head_chunk 2 over 3 frames), pose
    decoding and unprojection."""
    jmodel, params, tmodel = tiny_models
    crops = _images(3, 16, 512, seed=2)[0]
    with jax.default_matmul_precision("highest"):
        want = j_make_reconstructor(jmodel, params, jnp.float32, offload_params=False, head_chunk=2)(
            jnp.asarray(crops))
    got = make_reconstructor(tmodel, torch.float32, head_chunk=2)(torch.from_numpy(crops))
    for key in ("world_points", "conf", "extrinsic", "colors"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **MODEL_TOL, err_msg=key)


def test_weight_bridge_round_trip():
    """Port state dict (upstream names) -> convert_vggt_state_dict -> JAX tree
    -> vggt_params_from_jax -> the same tensors, with a clean conversion report."""
    model = build_reconstructor("tiny", seed=3, compute_dtype=torch.float32, device="cpu").model
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree, report = convert_vggt_state_dict(sd, output_layers=TINY.aggregator.output_layers)
    assert report == []
    back = vggt_params_from_jax(tree)
    assert sorted(back) == sorted(sd)
    for name, value in sd.items():
        np.testing.assert_array_equal(back[name].numpy(), value, err_msg=name)


def test_build_reconstructor_keeps_norms_fp32_and_draws_deterministically():
    a = build_reconstructor("tiny", seed=4, compute_dtype=torch.bfloat16, device="cpu").model
    b = build_reconstructor("tiny", seed=4, compute_dtype=torch.bfloat16, device="cpu").model
    dtypes = {n: p.dtype for n, p in a.named_parameters()}
    assert dtypes["aggregator.frame_blocks.0.attn.q_norm.weight"] == torch.float32
    assert dtypes["aggregator.global_blocks.3.ls2.gamma"] == torch.float32
    assert dtypes["camera_head.empty_pose_tokens"] == torch.float32
    assert dtypes["aggregator.global_blocks.3.attn.qkv.weight"] == torch.bfloat16
    assert dtypes["depth_head.scratch.refinenet1.out_conv.weight"] == torch.bfloat16
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


@pytest.mark.parametrize("hw,out,method", [((384, 512), (392, 518), "bilinear"), ((16, 512), (14, 518), "bilinear"),
                                           ((37, 37), (28, 37), "cubic"), ((37, 37), (2, 3), "cubic"),
                                           ((5, 7), (11, 3), "cubic")])
def test_half_pixel_resize_matches_jax_image_resize(hw, out, method):
    x = np.random.default_rng(5).normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *out, 3), method))
    np.testing.assert_allclose(resize_half_pixel(torch.from_numpy(x), out, method).numpy(), want, **TOL)
    if method == "bilinear" and out[0] >= hw[0] and out[1] >= hw[1]:  # upsampling: no antialias term
        ref = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=out, mode="bilinear",
                                              align_corners=False).permute(0, 2, 3, 1)
        np.testing.assert_allclose(ref.numpy(), want, **TOL)


def test_preprocess_and_align_corners_resize_match():
    crops = (np.random.default_rng(6).uniform(size=(2, 48, 64, 3)) * 255).astype(np.uint8)
    np.testing.assert_allclose(load_and_preprocess_images(torch.from_numpy(crops)).numpy(),
                               np.asarray(j_preprocess(crops)), **TOL)
    x = np.random.default_rng(7).normal(size=(3, 5, 7, 4)).astype(np.float32)
    for out in ((10, 14), (28, 37), (5, 7), (1, 3)):
        np.testing.assert_allclose(resize_bilinear_align_corners(torch.from_numpy(x), out).numpy(),
                                   np.asarray(j_resize_ac(jnp.asarray(x), out)), **TOL)


def test_rope_and_camera_geometry_match():
    rng = np.random.default_rng(8)
    t = rng.normal(size=(2, 11, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 40, size=(11, 2)).astype(np.int32)
    np.testing.assert_allclose(rope_2d(torch.from_numpy(t), torch.from_numpy(pos)).numpy(),
                               np.asarray(j_rope_2d(jnp.asarray(t), jnp.asarray(pos))), **TOL)
    pose_enc = rng.normal(size=(4, 9)).astype(np.float32)
    np.testing.assert_allclose(tgeo.quat_to_rotmat(torch.from_numpy(pose_enc[:, 3:7])).numpy(),
                               np.asarray(jgeo.quat_to_rotmat(jnp.asarray(pose_enc[:, 3:7]))), **TOL)
    got = tgeo.pose_encoding_to_extri_intri(torch.from_numpy(pose_enc), (14, 18))
    want = jgeo.pose_encoding_to_extri_intri(jnp.asarray(pose_enc), (14, 18))
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    depth = rng.uniform(0.5, 5.0, size=(4, 14, 18, 1)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want_pts = jgeo.unproject_depth_map_to_point_map(jnp.asarray(depth), *want)
    np.testing.assert_allclose(tgeo.unproject_depth_map_to_point_map(torch.from_numpy(depth), *got).numpy(),
                               np.asarray(want_pts), **TOL)
