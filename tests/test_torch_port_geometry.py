"""Parity of the PyTorch port's geometry, scheduler and resize with `evoworld_tpu`.

Numpy-seeded inputs through both sides in fp32 (JAX at matmul precision
"highest"); geometry and scheduler agree to 1e-5, the resize (a blur and
two interpolation matmuls over 8-bit-range values) to 1e-5 as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.diffusion import scheduler as js
from evoworld_tpu.geometry import plucker as jplk
from evoworld_tpu.geometry import pose as jpose
from evoworld_tpu.geometry import rays as jrays
from evoworld_tpu.ops import resize as jresize
from evoworld_tpu_torch.diffusion import scheduler as ts
from evoworld_tpu_torch.geometry import plucker as tplk
from evoworld_tpu_torch.geometry import pose as tpose
from evoworld_tpu_torch.geometry import rays as trays
from evoworld_tpu_torch.ops import resize as tresize
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = dict(rtol=1e-5, atol=1e-5)


def _poses(n=7, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * 3.0
    ang = rng.uniform(-180.0, 180.0, size=(n, 3))
    return np.concatenate([xyz, ang], axis=1).astype(np.float32)


def _j(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return np.array(fn(*args, **kw))  # a writable copy torch can wrap


def test_unity_to_opencv_and_rotmat():
    p = _poses()
    np.testing.assert_allclose(
        tpose.unity_to_opencv(torch.from_numpy(p)).numpy(), _j(jpose.unity_to_opencv, jnp.asarray(p)), **TOL)
    np.testing.assert_allclose(
        tpose.euler_deg_to_rotmat(torch.from_numpy(p[:, 3:])).numpy(),
        _j(jpose.euler_deg_to_rotmat, jnp.asarray(p[:, 3:])), **TOL)


@pytest.mark.parametrize("relative,homogeneous", [(False, False), (True, False), (True, True)])
def test_pose_to_matrix_and_invert(relative, homogeneous):
    p = _poses(seed=1)
    want = _j(jpose.pose_to_matrix, jnp.asarray(p), relative=relative, homogeneous=homogeneous)
    got = tpose.pose_to_matrix(torch.from_numpy(p), relative=relative, homogeneous=homogeneous).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    m34 = want[:, :3]
    np.testing.assert_allclose(
        tpose.invert_pose(torch.from_numpy(m34)).numpy(), _j(jpose.invert_pose, jnp.asarray(m34)), **TOL)


def test_compose_poses():
    a = _j(jpose.pose_to_matrix, jnp.asarray(_poses(6, seed=3)))
    b = _j(jpose.pose_to_matrix, jnp.asarray(_poses(6, seed=4)))
    want = _j(jpose.compose_poses, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(tpose.compose_poses(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want, **TOL)
    back = tpose.compose_poses(tpose.invert_pose(torch.from_numpy(a)), torch.from_numpy(a))  # a^-1 a = I
    np.testing.assert_allclose(back.numpy(), np.broadcast_to(np.eye(3, 4, dtype=np.float32), back.shape), atol=1e-5)


@pytest.mark.parametrize("hw, fov", [((48, 64), 90.0), ((576, 1024), 60.0)])
def test_pinhole_intrinsics(hw, fov):
    got = trays.pinhole_intrinsics(*hw, fov_x_deg=fov)
    assert got.dtype == torch.float32 and got.shape == (3, 3)
    np.testing.assert_allclose(got.numpy(), _j(jrays.pinhole_intrinsics, *hw, fov_x_deg=fov), **TOL)
    # K maps each ray of the pinhole grid to its pixel centre
    rays = trays.pinhole_ray_grid(*hw, fov_x_deg=fov)
    pix = torch.einsum("ij,hwj->hwi", got, rays / rays[..., 2:])
    ys, xs = torch.meshgrid(torch.arange(hw[0], dtype=torch.float32), torch.arange(hw[1], dtype=torch.float32),
                            indexing="ij")
    np.testing.assert_allclose(pix[..., 0].numpy(), xs.numpy(), atol=1e-3)
    np.testing.assert_allclose(pix[..., 1].numpy(), ys.numpy(), atol=1e-3)


def test_rays_and_plucker():
    grid_j = _j(jrays.equirect_ray_grid, 9, 16)
    grid_t = trays.equirect_ray_grid(9, 16).numpy()
    np.testing.assert_allclose(grid_t, grid_j, **TOL)
    c2w = _j(jpose.pose_to_matrix, jnp.asarray(_poses(5, seed=2)), relative=True)
    want = _j(jplk.plucker_embedding, jnp.asarray(grid_j), jnp.asarray(c2w))
    got = tplk.plucker_embedding(torch.from_numpy(grid_j), torch.from_numpy(c2w)).numpy()
    assert got.shape == (5, 6, 9, 16)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("steps", [2, 4, 25])
def test_scheduler(steps):
    sig_j = _j(js.karras_sigmas, steps)
    sig_t = ts.karras_sigmas(steps).numpy()
    np.testing.assert_allclose(sig_t, sig_j, **TOL)
    rng = np.random.default_rng(steps)
    out, sample = (rng.normal(size=(3, 4, 5)).astype(np.float32) for _ in range(2))
    for i in range(steps):
        s, sn = sig_j[i], sig_j[i + 1]
        tj = [jnp.asarray(x) for x in (out, sample, s, sn)]
        tt = [torch.tensor(x) for x in (out, sample, s, sn)]
        np.testing.assert_allclose(ts.euler_step(*tt).numpy(), _j(js.euler_step, *tj), **TOL)
        np.testing.assert_allclose(
            ts.scale_model_input(tt[1], tt[2]).numpy(), _j(js.scale_model_input, tj[1], tj[2]), **TOL)
        np.testing.assert_allclose(
            ts.sigma_to_timestep(tt[2]).numpy(), _j(js.sigma_to_timestep, tj[2]), **TOL)


@pytest.mark.parametrize("hw,out_hw", [((72, 128), (224, 224)), ((576, 1024), (224, 224)), ((40, 30), (20, 10))])
def test_resize_antialiased(hw, out_hw):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(1, *hw, 3)).astype(np.float32)
    want = _j(jresize.resize_antialiased, jnp.asarray(x), out_hw)
    got = tresize.resize_antialiased(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == (1, *out_hw, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_gaussian_blur2d():
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(2, 20, 24, 3)).astype(np.float32)
    want = _j(jresize.gaussian_blur2d, jnp.asarray(x), (5, 7), (1.1, 1.7))
    got = tresize.gaussian_blur2d(torch.from_numpy(x), (5, 7), (1.1, 1.7)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
