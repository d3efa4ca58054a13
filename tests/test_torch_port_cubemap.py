"""The port's cubemap conversions and the `cube_to_pano` CLI against the JAX package.

- `geometry/resample.py::pano_to_cubemap` / `cubemap_to_pano` (bilinear,
  pixel centres): within 1e-5 of the JAX functions, and the round trip
  close to the identity away from the seams.
- `data/engine.py::unity_cubes_to_pano` / `ue_cubes_to_pano` (nearest
  neighbour, the texel index truncated after fp32 trigonometry): equal to
  the JAX functions but where torch's and XLA's fp32 sin and cos can land
  on either side of a tie, which `_ties` finds in float64: a ray on the
  seam of two faces (the panorama columns at 45 degrees) or on a texel's
  edge, where each side picks a neighbouring texel. Every differing pixel
  must be such a tie, and at the CLI's default 1000 x 2000 from faces of
  1024 at most ENGINE_MAX_FLIPPED of the pixels may differ. Faces of
  random texels make every other wrong index show.
- `cli/cube_to_pano.py` on both capture layouts (Unity directories, UE flat
  `<id>_<face>.png` files) against the JAX CLI, the written PNGs decoded and
  held to the same share, and a second run skipping what exists.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from evoworld_tpu.cli import cube_to_pano as j_cli
from evoworld_tpu.data import engine as j_engine
from evoworld_tpu.geometry import resample as j_resample
from evoworld_tpu_torch.cli import cube_to_pano
from evoworld_tpu_torch.data import engine
from evoworld_tpu_torch.geometry import resample
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = dict(rtol=1e-5, atol=1e-5)
ENGINE_MAX_FLIPPED = 1e-3


def _faces(seed, size):
    return np.random.default_rng(seed).integers(0, 256, (6, size, size, 3)).astype(np.float32) / 255.0


def _ties(face_size, height, width):
    """(H, W) bool: the rays of `unity_cubes_to_pano` near a tie, in float64:
    two axes' magnitudes within 1e-6 (a face seam), or a texel index u (S - 1)
    or (1 - v) (S - 1) within S x 1e-6 of a whole number (fp32's rounding of
    the index is about S x 1.2e-7, a few of its ulps)."""
    yv, xv = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    lon = (-yv / width) * 2.0 * np.pi - np.pi + np.pi / 2.0
    lat = (xv / height) * np.pi - np.pi / 2.0
    x, y, z = np.cos(lat) * np.cos(lon), np.sin(lat), np.cos(lat) * np.sin(lon)
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    seam = (np.abs(ax - ay) < 1e-6) | (np.abs(ax - az) < 1e-6) | (np.abs(ay - az) < 1e-6)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay >= ax) & (ay >= az) & ~is_x
    with np.errstate(divide="ignore", invalid="ignore"):  # np.where evaluates every branch
        u = np.where(is_x, np.where(x > 0, -z, z) / ax, np.where(is_y, -x / ay, np.where(z > 0, x, -x) / az))
        v = np.where(is_x, -y / ax, np.where(is_y, np.where(y > 0, -z, z) / ay, -y / az))
    edge = [np.abs(t - np.round(t)) < 1e-6 * face_size for t in ((u + 1) / 2 * (face_size - 1),
                                                                 (1 - (v + 1) / 2) * (face_size - 1))]
    return seam | edge[0] | edge[1]


def _differ(a, b):
    return (np.asarray(a, np.float32) != np.asarray(b, np.float32)).any(-1)


def test_pano_to_cubemap_and_back_match_jax():
    rng = np.random.default_rng(0)
    pano = rng.uniform(size=(24, 48, 3)).astype(np.float32)
    faces = resample.pano_to_cubemap(torch.from_numpy(pano), 12).numpy()
    np.testing.assert_allclose(faces, np.asarray(j_resample.pano_to_cubemap(jnp.asarray(pano), 12)), **TOL)
    back = resample.cubemap_to_pano(torch.from_numpy(faces), 24, 48).numpy()
    np.testing.assert_allclose(back, np.asarray(j_resample.cubemap_to_pano(jnp.asarray(faces), 24, 48)), **TOL)
    odd = rng.uniform(size=(6, 7, 7, 2)).astype(np.float32)  # an odd face size, two channels
    np.testing.assert_allclose(resample.cubemap_to_pano(torch.from_numpy(odd), 10, 30).numpy(),
                               np.asarray(j_resample.cubemap_to_pano(jnp.asarray(odd), 10, 30)), **TOL)
    # a smooth panorama survives the round trip (the conventions invert each other)
    y, x = np.mgrid[0:24, 0:48].astype(np.float32)
    smooth = np.stack([np.cos(x / 48 * 2 * np.pi), np.sin(y / 24 * np.pi), np.ones_like(x)], -1) * 0.5 + 0.5
    trip = resample.cubemap_to_pano(resample.pano_to_cubemap(torch.from_numpy(smooth), 32), 24, 48).numpy()
    assert np.abs(trip - smooth)[3:-3].max() < 0.05


@pytest.mark.parametrize("which", ["unity", "ue"])
@pytest.mark.parametrize("size,hw", [(16, (32, 64)), (48, (100, 200)), (1024, (1000, 2000))])
def test_engine_cubes_to_pano_match_jax(which, size, hw):
    faces = _faces(size, size)
    fn, jfn = {"unity": (engine.unity_cubes_to_pano, j_engine.unity_cubes_to_pano),
               "ue": (engine.ue_cubes_to_pano, j_engine.ue_cubes_to_pano)}[which]
    got = fn(torch.from_numpy(faces), *hw).numpy()
    want = np.asarray(jfn(jnp.asarray(faces), *hw))
    assert got.shape == want.shape == (*hw, 3)
    differ = _differ(got, want)
    assert not (differ & ~_ties(size, *hw)).any(), np.argwhere(differ & ~_ties(size, *hw))[:5]
    if size == 1024:
        assert differ.mean() <= ENGINE_MAX_FLIPPED
    if which == "ue":  # the top and bottom faces are read turned by 180 degrees
        assert _differ(got, engine.unity_cubes_to_pano(torch.from_numpy(faces), *hw).numpy()).mean() > 0.1


def _write_captures(root, layout, faces_u8):
    """Two frames of six face PNGs in the Unity or the UE layout."""
    os.makedirs(root)
    for frame, faces in enumerate(faces_u8):
        for name, face in zip(engine.FACE_ORDER, faces):
            if layout == "unity":
                os.makedirs(os.path.join(root, f"{frame:03d}"), exist_ok=True)
                path = os.path.join(root, f"{frame:03d}", f"{name}.png")
            else:
                path = os.path.join(root, f"{frame + 1}_{name}.png")
            Image.fromarray(face).save(path)


@pytest.mark.parametrize("layout", ["unity", "ue"])
def test_cube_to_pano_cli_matches_jax_cli(tmp_path, layout):
    faces = np.random.default_rng(7).integers(0, 256, (2, 6, 40, 40, 3), dtype=np.uint8)
    captures = str(tmp_path / "captures")
    _write_captures(captures, layout, faces)
    common = [f"--data.root={captures}", "--data.height=60", "--data.width=120", f"--data.engine={layout}"]
    theirs, ours = str(tmp_path / "jax"), str(tmp_path / "port")
    with jax.default_matmul_precision("highest"):
        j_cli.main(common + [f"--runtime.save_dir={theirs}"])
    written = cube_to_pano.main(common + [f"--runtime.save_dir={ours}"], device="cpu")
    names = sorted(os.listdir(theirs))
    assert names == sorted(os.listdir(ours)) == sorted(os.path.basename(p) for p in written)
    assert len(names) == 2
    for name in names:
        a, b = (np.asarray(Image.open(os.path.join(d, name))) for d in (ours, theirs))
        assert a.shape == b.shape == (60, 120, 3)
        assert not (_differ(a, b) & ~_ties(40, 60, 120)).any(), name
    assert cube_to_pano.main(common + [f"--runtime.save_dir={ours}"], device="cpu") == []  # all exist: skipped
