"""The PyTorch port's loop geometry against `evoworld_tpu`, in fp32, to 1e-5.

Covers the navigator's path bookkeeping and Pluecker rays, `load_camera_poses`,
the spherical resampling (including the longitude seam), the pose alignment
(including the antiparallel case, a det = +1 rotation), the confidence filter
(including an input over 2^24 points, where `torch.quantile` refuses and the
port's `torch.kthvalue` route must agree with `jnp.percentile`), the z-buffer
splat (exact on tie-free points at radius 1 and 2) and the memory render.
Inputs come from seeded numpy; the JAX side runs at matmul precision "highest".
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.data.dataset import load_camera_poses as j_load_camera_poses
from evoworld_tpu.geometry import alignment as jal
from evoworld_tpu.geometry import resample as jrs
from evoworld_tpu.loop import navigator as jnav
from evoworld_tpu.memory.pointcloud import confidence_mask as j_confidence_mask
from evoworld_tpu.memory.render import align_target_poses as j_align
from evoworld_tpu.memory.render import render_memory_panoramas as j_render
from evoworld_tpu.ops.splat import splat_points_to_pano as j_splat
from evoworld_tpu_torch.data.dataset import load_camera_poses
from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
from evoworld_tpu_torch.geometry import alignment as tal
from evoworld_tpu_torch.geometry import resample as trs
from evoworld_tpu_torch.loop import navigator as tnav
from evoworld_tpu_torch.memory.pointcloud import confidence_mask, percentile
from evoworld_tpu_torch.memory.render import align_target_poses, render_memory_panoramas
from evoworld_tpu_torch.ops.splat import splat_points_to_pano
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = dict(rtol=1e-5, atol=1e-5)


def _j(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
    return jax.tree.map(np.asarray, out)


def _t(fn, *args, **kw):
    out = fn(*(torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
    return [o.numpy() for o in out] if isinstance(out, (tuple, list)) else out.numpy()


def _path(n, seed=0):
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(n, 6)) * np.array([0.3, 0.05, 0.3, 1.0, 8.0, 1.0])
    return np.cumsum(steps, axis=0).astype(np.float32)


@pytest.mark.parametrize("n", [10, 25, 49, 60])
def test_path_segmentation_matches(n):
    path = _path(n)
    for want, got in zip(jnav.split_curve_into_segments(path), tnav.split_curve_into_segments(path), strict=True):
        np.testing.assert_array_equal(got, want)
    turning = path.copy()
    turning[:, 3:6] = np.repeat(np.arange(n // 7 + 1), 7)[:n, None] * 15.0  # a rotation change every 7 poses
    for want, got in zip(jnav.split_path_into_segments(turning), tnav.split_path_into_segments(turning), strict=True):
        np.testing.assert_array_equal(got, want)
    for seg_id in range(4):
        assert tnav.calculate_segment_indices(seg_id, 24) == jnav.calculate_segment_indices(seg_id, 24)
    for length in (1, 2, 7, 25):
        np.testing.assert_allclose(tnav.extend_segment(path[:length], 25), jnav.extend_segment(path[:length], 25),
                                   **TOL)


def test_navigator_plucker_matches():
    cfg = PipelineConfig(height=64, width=128, num_frames=5)
    jn = jnav.Navigator(types.SimpleNamespace(config=cfg), num_frames=5)
    tn = tnav.Navigator(types.SimpleNamespace(config=cfg, device=torch.device("cpu")), num_frames=5)
    seg = _path(5, seed=1) * np.float32(0.1)
    np.testing.assert_allclose(tn.plucker_for_segment(seg).numpy(), _j(jn.plucker_for_segment, seg), **TOL)


def test_load_camera_poses_matches(tmp_path):
    rows = _path(12, seed=2)
    text = "Frame,PosX,PosY,PosZ,RotX,RotY,RotZ\n" + "".join(
        f"{i},{','.join(f'{x:.6f}' for x in r)}\n" for i, r in enumerate(rows)) + "\n12,1.0\n"
    path = tmp_path / "camera_poses.txt"
    path.write_text(text)
    for convert in (True, False):
        got, want = load_camera_poses(str(path), convert), j_load_camera_poses(str(path), convert)
        assert got.dtype == want.dtype and got.shape == (12, 6)
        np.testing.assert_array_equal(got, want)


def test_trajectory_cache_matches_jax(tmp_path):
    """`dump_trajectories`, `load_trajectory_file` and `trajectory_to_array`
    write and read the JAX package's camera_trajectories.json byte for
    byte, either side reading the other's cache."""
    from evoworld_tpu.data import dataset as jds
    from evoworld_tpu_torch.data import dataset as tds

    for side in ("port", "jax"):
        for e, n in (("ep_b", 12), ("ep_a", 5)):
            rows = _path(n, seed=len(e) + n)
            lines = "".join(f"{i},{','.join(f'{x:.6f}' for x in r)}\n" for i, r in enumerate(rows))
            (tmp_path / side / e).mkdir(parents=True)
            (tmp_path / side / e / "camera_poses.txt").write_text("Frame,PosX,PosY,PosZ,RotX,RotY,RotZ\n" + lines)
        (tmp_path / side / "no_poses").mkdir()
    got, want = tds.dump_trajectories(str(tmp_path / "port")), jds.dump_trajectories(str(tmp_path / "jax"))
    assert list(got) == ["ep_a", "ep_b"] and got == want
    assert (tmp_path / "port" / "camera_trajectories.json").read_bytes() == \
        (tmp_path / "jax" / "camera_trajectories.json").read_bytes()
    for side in ("port", "jax"):
        cache = str(tmp_path / side / "camera_trajectories.json")
        assert tds.load_trajectory_file(cache) == jds.load_trajectory_file(cache) == want
    arrays = [tds.trajectory_to_array(want["ep_b"]), jds.trajectory_to_array(want["ep_b"])]
    assert arrays[0].dtype == np.float32 and arrays[0].shape == (12, 6)
    np.testing.assert_array_equal(*arrays)
    shuffled = dict(reversed(list(want["ep_b"].items())))  # rows ordered by numeric frame id, not by insertion
    np.testing.assert_array_equal(tds.trajectory_to_array(shuffled), arrays[0])


def test_resampling_matches_including_the_seam():
    rng = np.random.default_rng(3)
    pano = rng.uniform(size=(32, 64, 3)).astype(np.float32)
    lon = np.concatenate([rng.uniform(-4.0, 4.0, 500),
                          np.pi + np.array([-1e-3, -1e-4, 0.0, 1e-4, 1e-3]),
                          -np.pi + np.array([-1e-3, 0.0, 1e-3])]).astype(np.float32)
    lat = rng.uniform(-np.pi / 2, np.pi / 2, lon.shape).astype(np.float32)
    np.testing.assert_allclose(_t(trs.bilinear_sample_pano, pano, lon, lat),
                               _j(jrs.bilinear_sample_pano, pano, lon, lat), **TOL)
    for yaw, pitch in ((0.0, 0.0), (0.7, 0.0), (-2.9, 0.3), (np.pi, -0.2)):
        got = trs.equi_to_pers(torch.from_numpy(pano), yaw=yaw, pitch=pitch, out_height=12, out_width=16).numpy()
        want = _j(jrs.equi_to_pers, pano, yaw=yaw, pitch=pitch, out_height=12, out_width=16)
        np.testing.assert_allclose(got, want, **TOL)
    for deg in (0.0, 30.0, -45.5, 400.0):
        np.testing.assert_array_equal(trs.rotate_pano_yaw(torch.from_numpy(pano), deg).numpy(),
                                      _j(jrs.rotate_pano_yaw, pano, deg))


@pytest.mark.parametrize("case", ["general", "antiparallel", "parallel", "zero"])
def test_rotation_between_vectors_matches(case):
    rng = np.random.default_rng(4)
    u = rng.normal(size=3).astype(np.float32)
    v = {"general": rng.normal(size=3).astype(np.float32), "antiparallel": -2.5 * u, "parallel": 3.0 * u,
         "zero": np.zeros(3, np.float32)}[case]
    got = _t(tal.rotation_between_vectors, u, v)
    np.testing.assert_allclose(got, _j(jal.rotation_between_vectors, u, v), **TOL)
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(got) - 1.0) < 1e-5
    if case != "zero":
        np.testing.assert_allclose(got @ (u / np.linalg.norm(u)), v / np.linalg.norm(v), atol=1e-5)


def test_similarity_fits_match():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(9, 3)).astype(np.float32)
    b = (1.7 * a @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.3).astype(np.float32)
    for fn_t, fn_j in ((tal.similarity_from_point_pairs, jal.similarity_from_point_pairs),
                       (tal.kabsch_similarity, jal.kabsch_similarity)):
        for got, want in zip(_t(fn_t, a, b), _j(fn_j, a, b), strict=True):
            np.testing.assert_allclose(got, want, **TOL)
    s, rot, t = _t(tal.similarity_from_point_pairs, a, b)
    np.testing.assert_allclose(_t(tal.apply_similarity, a, float(s), rot, t),
                               _j(jal.apply_similarity, a, float(s), rot, t), **TOL)


@pytest.mark.parametrize("q", [0.0, 50.0, 37.5, 95.0])
def test_confidence_mask_matches(q):
    conf = np.random.default_rng(6).gamma(2.0, size=(3, 7, 11)).astype(np.float32)
    np.testing.assert_array_equal(_t(confidence_mask, conf, q), _j(j_confidence_mask, conf, q))
    if q:
        np.testing.assert_allclose(percentile(torch.from_numpy(conf), q).item(), np.percentile(conf, q), **TOL)


def test_confidence_mask_over_two_to_the_24_points():
    """torch.quantile refuses more than 2^24 elements; the port's percentile
    does not, and agrees with jnp.percentile (heavy ties: 10007 levels)."""
    n = (1 << 24) + 4099
    conf = ((np.arange(n, dtype=np.int64) * 7919) % 10007).astype(np.float32)
    flat = torch.from_numpy(conf)
    with pytest.raises(RuntimeError):
        torch.quantile(flat, 0.5)
    got = confidence_mask(flat, 50.0)
    want = np.asarray(j_confidence_mask(jnp.asarray(conf), 50.0))
    assert int(got.sum()) == int(want.sum())
    np.testing.assert_array_equal(got.numpy(), want)


def _tie_free_cloud(n, seed):
    """Points whose packed (pixel, quantized log-depth) keys are all distinct:
    every point gets its own depth level (log-depth steps of 0.01, wider than
    the quantization step), in a random order and random directions, so
    pixels are shared and occlusion is exercised."""
    rng = np.random.default_rng(seed)
    depth = np.exp(rng.permutation(n) * 0.01).astype(np.float32)
    lon = rng.uniform(-np.pi, np.pi, n)
    lat = rng.uniform(-1.3, 1.3, n)
    d = np.stack([np.cos(lat) * np.sin(lon), np.sin(lat), np.cos(lat) * np.cos(lon)], -1)
    points = (d * depth[:, None]).astype(np.float32)
    points[:3] = 0.0  # at the camera: dropped
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    return points, colors, valid


@pytest.mark.parametrize("radius", [1, 2])
def test_splat_is_exact_on_tie_free_points(radius):
    points, colors, valid = _tie_free_cloud(1500, seed=7)
    c2w = np.eye(4, dtype=np.float32)[:3]
    got = splat_points_to_pano(*(torch.from_numpy(a) for a in (points, colors, c2w)), 24, 48,
                               valid=torch.from_numpy(valid), splat_radius=radius)
    want = _j(j_splat, points, colors, c2w, 24, 48, valid=jnp.asarray(valid), splat_radius=radius)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], **TOL)
    assert 0.3 < want[2].mean() < 1.0  # the cloud covers part of the panorama, with overlaps


def test_align_and_render_memory_match():
    rng = np.random.default_rng(8)
    rows = _path(30, seed=9)
    from evoworld_tpu.geometry.pose import pose_to_matrix as j_pose_to_matrix

    gt_c2w = _j(j_pose_to_matrix, rows, relative=True)
    ext = np.concatenate([np.linalg.qr(rng.normal(size=(10, 3, 3)))[0],
                          rng.normal(size=(10, 3, 1))], -1).astype(np.float32)
    for seg, start in ((0, 0), (0, 3)):
        got = _t(align_target_poses, gt_c2w, ext, seg, 4, recon_start=start)
        np.testing.assert_allclose(got, _j(j_align, gt_c2w, ext, seg, 4, recon_start=start), **TOL)
    targets = _t(align_target_poses, gt_c2w, ext, 1, 4)
    points, colors, valid = _tie_free_cloud(1200, seed=10)
    got = _t(render_memory_panoramas, points, colors, valid, targets, 16, 32)
    want = _j(j_render, points, colors, valid, targets, 16, 32)
    assert got.shape == (4, 16, 32, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("curve", [True, False])
def test_navigate_path_matches_with_a_stand_in_pipeline(curve):
    """`navigate_path`'s own work (segmenting, rotating the carried panorama in
    straight-path mode, carrying the last frame, the memory flag) against the
    JAX navigator's, with a stand-in pipeline on both sides that mixes its
    inputs into the frames it returns."""
    cfg = PipelineConfig(height=16, width=32, num_frames=5)

    def frames(start, plucker, memory, mask_mem, xp):
        mix = xp.tanh(plucker.mean(axis=(1, 2, 3)))[:, None, None, None] * 0.3
        mem = 0.0 if mask_mem else memory * 0.2
        return xp.clip((start[None] + 1.0) / 2.0 * 0.7 + mix + mem, 0.0, 1.0)

    def jpipe(s, p, m, rng, mask_mem):
        return frames(s, p, m, mask_mem, jnp)

    def tpipe(s, p, m, generator=None, mask_mem=False, latents=None, cond_noise=None):
        return frames(s, p, m, mask_mem, types.SimpleNamespace(tanh=torch.tanh, clip=torch.clamp))

    jpipe.config = tpipe.config = cfg
    tpipe.device = torch.device("cpu")
    jn, tn = jnav.Navigator(jpipe, num_frames=5), tnav.Navigator(tpipe, num_frames=5)
    path = _path(14, seed=11)
    path[:, 3] = path[:, 5] = 0.0
    path[:, 4] = np.repeat([0.0, 30.0, 30.0, -45.0], 4)[:14]  # yaw turns at poses 4 and 12
    rng = np.random.default_rng(12)
    start = rng.uniform(-1, 1, size=(16, 32, 3)).astype(np.float32)
    memory = rng.uniform(-1, 1, size=(5, 16, 32, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = [np.asarray(f) for f in jn.navigate_path(path * np.float32(0.1), jnp.asarray(start),
                                                         jnp.asarray(memory), jax.random.key(0), curve=curve)]
    got = tn.navigate_path(path * np.float32(0.1), torch.from_numpy(start), torch.from_numpy(memory), curve=curve)
    assert len(got) == len(want) == (4 if curve else 3)  # 5-frame windows and a tail; or 3 yaw runs
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
