"""The port's sky segmentation stack against the JAX package's, on the CPU:
`memory/onnx_io.py`, `memory/u2net.py` and `memory/skyseg.py`.

- ONNX: each side's writer read by the other's reader, tensors of several
  dtypes (the writer stores float32), a rank-0 tensor and an empty name;
  and a hand-built file of every stored form the readers take (raw data in
  float16, int32, int64 and float64; packed float, double and varint int64
  fields) read alike by both.
- U^2-Net at full width (every stage and head, 44 M parameters) on a 50 x 70
  input, so that each ceil-mode pooling pads: the port, the JAX `U2Net` and
  the independent torch twin `tests/torch_u2net.py`, all from one state,
  within the models' tolerance (rtol 2e-3 / atol 5e-4). Random weights
  ignore their input, so the state is made sensitive to the inputs first
  (`chip_smoke.sensitive_metric_net_`: batch-norm statistics from a pass
  over them), and the test asserts that the output moves with the input.
  The weight bridges are held exactly: the JAX package's ONNX-name
  converter and back through `u2net_params_from_jax`.
- `SkySegmentation` on crops: the masks (0 on sky, 255 elsewhere) at most
  MASK_MAX_FLIPPED apart from the JAX masks, where a min-max normalized
  value near 1 can floor either way; each mask neither all sky nor none;
  `apply_to_conf` onto confidences of another size; the weights-free
  heuristic exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from evoworld_tpu.memory import onnx_io as j_onnx
from evoworld_tpu.memory import skyseg as j_skyseg
from evoworld_tpu.memory.u2net import U2Net as JU2Net
from evoworld_tpu_torch.memory import onnx_io, skyseg
from evoworld_tpu_torch.memory.u2net import U2Net
from evoworld_tpu_torch.models.weights import u2net_params_from_jax
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tests.torch_u2net import U2NET as TwinU2NET

RTOL, ATOL = 2e-3, 5e-4
MASK_MAX_FLIPPED = 0.01


def _inputs(seed: int, n: int, h: int, w: int) -> np.ndarray:
    """Smooth random colour fields, (n, h, w, 3) in [0, 1]."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.uniform(size=(n, 3, 4, 5)).astype(np.float32))
    fine = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    return np.clip(fine.permute(0, 2, 3, 1).numpy() + rng.normal(0, 0.02, (n, h, w, 3)), 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def sensitive_state():
    """A random state made sensitive to 50 x 70 inputs normalized as the sky
    mask normalizes its 320 x 320 ones."""
    net = skyseg.load_u2net_state_(U2Net(), chip_smoke.random_u2net_state(0))
    x = (_inputs(1, 2, 50, 70) - np.array(skyseg._IMAGENET_MEAN, np.float32)) / np.array(
        skyseg._IMAGENET_STD, np.float32)
    return {k: v.numpy() for k, v in chip_smoke.sensitive_metric_net_(net, torch.from_numpy(
        x.transpose(0, 3, 1, 2).copy())).items()}


def test_onnx_round_trip_between_the_two_packages(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"stage1.rebnconvin.conv_s1.weight": rng.normal(size=(4, 3, 3, 3)),  # float64, stored as float32
               "counts": np.arange(6, dtype=np.int64).reshape(2, 3), "half": rng.normal(size=5).astype(np.float16),
               "": rng.normal(size=(2,)).astype(np.float32), "scalar": np.float32(2.5).reshape(())}
    for write, read in ((onnx_io.write_onnx_initializers, j_onnx.read_onnx_initializers),
                        (j_onnx.write_onnx_initializers, onnx_io.read_onnx_initializers)):
        path = str(tmp_path / f"{write.__module__}.onnx")
        write(path, tensors)
        got = read(path)
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], np.asarray(v, np.float32))
    port_bytes, jax_bytes = tmp_path / "p.onnx", tmp_path / "j.onnx"
    onnx_io.write_onnx_initializers(str(port_bytes), tensors)
    j_onnx.write_onnx_initializers(str(jax_bytes), tensors)
    assert port_bytes.read_bytes() == jax_bytes.read_bytes()


def _tensor_proto(name: str, dims, data_type: int, **fields) -> bytes:
    """A TensorProto; fields raw (9), floats (4), int64s (7, varints), doubles (10)."""
    v, f = onnx_io._varint, onnx_io._field
    out = b"".join(f(1, 0, v(d)) for d in dims) + f(2, 0, v(data_type))
    out += f(8, 2, v(len(name.encode())) + name.encode())
    if "raw" in fields:
        out += f(9, 2, v(len(fields["raw"])) + fields["raw"])
    if "floats" in fields:
        payload = np.asarray(fields["floats"], "<f4").tobytes()
        out += f(4, 2, v(len(payload)) + payload)
    if "doubles" in fields:
        payload = np.asarray(fields["doubles"], "<f8").tobytes()
        out += f(10, 2, v(len(payload)) + payload)
    if "int64s" in fields:
        payload = b"".join(v(int(x)) for x in fields["int64s"])
        out += f(7, 2, v(len(payload)) + payload)
    return out


def test_both_readers_take_every_stored_form(tmp_path):
    half = np.array([[1.5, -2.0]], np.float16)
    protos = [_tensor_proto("half", (1, 2), 10, raw=half.tobytes()),
              _tensor_proto("int32", (3,), 6, raw=np.array([1, -2, 3], "<i4").tobytes()),
              _tensor_proto("raw64", (2,), 7, raw=np.array([5, 1 << 40], "<i8").tobytes()),
              _tensor_proto("double", (2, 1), 11, raw=np.array([0.25, 1e300], "<f8").tobytes()),
              _tensor_proto("packed_float", (2, 2), 1, floats=[1, 2, 3, 4]),
              _tensor_proto("packed_double", (3,), 11, doubles=[1.0, -0.5, 2.0]),
              _tensor_proto("varint64", (2,), 7, int64s=[7, 300]),
              _tensor_proto("", (), 1, floats=[9.0])]
    graph = b"".join(onnx_io._field(5, 2, onnx_io._varint(len(p)) + p) for p in protos)
    path = tmp_path / "forms.onnx"
    path.write_bytes(onnx_io._field(7, 2, onnx_io._varint(len(graph)) + graph))
    ours, theirs = onnx_io.read_onnx_initializers(str(path)), j_onnx.read_onnx_initializers(str(path))
    assert list(ours) == list(theirs) == ["half", "int32", "raw64", "double", "packed_float", "packed_double",
                                          "varint64", ""]
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
        np.testing.assert_array_equal(ours[k], theirs[k])
    np.testing.assert_array_equal(ours["half"], half)
    np.testing.assert_array_equal(ours["varint64"], [7, 300])
    assert ours[""].shape == () and ours["raw64"][1] == 1 << 40


def test_u2net_full_width_matches_jax_and_the_torch_twin(sensitive_state):
    params, report = j_skyseg.convert_u2net_onnx_initializers(sensitive_state)
    assert report == []
    bridged = u2net_params_from_jax(params)
    assert set(bridged) == set(sensitive_state)
    for k, v in bridged.items():
        np.testing.assert_array_equal(v.numpy(), sensitive_state[k], err_msg=k)
    net = skyseg.load_u2net_state_(U2Net(), bridged).eval()
    twin = TwinU2NET(3, 1)
    missing, unexpected = twin.load_state_dict({k: torch.from_numpy(v) for k, v in sensitive_state.items()},
                                               strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    twin.eval()
    x = (_inputs(1, 2, 50, 70) - np.array(skyseg._IMAGENET_MEAN, np.float32)) / np.array(
        skyseg._IMAGENET_STD, np.float32)
    other = (_inputs(2, 1, 50, 70) - 0.45) / 0.225
    with torch.no_grad():
        got = net(torch.from_numpy(np.concatenate([x, other]).transpose(0, 3, 1, 2).copy()))[:, 0].numpy()
        twin_out = twin(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))[:, 0].numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(JU2Net().apply)(params, jnp.asarray(x)))[..., 0]
    assert got.shape == (3, 50, 70)
    np.testing.assert_allclose(got[:2], want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[:2], twin_out, rtol=RTOL, atol=ATOL)
    # sensitive: the map varies across each image and between images, far beyond the tolerance
    assert got.std(axis=(1, 2)).min() > 100 * ATOL
    assert np.abs(got[0] - got[2]).mean() > 100 * ATOL


def test_sky_segmentation_matches_jax(sensitive_state, tmp_path):
    path = str(tmp_path / "skyseg.onnx")
    onnx_io.write_onnx_initializers(path, sensitive_state)
    crops = _inputs(3, 2, 48, 64)
    ours = skyseg.SkySegmentation(path, device="cpu")
    got = ours.sky_masks(torch.from_numpy(crops)).numpy()
    jproc = j_skyseg.SkySegmentation(path)
    with jax.default_matmul_precision("highest"):
        want = np.stack([np.asarray(jproc.sky_mask(jnp.asarray(c))) for c in crops])
    assert got.shape == want.shape == (2, 48, 64)
    assert set(np.unique(got)) <= {0.0, 255.0}
    for g, w in zip(got, want):
        assert 0.02 < (w == 0).mean() < 0.98, "the reference mask is all sky or none: the test would prove nothing"
        assert (g != w).mean() <= MASK_MAX_FLIPPED
    conf = np.random.default_rng(4).uniform(0.5, 2.0, (2, 52, 70)).astype(np.float32)  # VGGT's size differs
    out = ours.apply_to_conf(torch.from_numpy(conf), torch.from_numpy(crops)).numpy()
    with jax.default_matmul_precision("highest"):
        jout = np.asarray(jproc.apply_to_conf(jnp.asarray(conf), jnp.asarray(crops)))
    assert ((out == 0) != (jout == 0)).mean() <= MASK_MAX_FLIPPED
    np.testing.assert_array_equal(out[out != 0], conf[out != 0])


def test_sky_mask_heuristic_matches_jax_exactly():
    rng = np.random.default_rng(5)
    images = _inputs(6, 3, 30, 40)
    images[:, :12, :, :] = np.array([0.55, 0.7, 0.95], np.float32) + rng.normal(0, 0.002, (3, 12, 40, 3))  # sky
    images = np.clip(images, 0, 1).astype(np.float32)
    proc = skyseg.SkySegmentation(None, device="cpu")
    got = proc.sky_masks(torch.from_numpy(images)).numpy()
    want = np.stack([np.asarray(j_skyseg.sky_mask_heuristic(jnp.asarray(i))) for i in images])
    np.testing.assert_array_equal(got, want)
    assert 0.05 < (got == 0).mean() < 0.6
    conf = rng.uniform(size=(3, 30, 40)).astype(np.float32)
    np.testing.assert_array_equal(skyseg.apply_sky_mask(torch.from_numpy(conf), torch.from_numpy(images)).numpy(),
                                  np.asarray(j_skyseg.apply_sky_mask(jnp.asarray(conf), jnp.asarray(images))))


def test_u2net_loader_strips_wrapper_prefixes_and_names_what_is_missing(sensitive_state):
    """Initializer names under an exporter's wrapper prefix load as the bare
    ones; a state short of a tensor, or with one the net lacks, is refused
    naming it."""
    bare = skyseg.load_u2net_state_(U2Net(), sensitive_state).state_dict()
    wrapped = skyseg.load_u2net_state_(U2Net(), {f"module.{k}": v for k, v in sensitive_state.items()}).state_dict()
    assert all(torch.equal(bare[k], wrapped[k]) for k in sensitive_state)
    short = {k: v for k, v in sensitive_state.items() if k != "outconv.bias"}
    with pytest.raises(ValueError, match="missing \\['outconv.bias'\\]"):
        skyseg.load_u2net_state_(U2Net(), short)
    with pytest.raises(ValueError, match="unexpected \\['side7.weight'\\]"):
        skyseg.load_u2net_state_(U2Net(), {**sensitive_state, "side7.weight": np.zeros(3, np.float32)})
