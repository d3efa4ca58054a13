"""The port's metric nets loaded from torch-named state dicts, and the whole
evaluation harness, against `evoworld_tpu.eval`.

Synthesized upstream-named state dicts (the `lpips` package's, timm's
`inception_v4`, videogpt's I3D) are read by the JAX package's converters and
by the port's loaders; the nets, made sensitive to their input first
(`sensitive_`), then agree within rtol 2e-3 / atol 5e-4 on the same numpy
inputs. `calculate_all_metrics` on the same videos and
weights gives the same keys and structure, SSIM within 1e-5, PSNR within
1e-5 or 2e-6 relative, and the feature metrics (FVD, LPIPS, latent MSE)
within the nets' tolerance; each feature metric is first asserted to be far
above that tolerance's absolute floor.
"""

import jax
import numpy as np
import pytest
import torch

from evoworld_tpu.eval import feature_nets as jf
from evoworld_tpu.eval import harness as jh
from evoworld_tpu.eval import inception_v4 as ji4
from evoworld_tpu.eval import weights as jw
from evoworld_tpu_torch.eval import feature_nets as tf
from evoworld_tpu_torch.eval import harness as th
from evoworld_tpu_torch.eval import inception_v4 as ti4
from evoworld_tpu_torch.eval import weights as tw
from evoworld_tpu_torch.eval.harness import _inception_preprocess
from tests.test_torch_port_eval import (ATOL, RTOL, _apply, _port_net, _run_port, _videos, assert_sensitive, net_inputs,
                                         sensitive_)
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def synthesize_state_dict(model: torch.nn.Module, seed: int = 0) -> dict[str, np.ndarray]:
    """A torch-named state dict with `model`'s keys and shapes and random
    values that keep a deep net's scale: fan-in-scaled kernels, batch-norm
    scales near 1 and variances in [1, 2]. Counters and the LPIPS input
    scaling (constants) are left out."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked") or name.startswith("scaling_layer."):
            continue
        if name.endswith("running_var"):
            v = rng.uniform(1.0, 2.0, shape)
        elif len(shape) >= 2:
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith("weight"):  # norm scales
            v = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            v = 0.05 * rng.normal(size=shape)
        out[name] = v.astype(np.float32)
    return out


@pytest.mark.parametrize("name", ["lpips", "inception_v4", "i3d"])
def test_torch_named_state_dicts_load_in_both(name):
    """A synthesized upstream-named state dict: the JAX package's converter
    and the port's loader read it, and the two nets agree."""
    jmodel, tmodel, convert, to_port = {
        "lpips": (jf.LPIPSAlex(), tf.LPIPSAlex(), jw.convert_lpips_state_dict, tw.lpips_state_dict),
        "inception_v4": (ji4.InceptionV4Features(), ti4.InceptionV4Features(), jw.convert_inception_v4_state_dict,
                         tw.inception_v4_state_dict),
        "i3d": (jf.InceptionI3D(), tf.InceptionI3D(), jw.convert_i3d_state_dict, tw.i3d_state_dict),
    }[name]
    args = net_inputs(name)
    sd = sensitive_(_port_net(type(tmodel)(), to_port(synthesize_state_dict(tmodel))), *args)
    if name == "i3d":  # a DataParallel-wrapped, lowercased I3D: both packages normalise the keys
        sd = {"module." + k.replace("Mixed_3b", "mixed_3b"): v for k, v in sd.items()}
    out = _run_port(_port_net(tmodel, to_port(sd)), *args)
    assert_sensitive(out)
    np.testing.assert_allclose(out, _apply(jmodel, convert(sd), *args), rtol=RTOL, atol=ATOL)


def metric_weights(gen: np.ndarray, gt: np.ndarray, names=("lpips", "inception_v4"), i3d_size: int = 64,
                   seed: int = 0) -> dict[str, dict[str, np.ndarray]]:
    """Synthesized upstream state dicts of the harness nets `names`, each
    made sensitive to the (N, F, H, W, 3) [0, 1] videos it will score (I3D
    at `i3d_size`)."""
    videos = torch.from_numpy(np.concatenate([gen, gt]))
    nets = {"lpips": (tf.LPIPSAlex, tw.lpips_state_dict, lambda: ()),
            "inception_v4": (ti4.InceptionV4Features, tw.inception_v4_state_dict,
                             lambda: (_inception_preprocess(videos.reshape(-1, *videos.shape[2:])),)),
            "i3d": (tf.InceptionI3D, tw.i3d_state_dict, lambda: (tf.i3d_preprocess(videos, i3d_size),))}
    out = {}
    for i, name in enumerate(names):
        cls, to_port, inputs = nets[name]
        model = cls()
        out[name] = sensitive_(_port_net(model, to_port(synthesize_state_dict(model, seed + i))), *inputs())
    return out


def assert_resolved(result: dict) -> None:
    """Each feature metric's mean lies far above the parity tolerance's
    absolute floor, so a port that returned 0 would fail."""
    for key in ("fvd", "lpips", "latent_mse", "loop_closure_latent_mse"):
        if key in result:
            assert abs(result[key]["value_mean"]) > 100 * ATOL, (key, result[key]["value_mean"])


def assert_same_result(out, ref, path=""):
    """Equal keys and structure; numbers within the metric's tolerance."""
    if isinstance(ref, dict):
        assert isinstance(out, dict) and out.keys() == ref.keys(), (path, sorted(out), sorted(ref))
        for k in ref:
            assert_same_result(out[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert list(out) == list(ref), path
    elif isinstance(ref, str):
        assert out == ref, path
    elif path.startswith("/psnr"):
        # The JAX package's fp32 mean of the squared error sums in another
        # order: a relative error of ~1e-6 in PSNR (2.5e-5 dB at 26 dB,
        # where float64 puts the port 1.5e-6 dB from the exact value).
        np.testing.assert_allclose(out, ref, rtol=2e-6, atol=1e-5, err_msg=path)
    elif path.startswith("/ssim"):
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5, err_msg=path)
    else:
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL, err_msg=path)


def test_calculate_all_metrics_matches_jax():
    """Every metric but FVD, which needs 10 frames (the next test); 3 frames
    keep the Inception-v4 passes at 299 px few."""
    gen, gt = _videos(np.random.default_rng(9), (2, 3, 24, 40, 3), noise=0.2)
    weights = metric_weights(gen, gt)
    with jax.default_matmul_precision("highest"):
        ref = jh.calculate_all_metrics(gen, gt, nets=jh.FeatureNets(weights))
    out = th.calculate_all_metrics(gen, gt, nets=th.FeatureNets(weights, device="cpu"))
    assert set(ref) == {"ssim", "psnr", "lpips", "latent_mse", "loop_closure_latent_mse"}
    assert_resolved(ref)
    assert_same_result(out, ref)
    assert th.FeatureNets(device="cpu").tag("lpips") == "random_seed0_torch"


def test_fvd_matches_jax():
    """FVD of 3 videos of 10 frames, I3D at 64 px."""
    gen, gt = _videos(np.random.default_rng(10), (3, 10, 24, 40, 3), noise=0.2)
    weights = metric_weights(gen, gt, ["i3d"])
    with jax.default_matmul_precision("highest"):
        ref = jh.calculate_fvd_batch(gen, gt, jh.FeatureNets(weights), i3d_size=64)
    out = th.calculate_fvd_batch(gen, gt, th.FeatureNets(weights, device="cpu"), i3d_size=64)
    assert sorted(ref["value"]) == [10]
    assert_resolved({"fvd": ref})
    assert_same_result(out, ref, "/fvd")


def test_metric_weights_load_state_dicts_and_torchscript(tmp_path):
    """`load_metric_weights` reads a state dict as it is and a TorchScript
    archive (the reference's i3d_torchscript.pt) through its module."""

    class Wrapped(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.module = torch.nn.Linear(2, 3)

        def forward(self, x):
            return self.module(x)

    wrapped = Wrapped()
    torch.jit.script(wrapped).save(str(tmp_path / "i3d_torchscript.pt"))
    lpips = {"lin0.model.1.weight": torch.randn(1, 64, 1, 1)}
    torch.save(lpips, tmp_path / "lpips.pth")
    loaded = tw.load_metric_weights(str(tmp_path))
    assert sorted(loaded) == ["i3d", "lpips"]
    assert torch.equal(loaded["lpips"]["lin0.model.1.weight"], lpips["lin0.model.1.weight"])
    assert all(torch.equal(loaded["i3d"][k], v) for k, v in wrapped.state_dict().items())
    assert tw.load_metric_weights(str(tmp_path / "absent")) == {}
