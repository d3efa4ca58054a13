"""The port's data-parallel training and `reproject` under several ranks,
on CPU ranks over gloo.

One spawn of W = 2 ranks (`parallel/launch.py`, `parallel.checks.several_rank`)
runs, in turn: the data-parallel `train_step` at ZeRO-1 and at ZeRO-2 on a
global batch of 2 (the ZeRO rule's `min_size` set to 1024, so that some
leaves are split and some replicated), the training CLI at the tiny preset
(the rule at its default splits its feed-forward weights; an uninterrupted
2-step run; a 1-step run then its resume to 2) and the reproject CLI. The
parent meanwhile runs the same step in one process and through
`evoworld_tpu.train.train_step.make_sharded_train_step` on 2 CPU devices at
ZeRO-2 (fp32, matmul precision "highest", JAX's draws), and the same
reproject in one process, then resumes the W = 2 checkpoint at W = 1.
The models are those of `tests/test_torch_port_train.py` cut to one UNet
level and single layers, so that JAX compiles its sharded step in seconds.

Tolerances:
- against the one-process step (the same float work at batch 1 rather than
  2): loss and gradient norm rtol 1e-5; gradients and the gathered
  moments within 1e-4 of each tensor's largest value plus a floor (1e-6,
  and 1e-7 and 1e-12 for the first and second moments, which a leaf with
  a gradient of rounding noise needs); updated masters atol 3e-7 (a few ulps at 1, 3e-3 of the learning
  rate). A rank's gradient left out of the mean moves the gradients and
  the moments by their own size and the masters by ~lr;
- against JAX's ZeRO-2 step: loss 1e-5, gradient norm rtol 2e-3 and the
  masters atol 1e-6, as `tests/test_torch_port_train_step.py` (Adam's eps
  1e-4 there and here: its first update g / (|g| + eps) would otherwise
  magnify the frameworks' ~1e-9 differences in near-zero gradients);
- a W = 2 run resumed at W = 2 equals the uninterrupted run bit for bit;
  resumed at W = 1, within the one-process tolerances above;
- the ranks' renders equal the one-process CLI's, byte for byte.
"""

import concurrent.futures
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.models.clip import CLIPVisionConfig as JClipCfg
from evoworld_tpu.models.clip import CLIPVisionTower as JClip
from evoworld_tpu.models.unet import UNetConfig as JUNetCfg
from evoworld_tpu.models.unet import UNetSpatioTemporal as JUNet
from evoworld_tpu.models.vae import AutoencoderKLTemporal as JVAE
from evoworld_tpu.models.vae import VAEConfig as JVAECfg
from evoworld_tpu.models.weights import host_random_params
from evoworld_tpu.parallel.mesh import make_mesh as jmake_mesh
from evoworld_tpu.train import train_step as jts
from evoworld_tpu_torch.cli import reproject, train
from evoworld_tpu_torch.cli.common import load_frames
from evoworld_tpu_torch.models.clip import CLIPVisionConfig
from evoworld_tpu_torch.models.unet import UNetConfig
from evoworld_tpu_torch.models.vae import VAEConfig
from evoworld_tpu_torch.models.weights import params_from_jax
from evoworld_tpu_torch.parallel.checks import train_step_rank
from evoworld_tpu_torch.parallel.launch import Ranks
from evoworld_tpu_torch.parallel.mesh import Mesh, zero_sharded
from evoworld_tpu_torch.runtime import build_trainer
from evoworld_tpu_torch.train.train_step import TRAINABLE_KEYS
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tests.test_torch_port_reproject import ARGS as REPROJECT_ARGS
from tests.test_torch_port_reproject import _write_episode
from tests.test_torch_port_train import jax_draws
from tests.test_torch_port_train_cli import episode  # noqa: F401  (the training CLI's episode fixture)

UNET = dict(block_out_channels=(32,), num_attention_heads=(2,), layers_per_block=1, cross_attn_blocks=(True,))
VAE = dict(block_out_channels=(32, 32, 32, 32), layers_per_block=1)
CLIP = dict(hidden_size=64, num_layers=1, num_heads=4, mlp_dim=128)
B, F, H, W = 2, 2, 64, 128
STEP = dict(total_steps=10, warmup_steps=0, learning_rate=1e-4, adam_eps=1e-4)
MIN_SIZE = 1024  # the ZeRO rule's threshold for the step (its default, 65536, splits no leaf of these models)
CLI = ["--runtime.model_preset=tiny", "--runtime.compute_dtype=float32", f"--pipeline.height={H}",
       f"--pipeline.width={W}", "--data.sequence_length=3", "--pipeline.num_frames=3", "--train.warmup_steps=0",
       "--trainer.log_steps=1", "--trainer.prefetch_depth=0", "--train.adam_eps=1e-4"]
STEP_RTOL, GRAD_ATOL, GRAD_RTOL, MASTER_ATOL = 1e-5, 1e-6, 1e-4, 3e-7
MOMENT_ATOL = {"mu": 1e-7, "nu": 1e-12}  # (1 - b1) and (1 - b2) times the gradients' floor and its square


def _models():
    """The JAX modules with host-random parameters (every UNet leaf perturbed,
    as in `tests/test_torch_port_train.py`) and the port's configurations
    and state dicts of the same weights."""
    key = jax.random.key(0)
    junet, jvae, jclip = JUNet(JUNetCfg(**UNET)), JVAE(JVAECfg(**VAE)), JClip(JClipCfg(**CLIP))
    shapes = jax.eval_shape(junet.init, key, jnp.zeros((1, F, H // 8, W // 8, 18)), jnp.asarray(1.0),
                            jnp.zeros((1, 1, 1024)), jnp.zeros((1, 3)))
    rng = np.random.default_rng(11)
    uparams = jax.tree.map(lambda x: x + 0.02 * rng.normal(size=x.shape).astype(np.float32),
                           host_random_params(shapes, 0, jnp.float32, as_numpy=True))
    frozen = {
        "vae": host_random_params(jax.eval_shape(functools.partial(jvae.init, num_frames=1), key,
                                                 jnp.zeros((1, H, W, 3))), 1, jnp.float32),
        "clip": host_random_params(jax.eval_shape(jclip.init, key, jnp.zeros((1, 224, 224, 3))), 2, jnp.float32),
    }
    port = {"unet": (UNetConfig(**UNET), params_from_jax(uparams)),
            "vae": (VAEConfig(**VAE), params_from_jax(jax.tree.map(np.asarray, frozen["vae"]))),
            "clip": (CLIPVisionConfig(**CLIP), params_from_jax(jax.tree.map(np.asarray, frozen["clip"])))}
    return (junet, jvae, jclip, uparams, frozen), port


def _global_batch():
    rng = np.random.default_rng(5)
    return {"pixel_values": rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
            "memory_values": rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
            "plucker": rng.normal(size=(B, F, H // 8, W // 8, 6)).astype(np.float32)}


def _jax_step(jax_side, batch):
    junet, jvae, jclip, uparams, frozen = jax_side
    cfg = jts.TrainConfig(**STEP, zero_stage=2)
    opt = jts.make_optimizer(cfg, uparams)
    state = jts.TrainState(jax.tree.map(jnp.asarray, uparams), opt.init(uparams), jnp.zeros((), jnp.int32))
    step = jts.make_sharded_train_step(junet, jvae, jclip, frozen, opt, cfg, jmake_mesh(jax.devices()[:2], data=2),
                                       compute_dtype=jnp.float32, zero_stage=2)
    with jax.default_matmul_precision("highest"):
        new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(9))
    return float(metrics["loss"]), float(metrics["grad_norm"]), params_from_jax(jax.tree.map(np.asarray,
                                                                                            new_state.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, episode):  # noqa: F811
    root = tmp_path_factory.mktemp("mesh_train")
    jax_side, port = _models()
    batch = _global_batch()
    draws = jax_draws(jax.random.key(9), b=B, f=F, h=H, w=W)
    prep = str(root / "prep")
    _write_episode(os.path.join(prep, "ranks"), seed=1)
    shutil.copytree(os.path.join(prep, "ranks"), os.path.join(prep, "one"))
    reproject_argv = [*REPROJECT_ARGS, "--data.mask_sky=false", "--runtime.vggt_tiny=true",
                      "--runtime.compute_dtype=float32", "--runtime.seed=3"]
    cli = [f"--data.root={episode}", *CLI]
    out = {k: str(root / k) for k in ("uninterrupted", "resumed", "at_w1")}
    calls = [("train_step_rank", (port, dict(STEP, zero_stage=stage), [batch], [draws], MIN_SIZE))
             for stage in (1, 2)]
    calls.append(("train_cli_rank", ([[*cli, f"--runtime.save_dir={out['uninterrupted']}", "--train.total_steps=2"],
                                      [*cli, f"--runtime.save_dir={out['resumed']}", "--train.total_steps=1"],
                                      [*cli, f"--runtime.save_dir={out['resumed']}", "--train.total_steps=2"]],
                                     str(root))))
    calls.append(("reproject_rank", ([*reproject_argv, f"--data.root={prep}/ranks"],)))
    job = Ranks("evoworld_tpu_torch.parallel.checks:several_rank", 2, str(root / "job"), device="cpu",
                args=(calls,))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # JAX compiles its step meanwhile
        jax_step = pool.submit(_jax_step, jax_side, batch)
        one = train_step_rank(None, port, STEP, [batch], [draws], MIN_SIZE)
        one_records = reproject.main([*reproject_argv, f"--data.root={prep}/one"], device="cpu")
        ranks = job.results()
        os.makedirs(os.path.join(out["at_w1"], "checkpoints"))
        shutil.copy(os.path.join(out["resumed"], "checkpoints", "1.pt"), os.path.join(out["at_w1"], "checkpoints"))
        train.main([*cli, f"--runtime.save_dir={out['at_w1']}", "--train.total_steps=2",
                    "--trainer.per_device_batch_size=2"], device="cpu")
        jax_step = jax_step.result()
    return dict(ranks=ranks, one=one, jax=jax_step, out=out, prep=prep, one_records=one_records, root=str(root))


def _whole(ranks, name, stage):
    """The gradient of leaf `name` the optimizer was given, whole: at ZeRO-2 a
    sharded leaf's pieces joined in rank order, else rank 0's."""
    pieces = [r[stage - 1]["grads"][name] for r in ranks]
    if stage >= 2 and name in ranks[0][stage - 1]["sharded"]:
        return torch.cat(pieces)
    assert all(torch.equal(p, pieces[0]) for p in pieces), name  # a whole gradient is the same on every rank
    return pieces[0]


@pytest.mark.parametrize("stage", [1, 2])
def test_sharded_step_matches_the_one_process_step(runs, stage):
    ranks, one = runs["ranks"], runs["one"]
    sharded = ranks[0][stage - 1]["sharded"]
    assert sharded and len(sharded) < len(one["params"])  # the rule splits some leaves and replicates others
    if stage >= 2:  # the pieces, not the whole gradients, reach the optimizer
        name = sharded[0]
        assert ranks[0][1]["grads"][name].shape[0] * 2 == one["params"][name].shape[0]
    for r in ranks:
        res = r[stage - 1]
        np.testing.assert_allclose(res["loss"], one["loss"], rtol=STEP_RTOL)
        np.testing.assert_allclose(res["grad_norm"], one["grad_norm"], rtol=STEP_RTOL)
        for name, p in one["params"].items():
            np.testing.assert_allclose(res["params"][name].numpy(), p.numpy(), rtol=0, atol=MASTER_ATOL,
                                       err_msg=name)
        for i, want in one["opt_state"]["state"].items():
            for k in ("mu", "nu"):
                np.testing.assert_allclose(res["opt_state"]["state"][i][k].numpy(), want[k].numpy(), rtol=0,
                                           atol=MOMENT_ATOL[k] + GRAD_RTOL * float(want[k].abs().max()),
                                           err_msg=f"{k} {i}")
        assert res["opt_state"]["param_groups"][0]["count"] == 1
    for name, g in one["grads"].items():
        got = _whole(ranks, name, stage)
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_ATOL + GRAD_RTOL * float(g.abs().max()), err_msg=name)


def test_sharded_zero2_step_matches_jax(runs):
    loss, grad_norm, want = runs["jax"]
    for r in runs["ranks"]:
        res = r[1]
        np.testing.assert_allclose(res["loss"], loss, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["grad_norm"], grad_norm, rtol=2e-3)
        for name, p in res["params"].items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)


def _checkpoint(run_dir, step):
    return torch.load(os.path.join(run_dir, "checkpoints", f"{step}.pt"), weights_only=True)


def test_a_two_rank_checkpoint_resumes_at_one_and_two_ranks(runs):
    unet = build_trainer("tiny", device="cpu", compute_dtype=torch.float32)[0]
    mesh = Mesh(2, 1, 0, torch.device("cpu"), "gloo")
    split = [zero_sharded(p, mesh) for p in unet.parameters() if p.requires_grad]
    assert any(split) and not all(split)  # the CLI's default rule splits some of the tiny preset's leaves
    out = runs["out"]
    whole = _checkpoint(out["uninterrupted"], 2)
    resumed, at_w1 = _checkpoint(out["resumed"], 2), _checkpoint(out["at_w1"], 2)
    params = dict(whole["params"])
    trainable = [n for n in params if any(k in n.lower() for k in TRAINABLE_KEYS)]
    for i, name in enumerate(trainable):  # the one-process format: every moment whole
        assert whole["opt_state"]["state"][i]["mu"].shape == params[name].shape
    for name, p in params.items():
        assert torch.equal(resumed["params"][name], p), name
        np.testing.assert_allclose(at_w1["params"][name].numpy(), p.numpy(), rtol=0, atol=MASTER_ATOL, err_msg=name)
    for i, want in whole["opt_state"]["state"].items():
        assert all(torch.equal(resumed["opt_state"]["state"][i][k], want[k]) for k in ("mu", "nu"))
        np.testing.assert_allclose(at_w1["opt_state"]["state"][i]["mu"].numpy(), want["mu"].numpy(), rtol=0,
                                   atol=MOMENT_ATOL["mu"] + GRAD_RTOL * float(want["mu"].abs().max()))
    assert torch.equal(resumed["rng"], whole["rng"]) and torch.equal(at_w1["rng"], whole["rng"])
    assert whole["opt_state"]["param_groups"][0]["count"] == at_w1["opt_state"]["param_groups"][0]["count"] == 2


def test_only_rank_zero_writes_the_training_files(runs):
    root = runs["root"]
    writes = [r[2]["writes"] for r in runs["ranks"]]
    assert writes[1] == []
    written = {path for _, path in writes[0]}
    for run in ("uninterrupted", "resumed"):
        assert {f"{run}/checkpoints/2.pt", f"{run}/train_metrics.jsonl"} <= written
    for r in runs["ranks"]:
        assert [run["step"] for run in r[2]["runs"]] == [2, 1, 2]
    with open(os.path.join(root, "resumed", "train_metrics.jsonl")) as f:
        assert len(f.readlines()) == 2  # one record a step over both runs: no rank's second copy


def test_reproject_ranks_render_what_one_process_renders(runs):
    ranks = [r[3] for r in runs["ranks"]]
    assert [len(r["saved"]) for r in ranks] == [1, 0]
    assert ranks[0]["records"][0]["episode"] == ranks[1]["records"][0]["episode"]
    assert [r["records"][0]["rendered"] for r in ranks] == [True, True] and runs["one_records"][0]["rendered"]

    def read(name):
        d = os.path.join(runs["prep"], name, "rendered_panorama_vggt_open3d")
        return np.stack(load_frames([os.path.join(d, n) for n in sorted(os.listdir(d))]))

    got, want = read("ranks"), read("one")
    assert got.shape == want.shape and float(want.std()) > 0
    np.testing.assert_array_equal(got, want)
