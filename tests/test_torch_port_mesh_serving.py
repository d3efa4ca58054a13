"""The port's frame-sharded serving clip on CPU ranks over gloo, against the
one-process port and the JAX package's pipeline on a 2-device mesh.

A mesh splits the denoise by frames over its data axis, as the JAX package's
pipeline does (`evoworld_tpu/diffusion/pipeline.py::_shard_frames`): every
rank runs both guidance halves on its frames and returns the whole clip.
Three spawns of ranks (`parallel/launch.py::Ranks`, one torch thread each)
run the gate's tiny pipeline (`parallel/checks.py::tiny_gate_pipeline_setup`
at F = 5 frames, 2 steps; `serving_clip_rank`) at once: W = 2 (3 + 2
frames), W = 3 (2 + 2 + 1) and a 2 x 2 mesh (data 2 x model 2: the model
ranks of a data rank hold the same frames). The weights are the JAX
package's random ones from seed 7, carried across by `params_from_jax`;
every run gets the same inputs, initial latents and conditioning noise (the
draw the JAX pipeline makes itself when `latents` is given). Meanwhile this
process runs the clip in one process and through `evoworld_tpu`'s
`PanoDiffusionPipeline` on a 2-device CPU mesh (fp32, matmul precision
"highest").

Tolerances: every rank's clip within atol 1e-4 of the one-process clip
(fp32 sums in another order) and within 2e-3 of the JAX mesh clip (the
whole-tiny-clip tolerance of `tests/test_torch_port_pipeline.py`); the
ranks of a run bit for bit equal, and the 2 x 2 mesh's the W = 2 clip's. A
pipeline whose ranks read guidance from their own first frame (the wrong
frame indices) must fail the one-process tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.diffusion.pipeline import make_random_pipeline as j_make_random_pipeline
from evoworld_tpu.parallel.checks import tiny_gate_pipeline_setup as j_tiny_gate_pipeline_setup
from evoworld_tpu.parallel.mesh import make_mesh as jmake_mesh
from evoworld_tpu_torch.models.weights import params_from_jax
from evoworld_tpu_torch.parallel.checks import serving_clip_rank
from evoworld_tpu_torch.parallel.launch import Ranks
from evoworld_tpu_torch.parallel.mesh import split_sizes
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F, H, W = 5, 64, 128
ONE_ATOL, JAX_ATOL = 1e-4, 2e-3
# name: (ranks, model axis)
MESHES = {"w2": (2, 1), "w3": (3, 1), "2x2": (4, 2)}


def _inputs():
    rng = np.random.default_rng(0)
    return dict(image=rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
                plucker=rng.normal(size=(F, 6, H // 8, W // 8)).astype(np.float32),
                memory_frames=rng.uniform(-1, 1, (F, H, W, 3)).astype(np.float32),
                latents=rng.normal(size=(F, H // 8, W // 8, 4)).astype(np.float32),
                cond_noise=np.array(jax.random.normal(jax.random.key(7), (F + 1, H, W, 3), jnp.float32)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"one": the one-process clip, "jax": the JAX mesh clip, mesh name: every rank's result}."""
    root = tmp_path_factory.mktemp("serving_frames")
    _, cfg, kwargs = j_tiny_gate_pipeline_setup(F)
    jpipe = j_make_random_pipeline(cfg, mesh=jmake_mesh(jax.devices()[:2], data=2), **kwargs)
    models = {name: params_from_jax(jax.tree.map(np.asarray, jpipe.params[name])) for name in ("unet", "vae", "clip")}
    inputs = _inputs()
    jobs = {name: Ranks("evoworld_tpu_torch.parallel.checks:serving_clip_rank", w, str(root / name), device="cpu",
                        args=(models, F, inputs, name == "w2"), mesh_model=model)
            for name, (w, model) in MESHES.items()}
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jpipe(*(jnp.asarray(inputs[k]) for k in ("image", "plucker", "memory_frames")),
                                jax.random.key(7), latents=jnp.asarray(inputs["latents"])))
    out = {"jax": torch.tensor(want), "one": serving_clip_rank(None, models, F, inputs)}
    out.update({name: job.results() for name, job in jobs.items()})
    return out


def test_one_process_clip_matches_jax(runs):
    one = runs["one"]["clip"]
    assert one.shape == (F, H, W, 3) and torch.isfinite(one).all()
    assert runs["one"]["unet_calls"] == [[2, F, None, None]] * 2  # both guidance halves, every frame, 2 steps
    torch.testing.assert_close(one, runs["jax"], rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("name", list(MESHES))
def test_frame_split_clip_matches_one_process(runs, name):
    for r in runs[name]:
        torch.testing.assert_close(r["clip"], runs["one"]["clip"], rtol=0, atol=ONE_ATOL)


@pytest.mark.parametrize("name", list(MESHES))
def test_frame_split_clip_matches_jax_mesh_pipeline(runs, name):
    for r in runs[name]:
        torch.testing.assert_close(r["clip"], runs["jax"], rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("name", list(MESHES))
def test_ranks_are_bit_equal(runs, name):
    assert all(torch.equal(r["clip"], runs[name][0]["clip"]) for r in runs[name])


@pytest.mark.parametrize("name", list(MESHES))
def test_each_rank_denoises_its_own_frames_with_both_halves(runs, name):
    ranks, model = MESHES[name]
    sizes = split_sizes(F, ranks // model)
    starts = np.cumsum([0] + sizes)
    for rank, r in enumerate(runs[name]):
        d = rank // model  # ranks run model-fastest
        assert r["unet_calls"] == [[2, sizes[d], int(starts[d]), int(starts[d + 1])]] * 2, rank


def test_model_ranks_hold_the_w2_clip(runs):
    assert [r["unet_calls"] for r in runs["2x2"]][::2] == [r["unet_calls"] for r in runs["w2"]]
    assert all(torch.equal(r["clip"], runs["w2"][0]["clip"]) for r in runs["2x2"])


def test_guidance_at_local_frame_indices_fails(runs):
    """The control: rank 1 of W = 2 scales frames 3 and 4 by frames 0 and 1's guidance."""
    for r in runs["w2"]:
        diff = (r["control"] - runs["one"]["clip"]).abs()
        assert diff.max() > 100 * ONE_ATOL and diff.max() > JAX_ATOL
