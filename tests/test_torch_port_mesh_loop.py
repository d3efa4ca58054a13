"""The port's sharded serving path at W = 2 against its own one-process runs.

Two CPU ranks over gloo (`parallel/launch.py::Ranks`, one torch thread
each) run the JAX gate's tiny configurations (`parallel/checks.py`) with
the mesh in them while this process runs the same calls without it; the
one-process port is what the other `test_torch_port_*` files hold against
the JAX package (whose own sharding tests are slow-tier for their compiles).

- The clip: the denoise split by frames over the ranks (both guidance
  halves on each), the encode and decode split by chunk; every rank's
  frames within atol 1e-4 of the one-process clip
  (`tests/test_torch_port_mesh_serving.py` holds the split at uneven frame
  counts and against the JAX package's mesh pipeline).
- VGGT on four 16x512 crops: frames split two a rank, the global attention
  on the head-sharded route from 16 tokens; points, confidence and
  extrinsics within rtol 2e-3 / atol 5e-4 (the layers' tolerance), colours
  exactly.
- The composed loop gate: the 2-segment episode with all three stages
  sharded, `assert_episode_close` (the JAX gate's 99% of pixels within 3e-2,
  0.2 at most on the segments).
- `cli.run_unified` in a group of two ranks (as under `torchrun`): rank 0
  writes the episode's PNGs, rank 1 nothing, and they are the one-process
  CLI's under the composed gate's rules (99% within 3e-2, the frames 0.2 at
  most).
Both ranks return the same results bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from evoworld_tpu_torch.cli import run_unified
from evoworld_tpu_torch.data import native_io
from evoworld_tpu_torch.parallel import checks
from evoworld_tpu_torch.parallel.launch import Ranks
from tests.test_torch_port_cli import TINY_ARGS, episode  # noqa: F401  (fixture)
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

W, VGGT_FRAMES = 2, 4
RTOL, ATOL = 2e-3, 5e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory, episode):  # noqa: F811
    """(rank results, one-process results), the ranks running while this
    process computes; "cli" holds both save directories of `run_unified`."""
    root = tmp_path_factory.mktemp("serving")
    cli = {k: root / k for k in ("sharded", "single")}
    argv = [f"--data.root={episode}", *TINY_ARGS]
    jobs = (Ranks("evoworld_tpu_torch.parallel.checks:sharded_serving_rank", W, str(root / "job"),
                  device="cpu", args=(W, VGGT_FRAMES)),
            Ranks("evoworld_tpu_torch.parallel.checks:cli_rank", W, str(root / "cli_job"),
                  device="cpu", args=("run_unified", argv + [f"--runtime.save_dir={cli['sharded']}"])))
    ref = {"clip": checks.gate_clip(W), "vggt": checks.gate_reconstruct(W, VGGT_FRAMES),
           "loop": checks.run_composed_loop(W)}
    run_unified.main(argv + [f"--runtime.save_dir={cli['single']}"], device="cpu")
    ranks = jobs[0].results()
    for r, records in zip(ranks, jobs[1].results()):
        r["cli"] = records
    ref["cli"] = cli
    return ranks, ref


def test_sharded_clip_matches_one_process(runs):
    ranks, ref = runs
    assert ref["clip"].shape == (W, 64, 128, 3)
    for r in ranks:
        torch.testing.assert_close(r["clip"], ref["clip"], rtol=0, atol=1e-4)


def test_sharded_vggt_matches_one_process(runs):
    ranks, ref = runs
    assert ref["vggt"]["world_points"].shape[0] == VGGT_FRAMES
    for r in ranks:
        for key in ("world_points", "conf", "extrinsic"):
            torch.testing.assert_close(r["vggt"][key], ref["vggt"][key], rtol=RTOL, atol=ATOL)
        assert torch.equal(r["vggt"]["colors"], ref["vggt"]["colors"])


def test_composed_loop_gate(runs):
    ranks, ref = runs
    for r in ranks:
        checks.assert_episode_close(ref["loop"], r["loop"])


@pytest.mark.parametrize("part", ["clip", "vggt", "loop"])
def test_ranks_agree(runs, part):
    a, b = (r[part] for r in runs[0])
    if part == "clip":
        assert torch.equal(a, b)
    else:
        for key in a:
            assert all(torch.equal(x, y) for x, y in zip(a[key], b[key]))


def _pngs(directory):
    names = sorted(os.listdir(directory))
    h, w = native_io.image_size(os.path.join(directory, names[0]))
    return names, native_io.load_image_batch([os.path.join(directory, n) for n in names], h, w, minus1_1=False)


def test_run_unified_under_two_ranks_writes_once(runs):
    ranks, ref = runs
    records = [r["cli"] for r in ranks]
    assert [len(r) for r in records] == [1, 1] and records[0][0]["out_dir"] == records[1][0]["out_dir"]
    name = os.path.basename(records[0][0]["out_dir"])
    sharded, single = ref["cli"]["sharded"] / name, ref["cli"]["single"] / name
    subdirs = sorted(os.listdir(single))
    assert sorted(os.listdir(sharded)) == subdirs and "rendered_panorama_0" in subdirs
    for sub in subdirs:
        (names_a, a), (names_b, b) = _pngs(sharded / sub), _pngs(single / sub)
        assert names_a == names_b
        diff = np.abs(a - b)
        assert (diff <= 3e-2).mean() >= 0.99, sub  # the composed gate's rules, at 8 bits
        if not sub.startswith("rendered"):
            assert diff.max() <= 0.2, sub
