"""`chip_smoke.py`'s own logic off the card: its reading of nvcc's ptxas
report, on a log shaped like nvcc's, its CLI, training-CLI and evaluation
phases at tiny size, and its GIF block parser.

ptxas prints its warning that it serialized an entry's wgmma before the
entries' own lines, naming the function; the report must attach it to that
entry so that the smoke run fails on it.
"""

import re
from pathlib import Path

import pytest

import chip_smoke
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

LOG = """\
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized due to \
program dependence on compiler-inserted WG.AR in divergent path in the function '_Z4wideILi2EEvv'
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z5wgmmaILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z5wgmmaILi64EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z4wideILi2EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z4wideILi2EEvv
    176 bytes stack frame, 176 bytes spill stores, 172 bytes spill loads
ptxas info    : Used 224 registers, used 16 barriers, 176 bytes cumulative stack size
"""


def test_ptxas_report_attaches_each_warning_to_its_entry():
    first, second = chip_smoke.ptxas_report(LOG)
    assert first == dict(entry="_Z5wgmmaILi64EEvv", spill_stores=0, spill_loads=0, registers=168)
    assert (second["entry"], second["spill_stores"], second["spill_loads"], second["registers"]) == (
        "_Z4wideILi2EEvv", 176, 172, 224)
    assert "serialized" in second["wgmma_serialized"]


def test_ptxas_report_catches_a_serialization_for_want_of_registers():
    """Where registers run short ptxas words its warning "... for the
    function '...'" (C7512), not "in the function"; the entry must still
    carry it, or the build phase passes a kernel whose wgmma runs serialized."""
    log = LOG.replace(
        "program dependence on compiler-inserted WG.AR in divergent path in the function '_Z4wideILi2EEvv'",
        "insufficient register resources for the function '_Z5wgmmaILi64EEvv'")
    first, second = chip_smoke.ptxas_report(log)
    assert "insufficient register resources" in first["wgmma_serialized"]
    assert "wgmma_serialized" not in second


def test_every_kernel_the_smoke_run_names_is_a_global_function():
    """The forward's and the backward's kernel names that phase 3 and 3b look
    for in a profiler trace are `__global__` functions of the CUDA sources,
    so that a renamed kernel fails here and not only on the card."""
    csrc = Path(chip_smoke.__file__).resolve().parent / "evoworld_tpu_torch" / "csrc"
    text = "\n".join(f.read_text() for f in sorted(csrc.glob("*.cu")))
    defined = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", text))
    named = set(chip_smoke.FWD_KERNELS.values()) | {n for _, names in chip_smoke.BWD_DESIGNS.values() for n in names}
    assert named <= defined, named - defined
    assert not set(chip_smoke.RETIRED_BWD_KERNELS) & defined


TINY = ("--runtime.model_preset=tiny", "--runtime.vggt_tiny=true", "--runtime.compute_dtype=float32",
        "--pipeline.height=64", "--pipeline.width=128", "--pipeline.num_frames=5", "--loop.num_frames=5",
        "--loop.num_target_view=4", "--loop.num_segments=2", "--loop.pers_height=16", "--loop.pers_width=512",
        "--data.sequence_length=5")


def test_cli_phase_runs_at_tiny_size_on_the_cpu():
    """Phase 11's own logic (episode and checkpoint writing, both CLIs from the
    checkpoints, the loaded-equals-written, PNG count and size and writer
    checks) on the CPU at the tiny presets, where the kernels' plain
    versions run and so no launch is counted."""
    import torch

    result = chip_smoke.full_cli(torch.device("cpu"), 2, 0, overrides=TINY)
    assert result["single"]["parameters_equal"] == {"unet": True, "vae": True, "clip_tower": True}
    assert result["unified"]["vggt_parameters_equal"]
    assert result["unified"]["pngs"]["rendered_panorama_0"] == (4, [(128, 64)])


def test_jpeg_phase_passes_on_the_cpu():
    """Phase 2b needs no card: the port's JPEG decode of every committed
    fixture equals the PNG of PIL's decode beside it."""
    rows = chip_smoke.check_jpeg_fixtures()
    assert [r["name"] for r in rows] == list(chip_smoke.JPEG_FIXTURES)
    assert all(r["differing_pixels"] == 0 for r in rows)


def test_train_cli_and_eval_phases_run_at_tiny_size_on_the_cpu(tmp_path):
    """Phases 12 and 13 on phase 11's files at the tiny presets: the training
    CLI with its validation, checkpoint and resume checks, then the
    evaluation CLIs with the harness held against itself (the CPU on both
    sides) and the TF32 flags switched on around it."""
    import torch

    dev = torch.device("cpu")
    cli = chip_smoke.full_cli(dev, 2, 0, overrides=TINY, workdir=str(tmp_path))
    train = chip_smoke.full_train_cli(dev, 2, 0, str(tmp_path), overrides=TINY)
    assert [r["final_step"] for r in train["runs"]] == [2, 3] and train["resumed_from"] == [2]
    assert train["gif"]["frames"] == 5 and train["gif"]["screen"] == (256, 64)
    assert [s["step"] for s in train["saves"]] == [2, 2, 3]
    evaluation = chip_smoke.full_eval(dev, str(tmp_path), cli["out_dir"], train.pop("clip"), overrides=TINY)
    assert evaluation["videos"] == [3, 4, 64, 128, 3] and evaluation["launches"] == [0, 0]
    assert set(evaluation["metric_seconds"]) == {"ssim", "psnr", "lpips", "latent_mse", "loop_closure_latent_mse"}


def test_gif_summary_reads_the_block_structure(tmp_path):
    """The phase-12 parser on the port's GIF and on PIL's (which adds a global
    palette and its own extensions), and its refusal of a truncated file."""
    import numpy as np
    from PIL import Image

    from evoworld_tpu_torch.utils.video import export_gif

    frames = np.random.default_rng(0).integers(0, 256, (3, 8, 12, 3), dtype=np.uint8)
    ours, pil = str(tmp_path / "ours.gif"), str(tmp_path / "pil.gif")
    export_gif(frames, ours)
    images = [Image.fromarray(f) for f in frames]
    images[0].save(pil, save_all=True, append_images=images[1:], duration=100, loop=0)
    for path in (ours, pil):
        summary = chip_smoke.gif_summary(path)
        assert summary["screen"] == (12, 8) and summary["loop"] == 0
        assert summary["delays_cs"] == [10, 10, 10]
        assert len(summary["frames"]) == 3 and summary["frames"][0] == (12, 8)
    with open(ours, "rb") as f:
        data = f.read()
    (tmp_path / "cut.gif").write_bytes(data[: len(data) // 2])
    with pytest.raises((ValueError, IndexError)):
        chip_smoke.gif_summary(str(tmp_path / "cut.gif"))


def test_prep_phase_runs_at_tiny_size_on_the_cpu(tmp_path):
    """Phase 14 on phase 11's files at the tiny presets: the crops, the
    reproject CLI's selection, skip and render checks with a U^2-Net sky
    mask (10 target views, so that 3 of the 13 crops are sources), the
    mask's and the cubemaps' comparison (the CPU on both sides)."""
    import torch

    dev = torch.device("cpu")
    chip_smoke.full_cli(dev, 2, 0, overrides=TINY, workdir=str(tmp_path))
    prep = chip_smoke.full_prep(dev, str(tmp_path), 0, cube_face=24, mask_crops=1, overrides=TINY + (
        "--loop.num_target_view=10", "--data.height=40", "--data.width=80"))
    assert prep["pers_crops"] == 13 and prep["sources"] == 3 and prep["crop_sizes"] == [(16, 512)]
    assert prep["renders"] == 10 and prep["render_shape"] == [64, 128, 3] and prep["vggt_builds"] == 1
    assert prep["launches"] == prep["rerun_launches"] == [0, 0] and prep["rerun_wrote_nothing"]
    assert prep["sky_mask_flipped"] == 0.0 and set(prep["cube_to_pano"]["ue"]) >= {"flipped", "panoramas"}
