"""`chip_smoke.py`'s own logic off the card: its reading of nvcc's ptxas
report, on a log shaped like nvcc's, and its CLI phase at tiny size.

ptxas prints its warning that it serialized an entry's wgmma before the
entries' own lines, naming the function; the report must attach it to that
entry so that the smoke run fails on it.
"""

import re
from pathlib import Path

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


def test_cli_phase_runs_at_tiny_size_on_the_cpu():
    """Phase 11's own logic (episode and checkpoint writing, both CLIs from the
    checkpoints, the loaded-equals-written, PNG count and size and writer
    checks) on the CPU at the tiny presets, where the kernels' plain
    versions run and so no launch is counted."""
    import torch

    tiny = ("--runtime.model_preset=tiny", "--runtime.vggt_tiny=true", "--runtime.compute_dtype=float32",
            "--pipeline.height=64", "--pipeline.width=128", "--pipeline.num_frames=5", "--loop.num_frames=5",
            "--loop.num_target_view=4", "--loop.num_segments=2", "--loop.pers_height=16", "--loop.pers_width=512",
            "--data.sequence_length=5")
    result = chip_smoke.full_cli(torch.device("cpu"), 2, 0, overrides=tiny)
    assert result["single"]["parameters_equal"] == {"unet": True, "vae": True, "clip_tower": True}
    assert result["unified"]["vggt_parameters_equal"]
    assert result["unified"]["pngs"]["rendered_panorama_0"] == (4, [(128, 64)])


def test_jpeg_phase_passes_on_the_cpu():
    """Phase 2b needs no card: the port's JPEG decode of every committed
    fixture equals the PNG of PIL's decode beside it."""
    rows = chip_smoke.check_jpeg_fixtures()
    assert [r["name"] for r in rows] == list(chip_smoke.JPEG_FIXTURES)
    assert all(r["differing_pixels"] == 0 for r in rows)
