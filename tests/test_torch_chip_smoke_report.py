"""`chip_smoke.py`'s own logic off the card: its reading of nvcc's ptxas
report, on a log shaped like nvcc's, with each kernel's bf16 and fp16
instantiations paired and the fp32 source's entries found, the fp16 rows'
pairing with their bf16 twins and the fp32 rows' with their fp16 twins,
each type's limits, its CLI, training-CLI, evaluation, data-preparation,
fp16, fp32, tools and multi-GPU training phases at tiny size, the
model-parallel phase's route gradients at tiny size and its step gate, the
frame-split clip phase's record, cut and gate on stand-in ranks, its GIF
block parser, and its kernel timing when the profiler drops a row's
records or one kernel's.

ptxas prints its warning that it serialized an entry's wgmma before the
entries' own lines, naming the function; the report must attach it to that
entry so that the smoke run fails on it.
"""

import math
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


# Entries as nvcc mangles the templated kernels: one per element type.
TWINS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115flash_fwd_wgmmaILi64E6__halfEEvv' for 'sm_90a'
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115flash_fwd_wgmmaILi64E13__nv_bfloat16EEvv' for 'sm_90a'
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114flash_fwd_wideI13__nv_bfloat16EEvv' for 'sm_90a'
ptxas info    : Used 168 registers, used 16 barriers
"""


def test_ptxas_twins_pair_each_kernel_across_element_types():
    """Phase 2 pairs each entry's bf16 and fp16 instantiations; a kernel
    built in one type only shows None for the other, which fails the run."""
    twins = {t["entry"]: t["registers"] for t in chip_smoke.ptxas_twins(chip_smoke.ptxas_report(TWINS_LOG))}
    assert twins == {"_ZN12_GLOBAL__N_115flash_fwd_wgmmaILi64ETEEvv": {"bf16": 168, "fp16": 168},
                     "_ZN12_GLOBAL__N_114flash_fwd_wideITEEvv": {"bf16": 168, "fp16": None}}


def test_fp16_rows_meet_their_bf16_twins():
    """Each fp16 row of phases 3 and 3b reads its bf16 twin's ms and the
    ratio the run holds to TWIN_MS_RATIO; every twin label names a row of
    its phase, and the element types map onto torch's and the trace's."""
    import torch

    rows = [dict(label="unet_l0_spatial", dtype="bf16", ms=10.0), dict(label="vae_encoder_mid", dtype="bf16", ms=1.0)]
    fp16 = dict(label="unet_l0_spatial_fp16", dtype="fp16", ms=10.5)
    chip_smoke.add_twin_ratio(fp16, rows)
    assert fp16["twin_ms"] == 10.0 and abs(fp16["twin_ratio"] - 1.05) < 1e-12
    chip_smoke.add_twin_ratio(rows[1], rows)
    assert rows[1]["twin_ms"] is None and rows[1]["twin_ratio"] is None
    assert {getattr(torch, name) for name in chip_smoke.ELEM_TYPES.values()} == {
        torch.bfloat16, torch.float16, torch.float32}
    key = "void (anonymous namespace)::flash_fwd_wgmma<64, __half>(CUtensorMap_st, (anonymous namespace)::FwdArgs<__half>)"
    assert chip_smoke.trace_elem_type(key) == "fp16"
    assert chip_smoke.trace_elem_type(key.replace("__half", "__nv_bfloat16")) == "bf16"
    assert chip_smoke.trace_elem_type("void at::native::elementwise_kernel<128, 2>") is None
    source = Path(chip_smoke.__file__).read_text()
    assert all(f'("{name}",' in source for name in chip_smoke.FP16_FWD_TWINS + chip_smoke.FP16_BWD_TWINS)
    cases = [("a", 1), ("b", 2), ("c", 3)]
    assert chip_smoke.twin_runs(cases, ("a", "c")) == [(0, ("a", 1), "bf16"), (0, ("a_fp16", 1), "fp16"),
                                                       (1, ("b", 2), "bf16"), (2, ("c", 3), "bf16"),
                                                       (2, ("c_fp16", 3), "fp16")]


# ptxas's report of csrc/flash_attn_fp32.cu: its kernels are not templated
# over the element type, one entry per kernel and head dim.
FP32_LOG = "".join(
    f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{len(name)}{name}ILi{d}EEEvNS_9FwdParamsE' "
    f"for 'sm_90a'\nptxas info    : Used {100 + d // 64} registers, used 1 barriers\n"
    for name, d in chip_smoke.FP32_ENTRIES)


def test_ptxas_check_exempts_fp32_entries_from_twins_and_fails_a_missing_one():
    """Phase 2 holds the bf16/fp16 sources to a bf16 and an fp16 instantiation
    of every entry, and the fp32 source, whose entries carry no type, to every
    entry of FP32_ENTRIES: the full fp32 report passes (it would fail the twin
    check), and one without flash_fp32_bwd_dq<512> fails naming it."""
    entries = chip_smoke.ptxas_report(FP32_LOG)
    assert len(entries) == len(chip_smoke.FP32_ENTRIES) == 12
    chip_smoke.check_ptxas("flash_attn_fp32.cu", entries, fp32=True)
    with pytest.raises(AssertionError, match="lacks its bf16 or fp16 instantiation"):
        chip_smoke.check_ptxas("flash_attn_fp32.cu", entries)
    found = {(r["kernel"], r["d"]): r["registers"] for r in chip_smoke.fp32_entries(entries)}
    assert found[("flash_fp32_bwd_dq", 512)] == 108 and found[("flash_fp32_fwd", 64)] == 101
    missing = [r for r in entries if "17flash_fp32_bwd_dqILi512E" not in r["entry"]]
    with pytest.raises(AssertionError, match=r"\('flash_fp32_bwd_dq', 512\)"):
        chip_smoke.check_ptxas("flash_attn_fp32.cu", missing, fp32=True)
    spilled = [dict(r, spill_stores=8) if i == 0 else r for i, r in enumerate(entries)]
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.check_ptxas("flash_attn_fp32.cu", spilled, fp32=True)
    paired = TWINS_LOG.replace("_ZN12_GLOBAL__N_114flash_fwd_wideI13__nv_bfloat16EEvv",
                               "_ZN12_GLOBAL__N_115flash_fwd_wgmmaILi64E6__halfEEvv")
    chip_smoke.check_ptxas("flash_attn_fwd.cu", chip_smoke.ptxas_report(paired))  # both types: passes


WGMMA_SASS = ["SYNCS.ARRIVE.TRANS64", "HGMMA.64x64x16.F32.BF16", "WARPGROUP.DEPBAR.LE", "FADD"]


def _fp32_sass(changed: dict) -> dict:
    """A `compare_kernels.sass_entries` result for the fp32 library, lines
    shaped like cuobjdump's: the entries of FP32_WGMMA_KERNELS with wgmma's
    HGMMA, flash_fp32_bwd_delta with no tensor-core instruction, and the
    (kernel, D) entries of `changed` with the opcodes given there."""
    def lines(ops):
        return [f"/*{16 * i:04x}*/  {op} R0, R2, R4 ;" for i, op in enumerate(ops)]
    sass = {(name, d, "fp32"): lines(WGMMA_SASS if name in chip_smoke.FP32_WGMMA_KERNELS else ["FFMA", "SHFL.BFLY"])
            for name, d in chip_smoke.FP32_ENTRIES}
    sass.update({(name, d, "fp32"): lines(ops) for (name, d), ops in changed.items()})
    return sass


def test_fp32_sass_check_holds_the_wgmma_kernels_to_hgmma_alone():
    """Phase 2 reads the fp32 library's SASS: every entry of
    FP32_WGMMA_KERNELS (the forward, dK/dV and dQ at every D) must hold HGMMA
    and no HMMA; flash_fp32_bwd_delta is counted and not held to it. An
    entry with an mma.sync (HMMA) left, or with no HGMMA, or missing from the
    dump, fails naming it."""
    assert set(chip_smoke.FP32_WGMMA_KERNELS) == {"flash_fp32_fwd", "flash_fp32_bwd_dkdv", "flash_fp32_bwd_dq"}
    good = chip_smoke.fp32_sass_rows(_fp32_sass({}))
    assert len(good) == len(chip_smoke.FP32_ENTRIES) == 12
    fwd = {r["d"]: r for r in good if r["kernel"] == chip_smoke.FP32_FWD_KERNEL}
    assert fwd[512] == dict(kernel="flash_fp32_fwd", d=512, hgmma=1, hmma=0, wgmma_design=True)
    delta = next(r for r in good if r["kernel"] == "flash_fp32_bwd_delta" and r["d"] == 64)
    assert (delta["hgmma"], delta["hmma"], delta["wgmma_design"]) == (0, 0, False)
    chip_smoke.check_fp32_sass(good)
    for bad in ({("flash_fp32_fwd", 128): WGMMA_SASS + ["HMMA.1688.F32.TF32"]},
                {("flash_fp32_bwd_dq", 512): ["LDS.128", "HMMA.1688.F32.TF32", "FADD"]},
                {("flash_fp32_bwd_dkdv", 64): ["FADD"]}):
        with pytest.raises(AssertionError, match="lacks HGMMA or holds HMMA"):
            chip_smoke.check_fp32_sass(chip_smoke.fp32_sass_rows(_fp32_sass(bad)))
    missing = _fp32_sass({})
    del missing[(chip_smoke.FP32_FWD_KERNEL, 64, "fp32")]
    with pytest.raises(AssertionError, match="'d': 64"):
        chip_smoke.check_fp32_sass(chip_smoke.fp32_sass_rows(missing))


@pytest.mark.parametrize("elem, errs, passes", [
    ("fp32", (9.8e-5, 1.6e-6), True),    # the worst fp32 reading (the VAE mid D = 512 dK)
    ("fp32", (0.0022, 0.00021), False),  # the best fp16 twin's reading: one TF32 pass in an fp32 kernel
    ("fp32", (1.1, 0.05), False),        # 32 dropped keys
    ("fp32", (5e-5, 4.2e-4), False),     # one accumulator across 75,993 keys (PERF.md)
])
def test_fp32_rows_have_limits_of_their_own(elem, errs, passes):
    """fp32 rows are held to FP32_MAX_REL_ERR / FP32_MEAN_REL_ERR, which pass
    the fp32 kernels' readings and fail fp16's, so that an fp32 kernel
    that lost precision to a single TF32 pass (fp16's mantissa) fails; each
    fp32 row meets its fp16 twin, and its bound is at the TF32 rate, with
    three times it beside it."""
    e = dict(max_rel_err=errs[0], mean_rel_err=errs[1])
    assert chip_smoke.within_limits(e, elem) is passes
    rows = [dict(label="a", dtype="bf16"), dict(label="a_fp16", dtype="fp16"), dict(label="a_fp32", dtype="fp32"),
            dict(label="b_fp32", dtype="fp32")]
    assert chip_smoke.twin_of(rows[2], rows) is rows[1] and chip_smoke.twin_of(rows[3], rows) is None
    assert set(chip_smoke.FP32_FWD_TWINS) <= set(chip_smoke.FP16_FWD_TWINS)
    assert set(chip_smoke.FP32_BWD_TWINS) <= set(chip_smoke.FP16_BWD_TWINS)
    bound = chip_smoke.row_bound(4.95e12, 1e6, "fp32")
    assert bound["bound_by"] == "operations" and abs(bound["bound_ms"] - 10.0) < 1e-9
    assert abs(bound["split_bound_ms"] - 30.0) < 1e-9 and chip_smoke.row_bound(9.89e12, 1e6, "bf16") == dict(
        bound_ms=10.0, bound_by="operations", split_bound_ms=None)
    assert chip_smoke.trace_elem_type("void (anonymous namespace)::flash_fp32_bwd_dkdv<64>(BwdParams)") == "fp32"


@pytest.mark.parametrize("elem, errs, passes", [
    ("fp16", (0.0098, 0.00023), True),   # the worst fp16 reading (the L0 training dK)
    ("fp16", (0.018, 0.0017), False),    # the best bf16 twin's reading: a bf16 rounding in an fp16 kernel
    ("fp16", (1.1, 0.05), False),        # 32 dropped keys
    ("bf16", (0.070, 0.0018), True),     # the worst bf16 reading
    ("bf16", (1.1, 0.05), False),
])
def test_fp16_rows_have_limits_of_their_own(elem, errs, passes):
    """fp16 rows are held to FP16_MAX_REL_ERR / FP16_MEAN_REL_ERR, which pass
    fp16's readings and fail bf16's, so that an fp16 kernel that lost
    precision to bf16's fails; bf16 rows keep their limits."""
    e = dict(max_rel_err=errs[0], mean_rel_err=errs[1])
    assert chip_smoke.within_limits(e, elem) is passes
    rows = [dict(label="a", dtype="bf16"), dict(label="a_fp16", dtype="fp16"), dict(label="b", dtype="bf16")]
    assert chip_smoke.twin_of(rows[1], rows) is rows[0] and chip_smoke.twin_of(rows[2], rows) is None


def test_every_kernel_the_smoke_run_names_is_a_global_function():
    """The forward's and the backward's kernel names that phase 3 and 3b look
    for in a profiler trace are `__global__` functions of the CUDA sources,
    so that a renamed kernel fails here and not only on the card."""
    csrc = Path(chip_smoke.__file__).resolve().parent / "evoworld_tpu_torch" / "csrc"
    text = "\n".join(f.read_text() for f in sorted(csrc.glob("*.cu")))
    defined = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", text))
    named = set(chip_smoke.FWD_KERNELS.values()) | {n for _, names in chip_smoke.BWD_DESIGNS.values() for n in names}
    named |= {chip_smoke.FP32_FWD_KERNEL, *chip_smoke.FP32_BWD_DESIGN[1]} | {n for n, _ in chip_smoke.FP32_ENTRIES}
    assert named <= defined, named - defined
    assert not set(chip_smoke.RETIRED_BWD_KERNELS) & defined


class _Trace:
    """A profiler run whose `key_averages()` are the given rows."""

    def __init__(self, rows):
        self.rows = rows

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return self.rows


def _profiler(device_us: float, calls: list):
    """A profiler factory whose traces name flash_fwd_wgmma with `device_us` of device time in 3 records."""
    import types

    def profiler():
        calls.append(1)
        return _Trace([types.SimpleNamespace(key="void flash_fwd_wgmma<64, __nv_bfloat16>(Params)", count=3,
                                             device_time_total=device_us)])
    return profiler


def _timer(fn, reps):  # cuda_ms's calls (a warm-up, then reps), and a time
    for _ in range(reps + 1):
        fn()
    return 2.5


@pytest.mark.parametrize("launches_per_call, device_us, timed_by", [(1, 3000.0, "trace"), (1, 0.0, "events"),
                                                                      (0, 0.0, None)])
def test_kernel_time_survives_an_empty_trace_only_where_the_kernel_launched(launches_per_call, device_us, timed_by):
    """A trace with device time times the row from its records; one with every
    record dropped is taken again TRACE_TRIES times in all, then the call is
    run under events and passes if the kernel's launch count moved once a
    call, with no time per kernel (the row's own time is the call's), and
    the row fails if it did not."""
    import types

    counter, traces = types.SimpleNamespace(launches=0), []

    def fn():
        counter.launches += launches_per_call

    args = dict(served=("flash_fwd_wgmma",), elem="bf16", counter=counter, profiler=_profiler(device_us, traces),
                timer=_timer)
    names = ["flash_fwd_wgmma", "flash_fwd_wide"]
    if timed_by is None:
        with pytest.raises(AssertionError, match="did not launch"):
            chip_smoke.kernel_ms_from_trace(fn, names, **args)
        assert len(traces) == chip_smoke.TRACE_TRIES
        return
    ms, kinds, how = chip_smoke.kernel_ms_from_trace(fn, names, **args)
    assert how == timed_by and kinds == ["bf16"]
    assert ms == ({"flash_fwd_wgmma": 1.0, "flash_fwd_wide": 0.0} if timed_by == "trace"
                  else {"flash_fwd_wgmma": None, "flash_fwd_wide": 0.0})
    assert len(traces) == (1 if timed_by == "trace" else chip_smoke.TRACE_TRIES)


def test_a_trace_missing_one_served_kernel_is_taken_again():
    """A backward row's trace that recorded one kernel of its design and not
    the other (the card's profiler dropped a kernel's records once) is taken
    again; a full trace then times the row by its records."""
    import types

    traces = []

    def profiler():
        traces.append(1)
        fused = 0.0 if len(traces) == 1 else 9000.0
        return _Trace([types.SimpleNamespace(key="void flash_bwd_fused<64, __half>(P)", count=3, device_time_total=fused),
                       types.SimpleNamespace(key="void flash_bwd_store_dq<__half>(P)", count=3,
                                             device_time_total=300.0)])

    counter = types.SimpleNamespace(launches=0)
    ms, kinds, how = chip_smoke.kernel_ms_from_trace(
        lambda: None, ["flash_bwd_fused", "flash_bwd_store_dq", "flash_bwd_wide_dv"],
        served=("flash_bwd_fused", "flash_bwd_store_dq"), elem="fp16", counter=counter, profiler=profiler,
        timer=_timer)
    assert how == "trace" and kinds == ["fp16"] and len(traces) == 2
    assert ms == pytest.approx({"flash_bwd_fused": 3.0, "flash_bwd_store_dq": 0.1, "flash_bwd_wide_dv": 0.0})


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
    assert [s["step"] for s in train["saves"]] == [2, 3]  # step 2's checkpoint is the first run's last
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


PREP = TINY + ("--loop.num_target_view=10", "--data.height=40", "--data.width=80")


@pytest.fixture(scope="module")
def prepped(tmp_path_factory):
    """Phases 11 and 14 at the tiny presets on the CPU, in one workdir: (its
    path, phase 14's result)."""
    import torch

    dev, workdir = torch.device("cpu"), str(tmp_path_factory.mktemp("prep"))
    chip_smoke.full_cli(dev, 2, 0, overrides=TINY, workdir=workdir)
    return workdir, chip_smoke.full_prep(dev, workdir, 0, cube_face=24, mask_crops=1, overrides=PREP)


def test_prep_phase_runs_at_tiny_size_on_the_cpu(prepped):
    """Phase 14 on phase 11's files at the tiny presets: the crops, the
    reproject CLI's selection, skip and render checks with a U^2-Net sky
    mask (10 target views, so that 3 of the 13 crops are sources), the
    mask's and the cubemaps' comparison (the CPU on both sides)."""
    prep = prepped[1]
    assert prep["pers_crops"] == 13 and prep["sources"] == 3 and prep["crop_sizes"] == [(16, 512)]
    assert prep["renders"] == 10 and prep["render_shape"] == [64, 128, 3] and prep["vggt_builds"] == 1
    assert prep["launches"] == prep["rerun_launches"] == [0, 0] and prep["rerun_wrote_nothing"]
    assert prep["sky_mask_flipped"] == 0.0 and set(prep["cube_to_pano"]["ue"]) >= {"flipped", "panoramas"}


@pytest.fixture(scope="module")
def fp16_run(prepped):
    """Phase 15 on `prepped`'s workdir at the tiny presets on the CPU, the
    tiny configurations standing in for the full-width ones `validate`
    checks against: (the workdir, phase 15's result)."""
    import torch

    from evoworld_tpu_torch import runtime

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(runtime.PRESETS, "full", runtime.PRESETS["tiny"])
        return prepped[0], chip_smoke.full_fp16(torch.device("cpu"), 2, 0, prepped[0], overrides=PREP)


def test_fp16_phase_runs_at_tiny_size_on_the_cpu(fp16_run):
    """Phase 15 on phases 11's and 14's files at the tiny presets, in fp16 on
    the CPU (where the kernels' plain versions run, so no launch is
    counted): the checkpoints halved and validated (the tiny configurations
    standing in for the full-width ones `validate` checks against), the
    single-segment clip, two training steps and reproject, each at
    `--runtime.compute_dtype=float16`."""
    result = fp16_run[1]
    conv = result["convert"]
    assert conv["exact"] and conv["validate_code"] == 0 and conv["bad_code"] == 1
    assert conv["validate_out"] == ["unet: OK", "vae: OK", "image_encoder: OK"]
    assert any("conv_out.weight" in line for line in conv["bad_out"])
    assert result["single"]["finite"] and result["single"]["launches"] == [0, 0]
    assert result["single"]["pngs"]["predictions"] == (5, [(128, 64)])
    assert 0 < result["single"]["rms_from_bf16_clip"] < 1
    assert len(result["train"]["losses"]) == 2 and result["train"]["norm1_grad_abs_max"] > 0
    assert result["reproject"]["renders"] == 10 and result["reproject"]["render_shape"] == [64, 128, 3]


def test_fp32_phase_runs_at_tiny_size_on_the_cpu(fp16_run):
    """Phase 16 on the files of phases 11, 14 and 15 (its `svd_fp32/`) at the
    tiny presets, in fp32 on the CPU: the single-segment clip, two training
    steps at the configuration's frames (no cut: the CPU does not run out of
    memory) and reproject, each at `--runtime.compute_dtype=float32`, under
    torch's default TF32 flags, which it restores after."""
    import os

    import torch

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    assert os.path.isdir(os.path.join(fp16_run[0], "svd_fp32", "unet"))
    result = chip_smoke.full_fp32(torch.device("cpu"), 2, 0, fp16_run[0], overrides=PREP)
    assert result["tf32"] == dict(matmul_allow_tf32=False, cudnn_allow_tf32=True)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
    assert result["single"]["finite"] and result["single"]["launches"] == [0, 0]
    assert result["single"]["pngs"]["predictions"] == (5, [(128, 64)])
    # the rehearsal's phase 11 ran in fp32 on the CPU too, from the same
    # weights: its clip and this one are the same computation
    assert result["single"]["rms_from_bf16_clip"] == 0.0
    train = result["train"]
    assert len(train["losses"]) == 2 and train["norm1_grad_abs_max"] > 0
    assert train["frames"] == 5 and train["cut"] == []
    assert result["reproject"]["renders"] == 10 and result["reproject"]["render_shape"] == [64, 128, 3]


def test_tools_phase_runs_at_tiny_size_on_the_cpu(prepped):
    """Phase 17 on phase 11's files at the tiny presets (the tiny
    configurations standing in for the full-width ones the converter check
    reads against), on the CPU: the parity gate passes against phase 11's
    own frames and exits with code 1 against them perturbed; a small cloud
    is written as PLY and OBJ."""
    import torch

    from evoworld_tpu_torch import runtime

    g = torch.Generator().manual_seed(0)
    cloud = {"world_points": torch.randn((70000, 3), generator=g), "colors": torch.rand((70000, 3), generator=g)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(runtime.PRESETS, "full", runtime.PRESETS["tiny"])
        result = chip_smoke.full_tools(torch.device("cpu"), 2, 0, prepped[0], cloud, overrides=TINY)
    runs = result["validate_parity"]
    assert runs["own_frames"]["exit_code"] == 0 and runs["perturbed"]["exit_code"] == 1
    assert runs["own_frames"]["launches"] == [0, 0] and result["expected_launches"] == [0, 0]
    assert result["export"]["cloud.ply"]["first_lines"][0] == "element vertex 70000\n"
    assert result["export"]["cloud.obj"]["bytes"] > result["export"]["cloud.ply"]["bytes"] > 70000 * 12


def test_mesh_train_phase_runs_at_tiny_size_on_the_cpu(prepped):
    """Phase 19(b) on phase 11's files at the tiny presets, on two CPU ranks
    (2 frames): a ZeRO-1 step and a ZeRO-2 step resumed from its checkpoint
    on the ranks, rank 1 writing nothing, and at W = 1 a fresh step 1 and a
    resume from the step-1 checkpoint, whose steps meet the ranks' ZeRO-1
    and ZeRO-2 steps within the card's limits (on the CPU, in fp32, far
    within)."""
    import torch

    result = chip_smoke.mesh_train(torch.device("cpu"), prepped[0], 0, overrides=TINY, frames=2)
    assert [x["step"] for x in result["ranks"][0]["runs"]] == [1, 2]
    assert [result["one_process"][z]["step"] for z in ("zero1", "zero2")] == [1, 2]
    assert result["ranks"][1]["writes"] == 0 and "checkpoints/2.pt" in result["rank0_files"]
    for i, zero in enumerate(("zero1", "zero2")):
        agreement = result["step_agreement"][zero]
        assert agreement["frozen_equal"] and agreement["counts"] == [i + 1, i + 1]
        assert result["loss_rel"][i] < 1e-5 and agreement["mu_rel_rms"] < 1e-4


def test_sharded_clip_launches_follow_the_chunks():
    """Each rank's share of a full clip's flash launches at W = 2: 5 a step
    (its frames, both guidance halves), 7 of the 13 encode chunks (the last
    rank repeating one), 3 of the 5 decode chunks; one process is the single
    clip's 5N + 18; at W = 4, 4 encode and 2 decode chunks."""
    from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig

    assert chip_smoke.sharded_clip_launches(4, PipelineConfig(), 2) == 5 * 4 + 7 + 3
    assert chip_smoke.sharded_clip_launches(4, PipelineConfig(), 1) == 5 * 4 + 18
    assert chip_smoke.sharded_clip_launches(1, PipelineConfig(), 4) == 5 + 4 + 2  # phase 21's ranks


def test_memory_flip_reading_names_each_kind_of_flip():
    """Two clouds rendered at one pose: a point that moves behind another
    flips its 2 x 2 footprint by depth order, a point that leaves the
    confidence mask empties its footprint, and a point that moves across a
    pixel edge takes its footprint one pixel over; the index render's
    winners give back each memory's colours."""
    import torch

    from evoworld_tpu_torch.memory.render import render_memory_panoramas

    # u = (atan2(x, z) / 2 pi + 0.5) * 32: point 4 at u = 28.01 on one side and 27.99 on the other.
    lon = [(28.01 / 32 - 0.5) * 2 * math.pi, (27.99 / 32 - 0.5) * 2 * math.pi]
    points = torch.tensor([[0.0, 0.0, 2.0], [0.0, 0.0, 2.5], [0.0, 0.0, -10.0], [3.0, 0.0, 0.0],
                           [4 * math.sin(lon[0]), 0.0, 4 * math.cos(lon[0])]])
    colors = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 1.0, 1.0], [1.0, 0.0, 1.0]])
    pose = torch.cat([torch.eye(3), torch.zeros(3, 1)], dim=1)[None]
    ref = dict(points=points, colors=colors, valid=torch.ones(5, dtype=torch.bool), target_c2w=pose, height=16,
               width=32)
    got = dict(ref, points=points.clone(), valid=torch.tensor([True, True, True, False, True]))
    got["points"][0, 2] = 2.6
    got["points"][4] = torch.tensor([4 * math.sin(lon[1]), 0.0, 4 * math.cos(lon[1])])
    memories = [render_memory_panoramas(r["points"], r["colors"], r["valid"], r["target_c2w"], 16, 32) for r in (ref, got)]
    reading = chip_smoke.memory_flip_reading(ref, got, *memories, torch.device("cpu"))
    # the edge crossing: footprint columns 28-29 become 27-28, so columns 27 and 29 flip (two rows each)
    assert reading["kinds"] == {"depth_order": 4, "validity": 4, "pixel_edge": 4} and reading["flipped"] == 12
    assert reading["winners_reproduce"] and reading["validity_changed"] == 1
    assert reading["edge_crossings"] == 1 and reading["max_edge_move_px"] == pytest.approx(0.02, abs=1e-4)
    assert reading["max_edge_distance_px"] == pytest.approx(0.01, abs=1e-4)
    assert reading["max_point_shift"] == pytest.approx(0.3)
    assert 0 < reading["depth_quantum"] < 1e-3
    order = next(r for r in reading["rows"] if r["kind"] == "depth_order")
    assert order["winners"] == [0, 1] and order["covers"] == [[True, True], [True, True]]
    assert order["depth_gap"] == [pytest.approx(0.25), pytest.approx(0.1 / 2.6)]


def test_segment_agreement_holds_the_gate_rule():
    """The composed gate's rule on a segment: a little noise passes, the
    same frames rolled by a chunk or one pixel in a hundred moved by 0.3 fail."""
    import torch

    g = torch.Generator().manual_seed(0)
    ref = torch.rand((10, 8, 16, 3), generator=g)
    assert chip_smoke.segment_agreement(ref, ref + 1e-3 * torch.randn(ref.shape, generator=g))["passes"]
    assert not chip_smoke.segment_agreement(ref, torch.roll(ref, 5, 0))["passes"]
    moved = ref.clone()
    moved[0, 0, 0, 0] += 0.3
    result = chip_smoke.segment_agreement(ref, moved)
    assert not result["passes"] and result["share_within_3e_2"] > 0.99 and result["rel_rms"] < 0.01


def test_mesh_gate_runs_on_the_cpu(tmp_path):
    """Phase 18(b) as the card runs it, on two CPU ranks against one rank in
    this process: the teacher-forced and the pixel-swapped episodes pass the
    gate, and the reading's winners give back the memories' colours."""
    import torch

    gate = chip_smoke.mesh_gate(torch.device("cpu"), str(tmp_path))
    assert gate["launches"] == [[0, 0], [0, 0]]
    assert gate["flipped_pixels"]["winners_reproduce"]
    for run in gate["teacher_forced"] + gate["flipped_pixels_swapped"]["vs_ranks"]:
        assert min(run["segments"]["share_within_3e_2"]) >= 0.99


def test_route_gradients_phase_runs_at_tiny_size_on_the_cpu(tmp_path):
    """Phase 20(a) at a tiny shape on CPU ranks (the plain versions, no
    launches): both routes' gradients pass its gate against the plain fp32
    backward, the short ring block fails the limits, and the gate refuses a
    route whose rank launched the wrong count or whose ranks disagree."""
    import copy

    import torch

    result = chip_smoke.route_gradients(torch.device("cpu"), str(tmp_path), 0, shape=(1, 96, 16, 8), min_seq=1)
    assert [(r["route"], r["world_size"]) for r in result["routes"]] == [("head_sharded", 2), ("ring", 3)]
    assert not all(chip_smoke.within_limits(e) for e in result["dropped_block_errors"].values())
    for broken in ("launches", "ranks_equal", "errors"):
        bad = copy.deepcopy(result)
        route = bad["routes"][1]
        if broken == "launches":
            route["ranks"][2]["launches"] = [0, 1]
        elif broken == "ranks_equal":
            route["ranks_equal"] = False
        else:
            route["errors"]["dk"] = bad["dropped_block_errors"]["dk"]
        with pytest.raises(AssertionError):
            chip_smoke.check_route_gradients(bad)


def test_route_gradients_phase_takes_ranks_started_ahead(tmp_path):
    """Phase 20(a) on ranks started before it (`Ranks` with no call, as
    `chip_smoke.prestart` starts them on the card): the same routes, in the
    same order, pass its gate."""
    import torch

    from evoworld_tpu_torch.parallel.launch import Ranks

    ahead = {w: Ranks(None, w, str(tmp_path / f"ahead{w}"), device="cpu") for w in (2, 3)}
    result = chip_smoke.route_gradients(torch.device("cpu"), str(tmp_path), 0, shape=(1, 96, 16, 8), min_seq=1,
                                        ranks=ahead)
    assert [(r["route"], r["world_size"]) for r in result["routes"]] == [("head_sharded", 2), ("ring", 3)]
    assert all(job.called and all(p.poll() == 0 for p in job.procs) for job in ahead.values())


def test_model_parallel_step_gate():
    """Phase 20(b) and (c)'s gate on a report shaped like the card's: it
    passes, and fails on a rank's launches, a loss apart, masters or first
    moments apart, or a second update."""
    import copy

    rank = dict(loss=1.1757, grad_norm=11.3402, launches=[14, 5])
    good = dict(target="frame_step_rank", ranks=[rank, dict(rank)], expected_launches=[[14, 5], [14, 5]],
                one_process=dict(loss=1.1758, grad_norm=11.3407, launches=[18, 5]),
                expected_one_process_launches=[18, 5], loss_rel=[9e-5, 9e-5], grad_norm_rel=[5e-5, 5e-5],
                step_agreement=dict(within_tenth_lr=0.994, mu_rel_rms=0.002, counts=[1, 1]))
    chip_smoke.check_model_parallel_step(good)
    for path, value in ((("ranks", 1, "launches"), [13, 5]), (("loss_rel", 0), 2e-2),
                        (("step_agreement", "within_tenth_lr"), 0.9), (("step_agreement", "mu_rel_rms"), 0.2),
                        (("step_agreement", "counts"), [1, 2]), (("one_process", "launches"), [17, 5])):
        bad = copy.deepcopy(good)
        target = bad
        for key in path[:-1]:
            target = target[key]
        target[path[-1]] = value
        with pytest.raises(AssertionError):
            chip_smoke.check_model_parallel_step(bad)


def _frame_clip_spawn(broken: str):
    """A stand-in for `spawn` in phase 21: four ranks run the card out of
    memory, three return `clip_rank` records of a small clip (rank 0's within
    1e-3 of the one-process clip), broken as `broken` says."""
    import torch

    from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig

    g = torch.Generator().manual_seed(0)
    one = dict(frames=torch.rand((10, 8, 16, 3), generator=g), latents=torch.randn((10, 4, 1, 2), generator=g))
    got = one["frames"] + 1e-3 * torch.randn(one["frames"].shape, generator=g)
    want = chip_smoke.sharded_clip_launches(1, PipelineConfig(num_steps=1), 3)
    calls = []

    def spawn(target, world_size, workdir, device, args=(), **kwargs):
        calls.append((target, world_size, args))
        if world_size == 4 or broken == "every_count_out_of_memory":
            raise RuntimeError("spawned ranks failed:\nrank 2:\ntorch.OutOfMemoryError: CUDA out of memory.")
        if broken == "other_error":
            raise RuntimeError("spawned ranks failed:\nrank 0:\nValueError: something else")
        ranks = [dict(rank=r, world_size=3, data=3, model=1, frames=[0, 9], seconds=20.0 + r,
                      stage_seconds={"denoise": 9.0}, peak_memory_bytes=14e9, launches=[want, 0], shape=[10, 8, 16, 3],
                      finite=True, sha256="a", clip=got if r == 0 else None,
                      latents=one["latents"] * 1.01 if r == 0 else None) for r in range(3)]
        if broken == "launches":
            ranks[2]["launches"] = [want - 5, 0]  # a rank whose UNet never reached the kernel
        elif broken == "ranks_differ":
            ranks[1]["sha256"] = "b"
        elif broken == "rolled":
            ranks[0]["clip"] = torch.roll(got, 5, 0)  # decode chunks joined out of order
        return ranks

    return one, spawn, calls


def test_frame_clip_phase_cuts_on_out_of_memory_and_prints_its_record(monkeypatch, tmp_path, capsys):
    """Phase 21 on stand-in ranks: four run out of memory, so three run, the
    cut and its reason recorded; the printed record holds the ranks' launches,
    seconds and peaks beside the one-process runs', the gate's reading and
    the rolled clip's failing one."""
    import json

    import torch

    from evoworld_tpu_torch.parallel import launch

    one, spawn, calls = _frame_clip_spawn("none")
    monkeypatch.setattr(launch, "spawn", spawn)
    one_runs = [dict(clip="cold", seconds=5.1, stage_seconds={}, peak_memory_bytes=34e9),
                dict(clip="warm", seconds=4.9, stage_seconds={}, peak_memory_bytes=34e9)]
    result = chip_smoke.frame_clip(torch.device("cpu"), 1, 0, str(tmp_path), one, one_runs)
    assert [(c[0], c[1], c[2]) for c in calls] == [("chip_smoke:clip_rank", 4, (1, 0)), ("chip_smoke:clip_rank", 3, (1, 0))]
    assert result["world_size"] == 3 and result["cuts"] == [dict(world_size=4, reason="4 ranks ran the card out of memory")]
    line = next(x for x in capsys.readouterr().out.splitlines() if x.startswith("frame clip {"))
    printed = json.loads(line[len("frame clip "):])
    assert printed["expected_launches"] == [5 + 5 + 2, 0]  # a step, 5 of 13 encode and 2 of 5 decode chunks at W = 3
    assert [r["launches"] for r in printed["ranks"]] == [printed["expected_launches"]] * 3
    assert [r["seconds"] for r in printed["ranks"]] == [20.0, 21.0, 22.0]
    assert printed["one_process"]["warm"]["peak_memory_bytes"] == 34e9
    assert printed["vs_one_process"]["passes"] and not printed["rolled_by_a_decode_chunk"]["passes"]
    assert printed["ranks_equal"] and "clip" not in printed["ranks"][0] and "latents" not in printed["ranks"][0]
    assert printed["latents_vs_one_process"]["rel_rms"] == pytest.approx(0.01)


@pytest.mark.parametrize("broken", ["launches", "ranks_differ", "rolled", "every_count_out_of_memory", "other_error"])
def test_frame_clip_phase_fails(monkeypatch, tmp_path, broken):
    """Phase 21 fails on a rank's launch count, ranks whose clips differ, a
    clip whose decode chunks are out of order, every rank count out of
    memory, or an error other than out of memory (which makes no cut)."""
    import torch

    from evoworld_tpu_torch.parallel import launch

    one, spawn, _ = _frame_clip_spawn(broken)
    monkeypatch.setattr(launch, "spawn", spawn)
    error = RuntimeError if broken == "other_error" else AssertionError
    with pytest.raises(error):
        chip_smoke.frame_clip(torch.device("cpu"), 1, 0, str(tmp_path), one, [])
