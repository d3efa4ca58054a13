"""`evoworld_tpu_torch/compare_kernels.py` off the card: its pairing of
kernel entries across two builds by kernel, head dim and element type (an
entry whose name carries no type is bf16, as before the type became a
template parameter, but the fp32 source's `flash_fp32_*` kernels, which are
fp32), and its reading of `cuobjdump -sass`."""

import os
import stat

import pytest

from evoworld_tpu_torch import compare_kernels

NS = "_ZN50_GLOBAL__N__5f87c45e_17_flash_attn_bwd_cu_ca4a9867"


@pytest.mark.parametrize("mangled, key", [
    (NS + "15flash_bwd_fusedILi64E6__halfEEv14CUtensorMap_stS2_NS_9FusedArgsIT0_EE", ("flash_bwd_fused", 64, "fp16")),
    (NS + "15flash_bwd_fusedILi64E13__nv_bfloat16EEv14CUtensorMap_st", ("flash_bwd_fused", 64, "bf16")),
    (NS + "15flash_bwd_fusedILi64EEEv14CUtensorMap_stS1_S1_S1_NS_9FusedArgsE", ("flash_bwd_fused", 64, "bf16")),
    (NS + "15flash_bwd_deltaILi512E6__halfEEvNS_9BwdParamsIT0_EEl", ("flash_bwd_delta", 512, "fp16")),
    (NS + "4wide17flash_bwd_wide_dqI6__halfEEv14CUtensorMap_stS3_S3_S3_NS0_8WideArgsIT_EE",
     ("flash_bwd_wide_dq", None, "fp16")),
    (NS + "4wide17flash_bwd_wide_dvEv14CUtensorMap_stS1_S1_NS0_8WideArgsE", ("flash_bwd_wide_dv", None, "bf16")),
    ("_ZN12_GLOBAL__N_114flash_fwd_wideI13__nv_bfloat16EEvv", ("flash_fwd_wide", None, "bf16")),
    # the fp32 source's kernels carry no type: fp32 by name, paired by kernel and head dim
    ("_ZN51_GLOBAL__N__638dd51a_18_flash_attn_fp32_cu_a7cea31217flash_fp32_bwd_dqILi512EEEvNS_9BwdParamsE",
     ("flash_fp32_bwd_dq", 512, "fp32")),
    ("_ZN51_GLOBAL__N__638dd51a_18_flash_attn_fp32_cu_a7cea31220flash_fp32_bwd_deltaILi64EEEvNS_9BwdParamsEl",
     ("flash_fp32_bwd_delta", 64, "fp32")),
    ("_ZN51_GLOBAL__N__638dd51a_18_flash_attn_fp32_cu_a7cea31214flash_fp32_fwdILi128EEEvNS_9FwdParamsE",
     ("flash_fp32_fwd", 128, "fp32")),
])
def test_entry_key_pairs_the_same_kernel_across_builds(mangled, key):
    assert compare_kernels.entry_key(mangled) == key


def test_sass_entries_reads_each_function_apart(tmp_path):
    dump = tmp_path / "sass.txt"
    dump.write_text("""
Fatbin elf code:
================
arch = sm_90a
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_115flash_fwd_wgmmaILi64E6__halfEEvv
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   EXIT ;                          /* 0x000000000000794d */
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_115flash_fwd_wgmmaILi64EEEvv
        /*0000*/                   EXIT ;                          /* 0x000000000000794d */
""")
    fake = tmp_path / "cuobjdump"
    fake.write_text(f"#!/bin/sh\ncat {dump}\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    entries = compare_kernels.sass_entries(os.devnull, str(fake))
    assert list(entries) == [("flash_fwd_wgmma", 64, "fp16"), ("flash_fwd_wgmma", 64, "bf16")]
    assert len(entries[("flash_fwd_wgmma", 64, "fp16")]) == 3
    assert entries[("flash_fwd_wgmma", 64, "bf16")] == ["/*0000*/                   EXIT ;"
                                                        "                          /* 0x000000000000794d */"]


def test_twin_diff_counts_lines_by_the_opcodes_that_differ():
    bf16 = ["/*0100*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;  /* 0x01 */", "/* 0x000fe4 */",
            "/*0110*/  @P0 F2FP.BF16.F32.PACK_AB R3, R5, R4 ;  /* 0x02 */", "/*0120*/  EXIT ;  /* 0x03 */"]
    fp16 = ["/*0100*/  HGMMA.64x64x16.F32 R24, gdesc[UR4], R24 ;  /* 0x04 */", "/* 0x000fe5 */",
            "/*0110*/  @P0 F2FP.F16.F32.PACK_AB R3, R5, R4 ;  /* 0x05 */", "/*0120*/  EXIT ;  /* 0x03 */"]
    assert compare_kernels.twin_diff(bf16, fp16) == dict(
        lines=4, bf16_lines=4, differing_lines=3,
        differing_opcodes=[["F2FP.BF16.F32.PACK_AB", "F2FP.F16.F32.PACK_AB", 1],
                           ["HGMMA.64x64x16.F32.BF16", "HGMMA.64x64x16.F32", 1], ["encoding", "encoding", 1]])


def test_main_refuses_unknown_parts_and_a_missing_other(capsys):
    for argv in (["--parts", "sass,speed"], ["--parts", "bf16_ab"], ["--parts", "fp32_ab"]):
        with pytest.raises(SystemExit) as exit_info:
            compare_kernels.main(argv)
        assert exit_info.value.code == 2
    assert "need --other" in capsys.readouterr().err


def test_ab_times_pair_each_row_of_the_two_checkouts():
    """`fp32_ab` (and `bf16_ab`) time each checkout twice, other, this, this,
    other: each row gets both checkouts' reads in that order and the ratio of
    their sums; a row the other checkout does not time gets no ratio."""
    label, second = compare_kernels.ROWS[0][0], compare_kernels.ROWS[1][0]
    assert ("head_dim_128_fwd", "fwd") == next(r[:2] for r in compare_kernels.ROWS if r[0] == "head_dim_128_fwd")
    assert compare_kernels.AB_PARTS == {"bf16_ab": "bf16", "fp32_ab": "fp32"}
    assert compare_kernels.DTYPES["fp32"] == "float32"
    other, here = "/other", compare_kernels.HERE
    runs = [(other, {label: 4.0}), (here, {label: 2.0, second: 1.0}), (here, {label: 2.2, second: 1.0}),
            (other, {label: 4.2})]
    times = compare_kernels.ab_times(runs, other)
    assert times[label] == dict(other_ms=[4.0, 4.2], this_ms=[2.0, 2.2], ratio=4.2 / 8.2)
    assert times[second] == dict(other_ms=[], this_ms=[1.0, 1.0], ratio=None)
    assert set(times) == {r[0] for r in compare_kernels.ROWS}
