#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`evoworld_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build the port's CUDA sources with nvcc for sm_90a and print ptxas's
     registers and spills for each kernel entry (a spill fails the run);
  3. hold each kernel against its plain PyTorch version at the shapes the
     main path gives it (plus a ragged length with padded, masked keys, and
     the training shape with its log-sum-exp), within limits relative to the
     plain output's RMS that a deliberately wrong result must fail, and time
     the kernel, the plain version and, as a yardstick only, one PyTorch
     library call (short calls repeated to fill FILL_MS); the D = 512 rows
     run a second time asking for the log-sum-exp, held against the plain
     one within LSE_ATOL and timed apart; each row prints
     its TFLOP/s, its share of the bound and the kernel that served it, read
     from a profiler trace (flash_fwd_wgmma at D = 64/128, flash_fwd_wide at
     512, or the run fails); on a card at its full power limit the D = 512
     rows must keep to FWD_MS_LINES;
  4. a small clip on the card against the same clip on the CPU (tiny widths,
     fp32), the port's own reference check;
  5. two full-width clips (1024x576, 25 frames, bf16, random weights from
     seed 0, N = STEPS denoise steps), cold then warm, through `build_pipeline`
     and the pipeline's `__call__`; the kernel launch counts are reset just
     before each clip and must equal 5*N + 18 after it.
The training slice (EDM fine-tuning) adds:
  3b. the forward kernel's log-sum-exp and the backward kernel
     (flash_attn_bwd.cu) against the plain forward and backward: the LSE,
     dQ, dK, dV at the training shape, at D = 128 and at the ragged row,
     within the same RMS-relative limits, which the plain backward without
     its last DROPPED_KEYS keys must fail; a second call on the same inputs
     must give the same dK and dV bit for bit and dQ within one bf16 step
     (the fused pass sums dQ with global reductions in no fixed order); the
     trace must hold the row's design's kernels and no other backward
     kernel; timed beside its bound, its plain version and
     scaled_dot_product_attention's backward, each kernel of the call apart;
     on a card at its full power limit the D = 64 and 128 rows must keep to
     BWD_MS_LINES. The CLI slice adds the D = 512 backward (the VAE's
     mid-block attention, which no path differentiates) at (8, 9216, 1, 512),
     (2, 9216, 1, 512) and a ragged length, the same checks, and a second
     call that must repeat dQ, dK and dV bit for bit (no sums across blocks);
  6. one full-width level-0 TransformerSpatioTemporalModel (320 channels,
     5 heads, 9216 tokens, 5 frames, bf16 under autocast), forward and
     backward through the kernels against the dispatch's plain route;
  7. a tiny fp32 training step (2 micro-batches) on the card against the
     same step on the CPU, same weights and draws;
  8. TRAIN_STEPS full-width training steps (1024x576, 25 frames, batch 1,
     bf16, block remat, random weights from seed 0) through `build_trainer`
     and the training loop `train` (EMA on, a final checkpoint into a
     temporary directory) on a synthetic in-memory dataset; per step the
     tracker's seconds, loss and gradient norm, and the launch counts and
     peak memory read at the loop's step log line; the counts are reset
     just before the loop and must equal the derived number in every step;
     losses and gradients finite, level-0 norm1's gradient nonzero,
     the checkpoint's trainable leaves moved and frozen ones not, its Adam
     state over the trainable leaves, the UNet left holding its EMA.
The loop slice (the evolving-memory loop) adds:
  3. rows at VGGT's global attention, (1, 26025, 16, 64) and (1, 51009, 16,
     64) at the loop's two rebuilds (25 and 49 frames x 1041 tokens), and a
     head dim the wrapper zero-pads to the D = 64 kernel, (2, 9216, 2, 16)
     (the multi-GPU training slice adds VGGT's frame attention, (25, 1041,
     16, 64), scripts/exp_vggt_attn.py's shape);
  9. a tiny fp32 3-segment loop on the card, each stage (clip generation,
     memory rebuild) held against the same stage on the CPU given the card's
     inputs (tiny pipeline and VGGT, 64x128 panoramas, 16x512 crops, the
     same weights and draws), within the CPU parity test's tolerances;
  10. the full-width loop: 3 segments of 25 frames at 1024x576, N = STEPS denoise
     steps, bf16, random weights from seed 0, 384x512 crops, through
     `build_pipeline`, `build_reconstructor("full")`, `Navigator` and
     `UnifiedLoop.run_episode` on a synthetic camera path; per-stage seconds,
     peak memory and each memory stack's coverage; every frame and memory
     finite, and the flash launches, reset just before the episode, equal to
     `expected_loop_launches` (3 (5N + 18) + 2 x 24 = 117 at N = 1).
The CLI slice (checkpoints, image IO, the production CLIs) adds:
  3c. torch.autograd through one full-width VAE mid-block attention (512
     channels, one head of 512, 9216 tokens, bf16) on the card: the kernels
     (the wide forward with its log-sum-exp, the D = 512 backward) against
     the block's plain route, output and every gradient within BLOCK_REL_RMS;
  11. the production CLIs at full width: a synthetic 1024x576 episode written
     with the port's PNG writer, full-width random checkpoints (UNet, VAE and
     CLIP safetensors with conv_in cut to 8 channels, a VGGT model.pt) in a
     temporary directory, then `cli.run_single_segment.main` and
     `cli.run_unified.main` at N = STEPS on the card from them; the loaded
     parameters must equal the written ones, the PNGs' counts and sizes the
     episode's, the flash launches 5N + 18 and 162, and the writer's encode
     must overlap the compute; it prints the write, load, generate,
     reconstruct, splat, host decode and host save seconds.
The JPEG slice (the redesigned D = 128 backward, JPEG decode) adds:
  2b. the port's JPEG decoder (csrc/imageio.cpp, built with g++ beside the
     two nvcc builds) on the fixtures committed under tests/torch_port_data/
     (4:2:0 baseline, 4:2:2 with restart markers, progressive, grey): every
     byte must equal the PNG stored beside each, PIL's decode of it (this
     machine has neither PIL nor libjpeg);
  3b. the D = 128 rows, (2, 9216, 2, 128) and (1, 5205, 16, 128) with keys
     padded to 5632, run the fused wgmma pass (flash_bwd_fused<128>) under
     the D = 64 rules: dQ within DQ_REPEAT_RTOL on a second call, and
     head_dim_128 within its BWD_MS_LINES line.
The wide-backward slice (the D = 512 backward redesigned) adds:
  3b. the D = 512 rows run three wgmma sweeps (flash_bwd_wide_dv, _dk, _dq)
     after flash_bwd_delta: the trace must hold them and neither kernel of
     the mma.sync pair they replaced (RETIRED_BWD_KERNELS); dQ, dK and dV
     still repeat bit for bit, and vae_mid_d512 and vae_mid_d512_b2 keep to
     their BWD_MS_LINES lines.
The training-CLI and evaluation slice adds, on phase 11's files:
  12. `cli.train.main` at full width from phase 11's checkpoint directories
     and episode (the last 25 frames, bf16, EMA on): 2 steps with a
     checkpoint and a validation clip (N = STEPS) at step 2, then a resume to
     step 3; the flash launches of every step (`expected_train_launches`)
     and of the validation clip (5N + 18), finite losses and gradient norms,
     the loaded models equal to the files, the validation GIF's blocks (25
     frames of 576 x 2048, parsed without PIL), the logged val_psnr /
     val_ssim equal to `eval.metrics` on the CPU, the clip rendered with the
     step-2 checkpoint's EMA, the resume at step 2 with the checkpoint's
     EMA; it prints seconds per step, validation and
     checkpoint save seconds, checkpoint bytes and peak memory;
  13. with TF32 switched on for matmuls and cuDNN, `cli.calculate_metrics.main`
     over three episodes at 1024x576 (phase 11's last segment and single clip,
     phase 12's validation clip) with metric nets made sensitive to the
     frames, each metric timed on the card, the harness on 2 episodes x 10
     frames against the same on the CPU (SSIM within 1e-5, the feature
     metrics above EVAL_FEATURE_FLOOR and within EVAL_FEATURE_RTOL; the
     errors without the harness's fp32 guard reported beside them),
     `cli.calculate_dreamsim.main` (dino_vitb16 and the ensemble) against the
     CPU, no flash launch.
The data-preparation slice (cube_to_pano, pano_to_pers, sky segmentation,
reproject) adds:
  3. a row at VGGT's global attention over a 97-frame episode's 73 source
     frames, (1, 75993, 16, 64);
  14. on phase 11's episode (97 panoramas of 1024x576) and VGGT-1B model.pt:
     `cli.pano_to_pers.main` (97 crops of 384x512 and the camera file), then
     `cli.reproject.main` with the sky mask on, from a full-width random
     U^2-Net made sensitive to the crops (`sensitive_skyseg_onnx`) and
     written as skyseg.onnx by the port's ONNX writer: 24 renders at
     576x1024, finite and not one value, exactly 24 flash launches (reset
     just before), `--data.start_idx` / `--data.end_idx` selecting the
     episode they name among three, a second call that builds no VGGT,
     launches nothing and writes nothing; the sky mask of 4 crops on the
     card against the CPU by flipped share (PREP_MASK_MAX_FLIPPED); then
     `cli.cube_to_pano.main` on synthetic faces of 1024 in the Unity and UE
     layouts into 1000x2000 panoramas, against the CPU by flipped share
     (CUBE_MAX_FLIPPED); it prints the seconds of the crops, VGGT, the mask,
     the alignment and render, and cube_to_pano, and the peak memory.
The fp16 slice (every flash kernel templated over bf16 and fp16, the
converter) adds:
  2. the ptxas report of every fp16 instantiation beside its bf16 twin's:
     each kernel entry must exist in both types, neither spilling nor
     serializing its wgmma;
  3, 3b. fp16 twins of the main path's rows (FP16_FWD_TWINS, FP16_BWD_TWINS:
     UNet L0 with and without the LSE, VGGT at 51009 and 75993 tokens, the
     VAE mid at B = 2, 5 and 8, the ragged rows; the training shape,
     D = 128, D = 512 at B = 8, the ragged backward rows) on the same values
     cast to fp16, under fp16's own limits (FP16_MAX_REL_ERR,
     FP16_MEAN_REL_ERR), which the dropped-keys version and the bf16 twin's
     errors must fail, the same repeat checks, timed beside their bound,
     plain version and library call; every row names the element type the trace shows,
     and on a card at FULL_POWER_W each fp16 row keeps within TWIN_MS_RATIO
     of its bf16 twin;
  15. the fp16 path on phase 11's and 14's files: phase 11's checkpoints as
     fp32 safetensors, halved by `cli.convert_checkpoint halve` into an fp16
     pipeline directory (every F32 tensor equal to its `.to(float16)` bit for
     bit), `cli.convert_checkpoint validate` on it (exit 0) and on a copy with
     one tensor's shape changed (exit 1, naming it), then at
     `--runtime.compute_dtype=float16`: `cli.run_single_segment.main` from
     the fp16 directory (5N + 18 launches, finite frames, the PNGs; the RMS
     difference from phase 11's bf16 clip reported), `cli.train.main` for 2
     steps from phase 11's checkpoints without validation
     (`expected_train_launches` a step, finite losses and gradient norms,
     level-0 norm1's gradient nonzero), and `cli.reproject.main` on a fresh
     copy of phase 14's episode (24 launches, 24 finite renders that are not
     one value); seconds, peak memory.
The fp32 slice (csrc/flash_attn_fp32.cu; split-TF32 mma.sync, then wgmma on a
three-part bf16 split of each fp32 operand) adds:
  2. its source built beside the others (every entry of FP32_ENTRIES in
     ptxas's report, no spill); `cuobjdump -sass` of the fp32 library shows
     every entry of FP32_WGMMA_KERNELS holding HGMMA and no HMMA
     (`fp32_sass_rows`, `check_fp32_sass`);
  3, 3b. the FP32_FWD_TWINS and FP32_BWD_TWINS rows again in fp32 on the same
     draws (labels with "_fp32"), against the plain version in fp32 with TF32
     off, under fp32's own limits (FP32_MAX_REL_ERR, FP32_MEAN_REL_ERR; the
     LSE within FP32_LSE_ATOL), which the dropped-keys version and the fp16
     twin's errors (every gradient's) must fail; dQ, dK and dV repeated bit
     for bit; the trace naming the fp32 kernels and no other; timed beside
     the bound at the TF32 rate, three times it (six bf16 products a
     product), the plain version and the library call;
  16. the fp32 path on the files of phases 11, 14 and 15 under torch's default
     TF32 flags (printed): at `--runtime.compute_dtype=float32`
     `cli.run_single_segment.main` from phase 15's `svd_fp32/` (5N + 18
     launches at N = STEPS), `cli.train.main` for 2 steps from phase 11's
     checkpoints (the first of FP32_TRAIN_FRAMES that does not run the
     card out of memory, 22 of the configuration's 25, each count given up
     reported as the cut; `expected_train_launches` a step) and
     `cli.reproject.main` on a fresh copy of phase 14's episode (24
     launches); seconds, peak memory. The kernels line gets an entry for the
     fp32 forward and one for the fp32 backward, their launches phase 16's.
The tools and multi-GPU slice (validate_parity, the PLY / OBJ export, the
mesh routes, the sharded clip, VGGT, render and loop) adds:
  10. phase 10 keeps its first rebuild's confidence-filtered cloud (25 frames
     of VGGT-1B points and colours) on the host for phase 17, and its first
     segment for phase 18;
  17. `cli.validate_parity.main` at full width on phase 11's checkpoint
     directories, model.pt and episode (N = STEPS, `--parity.dry_run`):
     against phase 11's own single-segment frames the gate must pass, against
     them perturbed it must exit with code 1 (the JAX CLI's), each run 5N + 18
     launches; then phase 10's cloud (its first EXPORT_POINTS points)
     written as PLY and OBJ by `memory/export.py` in one process, seconds
     and bytes;
  18. the multi-GPU serving path on the one card, W ranks spawned by
     `parallel/launch.py` sharing cuda:0 over gloo: (a) VGGT's global
     attention (ROUTE_GRAD_SHAPE) in bf16 on the head-sharded route at W = 2 and the
     ring at W = 3, each rank within the bf16 limits of the plain fp32
     version and its launches counted (1, and W ring blocks; run in phase
     20(a)'s ranks, before their gradient); the composed loop gate at
     W = 2 against the same episode on one rank in this process (fp32),
     teacher-forced at the memory, with the free-running differences and a
     reading of their cause (`memory_flip_reading`; the one-rank episode
     fed its own memory with only the flipped pixels taken from the ranks'
     must pass the gate); a full-width episode at W = 2 (`LoopConfig()`,
     VGGT-1B, N = STEPS), finite, the ranks' outputs equal, its first
     segment held to phase 10's by the gate's rule (and the same frames
     rolled by a decode chunk must fail it), each rank's launches
     `sharded_clip_launches` a clip and 24 a rebuild (steps, then segments,
     cut where two ranks run the card out of memory, and the cut
     reported; MESH_EPISODE_SEGMENTS segments, cut for the run's time
     limit: one since phase 21 came, so no rebuild). Two ranks on one card
     measure nothing of multi-GPU speed.
The multi-GPU training slice (the data-parallel step with ZeRO-1 and ZeRO-2,
rank-0 checkpoints, reproject under torchrun, VGGT's host parameter offload) adds:
  3, 3b. a row whose profiler trace holds no device time is traced again, up
     to TRACE_TRIES times, then timed by CUDA events if the kernel's launch
     count moved once a call (else it fails); each row prints `timed_by`;
  10. the episode's VGGT keeps its parameters in pinned host memory between
     rebuilds (the default on one card), and each generate and reconstruct
     call's peak memory is read;
  19. on phase 10's, 11's and 14's files, W = 2 ranks sharing cuda:0 over gloo:
     (a) `cli.reproject.main` on a fresh copy of phase 14's episode, VGGT's
     global attention head-sharded (73 frames divide by no W): rank 0's 24
     renders against phase 14's within MESH_RENDER_ATOL / MESH_RENDER_EQUAL,
     rank 0 alone writing, the ranks' records equal, 24 launches a rank;
     (b) `cli.train.main` at full width from phase 11's checkpoints and
     episode, per-device batch 1, bf16, MESH_TRAIN_FRAMES frames (two ranks
     share the 80 GB): a ZeRO-1 step and its checkpoint, a ZeRO-2 step
     resumed from it at W = 2, then in this process at W = 1 (batch 2, the
     same batch and draws) a fresh step 1 and a resume from the ranks'
     step-1 checkpoint, each step held to the ranks' within MESH_TRAIN_RTOL,
     MESH_TRAIN_WITHIN_LR and MESH_TRAIN_MU_RMS; `expected_train_launches` a
     rank a step, rank 0 alone writing; (c) phase 10's episode cut to two segments with VGGT's
     parameters kept on the card, against phase 10's: outputs bit for bit,
     each stage's peak memory, seconds. Each sub-phase prints its seconds
     and every rank's peak memory. Ranks sharing a card measure nothing of
     multi-GPU speed.
The model-parallel half of training (the routes' gradients, the
frame-sharded step, tensor-parallel weights) adds:
  20. on phase 11's checkpoints, ranks sharing cuda:0 over gloo: (a) the
     gradient of VGGT's global attention at ROUTE_GRAD_SHAPE (bf16) through the
     head-sharded route at W = 2 and the ring at W = 3, rank 0's dq, dk, dv
     within the bf16 limits of the plain fp32 backward (which the same
     gradients with one ring block's dK and dV short of a query shard's part
     must fail), every rank's equal, launches a rank [1, 1] and [3, 3]; (b)
     one full-width bf16 step with the frames sharded over W = 2 at
     FRAME_STEP_FRAMES and (c) one on a 1 x 2 tensor-parallel mesh at
     TP_STEP_FRAMES, the four ranks at once, each against the same step in
     this process at the
     same frames, batch and draws (MESH_TRAIN_RTOL, MESH_TRAIN_WITHIN_LR,
     MESH_TRAIN_MU_RMS), each rank's launches `expected_train_launches` at
     its frame count, each rank's peak memory and state bytes beside the
     one-process step's. Ranks sharing a card measure nothing of multi-GPU
     speed.
The frame-sharded serving denoise (a mesh splits the clip's frames over its
data axis, both guidance halves on every rank, as the JAX package does) adds:
  3. rows of the forward at the first rank's level-0 attention of a split
     clip: (26, 9216, 5, 64) at W = 2 and (14, 9216, 5, 64) at W = 4;
  18(c). the episode's clip splits its frames 13 + 12 (phase 21 holds a
     split clip alone to phase 5's);
  21. phase 5's clip with the frames split over W = 4 ranks sharing cuda:0
     over gloo (7 + 6 + 6 + 6 frames; W = 3 where four run the card out of
     memory, the cut and its reason printed), by the same rule against phase
     5's clip, the ranks' clips equal, `sharded_clip_launches` a rank; each
     rank's seconds and peak memory beside phase 5's. Ranks sharing a card
     measure nothing of multi-GPU speed.
The MP4 slice (the scoring of video files, the MP4 export) adds:
  2c. the port's MPEG-4 Part 2 decoder (csrc/video.cpp, built with g++ beside
     the other builds) on the `mp4v` fixtures committed under
     tests/torch_port_data/ (FFmpeg's default `mpeg4` encode: I- and
     P-VOPs, half-pel vectors, a size that is no multiple of 16): every byte
     within MP4_MAX_LEVELS of the PNG strip stored beside each, OpenCV's
     decode of it (this machine has no OpenCV), MP4_MEAN_LEVELS on average;
     decode seconds and frames a second printed; since the H.264 slice also
     the port's H.264 decoder (csrc/h264.h, in the same library) on the
     three H.264 fixtures (H264_FIXTURES: CABAC with a B-pyramid, CAVLC with
     temporal direct and long-term references cropped to 200x120,
     Constrained Baseline in avc3), held the same way (every byte equal on
     the CPU), their frames a second printed beside the card's name and
     power limit;
  22. after phase 13, on phase 11's files: `utils.video.export_mp4` writes
     navigated.mp4 and original.mp4 (1024x576, 25 frames) for two pairs,
     `run_unified`'s last segment against its episode frames and
     `run_single_segment`'s clip against its GT; the port's decode of each
     file within ENCODE_LUMA_MAE of the frames written; then, with TF32
     switched on, `cli.calculate_scores.main` on the card with metric nets
     made sensitive to the frames it scores (so that FVD runs): every score
     finite, the feature scores above EVAL_FEATURE_FLOOR, no flash launch;
     the encode, decode, resize and per-metric seconds printed. Files of
     each clip's last SCORES_CPU_FRAMES frames are scored by `main` on the
     card and by `main(..., device="cpu")`, held to each other within
     phase 13's tolerances (the CPU's FVD over the 25-frame files' 16 clip
     lengths would take twice the phase's budget).
The fp32 card-against-CPU checks (4, 7, 9) build on the CPU and move a copy to
the card, so that both sides hold the same weights.
For the run's time limit, the ranks of phases 18, 20 and 21 start during the
phase before theirs (`prestart`: imports, the card's context and the group
come up meanwhile), 19(a) and 19(b) run together, as do 20(a)'s two spawns and 20(b)'s
and 20(c)'s ranks, and finished checkpoints are deleted in a thread.
Every record's head goes to stderr after the run's seconds so far.
It prints, in order before the last line, the run's wall seconds, the card's
name and power limit, a JSON line of the kernels, and ends with the JSON line
{"ok": true, "device": {...}}. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import types

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak, fp16's too
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 tensor-core peak: the fp32 rows' bound
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bandwidth
# Kernel against plain version, error over the RMS of the plain output (about
# sqrt(e / kv_len) for these inputs). bf16 rounding of P and of the output sits
# near 0.03 max / 0.002 mean; leaving out one 32-key tile moves the output by
# about 0.05 mean, which DROPPED_KEYS checks the limits catch.
MAX_REL_ERR, MEAN_REL_ERR = 0.1, 0.01
# The same limits for the fp16 rows, which round to 3 more mantissa bits:
# fp16 reads 0.0022-0.0098 max / 0.00021-0.00023 mean where its bf16 twins
# read 0.018-0.070 / 0.0017-0.0018 on the same values (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md). An fp16 kernel that rounded anything to bf16
# would read bf16's mean, which each fp16 row checks its twin's errors fail.
FP16_MAX_REL_ERR, FP16_MEAN_REL_ERR = 0.02, 0.0006
# The same for the fp32 rows (csrc/flash_attn_fp32.cu: each product six bf16
# wgmma products over a three-part split of each operand; against the plain
# version in fp32 with TF32 off). Each fp32 row checks that its fp16 twin's
# errors fail them, so that an fp32 kernel that lost precision to a single
# TF32 pass (fp16's 10 mantissa bits) or to a bf16 one fails.
# Readings: 1.2e-5-5.4e-5 max and 4.9e-7-1.6e-6 mean over every fp32 row
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), part of it the plain version's
# own fp32 rounding; the max limit sits at twice the worst reading of the
# split-TF32 kernels these replaced (9.3e-5), and fp16 twins (2.2e-3-9.8e-3
# / 2.1e-4-2.3e-4) fail both limits ten times over.
FP32_MAX_REL_ERR, FP32_MEAN_REL_ERR = 2e-4, 1e-5
DROPPED_KEYS = 32
# Forward kernel's row log-sum-exp against the plain one (about 9.6 for 9216
# keys): fp32 accumulation order moves it by ~1e-5; dropping DROPPED_KEYS of
# kv_len keys moves it by about -log(1 - 32 / kv_len), 3.5e-3 or more here.
LSE_ATOL = 1e-3
# The fp32 kernels' log-sum-exp: fp32 sums and exp2 on both sides (readings
# up to 3.8e-6; a torch logsumexp of fp32 scores at a scale of 0.125 and D =
# 512, 1.3e-5).
FP32_LSE_ATOL = 1e-4
STEPS = 1  # denoise steps per full-width clip (production: 25), cut for the time limit (4 until phase 20 came)
SEED = 0
TRAIN_STEPS = 2  # full-width training steps, the first cold (3 until phase 21 came; cut for the time limit)
# Phase 16's training frames, tried in turn while the card runs out of
# memory: 22, the most that fit an H100's 79.2 GiB in fp32 (25, 24 and 23
# ran out of memory, 22 peaked at 74.3 GiB; NVIDIA H100 80GB HBM3, PERF.md),
# then PERF.md §2's cut of 14. The configuration's 25 is not tried: it ran
# out of memory in every run and cost ~28 s of the time limit doing so.
FP32_TRAIN_FRAMES = (22, 14)
# Kernel route against the plain route through a whole level-0 block, and
# the card against the CPU for a tiny fp32 step: relative RMS error limits
# (||a - b|| / ||b|| per tensor). The two bf16 routes round P, dS and the
# attention output at different places (about 1% of a gradient's RMS); a
# gradient that missed the attention would be off by 100%.
BLOCK_REL_RMS = 0.05
# The forward's kernel by head dim, as named in a profiler trace: the wgmma
# kernel at D = 64/128, the wide kernel (D split across the consumers) at D = 512.
FWD_KERNELS = {64: "flash_fwd_wgmma", 128: "flash_fwd_wgmma", 512: "flash_fwd_wide"}
# The backward's kernels by head dim, as named in a profiler trace: the fused
# wgmma pass between its two small passes, or three wgmma sweeps.
BWD_DESIGNS = {
    64: ("fused wgmma pass", ("flash_bwd_fused", "flash_bwd_store_dq", "flash_bwd_delta")),
    128: ("fused wgmma pass, K and V read from shared memory, dQ split by columns between the consumers",
          ("flash_bwd_fused", "flash_bwd_store_dq", "flash_bwd_delta")),
    512: ("wgmma dV, dK and dQ sweeps, D split across the consumers, which swap partial scores",
          ("flash_bwd_wide_dv", "flash_bwd_wide_dk", "flash_bwd_wide_dq", "flash_bwd_delta")),
}
# The D = 512 mma.sync pair that the sweeps replaced: a trace must not hold it.
RETIRED_BWD_KERNELS = ("flash_bwd_dkdv", "flash_bwd_dq")
# The fp32 kernels (csrc/flash_attn_fp32.cu), one design at every head dim,
# and the entries phase 2 must find in ptxas's report of that source.
FP32_FWD_KERNEL = "flash_fp32_fwd"
FP32_BWD_DESIGN = ("wgmma on a three-part bf16 split: delta, a dK/dV sweep over query tiles (dV and dK from "
                   "separate blocks at D = 512), a dQ sweep over key tiles",
                   ("flash_fp32_bwd_delta", "flash_fp32_bwd_dkdv", "flash_fp32_bwd_dq"))
FP32_ENTRIES = tuple((name, d) for name in (FP32_FWD_KERNEL, *FP32_BWD_DESIGN[1]) for d in (64, 128, 512))
# The fp32 kernels redesigned on wgmma: phase 2 holds every entry of each to
# HGMMA instructions and no HMMA (mma.sync) in the library's SASS.
FP32_WGMMA_KERNELS = (FP32_FWD_KERNEL, "flash_fp32_bwd_dkdv", "flash_fp32_bwd_dq")
# Every kernel a backward call may launch, or once did: a row's trace must
# hold its design's kernels and none of the others.
BWD_KERNELS = tuple(sorted({n for _, names in BWD_DESIGNS.values() for n in names} | set(RETIRED_BWD_KERNELS)
                           | set(FP32_BWD_DESIGN[1])))
# Two calls of a design that adds dQ's fp32 terms across blocks (the fused
# pass, whose dQ then goes through flash_bwd_store_dq) add them in another
# order, which can move a sum across a bf16 rounding boundary: one bf16 step
# (2^-7 of the value), beside 1e-4 of dQ's RMS for sums that nearly cancel.
# Every other design repeats dQ exactly.
DQ_REPEAT_RTOL, DQ_REPEAT_RMS_ATOL = 2.0 ** -7, 1e-4
DQ_SUMMED_DIMS = tuple(d for d, (_, names) in BWD_DESIGNS.items() if "flash_bwd_store_dq" in names)
# The lines the backward is held to in PERF.md, in ms on an H100 at its full
# power limit, FULL_POWER_W: asserted there, only printed on a card set below
# it (which runs slower under load).
BWD_MS_LINES = {"unet_l0_train": 19.5, "ragged_padded_kv": 0.95, "head_dim_128": 1.45,
                "vae_mid_d512": 21.0, "vae_mid_d512_b2": 6.5}
# The same for the D = 512 forward at the VAE's three shapes.
FWD_MS_LINES = {"vae_encoder_mid": 1.7, "vae_encoder_mid_train": 5.0, "vae_decoder_mid": 3.3}
FULL_POWER_W = 700.0
# The kernels' element types, by the name each row and report uses, and the
# name of each in the kernels' demangled (profiler) and mangled (ptxas) names.
# fp32's kernels are not templated over the type: their names carry the
# family's prefix instead, and ptxas's twin check leaves them out.
ELEM_TYPES = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}
TRACE_TYPE_NAMES = {"bf16": "__nv_bfloat16", "fp16": "__half", "fp32": "flash_fp32_"}
PTXAS_TYPE_NAMES = {"bf16": "13__nv_bfloat16", "fp16": "6__half"}
# The phase-3 and phase-3b rows repeated in fp16 (labels with "_fp16"): the
# main path's shapes. On a card at FULL_POWER_W each fp16 row must keep
# within TWIN_MS_RATIO of its bf16 twin's ms in the same run (the same
# kernels at the same tensor-core rate; a serialized wgmma or another
# schedule would cost more).
FP16_FWD_TWINS = ("unet_l0_spatial", "unet_l0_train_lse", "vae_encoder_mid", "vae_encoder_mid_train",
                  "vae_decoder_mid", "ragged_padded_kv", "ragged_padded_kv_exp2", "vggt_global_49", "vggt_global_73",
                  "head_dim_128_fwd")
FP16_BWD_TWINS = ("unet_l0_train", "head_dim_128", "vae_mid_d512", "ragged_padded_kv", "ragged_d128", "ragged_d512")
TWIN_MS_RATIO = 1.10
# The rows repeated in fp32 (labels with "_fp32", right after the fp16 twin
# on the same values): the main path's shapes, under fp32's own limits, which
# their fp16 twin's errors must fail. Their bound is the TF32 rate's; a
# design of six bf16 products a product at twice that rate (as long as three
# TF32 products) cannot beat three times it.
FP32_FWD_TWINS = ("unet_l0_spatial", "unet_l0_train_lse", "vae_encoder_mid", "vae_encoder_mid_train",
                  "vae_decoder_mid", "ragged_padded_kv", "ragged_padded_kv_exp2", "vggt_global_73", "head_dim_128_fwd")
FP32_BWD_TWINS = ("unet_l0_train", "head_dim_128", "vae_mid_d512", "ragged_padded_kv", "ragged_d128", "ragged_d512")
# JPEGs with PIL's decode of each stored beside it as a PNG
# (tests/torch_port_data/make_jpeg_fixtures.py).
JPEG_FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_port_data")
JPEG_FIXTURES = ("baseline_420", "restart_422", "progressive_420", "grey")
# Phase 2c: `mp4v` files with OpenCV's decode of each stored beside it as a PNG
# strip (tests/torch_port_data/make_mp4_fixtures.py), held to the CPU test's
# limits (tests/test_torch_port_video.py): every byte within MP4_MAX_LEVELS,
# the mean under MP4_MEAN_LEVELS. The decoder works in FFmpeg's arithmetic
# and meets them with every byte equal on the CPU.
MP4_FIXTURES = {"mp4v_64": (14, 64, 64), "mp4v_200x120": (26, 120, 200)}  # name -> (frames, height, width)
# ... and the H.264 ones (tests/torch_port_data/make_h264_fixtures.py).
H264_FIXTURES = {"h264_cabac_64": (17, 64, 64), "h264_cavlc_200x120": (26, 120, 200), "h264_baseline_64": (12, 64, 64)}
MP4_MAX_LEVELS, MP4_MEAN_LEVELS = 2, 0.5
# Phase 22: the port's decode of a file `export_mp4` wrote, against the
# frames written, as the mean absolute error of their BT.601 luma (4:2:0
# halves the chroma each way, whose error the content sets). Intra-only at
# a quantiser of 2 (a DCT step of 4): 1.0 on flat frames, 1.33 on noise,
# 1.36 on noisy smooth fields at 1024x576 (the CPU).
ENCODE_LUMA_MAE = 1.5
SCORES_FPS = 10  # export_mp4's default
# Phase 22 holds the card to `calculate_scores.main(..., device="cpu")` on
# files of each clip's last SCORES_CPU_FRAMES frames (phase 13's cut, the
# fewest that score FVD): on the 25-frame files FVD runs at 16 clip lengths,
# which took 39.9 s on the card machine's CPU (I3D at 224 px), twice the
# phase's budget, and 651 s on 4 threads beside phases 14-21, which it
# slowed (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
SCORES_CPU_FRAMES = 10
FILL_MS = 20.0  # a timing repeats a call until about this much device time has passed
TRACE_TRIES = 3  # profiler traces of a row before it is timed by events (its launch count checked)
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-4, 1e-5  # a tenth of one update at lr 1e-4
# The tiny loop on the card against the CPU, the CPU parity test's tolerances
# (tests/test_torch_port_loop.py): frames atol 2e-3; at most 0.5% of memory
# pixels may differ by more than 2e-3 (a splatted point near a pixel edge may
# land in the neighbouring pixel under fp32 noise).
SMALL_LOOP = dict(num_segments=3, num_frames=5, num_target_view=4, pers_height=16, pers_width=512)
LOOP_FRAME_ATOL, LOOP_PIXEL_ATOL, LOOP_MAX_FLIPPED = 2e-3, 2e-3, 0.005
# Phase 13, the harness on the card (TF32 switched on by the caller, off
# inside the harness) against the CPU, per timestamp: FVD, LPIPS and the
# latent MSEs relative to the CPU's value. Both sides compute in fp32 and
# sum in other orders: the sensitive nets' metrics agree within 1e-6
# relative, while with the harness's guard made to do nothing (the phase's
# `unguarded_worst_rel_err`) FVD and the latent MSE miss by 2.9e-4 and
# 9.6e-4 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), so EVAL_FEATURE_RTOL
# sits between them. DreamSim's cosine distance of fp32 embeddings: absolute, as in the
# CPU parity test. The metric nets are random ones made sensitive to the
# frames they score (`sensitive_metric_weights`); each feature metric and
# DreamSim score must come out above EVAL_FEATURE_FLOOR, so that nets whose
# output ignores their input fail.
EVAL_FEATURE_RTOL = 1e-4
EVAL_FEATURE_FLOOR = 1e-3
DREAMSIM_ATOL = 1e-4
# Phase 14, card against CPU. The sky masks (0 on sky, 255 elsewhere) of the
# U^2-Net in fp32: a min-max normalized value near 1 can floor either way
# (the CPU parity test's limit, tests/test_torch_port_skyseg.py). The
# cubemap panoramas: nearest texels picked after fp32 trigonometry, which
# can fall on either side of a face seam or texel edge (the CPU parity
# test's share, tests/test_torch_port_cubemap.py).
PREP_MASK_MAX_FLIPPED = 0.01
CUBE_MAX_FLIPPED = 1e-3
CUBE_FACE = 1024  # a capture's face size
CUBE_PANO = (1000, 2000)  # the panoramas' size, the upstream converter's
# Phase 17 exports the first this many points of phase 10's cloud (of its ~2.5
# million; cut for the run's time limit: 2^20 once phase 20 came, 2^18 once
# phase 21 came).
EXPORT_POINTS = 1 << 18
# Phase 19: two ranks sharing the card. Renders of reproject at W = 2 against
# one process: at most this many levels of 255 apart, and at least this share
# equal (bit for bit is predicted). The data-parallel training step: frames a
# rank (the full step peaks at 63.4 GB alone: two ranks of 25 frames cannot
# share 80 GB), and step 2 against the one-process step at batch 2 from the
# same step-1 state (bf16 GEMMs at batch 1 against 2 round apart; a rank's
# gradient left out of the mean moves the first moments by a large share of
# their size and the masters by up to 2 lr in a quarter or more of them).
MESH_RENDER_ATOL, MESH_RENDER_EQUAL = 1, 0.999
MESH_TRAIN_FRAMES = 2  # 8 before phase 20 came, 4 before phase 21; cut for the run's time limit
MESH_TRAIN_RTOL, MESH_TRAIN_WITHIN_LR, MESH_TRAIN_MU_RMS = 1e-2, 0.95, 0.1
# Phase 20: the routes' gradients at VGGT's global attention over 25 frames,
# 26,025 tokens (head-sharded at W = 2, the ring at W = 3; 49 frames, 51,009
# tokens, until phase 21 came: cut for the run's time limit); the
# frame-sharded step's frames (25, the reference's, until phase 21 came: two
# ranks fit it at 32.96-34.90 GB, PERF.md; cut to 9 for the time limit, where
# its ranks, the tensor-parallel step's and one process's step fit on the
# card together and run at once); the tensor-parallel step's frames (cut for
# the time limit: at 8 frames, 19(b)'s cut, a step took 81.6 s a rank, every
# split layer's output gathered through host memory on gloo; 23.2-23.8 s at 2).
ROUTE_GRAD_SHAPE = (1, 26025, 16, 64)
FRAME_STEP_FRAMES = 9
TP_STEP_FRAMES = 1
# Phase 18(c)'s episode at W = 2: `LoopConfig()`'s 3 segments cut to 2 (one
# rebuild) once phase 20 came and to 1 (no rebuild; phase 19(a) runs VGGT
# and the render on the ranks at full width, 18(b) the hand-off between
# segments) once phase 21 came, for the run's time limit.
MESH_EPISODE_SEGMENTS = 1
# Phase 21's rank counts, tried in turn while the ranks run the card out of
# memory: four ranks share its 80 GB, else three.
FRAME_CLIP_RANKS = (4, 3)


_LOG_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of the record on stdout; its head on stderr after the run's
    seconds so far, the timeline of every phase."""
    print(msg, flush=True)
    print(f"[{time.perf_counter() - _LOG_T0:8.1f} s] {msg[:100]}", file=sys.stderr, flush=True)


_REMOVALS: list = []


def remove_later(path: str) -> None:
    """Remove the directory `path` in a thread while the next phases run
    (deleting a full-width checkpoint takes seconds): renamed at once, so
    that its name is free, then deleted; `wait_removals` joins the threads."""
    import shutil
    import threading

    trash = f"{path}.removing"
    os.rename(path, trash)
    thread = threading.Thread(target=shutil.rmtree, args=(trash,), name=f"remove {trash}")
    thread.start()
    _REMOVALS.append(thread)


def wait_removals() -> None:
    """Wait for every `remove_later` thread."""
    while _REMOVALS:
        _REMOVALS.pop().join()


def plain_call(fn) -> tuple:
    """(`fn()`, the device milliseconds of a call of it): a plain version's
    reference output and its time, the first call's where it fills FILL_MS
    (a slow call's time is its own, not its warm-up's), else `cuda_ms` of
    one call after it."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    return out, ms if ms >= FILL_MS else cuda_ms(fn, reps=1)


def cuda_ms(fn, reps: int | None) -> float:
    """Mean device milliseconds of `fn` over `reps` launches, after one warm-up;
    with `reps` None, over as many launches as fill FILL_MS (at least 3), or
    the one call that sized them where it filled FILL_MS alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if reps is None:
        start.record()
        fn()
        end.record()
        end.synchronize()
        if start.elapsed_time(end) >= FILL_MS:
            return start.elapsed_time(end)
        reps = max(3, math.ceil(FILL_MS / max(start.elapsed_time(end), 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def errors(out, ref) -> dict:
    """Absolute errors of `out` against `ref`, and the same over the RMS of `ref`."""
    err = (out.float() - ref).abs()
    rms = ref.pow(2).mean().sqrt()
    return dict(max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
                max_rel_err=(err.max() / rms).item(), mean_rel_err=(err.mean() / rms).item())


def within_limits(e: dict, elem: str = "bf16") -> bool:
    """Whether the errors `e` keep to the limits of element type `elem`."""
    max_rel, mean_rel = {"fp16": (FP16_MAX_REL_ERR, FP16_MEAN_REL_ERR),
                         "fp32": (FP32_MAX_REL_ERR, FP32_MEAN_REL_ERR)}.get(elem, (MAX_REL_ERR, MEAN_REL_ERR))
    return e["max_rel_err"] <= max_rel and e["mean_rel_err"] <= mean_rel


def lse_limit(elem: str) -> float:
    """The log-sum-exp's limit for element type `elem`."""
    return FP32_LSE_ATOL if elem == "fp32" else LSE_ATOL


def row_bound(flops: float, nbytes: float, elem: str) -> dict:
    """A row's bound: flops over the tensor cores' dense rate for its type
    (TF32's for fp32), bytes over HBM's; fp32 rows also get three times the
    operations' time, what six bf16 products a product (three TF32 ones'
    tensor-core time) need."""
    ops_ms = flops / (PEAK_TF32_FLOPS if elem == "fp32" else PEAK_BF16_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                split_bound_ms=3 * ops_ms if elem == "fp32" else None)


def check_flash_kernel(dev, power_limit_w: float) -> dict:
    """Flash kernel against flash_attention_plain (fp32 on the same bf16 inputs;
    the FP16_FWD_TWINS rows again in fp16, on the same values cast to fp16,
    and the FP32_FWD_TWINS rows in fp32 on the same draws, through
    `flash_fp32_fwd`).

    The padded case gives the kernel keys and values past `kv_len` that would
    swamp the output if the mask missed them (K = 10, V = 100). Each case also
    checks that the limits catch a wrong result: the plain version without
    the last DROPPED_KEYS keys must fail them. An fp16 row is held to fp16's
    limits, which its bf16 twin's errors must fail; an fp32 row to fp32's,
    which its fp16 twin's errors must fail. The training row also writes
    the log-sum-exp, held against the plain one within LSE_ATOL. A profiler
    trace names the kernel that served each row, which must be FWD_KERNELS'
    for its head dim (padded to the kernel's), or FP32_FWD_KERNEL in fp32;
    with the card at FULL_POWER_W
    the D = 512 rows must keep to FWD_MS_LINES and each fp16 row within
    TWIN_MS_RATIO of its bf16 twin. The trace must also show the row's
    element type in every kernel it names. Bound and rate count the work at
    the true head dim.
    """
    import torch
    import torch.nn.functional as F

    from evoworld_tpu_torch.ops.flash_attention import (
        _plain_forward,
        flash_attention,
        flash_attention_forward,
        kernel_head_dim,
    )

    cases = [  # (label, B, Sq, Skv, H, D, kv_len, use_exp2, with_lse)
        ("unet_l0_spatial", 50, 9216, 9216, 5, 64, 9216, False, False),
        # the training step's level-0 attention (batch 1 x 25 frames), with the LSE the backward reads
        ("unet_l0_train_lse", 25, 9216, 9216, 5, 64, 9216, False, True),
        ("vae_encoder_mid", 2, 9216, 9216, 1, 512, 9216, False, False),
        ("vae_encoder_mid_train", 8, 9216, 9216, 1, 512, 9216, False, False),  # training encodes in chunks of 8
        ("vae_decoder_mid", 5, 9216, 9216, 1, 512, 9216, False, False),
        # VGGT's global attention over 5 frames x 1041 tokens, keys padded to
        # K1's 512-key block multiple and masked past the real length
        ("ragged_padded_kv", 1, 5205, 5632, 16, 64, 5205, False, False),
        ("ragged_padded_kv_exp2", 1, 5205, 5632, 16, 64, 5205, True, False),
        # UNet level-1 attention (plain torch on the main path), the shape of
        # scripts/exp_l1_attn.py's shipped-flash experiment
        ("unet_l1_spatial", 50, 2304, 2304, 10, 64, 2304, False, False),
        # VGGT's global attention at the loop's two rebuilds, 25 and 49 frames x
        # 1041 tokens: no tile divides either length (51009 = 398 x 128 + 65)
        ("vggt_global_25", 1, 26025, 26025, 16, 64, 26025, False, False),
        ("vggt_global_49", 1, 51009, 51009, 16, 64, 51009, False, False),
        # reproject's VGGT over a 97-frame episode's 73 source frames (75993 = 593 x 128 + 89)
        ("vggt_global_73", 1, 75993, 75993, 16, 64, 75993, False, False),
        # VGGT's frame attention over 25 frames of 1041 tokens (plain torch on the main path, under
        # FLASH_MIN_SEQ), the shape of scripts/exp_vggt_attn.py's shipped-flash experiment
        ("vggt_frame_25", 25, 1041, 1041, 16, 64, 1041, False, False),
        # a head dim without a kernel (the tiny presets' 16), zero-padded to 64
        ("padded_d16", 2, 9216, 9216, 2, 16, 9216, False, False),
        # head dim 128 at the backward's D = 128 row's shape
        ("head_dim_128_fwd", 2, 9216, 9216, 2, 128, 9216, False, False),
        # the UNet level-0 attention of the first rank of a frame-split clip (both
        # guidance halves of its frames): 13 frames at W = 2, 7 at W = 4 (phases 18(c)'s episode, 21)
        ("unet_l0_spatial_w2", 26, 9216, 9216, 5, 64, 9216, False, False),
        ("unet_l0_spatial_w4", 14, 9216, 9216, 5, 64, 9216, False, False),
    ]
    shapes = []
    for i, (label, b, sq, skv, h, d, kv_len, use_exp2, with_lse), elem in twin_runs(cases, FP16_FWD_TWINS,
                                                                                   FP32_FWD_TWINS):
        scale = d ** -0.5
        dtype = getattr(torch, ELEM_TYPES[elem])
        g = torch.Generator(device=dev).manual_seed(1234 + i)  # a twin draws its bf16 row's values
        q = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((b, skv, h, d), generator=g, device=dev).to(dtype) for _ in range(2))
        k[:, kv_len:], v[:, kv_len:] = 10.0, 100.0

        def run():
            return flash_attention_forward(q, k, v, scale, kv_len, use_exp2, with_lse=with_lse)

        out, lse = run()
        torch.cuda.synchronize()
        qf, kf, vf = q.float(), k.float(), v.float()
        (ref, ref_lse), plain_ms = plain_call(lambda: _plain_forward(qf, kf, vf, scale, kv_len, use_exp2))
        err = errors(out, ref)
        cut = errors(_plain_forward(qf, kf, vf, scale, kv_len - DROPPED_KEYS, use_exp2)[0], ref)
        lse_err = (lse - ref_lse).abs().max().item() if with_lse else None
        del ref
        # the function's work at its true head dim (a padded row does d_kernel / d times as much)
        flops = 4 * b * h * sq * kv_len * d
        nbytes = (2 * sq + 2 * kv_len) * b * h * d * q.element_size() + (b * h * sq * 4 if with_lse else 0)
        d_kernel = kernel_head_dim(d)
        served_by = FP32_FWD_KERNEL if elem == "fp32" else FWD_KERNELS[d_kernel]
        bound = row_bound(flops, nbytes, elem)
        ms = cuda_ms(run, reps=None)
        wide_lse = None
        if d_kernel == 512 and not with_lse:  # the same call asking for the LSE the D = 512 backward reads

            def run_lse():
                return flash_attention_forward(q, k, v, scale, kv_len, use_exp2, with_lse=True)

            lse512 = run_lse()[1]
            wide_lse = dict(ms=cuda_ms(run_lse, reps=None), lse_max_abs_err=(lse512 - ref_lse).abs().max().item(),
                            dropped_keys_lse_err=(_plain_forward(qf, kf, vf, scale, kv_len - DROPPED_KEYS, use_exp2)[1]
                                                  - ref_lse).abs().max().item())
            del lse512
        traced, traced_types, timed_by = kernel_ms_from_trace(
            run, sorted({*FWD_KERNELS.values(), FP32_FWD_KERNEL}), served=(served_by,), elem=elem,
            counter=flash_attention)
        served = [n for n, t in traced.items() if t is None or t > 0]  # None: launched, timed by events
        qt, kt, vt = q.transpose(1, 2), k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=None)
        ms_line = FWD_MS_LINES.get(label)
        row = dict(label=label, dtype=elem, shape=[b, sq, h, d], skv=skv, kv_len=kv_len, use_exp2=use_exp2,
                   with_lse=with_lse, kernel=served, kernel_types=traced_types, timed_by=timed_by,
                   kernel_ms=traced[served_by], d_kernel=d_kernel, **err,
                   lse_max_abs_err=lse_err, dropped_keys_rel_err=[cut["max_rel_err"], cut["mean_rel_err"]],
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound,
                   tflops=flops / ms / 1e9, bound_share=bound["bound_ms"] / ms, at_most_library=ms <= library_ms,
                   ms_line=ms_line, within_ms_line=ms <= (ms_line or math.inf), with_lse_run=wide_lse)
        add_twin_ratio(row, shapes)
        del ref_lse
        log("kernel flash_attn_fwd " + json.dumps(row))
        if served != [served_by] or traced_types != [elem]:
            raise AssertionError(f"{label} ran {served} in {traced_types}, expected {served_by} in {elem}")
        if power_limit_w >= FULL_POWER_W and not row["within_ms_line"]:
            raise AssertionError(f"forward kernel took {ms:.3f} ms at {label}, over its line of {ms_line} ms")
        if power_limit_w >= FULL_POWER_W and elem == "fp16" and row["twin_ratio"] > TWIN_MS_RATIO:
            raise AssertionError(f"{label} took {ms:.3f} ms, over {TWIN_MS_RATIO} x its bf16 twin's {row['twin_ms']:.3f}")
        if not within_limits(err, elem):
            raise AssertionError(f"flash kernel disagrees with its plain version at {label}: {err}")
        if within_limits(cut, elem):
            raise AssertionError(f"the limits do not catch {DROPPED_KEYS} dropped keys at {label}: {cut}")
        twin = twin_of(row, shapes)
        if twin and within_limits(twin, elem):
            raise AssertionError(f"the {elem} limits do not catch its {twin['dtype']} twin's rounding at {label}")
        if with_lse and not lse_err <= lse_limit(elem):
            raise AssertionError(f"forward kernel's log-sum-exp off by {lse_err} at {label} (limit {lse_limit(elem)})")
        if wide_lse and not (wide_lse["lse_max_abs_err"] <= lse_limit(elem) < wide_lse["dropped_keys_lse_err"]):
            raise AssertionError(f"the wide kernel's log-sum-exp at {label}: {wide_lse} (limit {lse_limit(elem)})")
        shapes.append(row)
        del q, k, v, qf, kf, vf, out, lse
        torch.cuda.empty_cache()
    return {"shapes": shapes}


def check_jpeg_fixtures() -> list[dict]:
    """Phase 2b: each committed JPEG fixture decoded by the port against the
    PNG of PIL's decode stored beside it (read by the port's PNG decoder,
    which the CPU tests hold to PIL's bytes), byte for byte."""
    import numpy as np

    from evoworld_tpu_torch.data import native_io

    rows = []
    for name in JPEG_FIXTURES:
        jpg, png = (os.path.join(JPEG_FIXTURE_DIR, f"{name}.{ext}") for ext in ("jpg", "png"))
        height, width = native_io.image_size(png)
        want = native_io.load_image_batch([png], height, width, minus1_1=False, n_threads=1)
        t0 = time.perf_counter()
        got = native_io.load_image_batch([jpg], height, width, minus1_1=False, n_threads=1)
        seconds = time.perf_counter() - t0
        differing = int((got != want).any(axis=-1).sum())
        rows.append(dict(name=name, height=height, width=width, differing_pixels=differing,
                         max_abs_diff_255=float(np.abs(got - want).max() * 255), decode_s=seconds))
    log("jpeg fixtures " + json.dumps(rows))
    bad = [r for r in rows if r["differing_pixels"]]
    if bad:
        raise AssertionError(f"the port's JPEG decode differs from libjpeg's: {bad}")
    return rows


def check_mp4_fixtures(fixtures: dict = MP4_FIXTURES) -> list[dict]:
    """Phase 2c: each committed `mp4v` fixture (or H.264 one, with
    H264_FIXTURES) decoded by the port against the PNG strip of OpenCV's
    decode stored beside it (read by the port's PNG decoder), within
    MP4_MAX_LEVELS a byte and MP4_MEAN_LEVELS on average; the decode timed."""
    import numpy as np

    from evoworld_tpu_torch.data import native_io, native_video

    rows = []
    for name, (frames, height, width) in fixtures.items():
        mp4, png = (os.path.join(JPEG_FIXTURE_DIR, f"{name}.{ext}") for ext in ("mp4", "png"))
        strip = native_io.load_image_batch([png], frames * height, width, minus1_1=False, n_threads=1)[0]
        want = np.rint(strip * 255).astype(np.int16).reshape(frames, height, width, 3)
        t0 = time.perf_counter()
        got = native_video.read_mp4(mp4)
        seconds = time.perf_counter() - t0
        row = dict(name=name, shape=list(got.shape), decode_s=seconds, frames_per_s=len(got) / seconds)
        if got.shape == want.shape:
            err = np.abs(got.astype(np.int16) - want)
            row.update(max_abs_diff=int(err.max()), mean_abs_diff=float(err.mean()),
                       differing_bytes=int((err > 0).sum()))
        rows.append(row)
    log("mp4 fixtures " + json.dumps(rows))
    bad = [r for r, want in zip(rows, fixtures.values())
           if r["shape"] != [*want, 3] or r["max_abs_diff"] > MP4_MAX_LEVELS or r["mean_abs_diff"] >= MP4_MEAN_LEVELS]
    if bad:
        raise AssertionError(f"the port's video decode differs from OpenCV's: {bad}")
    return rows


def ptxas_report(log_text: str) -> list[dict]:
    """Registers and spill bytes of each kernel entry in an nvcc -Xptxas -v log,
    and ptxas's warning where it serialized an entry's wgmma (printed before
    the entries, naming the function "in the function '...'" or, where
    registers ran short, "for the function '...'")."""
    rows, serialized = [], {}
    for line in log_text.splitlines():
        warned = re.search(r"wgmma.*serialized.*(?:in|for) the function '(\w+)'", line)
        if warned:
            serialized[warned.group(1)] = line.strip()
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            rows.append(dict(entry=entry.group(1)))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and rows:
            rows[-1].update(spill_stores=int(spill.group(1)), spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and rows:
            rows[-1]["registers"] = int(regs.group(1))
    for row in rows:
        if row["entry"] in serialized:
            row["wgmma_serialized"] = serialized[row["entry"]]
    return rows


def check_flash_backward(dev, power_limit_w: float) -> dict:
    """Forward-with-LSE and backward kernels against the plain chain on the same bf16 inputs
    (the FP16_BWD_TWINS rows again in fp16, on the same values cast to fp16,
    and the FP32_BWD_TWINS rows in fp32 on the same draws, through the fp32
    kernels of FP32_BWD_DESIGN).

    The reference is flash_attention_backward_plain (fp32) fed with the plain
    forward's own output and log-sum-exp. The kernel's log-sum-exp must be
    within LSE_ATOL of the plain one, which the plain one over DROPPED_KEYS
    fewer keys must miss. dQ, dK and dV each within the RMS-relative limits
    at the training shape, a D = 128 shape, the VAE's D = 512 shapes and three
    ragged rows (keys past `kv_len` set to K = 10, V = 100, whose dK and dV
    rows must be exactly zero); the plain backward without the last
    DROPPED_KEYS keys must fail them (an fp16 row: fp16's limits, which each
    gradient of its bf16 twin must fail; an fp32 row: fp32's, which each
    gradient of its fp16 twin must fail). A second call must repeat dK and dV
    exactly and dQ within DQ_REPEAT_RTOL (exactly at D = 512 and in fp32:
    those kernels sum nothing across blocks), and the trace must hold every
    kernel of the row's design and no other backward kernel. With the card at FULL_POWER_W
    the rows named in BWD_MS_LINES must also keep to their lines, and each
    fp16 row within TWIN_MS_RATIO of its bf16 twin. Times: the whole
    call with CUDA events (the zeroing of the dQ buffer included), each of
    its kernels apart from a profiler trace, the plain version, and as a
    yardstick only `scaled_dot_product_attention` forward + backward less
    its forward.
    """
    import torch
    import torch.nn.functional as F

    from evoworld_tpu_torch.ops.flash_attention import (
        _plain_forward,
        flash_attention_backward,
        flash_attention_backward_plain,
        flash_attention_forward,
    )

    cases = [  # (label, B, Sq, Skv, H, D, kv_len)
        ("unet_l0_train", 25, 9216, 9216, 5, 64, 9216),
        ("head_dim_128", 2, 9216, 9216, 2, 128, 9216),
        ("ragged_padded_kv", 1, 5205, 5632, 16, 64, 5205),
        ("ragged_d128", 1, 5205, 5632, 16, 128, 5205),
        # the VAE's mid-block attention at the training encoder's chunk of 8
        # and at the clip's encode of 2, and a length no tile divides
        ("vae_mid_d512", 8, 9216, 9216, 1, 512, 9216),
        ("vae_mid_d512_b2", 2, 9216, 9216, 1, 512, 9216),
        ("ragged_d512", 1, 5205, 5632, 1, 512, 5205),
    ]
    shapes = []
    for i, (label, b, sq, skv, h, d, kv_len), elem in twin_runs(cases, FP16_BWD_TWINS, FP32_BWD_TWINS):
        scale = d ** -0.5
        dtype = getattr(torch, ELEM_TYPES[elem])
        g = torch.Generator(device=dev).manual_seed(4321 + i)  # a twin draws its bf16 row's values
        q = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((b, skv, h, d), generator=g, device=dev).to(dtype) for _ in range(2))
        k[:, kv_len:], v[:, kv_len:] = 10.0, 100.0
        out, lse = flash_attention_forward(q, k, v, scale, kv_len, with_lse=True)
        do = torch.randn(out.shape, generator=g, device=dev).to(dtype)
        grads = flash_attention_backward(q, k, v, out, do, lse, scale, kv_len)
        again = flash_attention_backward(q, k, v, out, do, lse, scale, kv_len)
        torch.cuda.synchronize()
        dq_gap = (again[0].float() - grads[0].float()).abs()
        dq_rms = grads[0].float().pow(2).mean().sqrt()
        repeat = dict(dkdv_equal=torch.equal(again[1], grads[1]) and torch.equal(again[2], grads[2]),
                      dq_equal=torch.equal(again[0], grads[0]), dq_max_abs_gap=dq_gap.max().item(),
                      dq_ok=bool((dq_gap <= DQ_REPEAT_RTOL * grads[0].float().abs() + DQ_REPEAT_RMS_ATOL * dq_rms).all()))
        del again, dq_gap
        # The reference chain is plain end to end: the plain forward's own
        # output and log-sum-exp on the same bf16 inputs feed the plain backward.
        ref_out, ref_lse = _plain_forward(q, k, v, scale, kv_len, False)
        lse_err = (lse - ref_lse).abs().max().item()
        cut_lse_err = (_plain_forward(q, k, v, scale, kv_len - DROPPED_KEYS, False)[1] - ref_lse).abs().max().item()
        f32 = [t.float() for t in (q, k, v, ref_out, do)]
        del ref_out
        ref, plain_ms = plain_call(lambda: flash_attention_backward_plain(*f32, ref_lse, scale, kv_len))
        errs = {n: errors(a, r) for n, a, r in zip(("dq", "dk", "dv"), grads, ref)}
        cut = flash_attention_backward_plain(*f32, ref_lse, scale, kv_len - DROPPED_KEYS)
        cut_errs = {n: errors(a, r) for n, a, r in zip(("dq", "dk", "dv"), cut, ref)}
        del cut, ref
        masked_zero = not grads[1][:, kv_len:].any() and not grads[2][:, kv_len:].any()

        def bwd():
            flash_attention_backward(q, k, v, out, do, lse, scale, kv_len)

        ms = cuda_ms(bwd, reps=None)
        design, names = FP32_BWD_DESIGN if elem == "fp32" else BWD_DESIGNS[d]
        traced, traced_types, timed_by = kernel_ms_from_trace(bwd, BWD_KERNELS, served=names, elem=elem,
                                                              counter=flash_attention_backward)
        split = {n: traced[n] for n in names}
        strays = [n for n, t in traced.items() if n not in names and t > 0]
        del f32, ref_lse
        torch.cuda.empty_cache()
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k[:, :kv_len], v[:, :kv_len]))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qt, kt, vt).backward(dot)

        with torch.no_grad():
            sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=None)
        library_ms = cuda_ms(sdpa_fwd_bwd, reps=None) - sdpa_fwd_ms
        flops = 10 * b * h * sq * kv_len * d
        nbytes = (4 * sq + 4 * kv_len) * b * h * d * q.element_size() + 2 * b * h * sq * 4
        bound = row_bound(flops, nbytes, elem)
        row = dict(label=label, dtype=elem, shape=[b, sq, h, d], skv=skv, kv_len=kv_len, kernel_types=traced_types,
                   timed_by=timed_by,
                   **{f"{n}_{key}": e[key] for n, e in errs.items() for key in e},
                   max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                   lse_max_abs_err=lse_err, dropped_keys_lse_err=cut_lse_err,
                   dropped_keys_rel_err={n: [e["max_rel_err"], e["mean_rel_err"]] for n, e in cut_errs.items()},
                   masked_rows_zero=masked_zero, repeat=repeat, design=design, ms=ms, other_kernels=strays,
                   kernel_ms={n.removeprefix("flash_bwd_"): t for n, t in split.items()}, plain_ms=plain_ms,
                   library_ms=library_ms, library_fwd_ms=sdpa_fwd_ms, **bound,
                   tflops=flops / ms / 1e9, bound_share=bound["bound_ms"] / ms,
                   ms_line=BWD_MS_LINES.get(label), within_ms_line=ms <= BWD_MS_LINES.get(label, math.inf),
                   at_most_library=ms <= library_ms)
        add_twin_ratio(row, shapes)
        log("kernel flash_attn_bwd " + json.dumps(row))
        if not all(within_limits(e, elem) for e in errs.values()):
            raise AssertionError(f"backward kernel disagrees with its plain version at {label}: {errs}")
        if all(within_limits(e, elem) for e in cut_errs.values()):
            raise AssertionError(f"the limits do not catch {DROPPED_KEYS} dropped keys at {label}: {cut_errs}")
        twin = twin_of(row, shapes)
        if twin and any(within_limits({k: twin[f"{n}_{k}"] for k in ("max_rel_err", "mean_rel_err")}, elem) for n in errs):
            raise AssertionError(f"the {elem} limits do not catch its {twin['dtype']} twin's rounding in every "
                                 f"gradient at {label}")
        if not lse_err <= lse_limit(elem) or cut_lse_err <= lse_limit(elem):
            raise AssertionError(f"forward kernel's log-sum-exp off by {lse_err} at {label} (limit {lse_limit(elem)}, "
                                 f"{DROPPED_KEYS} dropped keys give {cut_lse_err})")
        if not masked_zero:
            raise AssertionError(f"dK/dV rows past kv_len are not zero at {label}")
        dq_summed = d in DQ_SUMMED_DIMS and elem != "fp32"
        if not (repeat["dkdv_equal"] and repeat["dq_ok"]) or (not dq_summed and not repeat["dq_equal"]):
            raise AssertionError(f"a second backward call differs from the first at {label}: {repeat}")
        if not all(t is None or t > 0 for t in split.values()) or strays or traced_types != [elem]:
            raise AssertionError(f"the trace at {label} lacks a kernel of {design} or holds another's, or another "
                                 f"type than {elem}: {traced} in {traced_types}")
        if power_limit_w >= FULL_POWER_W and not row["within_ms_line"]:
            raise AssertionError(f"backward kernel took {ms:.3f} ms at {label}, over its line of {row['ms_line']} ms")
        if power_limit_w >= FULL_POWER_W and elem == "fp16" and row["twin_ratio"] > TWIN_MS_RATIO:
            raise AssertionError(f"{label} took {ms:.3f} ms, over {TWIN_MS_RATIO} x its bf16 twin's {row['twin_ms']:.3f}")
        shapes.append(row)
        del q, k, v, out, lse, do, grads, qt, kt, vt, dot
        torch.cuda.empty_cache()
    return {"shapes": shapes}


def trace_elem_type(key: str) -> str | None:
    """The element type ("bf16", "fp16") of a kernel instantiation named in a
    profiler trace, or None where the name carries neither."""
    return next((t for t, name in TRACE_TYPE_NAMES.items() if name in key), None)


def kernel_ms_from_trace(fn, names, reps: int = 3, served=(), elem: str | None = None, counter=None,
                         tries: int = TRACE_TRIES, profiler=None, timer=None) -> tuple[dict, list, str]:
    """Mean device milliseconds per launch of each named kernel in `fn` (each
    is launched once a call), from a profiler trace, the element types of
    the instantiations that ran, and how the row was timed ("trace" or
    "events"). The mean is over the launches the trace recorded: on the card
    it has been seen to drop the records of some calls of a kernel that runs
    for hundreds of milliseconds, once every record of a row, and once every
    record of one of a backward call's kernels. A trace with no device time
    for `names`, or (given `served`) for one of the `served` kernels, is
    taken again, up to `tries` times in all; after that the call is run
    under CUDA events (`timer`, `cuda_ms`)
    and passes only if `counter` (the wrapper's launch count,
    `flash_attention` or `flash_attention_backward`) moved once for every
    call: a kernel that never launched fails the row either way. Such a row
    has no time per kernel (each kernel of `served` reads None, the row's
    `ms` being the call's), and its types are `elem`, the inputs'.
    `profiler` (a context-manager factory with `key_averages()`, default
    torch's CUDA profiler) and `timer` stand in for the card's off it."""
    import torch

    if profiler is None:
        from torch.profiler import ProfilerActivity, profile

        def profiler():
            return profile(activities=[ProfilerActivity.CUDA])
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    fn()
    sync()
    for attempt in range(tries):
        with profiler() as prof:
            for _ in range(reps):
                fn()
            sync()
        totals, counts = {n: 0.0 for n in names}, {n: 0 for n in names}
        types = set()
        for ev in prof.key_averages():
            for n in names:
                if n in ev.key:
                    totals[n] += getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
                    counts[n] += ev.count
                    types.add(trace_elem_type(ev.key))
        if all(totals[n] for n in served) if served else any(totals.values()):
            return {n: t / 1e3 / max(counts[n], 1) for n, t in totals.items()}, sorted(types, key=str), "trace"
        log(f"the profiler trace holds no device time for {served or names} (try {attempt + 1} of {tries})")
    if counter is None or not served:
        raise AssertionError(f"the profiler trace holds no device time for {names}, and no launch count to time by")
    calls = 0

    def counted():
        nonlocal calls
        calls += 1
        fn()

    before = counter.launches
    ms = (timer or cuda_ms)(counted, reps)
    moved = counter.launches - before
    if calls == 0 or moved != calls:
        raise AssertionError(f"the profiler trace holds no device time for {names}, and the launch count moved "
                             f"{moved} times in {calls} calls: {served} did not launch")
    log(f"{served} launched once in each of {calls} calls, {ms:.4f} ms a call by events")
    return {n: None if n in served else 0.0 for n in names}, [elem], "events"


def twin_runs(cases: list[tuple], twins: tuple, fp32_twins: tuple = ()) -> list[tuple]:
    """(index of the case, the case, element type) for every case in bf16,
    each case labelled in `twins` followed at once by its fp16 twin (label
    "<twin>_fp16"), so that the card's clocks move little between the two,
    and each labelled in `fp32_twins` then by its fp32 twin ("<twin>_fp32")."""
    runs = []
    for i, case in enumerate(cases):
        runs.append((i, case, "bf16"))
        if case[0] in twins:
            runs.append((i, (case[0] + "_fp16", *case[1:]), "fp16"))
        if case[0] in fp32_twins:
            runs.append((i, (case[0] + "_fp32", *case[1:]), "fp32"))
    return runs


# A twin row's partner: fp16 rows meet their bf16 row, fp32 rows their fp16 row.
TWIN_PARTNER = {"fp16": "bf16", "fp32": "fp16"}


def twin_of(row: dict, rows: list[dict]) -> dict | None:
    """The row among `rows` that a twin `row` (label "<twin>_fp16" or
    "<twin>_fp32") is held against: an fp16 row's bf16 row, an fp32 row's
    fp16 twin; None for a bf16 row or a twin without its partner."""
    partner = TWIN_PARTNER.get(row.get("dtype"))
    if partner is None or not row["label"].endswith("_" + row["dtype"]):
        return None
    base = row["label"].removesuffix("_" + row["dtype"])
    want = base if partner == "bf16" else f"{base}_{partner}"
    return next((r for r in rows if r["dtype"] == partner and r["label"] == want), None)


def add_twin_ratio(row: dict, rows: list[dict]) -> None:
    """A twin row (label "<twin>_fp16" or "<twin>_fp32") gets its partner's
    (`twin_of`) ms and the ratio of the two (`twin_ms`, `twin_ratio`); bf16
    rows get None."""
    twin = twin_of(row, rows)
    row["twin_ms"] = twin["ms"] if twin else None
    row["twin_ratio"] = row["ms"] / twin["ms"] if twin else None


def ptxas_twins(entries: list[dict]) -> list[dict]:
    """Each kernel entry of a ptxas report by its name with the element type
    left out: the registers of its bf16 and fp16 instantiations (None where
    one is missing)."""
    by_name: dict = {}
    for row in entries:
        elem = next((t for t, name in PTXAS_TYPE_NAMES.items() if name in row["entry"]), None)
        base = row["entry"].replace(PTXAS_TYPE_NAMES[elem], "T") if elem else row["entry"]
        by_name.setdefault(base, {t: None for t in PTXAS_TYPE_NAMES})[elem] = row.get("registers")
    return [dict(entry=base, registers=regs) for base, regs in by_name.items()]


def fp32_entries(entries: list[dict]) -> list[dict]:
    """Each kernel entry of FP32_ENTRIES (kernel, head dim) with the registers
    ptxas reports for it, None where the report lacks the entry."""
    rows = []
    for name, d in FP32_ENTRIES:
        row = next((r for r in entries if f"{len(name)}{name}ILi{d}E" in r["entry"]), {})
        rows.append(dict(kernel=name, d=d, registers=row.get("registers")))
    return rows


def fp32_sass_rows(sass: dict) -> list[dict]:
    """Each entry of FP32_ENTRIES with the count of its HGMMA (wgmma) and
    HMMA (mma.sync) instructions, from `compare_kernels.sass_entries` of the
    fp32 library ({(kernel, head dim, "fp32"): SASS lines}); None where the
    dump lacks the entry."""
    from evoworld_tpu_torch.compare_kernels import opcode

    rows = []
    for name, d in FP32_ENTRIES:
        lines = sass.get((name, d, "fp32"))
        ops = [opcode(line).split(".")[0] for line in lines] if lines is not None else None
        rows.append(dict(kernel=name, d=d, hgmma=ops.count("HGMMA") if ops is not None else None,
                         hmma=ops.count("HMMA") if ops is not None else None,
                         wgmma_design=name in FP32_WGMMA_KERNELS))
    return rows


def check_fp32_sass(rows: list[dict]) -> None:
    """Phase 2: every entry of FP32_WGMMA_KERNELS holds HGMMA and no HMMA
    (the redesign is what was built), each row logged first."""
    for row in rows:
        log("sass fp32 entry " + json.dumps(row))
    bad = [r for r in rows if r["wgmma_design"] and not (r["hgmma"] and r["hmma"] == 0)]
    if bad:
        raise AssertionError(f"an fp32 wgmma kernel's SASS lacks HGMMA or holds HMMA: {bad}")


def check_ptxas(source: str, entries: list[dict], fp32: bool = False) -> None:
    """Phase 2's checks of one source's ptxas report, each line logged first:
    no entry spills or serializes its wgmma; every entry of the bf16/fp16
    sources in both types (`ptxas_twins`); the fp32 source, whose kernels are
    not templated over the type and so have no twin, every entry of
    FP32_ENTRIES (`fp32_entries`)."""
    for row in entries:
        log(f"ptxas {source} " + json.dumps(row))
        if row.get("spill_stores") or row.get("spill_loads") or "wgmma_serialized" in row:
            raise AssertionError(f"{source}: a kernel entry spills or serializes its wgmma: {row}")
    if fp32:
        found = fp32_entries(entries)
        for row in found:
            log(f"ptxas fp32 entry {source} " + json.dumps(row))
        missing = [(r["kernel"], r["d"]) for r in found if r["registers"] is None]
        if missing:
            raise AssertionError(f"{source}: no ptxas entry for {missing}")
        return
    # every kernel entry in both element types, from the one templated source
    for twin in ptxas_twins(entries):
        log(f"ptxas twins {source} " + json.dumps(twin))
        if set(twin["registers"]) != set(PTXAS_TYPE_NAMES) or None in twin["registers"].values():
            raise AssertionError(f"{source}: a kernel entry lacks its bf16 or fp16 instantiation: {twin}")


def rel_rms(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def check_level0_transformer(dev) -> dict:
    """One full-width level-0 TransformerSpatioTemporalModel, forward and
    backward, kernel route against the dispatch's plain route (attention with
    fp32 logits in torch), same weights and inputs, under the training's
    dtype policy (fp32 trainable leaves, bf16 frozen ones, bf16 autocast)."""
    import torch

    from evoworld_tpu_torch.models.layers import TransformerSpatioTemporalModel
    from evoworld_tpu_torch.models.weights import init_random_
    from evoworld_tpu_torch.ops import attention as tattn
    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from evoworld_tpu_torch.train.train_step import freeze_master_cast, trainable_mask

    frames, height, width, ch, heads = 5, 72, 128, 320, 5
    g = torch.Generator(device=dev).manual_seed(99)
    with torch.device("meta"):
        block = TransformerSpatioTemporalModel(heads, ch // heads, ch, 1024)
    block = freeze_master_cast(init_random_(block.to_empty(device=dev), g), torch.bfloat16)
    mask = trainable_mask(block)
    x = torch.randn((frames, ch, height, width), generator=g, device=dev).bfloat16()
    ctx = torch.randn((frames, 1, 1024), generator=g, device=dev).bfloat16()
    dout = torch.randn((frames, ch, height, width), generator=g, device=dev).bfloat16()

    def run():
        block.zero_grad(set_to_none=True)
        xin = x.clone().requires_grad_()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = block(xin, ctx, frames)
        out.backward(dout)
        grads = {n: None if p.grad is None else p.grad.clone() for n, p in block.named_parameters() if mask[n]}
        return {"out": out.detach(), "dx": xin.grad}, grads

    counts = flash_attention.launches, flash_attention_backward.launches
    got, got_grads = run()
    torch.cuda.synchronize()
    launches = [flash_attention.launches - counts[0], flash_attention_backward.launches - counts[1]]
    min_seq = tattn.FLASH_MIN_SEQ
    tattn.FLASH_MIN_SEQ = 1 << 30  # the reference: every attention on the plain route
    try:
        ref, ref_grads = run()
    finally:
        tattn.FLASH_MIN_SEQ = min_seq
    errs = {n: rel_rms(got[n], ref[n]) for n in got}
    if {n for n, t in got_grads.items() if t is None} != {n for n, t in ref_grads.items() if t is None}:
        raise AssertionError("the two routes disagree on which trainable leaves get a gradient")
    errs.update({n: rel_rms(t, ref_grads[n]) for n, t in got_grads.items() if t is not None})
    norm1 = "transformer_blocks.0.norm1.weight"
    worst = max(errs, key=errs.get)
    result = dict(shape=[frames, ch, height, width], heads=heads, launches_fwd_bwd=launches,
                  rel_rms_out=errs["out"], rel_rms_dx=errs["dx"], rel_rms_norm1_grad=errs[norm1],
                  norm1_grad_rms=ref_grads[norm1].float().pow(2).mean().sqrt().item(),
                  worst=[worst, errs[worst]], grads_compared=len(errs) - 2, limit=BLOCK_REL_RMS)
    log("level-0 transformer " + json.dumps(result))
    if launches != [1, 1]:
        raise AssertionError(f"level-0 block launched (forward, backward) {launches}, expected [1, 1]")
    if not result["norm1_grad_rms"] > 0 or errs[worst] > BLOCK_REL_RMS:
        raise AssertionError(f"kernel route differs from the plain route: {result}")
    del block, got, ref, got_grads, ref_grads
    torch.cuda.empty_cache()
    return result


def check_vae_mid_gradient(dev) -> dict:
    """torch.autograd through one full-width VAE mid-block attention (512
    channels, one head of 512, 9216 tokens, the clip's encode batch of 2,
    bf16 weights and activations) on the card: the kernel route (the wide
    forward with its log-sum-exp, then the D = 512 backward kernels) against
    the same block's plain route (attention in torch with fp32 logits), same
    weights and inputs; output, input gradient and every weight gradient
    within BLOCK_REL_RMS, but one: a bias shared by all keys moves every
    score of a query by the same amount, which the softmax ignores, so
    to_k.bias's exact gradient is zero and both routes give only rounding
    noise there; its size on each route must stay under BLOCK_REL_RMS of
    to_q.bias's gradient instead."""
    import torch

    from evoworld_tpu_torch.models.vae import VAEAttention
    from evoworld_tpu_torch.models.weights import init_random_
    from evoworld_tpu_torch.ops import attention as tattn
    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward

    batch, ch, height, width = 2, 512, 72, 128
    g = torch.Generator(device=dev).manual_seed(77)
    with torch.device("meta"):
        block = VAEAttention(ch)
    block = init_random_(block.to_empty(device=dev), g).bfloat16()
    x = torch.randn((batch, ch, height, width), generator=g, device=dev).bfloat16()
    dout = torch.randn((batch, ch, height, width), generator=g, device=dev).bfloat16()

    def run():
        block.zero_grad(set_to_none=True)
        xin = x.clone().requires_grad_()
        out = block(xin)
        out.backward(dout)
        return {"out": out.detach(), "dx": xin.grad, **{n: p.grad.clone() for n, p in block.named_parameters()}}

    counts = flash_attention.launches, flash_attention_backward.launches
    got = run()
    torch.cuda.synchronize()
    launches = [flash_attention.launches - counts[0], flash_attention_backward.launches - counts[1]]
    min_seq = tattn.FLASH_MIN_SEQ
    tattn.FLASH_MIN_SEQ = 1 << 30  # the reference: the plain route
    try:
        ref = run()
    finally:
        tattn.FLASH_MIN_SEQ = min_seq
    zero = "to_k.bias"
    errs = {n: rel_rms(got[n], ref[n]) for n in got if n != zero}
    worst = max(errs, key=errs.get)
    q_bias = ref["to_q.bias"].float().norm().item()
    noise = [got[zero].float().norm().item() / q_bias, ref[zero].float().norm().item() / q_bias]
    result = dict(shape=[batch, ch, height, width], launches_fwd_bwd=launches, rel_rms=errs, worst=[worst, errs[worst]],
                  key_bias_grad_over_query_bias_grad=noise, limit=BLOCK_REL_RMS)
    log("vae mid-block attention gradient " + json.dumps(result))
    if launches != [1, 1]:
        raise AssertionError(f"the VAE attention launched (forward, backward) {launches}, expected [1, 1]")
    if errs[worst] > BLOCK_REL_RMS or max(noise) > BLOCK_REL_RMS:
        raise AssertionError(f"the D = 512 gradient differs from the plain route: {result}")
    del block, got, ref
    torch.cuda.empty_cache()
    return result


def train_draws(g, f, h, w) -> dict:
    """edm_loss's random inputs for batch 1 (`draws`), drawn on the CPU from `g`."""
    import torch

    lh, lw = h // 8, w // 8
    return dict(latent_eps=torch.randn((f, lh, lw, 4), generator=g), noise=torch.randn((1, f, lh, lw, 4), generator=g),
                cond_sigma_eps=torch.randn((1,), generator=g), cond_noise=torch.randn((1, 1 + f, h, w, 3), generator=g),
                sigma_eps=torch.randn((1,), generator=g), drop=torch.rand((1,), generator=g),
                cond_latent_eps=torch.randn((1 + f, lh, lw, 4), generator=g))


def check_small_train_step_against_cpu(dev, seed: int) -> dict:
    """Tiny-width fp32 training step (2 micro-batches) on the card against the CPU."""
    import torch

    from evoworld_tpu_torch.runtime import build_trainer
    from evoworld_tpu_torch.train.train_step import TrainConfig, make_train_state, train_step

    cfg = TrainConfig(total_steps=10, warmup_steps=0, learning_rate=1e-4, adam_eps=1e-4)
    f, h, w = 3, 64, 128
    # the same seeded CPU build twice, one copy moved to the card, so that both
    # sides hold the same weights (a build on the card draws them there)
    models = {"cpu": build_trainer("tiny", seed=seed, compute_dtype=torch.float32, device="cpu"),
              dev: tuple(m.to(dev) for m in build_trainer("tiny", seed=seed, compute_dtype=torch.float32, device="cpu"))}
    init = {k: v.detach().cpu().clone() for k, v in models["cpu"][0].state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    batches = [dict(pixel_values=torch.rand((1, f, h, w, 3), generator=g) * 2 - 1,
                    memory_values=torch.rand((1, f, h, w, 3), generator=g) * 2 - 1,
                    plucker=torch.randn((1, f, h // 8, w // 8, 6), generator=g)) for _ in range(2)]
    draws = [train_draws(g, f, h, w) for _ in range(2)]
    out = {}
    for d, (unet, vae, clip) in models.items():
        state = make_train_state(cfg, unet, torch.float32)
        metrics = train_step(state, vae, clip, batches, cfg, torch.float32, draws=draws)
        out[d] = metrics, {k: v.detach().cpu() for k, v in unet.state_dict().items()}
    (m_gpu, p_gpu), (m_cpu, p_cpu) = out[dev], out["cpu"]
    param_err = max((p_gpu[k] - p_cpu[k]).abs().max().item() for k in p_cpu)
    moved = sum(not torch.equal(p_cpu[k], init[k]) for k in init)
    result = dict(loss_gpu=m_gpu["loss"], loss_cpu=m_cpu["loss"], grad_norm_gpu=m_gpu["grad_norm"],
                  grad_norm_cpu=m_cpu["grad_norm"], max_abs_param_err=param_err, leaves_moved=moved,
                  leaves=len(init))
    log("small train step card vs CPU (64x128, 3 frames, 2 micro-batches, fp32) " + json.dumps(result))
    if abs(m_gpu["loss"] - m_cpu["loss"]) > STEP_LOSS_RTOL * abs(m_cpu["loss"]) or param_err > STEP_PARAM_ATOL:
        raise AssertionError(f"the training step on the card differs from the CPU: {result}")
    if not moved:
        raise AssertionError("the tiny training step moved no parameter")
    return result


class SyntheticEpisodes:
    """In-memory episodes of full-width frames from a seeded numpy generator
    (values in [-1, 1], a smooth random camera path), `train`'s dataset protocol."""

    height, width, frames = 576, 1024, 25

    def __init__(self, n: int, seed: int):
        import numpy as np

        rng = np.random.default_rng(seed)
        shape = (self.frames, self.height, self.width, 3)
        self.items = []
        for _ in range(n):
            steps = rng.normal(size=(self.frames, 6)) * np.array([0.1, 0.0, 0.1, 0.0, 2.0, 0.0])
            self.items.append(types.SimpleNamespace(
                pixel_values=rng.random(shape, dtype=np.float32) * 2 - 1,
                memory_values=rng.random(shape, dtype=np.float32) * 2 - 1,
                cam_traj=np.cumsum(steps, axis=0).astype(np.float32)))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def expected_train_launches(frames: int, vae_chunk: int, layers_per_block: int) -> tuple[int, int]:
    """(forward, backward) flash launches of one full-width training step.

    Forward: the VAE encoder's mid attention once per chunk of the frames and
    of the 1 + frames conditioning frames (no grad); level-0 spatial
    attention in down block 0 (layers_per_block) and up block 3
    (layers_per_block + 1), twice with block remat (forward and recompute).
    Backward: one launch per level-0 attention.
    """
    level0 = 2 * layers_per_block + 1
    vae = math.ceil(frames / vae_chunk) + math.ceil((frames + 1) / vae_chunk)
    return vae + 2 * level0, level0


def full_train(dev, steps: int, seed: int) -> dict:
    """TRAIN_STEPS full-width steps through `train` (EMA on, final checkpoint);
    checks launches, gradients, updates, the checkpoint and the EMA."""
    import os
    import shutil
    import tempfile

    import torch

    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from evoworld_tpu_torch.runtime import build_trainer
    from evoworld_tpu_torch.train.train_step import TrainConfig, trainable_mask
    from evoworld_tpu_torch.train import trainer as trainer_module
    from evoworld_tpu_torch.train.trainer import TrainerConfig

    t0 = time.perf_counter()
    data = SyntheticEpisodes(2, seed)
    unet, vae, clip = build_trainer("full", seed=seed, compute_dtype=torch.bfloat16, device=dev)
    cfg = TrainConfig(warmup_steps=1)  # lr 0 on the first update (warmup), 1e-5 after
    mask = trainable_mask(unet)
    before = {n: p.detach().to("cpu", copy=True) for n, p in unet.named_parameters()}
    torch.cuda.synchronize()
    log(f"full trainer built in {time.perf_counter() - t0:.3f} s: "
        f"{sum(p.numel() for n, p in unet.named_parameters() if mask[n])} trainable fp32 of "
        f"{sum(p.numel() for p in unet.parameters())} UNet parameters, {sum(mask.values())} of {len(mask)} leaves")
    expected = expected_train_launches(data.frames, cfg.vae_encode_chunk, unet.config.layers_per_block)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as out_dir:
        tc = TrainerConfig(output_dir=out_dir, max_steps=steps, log_steps=1, use_ema=True)
        free = shutil.disk_usage(out_dir).free
        torch.cuda.reset_peak_memory_stats(dev)
        flash_attention.launches = flash_attention_backward.launches = 0
        probe = TrainProbe(dev, (flash_attention, flash_attention_backward))
        t0 = time.perf_counter()
        with probe.installed():
            state = trainer_module.train(unet, vae, clip, data, cfg, tc, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = [flash_attention.launches, flash_attention_backward.launches]
        # the checkpoint's save, after the last step's tracker row
        peak = max([r["peak_memory_bytes"] for r in probe.steps] + [torch.cuda.max_memory_allocated(dev)])
        with open(os.path.join(out_dir, "train_metrics.jsonl")) as f:
            rows = [{**json.loads(line), **probed, "expected_launches": list(expected)}
                    for line, probed in zip(f, probe.steps)]
        ckpt_dir = os.path.join(out_dir, "checkpoints")
        ckpt_files = sorted(os.listdir(ckpt_dir))
        ckpt_path = os.path.join(ckpt_dir, f"{steps}.pt")
        ckpt_bytes = os.path.getsize(ckpt_path)
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    for row in rows:
        log("train step " + json.dumps(row))
    if [r["step"] for r in rows] != list(range(1, steps + 1)) or len(probe.steps) != steps:
        raise AssertionError(f"the tracker logged steps {[r['step'] for r in rows]}, expected 1..{steps}")
    for r in rows:
        if (r["fwd_launches"], r["bwd_launches"]) != expected:
            raise AssertionError(f"step {r['step']} launched {r['fwd_launches']}, {r['bwd_launches']}, "
                                 f"expected {expected}")
    if not all(math.isfinite(r["train_loss"]) and math.isfinite(r["grad_norm"]) for r in rows):
        raise AssertionError(f"non-finite loss or gradient norm: {rows}")
    norm1 = unet.down_blocks[0].attentions[0].transformer_blocks[0].norm1.weight.grad
    grads = {n: p.grad for n, p in unet.named_parameters() if p.grad is not None}
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        raise AssertionError("non-finite gradients")
    if norm1 is None or not bool(norm1.abs().max() > 0):
        raise AssertionError("level-0 transformer_blocks.0.norm1 got no gradient")
    # The checkpoint keeps the raw parameters; the UNet now holds the EMA.
    params = ckpt["params"]
    changed = {n: not torch.equal(before[n], params[n]) for n in before}
    stale = [n for n in grads if mask[n] and not changed[n] and bool(grads[n].abs().max() > 0)]
    moved_frozen = [n for n in changed if changed[n] and not mask[n]]
    ema_loaded = all(torch.equal(p.detach().cpu(), ckpt["ema"][n]) for n, p in unet.named_parameters())
    summary = dict(train_seconds=seconds, steps=state.step, peak_memory_bytes=peak,
                   launches_total=launches, expected_per_step=list(expected),
                   trainable_changed=sum(changed[n] for n in mask if mask[n]), trainable=sum(mask.values()),
                   frozen_changed=len(moved_frozen), norm1_grad_abs_max=norm1.abs().max().item(),
                   checkpoints=ckpt_files, checkpoint_bytes=ckpt_bytes, tmp_free_bytes=free,
                   adam_states=len(ckpt["opt_state"]["state"]), ema_loaded=ema_loaded)
    log("train summary " + json.dumps(summary))
    if launches != [steps * expected[0], steps * expected[1]]:
        raise AssertionError(f"{steps} steps launched {launches}, expected {steps} x {list(expected)}")
    if stale or moved_frozen:
        raise AssertionError(f"trainable leaves with gradients did not move: {stale[:5]}; "
                             f"frozen leaves moved: {moved_frozen[:5]}")
    if (state.step, ckpt["step"], ckpt_files) != (steps, steps, [f"{steps}.pt"]):
        raise AssertionError(f"train ended at step {state.step} with checkpoints {ckpt_files}")
    if summary["adam_states"] != summary["trainable"] or not ema_loaded:
        raise AssertionError(f"optimizer state or EMA not as expected: {summary}")
    return {"steps": rows, "summary": summary}


def clip_inputs(cfg, dev, seed: int):
    """First frame, Pluecker rays of a smooth camera path and memory frames."""
    import torch

    from evoworld_tpu_torch.geometry.plucker import plucker_embedding
    from evoworld_tpu_torch.geometry.pose import pose_to_matrix, unity_to_opencv
    from evoworld_tpu_torch.geometry.rays import equirect_ray_grid

    g = torch.Generator(device=dev).manual_seed(seed)
    f = cfg.num_frames
    steps = torch.randn((f, 6), generator=g, device=dev) * torch.tensor([0.1, 0.0, 0.1, 0.0, 2.0, 0.0], device=dev)
    c2w = pose_to_matrix(unity_to_opencv(steps.cumsum(0)), relative=True)
    plucker = plucker_embedding(equirect_ray_grid(cfg.latent_height, cfg.latent_width, device=dev), c2w)
    image = torch.rand((cfg.height, cfg.width, 3), generator=g, device=dev) * 2 - 1
    memory = torch.rand((f, cfg.height, cfg.width, 3), generator=g, device=dev) * 2 - 1
    return image, plucker, memory


def pipeline_on(pipe, dev):
    """A copy of a (CPU-built, fp32) pipeline on `dev`, so that the card and
    the CPU run the same weights (a build on the card draws them there)."""
    import copy

    from evoworld_tpu_torch.diffusion.pipeline import PanoDiffusionPipeline

    models = (copy.deepcopy(m).to(dev) for m in (pipe.unet, pipe.vae, pipe.clip_tower))
    return PanoDiffusionPipeline(*models, pipe.config, pipe.compute_dtype)


def check_small_clip_against_cpu(dev, seed: int) -> float:
    """Tiny-width fp32 clip on the card against the same clip on the CPU."""
    import torch

    from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
    from evoworld_tpu_torch.runtime import build_pipeline

    cfg = PipelineConfig(height=64, width=128, num_frames=5, num_steps=2)
    cpu = build_pipeline(cfg, "tiny", seed=seed, compute_dtype=torch.float32, device="cpu")
    gpu = pipeline_on(cpu, dev)
    image, plucker, memory = clip_inputs(cfg, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    latents = torch.randn((5, 8, 16, 4), generator=g, device=dev)
    cond_noise = torch.randn((6, 64, 128, 3), generator=g, device=dev)
    out_gpu = gpu(image, plucker, memory, latents=latents, cond_noise=cond_noise).cpu()
    out_cpu = cpu(image.cpu(), plucker.cpu(), memory.cpu(), latents=latents.cpu(), cond_noise=cond_noise.cpu())
    err = (out_gpu - out_cpu).abs().max().item()
    log(f"small clip card vs CPU (64x128, 5 frames, 2 steps, fp32): max abs err {err:.3e}")
    if not err <= 2e-3:
        raise AssertionError(f"small clip on the card differs from the CPU by {err}")
    return err


def synthetic_path(rows: int, seed: int):
    """(scaled rows, unscaled rows), (rows, 6) OpenCV pose rows of a seeded
    walk: ~0.4 units forward a frame with a little sideways drift and a few
    degrees of yaw; positions scaled by the pipeline's pos_scale 0.1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(rows, 6)) * np.array([0.05, 0.0, 0.05, 0.0, 3.0, 0.0]) + np.array([0, 0, 0.4, 0, 0, 0])
    camera_params = np.cumsum(steps, axis=0).astype(np.float32)
    scaled = camera_params.copy()
    scaled[:, :3] *= 0.1
    return scaled, camera_params


def flipped_share(a, b) -> float:
    """Share of pixels of (..., H, W, 3) stacks that differ by more than LOOP_PIXEL_ATOL."""
    return ((a.float() - b.float()).abs() > LOOP_PIXEL_ATOL).any(-1).float().mean().item()


def check_small_loop_against_cpu(dev, seed: int) -> dict:
    """Tiny fp32 3-segment loop on the card, each stage held against the same
    stage on the CPU given the card's inputs: the same CPU-built weights (a
    copy moved to the card) and draws. Stage by stage, because the random tiny
    UNet spreads any change of its conditioning over the whole next clip (one
    flipped memory pixel in 32768 moved segment 1 by 0.08 in a free-running
    comparison), as in tests/test_torch_port_loop.py."""
    import copy

    import torch

    from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
    from evoworld_tpu_torch.loop.navigator import Navigator
    from evoworld_tpu_torch.loop.unified import LoopConfig, UnifiedLoop
    from evoworld_tpu_torch.models.vggt.model import make_reconstructor
    from evoworld_tpu_torch.runtime import build_pipeline, build_reconstructor

    f, h, w = SMALL_LOOP["num_frames"], 64, 128
    cpu_pipe = build_pipeline(PipelineConfig(height=h, width=w, num_frames=f, num_steps=2), "tiny", seed=seed,
                              compute_dtype=torch.float32, device="cpu")
    cpu_recon = build_reconstructor("tiny", seed=seed, compute_dtype=torch.float32, device="cpu")
    gpu_recon = make_reconstructor(copy.deepcopy(cpu_recon.model).to(dev), torch.float32)
    cpu_loop = UnifiedLoop(Navigator(cpu_pipe, num_frames=f), cpu_recon, LoopConfig(**SMALL_LOOP))
    loop = UnifiedLoop(Navigator(pipeline_on(cpu_pipe, dev), num_frames=f), gpu_recon, LoopConfig(**SMALL_LOOP))
    calls = {"generate": [], "rebuild": []}

    def recorded(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[name].append((args, kwargs, out))
            return out
        return call

    loop.navigator.generate_segment = recorded("generate", loop.navigator.generate_segment)
    loop.rebuild_memory = recorded("rebuild", loop.rebuild_memory)
    scaled, camera_params = synthetic_path(3 * (f - 1) + f + 4, seed)
    g = torch.Generator().manual_seed(seed)
    start = torch.rand((h, w, 3), generator=g) * 2 - 1
    draws = [dict(latents=torch.randn((f, h // 8, w // 8, 4), generator=g).to(dev),
                  cond_noise=torch.randn((f + 1, h, w, 3), generator=g).to(dev)) for _ in range(SMALL_LOOP["num_segments"])]
    out = loop.run_episode(start.to(dev), scaled, camera_params, draws=draws)

    def cpu(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    def on_cpu(fn, args, kwargs):
        return fn(*(cpu(a) for a in args), **{k: cpu(v) for k, v in kwargs.items()})

    result = dict(
        frame_max_abs_err=[(o.cpu() - on_cpu(cpu_loop.navigator.generate_segment, a, k)).abs().max().item()
                           for a, k, o in calls["generate"]],
        memory_flipped_share=[flipped_share(o.cpu(), on_cpu(cpu_loop.rebuild_memory, a, k)) for a, k, o in calls["rebuild"]],
        memory_coverage=[(m.sum(-1) > 0).float().mean().item() for m in out["memories"]],
        frame_atol=LOOP_FRAME_ATOL, max_flipped=LOOP_MAX_FLIPPED)
    log("small loop card vs CPU, stage by stage (64x128, 3 segments of 5 frames, 2 steps, 16x512 crops, fp32) "
        + json.dumps(result))
    kept = [o if i == 0 else o[1:] for i, (_, _, o) in enumerate(calls["generate"])]
    if not (all(torch.equal(a, b) for a, b in zip(out["segments"], kept, strict=True))
            and all(torch.equal(a, o) for a, (_, _, o) in zip(out["memories"], calls["rebuild"], strict=True))):
        raise AssertionError("the small loop's result is not the frames and memories its stages made")
    if len(result["memory_flipped_share"]) != 2 or not all(c > 0 for c in result["memory_coverage"]):
        raise AssertionError(f"the small loop rendered no memory to compare: {result}")
    if max(result["frame_max_abs_err"]) > LOOP_FRAME_ATOL or max(result["memory_flipped_share"]) > LOOP_MAX_FLIPPED:
        raise AssertionError(f"the small loop on the card differs from the CPU: {result}")
    return result


def vggt_tokens_per_frame(vggt_config, pers_hw) -> tuple[int, int]:
    """(aggregator, patch-encoder) tokens a frame for perspective crops of
    `pers_hw`, at the width VGGT's preprocessing resizes them to."""
    agg = vggt_config.aggregator
    width = 518  # load_and_preprocess_images: width 518, height rounded to whole patches
    height = int(round(pers_hw[0] * width / pers_hw[1] / agg.patch_size)) * agg.patch_size
    patches = (height // agg.patch_size) * (width // agg.patch_size)
    return 1 + agg.num_register_tokens + patches, 1 + agg.dino_num_register_tokens + patches


def vggt_launches(frames: int, pers_hw, vggt_config, flash_min_seq: int) -> int:
    """Flash launches of one VGGT reconstruction of `frames` crops of
    `pers_hw`: one for each attention whose sequence reaches `flash_min_seq`,
    the global attention (frames x tokens, once per aggregator pair), the
    frame attention and the patch encoder's (tokens a frame), the camera
    head's trunk (one token a frame, trunk depth x 4 refinements)."""
    agg = vggt_config.aggregator
    tokens, dino_tokens = vggt_tokens_per_frame(vggt_config, pers_hw)
    return (agg.depth * ((frames * tokens >= flash_min_seq) + (tokens >= flash_min_seq))
            + agg.patch_encoder_depth * (dino_tokens >= flash_min_seq)
            + vggt_config.camera_trunk_depth * 4 * (frames >= flash_min_seq))


def expected_loop_launches(steps: int, loop_cfg, vggt_config, flash_min_seq: int) -> int:
    """Flash launches of one episode: 5N + 18 per clip, and a VGGT
    reconstruction per rebuild; the rebuild after segment k sees
    num_frames + k (num_frames - 1) frames."""
    pers_hw = (loop_cfg.pers_height, loop_cfg.pers_width)
    total = loop_cfg.num_segments * (5 * steps + 18)
    for k in range(loop_cfg.num_segments - 1):
        total += vggt_launches(loop_cfg.num_frames + k * (loop_cfg.num_frames - 1), pers_hw, vggt_config,
                               flash_min_seq)
    return total


def full_loop(dev, steps: int, seed: int, num_segments: int | None = None, offload_params: bool | None = None,
              keep: int = 2) -> dict:
    """The full-width episode through the entry points (`LoopConfig()`, 3
    segments unless `num_segments` says otherwise; VGGT's parameters offloaded
    to the host between rebuilds unless `offload_params` is False); checks
    launches, shapes and finiteness, and reads stage seconds, the episode's
    peak memory, each stage's (every generate and reconstruct call, its
    peak counted from the memory held as it starts) and each memory stack's
    coverage. The episode's seconds include a synchronisation before and
    after each of those calls. Keeps
    the first rebuild's cloud, the first segment and, on the host, the first
    `keep` segments and `keep - 1` memories (phase 19(c) holds an episode to
    another)."""
    import dataclasses

    import torch

    from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
    from evoworld_tpu_torch.loop.navigator import Navigator
    from evoworld_tpu_torch.loop.unified import LoopConfig, UnifiedLoop
    from evoworld_tpu_torch.memory.pointcloud import confidence_mask
    from evoworld_tpu_torch.ops.attention import FLASH_MIN_SEQ
    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from evoworld_tpu_torch.runtime import VGGT_PRESETS, build_pipeline, build_reconstructor

    cfg, loop_cfg = PipelineConfig(num_steps=steps), LoopConfig()
    if num_segments is not None:
        loop_cfg = dataclasses.replace(loop_cfg, num_segments=num_segments)
    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated(dev)  # what the process holds before the episode's models
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, "full", seed=seed, compute_dtype=torch.bfloat16, device=dev)
    recon = build_reconstructor("full", seed=seed, compute_dtype=torch.bfloat16, device=dev,
                                offload_params=offload_params)
    torch.cuda.synchronize()
    vggt_bytes = sum(t.numel() * t.element_size() for t in (*recon.model.parameters(), *recon.model.buffers()))
    log(f"full loop built in {time.perf_counter() - t0:.3f} s: VGGT {sum(p.numel() for p in recon.model.parameters())} "
        f"parameters ({vggt_bytes} bytes, offloaded {recon.offload}), pipeline "
        f"{sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.clip_tower) for p in m.parameters())}")
    rows = loop_cfg.num_segments * loop_cfg.num_target_view + loop_cfg.num_frames
    scaled, camera_params = synthetic_path(rows, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    start = torch.rand((cfg.height, cfg.width, 3), generator=g, device=dev) * 2 - 1
    clouds, stage_peaks = [], {"generate": [], "reconstruct": []}
    episode_peak = 0  # the peak before each call's reset; the episode's is the largest with the last stretch's

    def peaked(stage, fn):
        def run(*args, **kwargs):
            nonlocal episode_peak
            torch.cuda.synchronize(dev)
            episode_peak = max(episode_peak, torch.cuda.max_memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            stage_peaks[stage].append(torch.cuda.max_memory_allocated(dev))
            return out
        return run

    def reconstruct(images):  # keeps each rebuild's confidence-filtered cloud on the host (phase 17 exports one)
        preds = recon(images)
        keep_ = confidence_mask(preds["conf"], loop_cfg.conf_percentile).reshape(-1)
        clouds.append({k: preds[k].reshape(-1, 3)[keep_].cpu() for k in ("world_points", "colors")})
        return preds

    navigator = Navigator(pipe, num_frames=loop_cfg.num_frames)
    navigator.generate_segment = peaked("generate", navigator.generate_segment)
    loop = UnifiedLoop(navigator, peaked("reconstruct", reconstruct), loop_cfg)
    expected = expected_loop_launches(steps, loop_cfg, VGGT_PRESETS["full"], FLASH_MIN_SEQ)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    flash_attention.launches = flash_attention_backward.launches = 0
    t0 = time.perf_counter()
    out = loop.run_episode(start, scaled, camera_params, draws=g, timings=timings)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, bwd_launches = flash_attention.launches, flash_attention_backward.launches
    finite = all(bool(torch.isfinite(t).all()) for t in out["segments"] + out["memories"])
    # frames are clamped to [0, 1]; memory colours are resampled crops (convex
    # combinations of [0, 1] values, which fp32 rounding may take past 1 by an ulp)
    in_range = all(t.min().item() >= 0 and t.max().item() <= 1 for t in out["segments"]) and all(
        t.min().item() >= 0 and t.max().item() <= 1 + 1e-6 for t in out["memories"])
    result = dict(segments=loop_cfg.num_segments, frames=[t.shape[0] for t in out["segments"]], num_steps=steps,
                  seconds=seconds, stage_seconds=timings,
                  peak_memory_bytes=max(episode_peak, torch.cuda.max_memory_allocated(dev)),
                  stage_peak_bytes=stage_peaks, baseline_bytes=baseline, vggt_bytes=vggt_bytes,
                  offloaded=recon.offload,
                  memory_coverage=[(m.sum(-1) > 0).float().mean().item() for m in out["memories"]],
                  flash_launches=launches, expected_launches=expected, bwd_launches=bwd_launches,
                  finite=finite, in_range=in_range)
    log("loop " + json.dumps(result))
    shapes = [tuple(t.shape) for t in out["segments"]] + [tuple(t.shape) for t in out["memories"]]
    want = [(loop_cfg.num_frames - (i > 0), cfg.height, cfg.width, 3) for i in range(loop_cfg.num_segments)]
    want += [(loop_cfg.num_target_view, cfg.height, cfg.width, 3)] * (loop_cfg.num_segments - 1)
    if shapes != want:
        raise AssertionError(f"the episode's shapes are {shapes}, expected {want}")
    if not (finite and in_range):
        raise AssertionError("the episode's frames or memories are not finite values in [0, 1]")
    if launches != expected or bwd_launches:
        raise AssertionError(f"the episode launched the flash kernels {launches} / {bwd_launches} times, "
                             f"expected {expected} / 0")
    kept = {"segments": [t.cpu() for t in out["segments"][:keep]],
            "memories": [t.cpu() for t in out["memories"][:keep - 1]]}
    del loop, navigator, pipe, recon, out
    torch.cuda.empty_cache()
    result["cloud"] = clouds[0]  # the first rebuild's (25 frames); not in the logged line
    result["first_segment"] = kept["segments"][0]  # phase 18(c) holds the sharded episode's to it
    result["kept"] = kept  # phase 19(c) holds the episode without offload to these
    return result


def write_episode(root: str, rows: int, memories: int, height: int, width: int, seed: int, dev) -> float:
    """A synthetic episode in the dataset's layout, written with the port's PNG
    writer: `rows` panoramas (smooth seeded colour fields with a little noise),
    `memories` rendered memory panoramas and `camera_poses.txt` (a seeded walk,
    Unity convention). Returns the seconds spent."""
    import os

    import numpy as np
    import torch
    import torch.nn.functional as F

    from evoworld_tpu_torch.data.native_io import save_png_batch
    from evoworld_tpu_torch.geometry.pose import UNITY_TO_OPENCV

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)

    def images(n):
        coarse = torch.rand((n, 3, 9, 16), generator=g, device=dev)
        fine = F.interpolate(coarse, size=(height, width), mode="bicubic", align_corners=False)
        fine = fine + 0.02 * torch.randn(fine.shape, generator=g, device=dev)
        return (fine.clamp(0, 1) * 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()

    os.makedirs(os.path.join(root, "panorama"))
    os.makedirs(os.path.join(root, "rendered_panorama_vggt_open3d"))
    save_png_batch([os.path.join(root, "panorama", f"{i:03d}.png") for i in range(1, rows + 1)], images(rows))
    save_png_batch([os.path.join(root, "rendered_panorama_vggt_open3d", f"{i:02d}.png") for i in range(memories)],
                   images(memories))
    _, camera_params = synthetic_path(rows, seed)
    unity = camera_params * np.asarray(UNITY_TO_OPENCV, np.float32)  # the sign flips are their own inverse
    with open(os.path.join(root, "camera_poses.txt"), "w") as f:
        f.write("Frame,PosX,PosY,PosZ,RotX,RotY,RotZ\n")
        for i, row in enumerate(unity):
            f.write(",".join([str(i + 1)] + [repr(float(x)) for x in row]) + "\n")
    return time.perf_counter() - t0


def write_checkpoints(root: str, config, dev, seed: int):
    """Checkpoints from random models of `config`'s presets (full width on the
    card): a diffusers pipeline directory (unet/ in two safetensors shards
    with conv_in cut to SVD's 8 input channels, vae/, image_encoder/) and
    VGGT's model.pt. Returns the source pipeline and VGGT model, the files'
    bytes and the write seconds."""
    import os

    import torch

    from evoworld_tpu_torch.config import compute_dtype
    from evoworld_tpu_torch.models.weights import save_safetensors
    from evoworld_tpu_torch.runtime import build_pipeline, build_reconstructor

    rt, dtype = config.runtime, compute_dtype(config.runtime)
    pipe = build_pipeline(config.pipeline, rt.model_preset, seed=seed + 5, compute_dtype=dtype, device=dev)
    vggt = build_reconstructor("tiny" if rt.vggt_tiny else "full", seed=seed + 5, compute_dtype=dtype,
                               device=dev).model
    t0 = time.perf_counter()
    for sub, model in (("unet", pipe.unet), ("vae", pipe.vae), ("image_encoder", pipe.clip_tower)):
        os.makedirs(os.path.join(root, sub))
        state = model.state_dict()
        if sub == "unet":
            state["conv_in.weight"] = state["conv_in.weight"][:, :8]
        names = list(state)
        shards = [names[: len(names) // 2], names[len(names) // 2:]] if sub == "unet" else [names]
        for i, shard in enumerate(shards):
            save_safetensors({n: state[n] for n in shard},
                             os.path.join(root, sub, f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"))
    torch.save({"model": {k: v.cpu() for k, v in vggt.state_dict().items()}}, os.path.join(root, "model.pt"))
    seconds = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    return pipe, vggt, nbytes, seconds


def same_parameters(loaded, src: dict, cut_conv_in: bool = False) -> bool:
    """Every tensor of `loaded`'s state dict equals the state dict `src`'s, cast
    to its dtype (conv_in: the first 8 input channels equal and the rest zero,
    with `cut_conv_in`, where `src` holds the full or the cut weight)."""
    import torch

    for name, t in loaded.state_dict().items():
        want = src[name].to(t.device, t.dtype)
        if cut_conv_in and name == "conv_in.weight":
            if not (torch.equal(t[:, :8], want[:, :8]) and not t[:, 8:].any()):
                return False
        elif not torch.equal(t, want):
            return False
    return set(src) == set(loaded.state_dict())


def full_cli(dev, steps: int, seed: int, overrides: tuple = (), workdir: str | None = None) -> dict:
    """The production CLIs at full width from checkpoint directories: a
    synthetic 1024x576 episode (97 panoramas, 24 memory renders) and
    full-width random checkpoints written to `workdir` (`episode_000/`,
    `svd/`, the CLIs' output under `out/`; a temporary directory where none
    is given), then
    `cli.run_single_segment.main` and `cli.run_unified.main` (N steps, bf16,
    on the card, no random fallback). Checks that the loaded parameters equal
    the written ones, the PNGs' counts and sizes, the flash launches (5N + 18
    for the clip, `expected_loop_launches` for the episode, no backward), and
    that the writer thread's encode overlapped the card's compute (it was
    busy longer than the episode waited for it at the end). `overrides`
    (CLI flags) cut the configuration down for a rehearsal off the card."""
    import contextlib
    import os
    import tempfile

    import torch

    from evoworld_tpu_torch.cli import run_single_segment, run_unified
    from evoworld_tpu_torch.config import EvoWorldConfig, apply_overrides
    from evoworld_tpu_torch.data.native_io import image_size
    from evoworld_tpu_torch.ops.attention import FLASH_MIN_SEQ
    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from evoworld_tpu_torch.runtime import VGGT_PRESETS

    config = apply_overrides(EvoWorldConfig(), [f"--pipeline.num_steps={steps}", f"--runtime.seed={seed}", *overrides])
    loop_cfg, height, width = config.loop, config.pipeline.height, config.pipeline.width
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rows = loop_cfg.num_segments * loop_cfg.num_target_view + loop_cfg.num_frames
    captured = {}

    def capturing(module, name):
        build = getattr(module, name)

        def wrapped(*args, **kwargs):
            captured[name] = build(*args, **kwargs)
            return captured[name]
        return build, wrapped

    with contextlib.ExitStack() as stack:
        tmp = workdir or stack.enter_context(tempfile.TemporaryDirectory())
        episode, ckpt = os.path.join(tmp, "episode_000"), os.path.join(tmp, "svd")
        episode_s = write_episode(episode, rows, loop_cfg.num_target_view, height, width, seed, dev)
        src_pipe, src_vggt, ckpt_bytes, write_s = write_checkpoints(ckpt, config, dev, seed)
        argv = [f"--data.root={episode}", f"--runtime.checkpoint_dir={ckpt}",
                f"--runtime.vggt_checkpoint={ckpt}/model.pt", "--runtime.allow_random_weights=false",
                f"--pipeline.num_steps={steps}", f"--runtime.seed={seed}", f"--runtime.save_dir={tmp}/out", *overrides]
        result = dict(episode_write_s=episode_s, checkpoint_bytes=ckpt_bytes, checkpoint_write_s=write_s)

        original, run_single_segment.build_pipeline = capturing(run_single_segment, "build_pipeline")
        flash_attention.launches = flash_attention_backward.launches = 0
        try:
            single = run_single_segment.main(argv, device=dev)[0]
        finally:
            run_single_segment.build_pipeline = original
        sync()
        single_launches = [flash_attention.launches, flash_attention_backward.launches]
        loaded = captured.pop("build_pipeline")
        pipeline_equal = {name: same_parameters(getattr(loaded, name), getattr(src_pipe, name).state_dict(),
                                                name == "unet") for name in ("unet", "vae", "clip_tower")}
        del loaded, src_pipe
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

        original, run_unified.build_reconstructor = capturing(run_unified, "build_reconstructor")
        flash_attention.launches = flash_attention_backward.launches = 0
        try:
            unified = run_unified.main(argv, device=dev)[0]
        finally:
            run_unified.build_reconstructor = original
        sync()
        unified_launches = [flash_attention.launches, flash_attention_backward.launches]
        vggt_equal = same_parameters(captured.pop("build_reconstructor").model, src_vggt.state_dict())
        del src_vggt

        def pngs(out_dir, sub):  # the count and the (width, height) of the PNGs
            names = sorted(os.listdir(os.path.join(out_dir, sub)))
            return len(names), sorted({image_size(os.path.join(out_dir, sub, n))[::-1] for n in names})

        f, t = loop_cfg.num_frames, loop_cfg.num_target_view
        want = {"predictions": (f, [(width, height)]), "predictions_gt": (f, [(width, height)])}
        got = {sub: pngs(single["out_dir"], sub) for sub in want}
        want_u = {f"{kind}_{i}": (f - (i > 0), [(width, height)])
                  for i in range(loop_cfg.num_segments) for kind in ("predictions", "predictions_gt")}
        want_u.update({f"rendered_panorama_{i}": (t, [(width, height)]) for i in range(loop_cfg.num_segments - 1)})
        got_u = {sub: pngs(unified["out_dir"], sub) for sub in want_u}

    stages = unified["stage_seconds"]
    vggt_config = VGGT_PRESETS["tiny" if config.runtime.vggt_tiny else "full"]
    expected_loop = expected_loop_launches(steps, loop_cfg, vggt_config, FLASH_MIN_SEQ) if on_card else 0
    expected_single = 5 * steps + 18 if on_card else 0  # CPU tensors take the plain versions
    result.update(
        out_dir=unified["out_dir"],
        single=dict(load_s=single["load_s"], host_decode_s=single["host_decode_s"], generate_s=single["generate_s"],
                    host_save_s=single["host_save_s"], launches=single_launches, expected=[expected_single, 0],
                    parameters_equal=pipeline_equal, pngs=got),
        unified=dict(load_s=unified["load_s"], episode_s=unified["episode_s"],
                     generate_s=sum(v for k, v in stages.items() if k.startswith("generate")),
                     reconstruct_s=sum(v for k, v in stages.items() if k.startswith("reconstruct")),
                     splat_s=sum(v for k, v in stages.items() if k.startswith("splat_render")),
                     pers_extract_s=sum(v for k, v in stages.items() if k.startswith("pers_extract")),
                     host_decode_s=unified["host_decode_s"], host_save_s=unified["host_save_s"],
                     writer_busy_s=unified["writer_busy_s"], writer_wait_s=unified["writer_wait_s"],
                     stage_seconds=stages, peak_memory_bytes=torch.cuda.max_memory_allocated(dev) if on_card else None,
                     launches=unified_launches, expected=[expected_loop, 0], vggt_parameters_equal=vggt_equal,
                     pngs=got_u))
    log("cli " + json.dumps(result))
    if not (all(pipeline_equal.values()) and vggt_equal):
        raise AssertionError(f"loaded parameters differ from the written ones: {pipeline_equal}, VGGT {vggt_equal}")
    if got != want or got_u != want_u:
        raise AssertionError(f"the CLIs wrote {got} and {got_u}, expected {want} and {want_u}")
    if single_launches != [expected_single, 0] or unified_launches != [expected_loop, 0]:
        raise AssertionError(f"the CLIs launched the flash kernels {single_launches} and {unified_launches} times, "
                             f"expected {[expected_single, 0]} and {[expected_loop, 0]}")
    if not unified["writer_busy_s"] > unified["writer_wait_s"]:
        raise AssertionError(f"the writer's encode did not overlap the compute: {result['unified']}")
    return result


def gif_summary(path: str) -> dict:
    """Walk a GIF's blocks (no decoding): the logical screen's (width,
    height), each image's (width, height), each graphic control extension's
    delay in hundredths of a second, and the NETSCAPE loop count (None if
    absent). Raises ValueError on a malformed block structure."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path} is not a GIF")
    screen = struct.unpack("<HH", data[6:10])
    pos = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 0x80 else 0)

    def skip_sub_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    frames, delays, loop = [], [], None
    while True:
        if pos >= len(data):
            raise ValueError(f"{path} ends without a trailer")
        tag = data[pos]
        if tag == 0x3B:
            break
        if tag == 0x21:
            label = data[pos + 1]
            if label == 0xF9:
                delays.append(struct.unpack("<H", data[pos + 4 : pos + 6])[0])
            elif label == 0xFF and data[pos + 3 : pos + 14] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", data[pos + 16 : pos + 18])[0]
            pos = skip_sub_blocks(pos + 2)
        elif tag == 0x2C:
            frames.append(struct.unpack("<HH", data[pos + 5 : pos + 9]))
            packed = data[pos + 9]
            pos += 10 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)  # the LZW minimum code size, then the data
        else:
            raise ValueError(f"{path}: unexpected block 0x{tag:02x} at byte {pos}")
    return dict(screen=screen, frames=frames, delays_cs=delays, loop=loop)


class TrainProbe:
    """Measures `train` (phase 8, and the training CLI's) through the
    trainer's own seams while `installed`: at each tracker row (one a step
    at `log_steps` = 1) the flash launches since the last reading and the
    peak memory (then reset); each checkpoint save's step and seconds;
    around each `run_validation` its launches, peak memory and seconds; the
    step each run resumed from."""

    def __init__(self, dev, counters):
        self.dev, self.counters = dev, counters
        self.steps, self.saves, self.validations, self.resumed = [], [], [], []
        self.last = self._counts()

    def _counts(self):
        return [c.launches for c in self.counters]

    def _since_last(self):
        counts = self._counts()
        diff = [a - b for a, b in zip(counts, self.last)]
        self.last = counts
        return diff

    def _peak(self):
        import torch

        if self.dev.type != "cuda":
            return None
        peak = torch.cuda.max_memory_allocated(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        return peak

    @contextlib.contextmanager
    def installed(self):
        """The trainer's tracker, checkpoint manager and `run_validation`
        replaced by measuring ones inside, the originals back after."""
        from evoworld_tpu_torch.train import trainer

        probe, originals = self, (trainer.JSONLTracker, trainer.CheckpointManager, trainer.run_validation)

        class Tracker(trainer.JSONLTracker):
            def log(self, step, scalars):
                super().log(step, scalars)
                fwd, bwd = probe._since_last()
                probe.steps.append(dict(step=int(step), fwd_launches=fwd, bwd_launches=bwd,
                                        peak_memory_bytes=probe._peak()))

        class Checkpoints(trainer.CheckpointManager):
            def save(self, step, state, ema=None):
                t0 = time.perf_counter()
                super().save(step, state, ema)
                probe.saves.append(dict(step=int(step), seconds=time.perf_counter() - t0))

            def restore(self, step, state):
                probe.resumed.append(int(step))
                return super().restore(step, state)

        def run_validation(*args):
            probe._since_last()
            probe._peak()
            t0 = time.perf_counter()
            originals[2](*args)
            fwd, bwd = probe._since_last()
            probe.validations.append(dict(seconds=time.perf_counter() - t0, fwd_launches=fwd, bwd_launches=bwd,
                                          peak_memory_bytes=probe._peak()))

        trainer.JSONLTracker, trainer.CheckpointManager, trainer.run_validation = Tracker, Checkpoints, run_validation
        try:
            yield self
        finally:
            trainer.JSONLTracker, trainer.CheckpointManager, trainer.run_validation = originals


def full_train_cli(dev, steps: int, seed: int, workdir: str, overrides: tuple = ()) -> dict:
    """Phase 12: `cli.train.main` at full width on phase 11's episode and
    checkpoint directories (`workdir`): 2 steps with EMA, a checkpoint and a
    validation clip at step 2 (N denoise steps), then a resume to step 3.
    Checks the flash launches of each step (`expected_train_launches`) and of
    the validation clip (5N + 18), finite losses and gradient norms, the
    loaded models against the files, the GIF's blocks (frames of H x 2W),
    the logged val_psnr / val_ssim against `eval.metrics` on the CPU, that
    the clip rendered with the step-2 checkpoint's EMA (not its raw
    parameters), and that the resumed run started at step 2 and carried the
    checkpoint's EMA one step on (`TrainProbe` reads the steps, saves,
    validation and resume). Returns the seconds, bytes and peak memory it read, and the
    validation clip (frames and GT, [0, 1]) for phase 13."""
    import os
    import shutil

    import numpy as np
    import torch

    from evoworld_tpu_torch.cli import train as train_cli
    from evoworld_tpu_torch.config import EvoWorldConfig, apply_overrides
    from evoworld_tpu_torch.data.dataset import EpisodeDataset
    from evoworld_tpu_torch.eval.metrics import batch_video_metrics
    from evoworld_tpu_torch.models.weights import load_safetensors_dir
    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from evoworld_tpu_torch.runtime import PRESETS

    episode, ckpt, out = (os.path.join(workdir, d) for d in ("episode_000", "svd", "train"))
    argv = [f"--data.root={episode}", f"--runtime.checkpoint_dir={ckpt}", "--runtime.allow_random_weights=false",
            f"--runtime.save_dir={out}", f"--runtime.seed={seed}", f"--pipeline.num_steps={steps}",
            "--train.warmup_steps=1", "--trainer.checkpointing_steps=2", "--trainer.validation_steps=2",
            "--trainer.use_ema=true", "--trainer.log_steps=1", *overrides]
    config = apply_overrides(EvoWorldConfig(), argv)
    pc, on_card = config.pipeline, dev.type == "cuda"
    loaded_equal, clips, rendered_with = {}, [], []
    build = train_cli.build_trainer
    navigator = train_cli.Navigator

    def checked_build(*args, **kwargs):
        models = build(*args, **kwargs)
        for sub, model in zip(("unet", "vae", "image_encoder"), models):
            loaded_equal.setdefault(sub, []).append(
                same_parameters(model, load_safetensors_dir(os.path.join(ckpt, sub)), sub == "unet"))
        return models

    class Capturing(navigator):
        def generate_segment(self, *args, **kwargs):
            # The first, middle and last trainable parameters the clip renders with.
            trainable = [(n, p) for n, p in self.pipeline.unet.unet.named_parameters() if p.requires_grad]
            rendered_with.append({n: p.detach().cpu().clone()
                                  for n, p in (trainable[0], trainable[len(trainable) // 2], trainable[-1])})
            clips.append(super().generate_segment(*args, **kwargs))
            return clips[-1]

    if on_card:
        torch.cuda.empty_cache()
    free = shutil.disk_usage(workdir).free
    probe = TrainProbe(dev, (flash_attention, flash_attention_backward))
    train_cli.build_trainer, train_cli.Navigator = checked_build, Capturing
    runs = []
    try:
        with probe.installed():
            for total in (2, 3):
                flash_attention.launches = flash_attention_backward.launches = 0
                probe.last = probe._counts()
                t0 = time.perf_counter()
                state = train_cli.main([*argv, f"--train.total_steps={total}"], device=dev)
                if on_card:
                    torch.cuda.synchronize()
                runs.append(dict(total_steps=total, seconds=time.perf_counter() - t0, final_step=state.step,
                                 launches=[flash_attention.launches, flash_attention_backward.launches]))
                if total == 2:
                    ckpt2_bytes = os.path.getsize(os.path.join(out, "checkpoints", "2.pt"))
                del state
    finally:
        train_cli.build_trainer, train_cli.Navigator = build, navigator
    if on_card:
        torch.cuda.empty_cache()

    with open(os.path.join(out, "train_metrics.jsonl")) as f:
        tracked = [json.loads(line) for line in f]
    with open(os.path.join(out, "validation_metrics.jsonl")) as f:
        val_rows = [json.loads(line) for line in f]
    gif = os.path.join(out, "validation_000002.gif")
    summary = gif_summary(gif)
    ckpts = {s: torch.load(os.path.join(out, "checkpoints", f"{s}.pt"), map_location="cpu", weights_only=True,
                           mmap=True) for s in (2, 3)}
    decay = config.trainer.ema_decay
    ema_carried = all(torch.equal(e, (ckpts[2]["ema"][n].float() * decay
                                      + ckpts[3]["params"][n].float() * (1 - decay)).to(e.dtype))
                      for n, e in ckpts[3]["ema"].items())
    # Validation rendered with the step-2 checkpoint's EMA, not its raw parameters.
    rendered_ema = len(rendered_with) == 1 and all(torch.equal(p, ckpts[2]["ema"][n]) for n, p in rendered_with[0].items())
    rendered_raw = [torch.equal(p, ckpts[2]["params"][n]) for n, p in rendered_with[0].items()] if rendered_with else []
    sample = EpisodeDataset(episode, height=pc.height, width=pc.width, sequence_length=config.data.sequence_length,
                            sampling=config.data.sampling, single_episode=True)[0]
    frames = clips[0].float().cpu()
    gt = np.clip(sample.pixel_values[: frames.shape[0]] / 2 + 0.5, 0, 1)
    cpu_scores = batch_video_metrics(frames[None], torch.from_numpy(gt[None]))
    del ckpts

    layers = PRESETS[config.runtime.model_preset][0].layers_per_block
    expected_step = expected_train_launches(pc.num_frames, config.train.vae_encode_chunk, layers) \
        if on_card else (0, 0)  # CPU tensors take the plain versions
    expected_val = (5 * steps + 18, 0) if on_card else (0, 0)
    result = dict(
        runs=runs, steps=probe.steps, tracked=tracked, saves=probe.saves, validations=probe.validations,
        resumed_from=probe.resumed, loaded_equal=loaded_equal, checkpoint_bytes=ckpt2_bytes, tmp_free_bytes=free,
        gif=dict(path_bytes=os.path.getsize(gif), screen=summary["screen"], frames=len(summary["frames"]),
                 frame_sizes=sorted(set(summary["frames"])), delays_cs=sorted(set(summary["delays_cs"])),
                 loop=summary["loop"]),
        val_psnr=val_rows[0].get("val_psnr"), val_ssim=val_rows[0].get("val_ssim"),
        cpu_psnr=cpu_scores["psnr"], cpu_ssim=cpu_scores["ssim"], ema_carried=ema_carried,
        validated_with_ema=rendered_ema, validated_params_equal_raw=rendered_raw,
        expected_step_launches=list(expected_step), expected_validation_launches=list(expected_val),
        sec_per_step=[r["sec_per_step"] for r in tracked])
    log("train cli " + json.dumps({k: v for k, v in result.items() if k != "tracked"}))
    if [r["step"] for r in tracked] != [1, 2, 3] or [r["step"] for r in probe.steps] != [1, 2, 3]:
        raise AssertionError(f"the tracker logged steps {[r['step'] for r in tracked]}, expected 1, 2, 3")
    if any((r["fwd_launches"], r["bwd_launches"]) != tuple(expected_step) for r in probe.steps):
        raise AssertionError(f"steps launched {probe.steps}, expected {list(expected_step)} each")
    if len(probe.validations) != 1 or (probe.validations[0]["fwd_launches"],
                                       probe.validations[0]["bwd_launches"]) != expected_val:
        raise AssertionError(f"validation launched {probe.validations}, expected one with {list(expected_val)}")
    if not all(math.isfinite(r["train_loss"]) and math.isfinite(r["grad_norm"]) for r in tracked):
        raise AssertionError(f"non-finite loss or gradient norm: {tracked}")
    if not all(all(v) for v in loaded_equal.values()) or len(loaded_equal["unet"]) != 2:
        raise AssertionError(f"the loaded models differ from the checkpoint files: {loaded_equal}")
    want_frames = [(2 * pc.width, pc.height)]
    if (summary["screen"], len(summary["frames"]), result["gif"]["frame_sizes"], summary["loop"]) != (
            (2 * pc.width, pc.height), pc.num_frames, want_frames, 0) or result["gif"]["delays_cs"] != [10]:
        raise AssertionError(f"the validation GIF holds {result['gif']}")
    vals = (result["val_psnr"], result["val_ssim"])
    if not all(isinstance(v, float) and math.isfinite(v) for v in vals):
        raise AssertionError(f"validation scores {vals} are not finite")
    if abs(vals[0] - cpu_scores["psnr"]) > 1e-5 + 2e-6 * abs(cpu_scores["psnr"]) or \
            abs(vals[1] - cpu_scores["ssim"]) > 1e-5:
        raise AssertionError(f"validation scores {vals} differ from the CPU's {cpu_scores['psnr']}, "
                             f"{cpu_scores['ssim']}")
    if not rendered_ema or all(rendered_raw):
        raise AssertionError(f"validation did not render with the EMA parameters: equal to the EMA {rendered_ema}, "
                             f"to the raw parameters {rendered_raw}")
    if probe.resumed != [2] or [r["final_step"] for r in runs] != [2, 3] or not ema_carried:
        raise AssertionError(f"the resume did not start at step 2 with the checkpoint's EMA: resumed from "
                             f"{probe.resumed}, runs {runs}, EMA carried {ema_carried}")
    result["clip"] = (frames.numpy(), gt)
    # Nothing after this phase reads its checkpoints (22 GB). The card's machine counts every
    # byte a run writes to its disk; blocks freed here can take the later phases' writes.
    remove_later(os.path.join(out, "checkpoints"))
    return result


def sensitive_metric_net_(model, *inputs) -> dict:
    """Make a randomly drawn metric net's output depend on its input, as
    trained weights do, and return its state dict (CPU tensors, without batch
    norms' counters). Drawn at random, a deep net's output comes from its
    last biases alone. LPIPS' linear heads become non-negative (the lpips
    package clamps them so) and of order 1 instead of 1 / sqrt(channels).
    Each batch norm's shift is raised by 1 (most ReLUs pass) and its
    statistics are those of a pass over `inputs` in train mode, the
    variances then raised by a tenth of the layer's mean (no near-constant
    channel amplifies rounding)."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("lin"):
                p.abs_().mul_(p.shape[1] ** 0.5)
        norms = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
        if norms:
            for m in norms:
                m.bias += 1.0
                m.reset_running_stats()
                m.momentum = None  # a cumulative average: one pass gives that pass's statistics
            model.train()(*inputs)
            for m in norms:
                m.momentum = 0.1
                m.running_var += 0.1 * m.running_var.mean()
        model.eval()
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


def sensitive_metric_weights(gen, gt, dev, i3d_size: int = 224,
                             names: tuple = ("lpips", "inception_v4", "i3d")) -> dict:
    """{"lpips" | "inception_v4" [| "i3d"]: state dict}: the harness's
    random nets (seeded 0) among `names` made sensitive, on `dev`, to the
    (N, F, H, W, 3) [0, 1] videos they will score as the harness
    preprocesses them; I3D only where the videos are long enough for FVD."""
    import numpy as np
    import torch

    from evoworld_tpu_torch.eval import harness
    from evoworld_tpu_torch.eval.feature_nets import i3d_preprocess
    from evoworld_tpu_torch.eval.metrics import full_fp32

    nets = harness.FeatureNets(device=dev)
    videos = torch.from_numpy(np.concatenate([gen, gt])).to(dev)
    inputs = {"lpips": lambda: (), "inception_v4": lambda: (harness._inception_preprocess(videos.flatten(0, 1)),)}
    if videos.shape[1] >= 10:
        inputs["i3d"] = lambda: (i3d_preprocess(videos, i3d_size),)
    with full_fp32():
        return {name: sensitive_metric_net_(nets.net(name), *make()) for name, make in inputs.items()
                if name in names}


def eval_tolerance(metric: str, cpu_value: float) -> float:
    """Phase 13's limit on a metric's value on the card at one timestamp
    against the CPU's: SSIM 1e-5, PSNR 1e-5 + 2e-6 relative, the feature
    metrics EVAL_FEATURE_RTOL relative."""
    if metric == "ssim":
        return 1e-5
    if metric == "psnr":
        return 1e-5 + 2e-6 * abs(cpu_value)
    return EVAL_FEATURE_RTOL * abs(cpu_value)


def full_scores(dev, workdir: str, cli_out: str, overrides: tuple = ()) -> dict:
    """Phase 22: `export_mp4` writes navigated.mp4 and original.mp4 for two
    pairs under `<workdir>/scores` from phase 11's PNGs (the last segment of
    `run_unified` against its episode frames, the clip of
    `run_single_segment` against its GT), each decoded back by the port
    within ENCODE_LUMA_MAE of the frames written; with TF32 switched on,
    `calculate_scores.main` scores them on the card with metric nets made
    sensitive to the 64x64 frames it scores (`sensitive_metric_weights`,
    loaded by the CLI from `--runtime.metric_weights_dir`), each metric
    timed inside the CLI's own run; every score finite, the feature scores
    above EVAL_FEATURE_FLOOR, no flash launch. Then the last SCORES_CPU_FRAMES
    frames of each clip are written as files of their own (phase 13's cut),
    which `main` scores on the card and `main(..., device="cpu")` on the
    CPU, held to each other within phase 13's tolerances (SSIM 1e-5, PSNR
    1e-5 + 2e-6 relative, FVD and LPIPS EVAL_FEATURE_RTOL relative, per
    timestamp)."""
    import io
    import os

    import numpy as np
    import torch

    from evoworld_tpu_torch.cli import calculate_metrics, calculate_scores
    from evoworld_tpu_torch.config import EvoWorldConfig, apply_overrides
    from evoworld_tpu_torch.data.native_video import read_mp4, resize_linear_u8
    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from evoworld_tpu_torch.utils.video import export_mp4

    config = apply_overrides(EvoWorldConfig(), list(overrides))
    last = config.loop.num_segments - 1
    root, cut_root = os.path.join(workdir, "scores"), os.path.join(workdir, "scores_cut")
    layout = {"pair_000": (f"predictions_{last}", f"predictions_gt_{last}"),
              "pair_001": ("predictions", "predictions_gt")}
    files, seconds = [], dict(read_png=0.0, encode=0.0, decode=0.0, resize=0.0)
    decoded = {}
    for pair, subs in layout.items():
        os.makedirs(os.path.join(root, pair))
        os.makedirs(os.path.join(cut_root, pair))
        for name, sub in zip(("navigated.mp4", "original.mp4"), subs):
            t0 = time.perf_counter()
            frames = calculate_metrics.read_video_dir(os.path.join(cli_out, sub), config.pipeline.num_frames)
            frames = np.rint(frames * 255).astype(np.uint8)
            seconds["read_png"] += time.perf_counter() - t0
            path = os.path.join(root, pair, name)
            t0 = time.perf_counter()
            export_mp4(frames, path, fps=SCORES_FPS)
            seconds["encode"] += time.perf_counter() - t0
            export_mp4(frames[-SCORES_CPU_FRAMES:], os.path.join(cut_root, pair, name), fps=SCORES_FPS)
            t0 = time.perf_counter()
            back = read_mp4(path)
            seconds["decode"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            decoded[pair, name] = resize_linear_u8(back, 64, 64).astype(np.float32) / 255.0
            seconds["resize"] += time.perf_counter() - t0
            row = dict(file=f"{pair}/{name}", shape=list(back.shape), bytes=os.path.getsize(path))
            if back.shape == frames.shape:
                luma = np.array([0.299, 0.587, 0.114])
                row.update(luma_mae=float(np.abs((back.astype(np.float64) - frames) @ luma).mean()),
                           rgb_mae=float(np.abs(back.astype(np.int16) - frames).mean()))
            files.append(row)
    bad = [r for r in files if "luma_mae" not in r or r["luma_mae"] > ENCODE_LUMA_MAE]
    if bad:
        raise AssertionError(f"the port's decode of export_mp4's files misses the frames written: {bad}")
    n = min(v.shape[0] for v in decoded.values())  # as the CLI cuts them
    gen, gt = (np.stack([decoded[p, name][:n] for p in layout]) for name in ("navigated.mp4", "original.mp4"))
    t0 = time.perf_counter()
    weights = sensitive_metric_weights(gen, gt, dev, names=("lpips", "i3d"))  # the nets calculate_scores runs
    weights_dir = os.path.join(workdir, "scores_weights")
    os.makedirs(weights_dir)
    for name, sd in weights.items():
        torch.save(sd, os.path.join(weights_dir, f"{name}.pt"))
    weights_s = time.perf_counter() - t0
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    metric_s = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            metric_s[name] = time.perf_counter() - t0
            return out
        return run

    def score(data_root, device):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the CLI prints its scores.json
            out = calculate_scores.main([f"--data.root={data_root}", f"--runtime.metric_weights_dir={weights_dir}"],
                                        device=device)
        sync()
        return out, time.perf_counter() - t0

    names = {"fvd": "calculate_fvd_batch", "ssim": "calculate_ssim", "psnr": "calculate_psnr",
             "lpips": "calculate_lpips"}
    kept = {k: getattr(calculate_scores, f) for k, f in names.items()}
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    flash_attention.launches = flash_attention_backward.launches = 0
    try:
        for k, f in names.items():
            setattr(calculate_scores, f, timed(k, kept[k]))
        on_dev, cli_s = score(root, dev)
    finally:
        for k, f in names.items():
            setattr(calculate_scores, f, kept[k])
    try:
        cut_dev, cut_s = score(cut_root, dev)
        launches = [flash_attention.launches, flash_attention_backward.launches]
        flags_kept = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    cut_cpu, cpu_s = score(cut_root, "cpu")

    compared = {}
    for metric, ref in cut_cpu.items():
        got = cut_dev.get(metric, {"value": {}})["value"]
        errs = {t: abs(got.get(t, math.nan) - v) for t, v in ref["value"].items()}
        compared[metric] = dict(card=cut_dev.get(metric, {}).get("value_mean"), cpu=ref["value_mean"],
                                max_abs_err=max(errs.values()),
                                worst_rel_err=max(e / max(abs(ref["value"][t]), 1e-30) for t, e in errs.items()),
                                ok=all(e <= eval_tolerance(metric, ref["value"][t]) for t, e in errs.items()))
    result = dict(files=files, seconds=seconds, weights_seconds=weights_s, cli_seconds=cli_s,
                  metric_seconds=metric_s, videos=list(gen.shape), launches=launches,
                  scores={k: v["value_mean"] for k, v in on_dev.items()},
                  weights={k: v.get("weights") for k, v in on_dev.items()}, tf32_flags_kept=flags_kept,
                  cut_frames=SCORES_CPU_FRAMES, cut_card_seconds=cut_s, cut_cpu_seconds=cpu_s, compared=compared)
    log("scores " + json.dumps(result))
    want = {"fvd", "ssim", "psnr", "lpips"}
    finite = all(math.isfinite(r[k]["value_mean"]) for r in (on_dev, cut_dev) for k in r)
    if set(on_dev) != want or set(cut_dev) != want or set(cut_cpu) != want or not finite:
        raise AssertionError(f"scores.json holds {result['scores']} (the cut's {sorted(cut_dev)} on the card, "
                             f"{sorted(cut_cpu)} on the CPU), expected finite {sorted(want)}")
    if not all(abs(r[k]["value_mean"]) > EVAL_FEATURE_FLOOR for r in (on_dev, cut_dev) for k in ("fvd", "lpips")) or \
            {r[k]["weights"] for r in (on_dev, cut_dev) for k in ("fvd", "lpips")} != {"converted"}:
        raise AssertionError(f"feature scores {result['scores']} are not above {EVAL_FEATURE_FLOOR}, or the nets "
                             f"were not the sensitive ones ({result['weights']})")
    if not all(c["ok"] for c in compared.values()):
        raise AssertionError(f"calculate_scores on the card differs from the CPU: {compared}")
    if launches != [0, 0] or not flags_kept:
        raise AssertionError(f"the scoring launched the flash kernels {launches} times or changed the caller's "
                             f"TF32 flags")
    return result


def full_eval(dev, workdir: str, cli_out: str, clip, overrides: tuple = ()) -> dict:
    """Phase 13: the evaluation CLIs on the card with TF32 switched on (the
    harness must keep its own fp32). `calculate_metrics.main` scores three
    episodes laid out under `<workdir>/eval` from phases 11 and 12 (the last
    segment of `run_unified`, the clip of `run_single_segment`, the
    validation clip against its GT) with metric nets made sensitive to the
    first 2 episodes' last 10 frames (`sensitive_metric_weights`, loaded by
    the CLI from `--runtime.metric_weights_dir`); then those frames are
    scored on the card one metric at a time, each timed (its net built
    first), each feature metric above EVAL_FEATURE_FLOOR, and held against
    `calculate_all_metrics` of the same frames on the CPU (SSIM within 1e-5,
    PSNR within 1e-5 + 2e-6 relative, the feature metrics within
    EVAL_FEATURE_RTOL relative), the errors with the harness's guard made to
    do nothing reported beside them; `calculate_dreamsim.main` scores a pair
    in both variants on the card and on the CPU (above EVAL_FEATURE_FLOOR,
    within DREAMSIM_ATOL). No flash kernel may launch."""
    import os

    import numpy as np
    import torch

    from evoworld_tpu_torch.cli import calculate_dreamsim, calculate_metrics
    from evoworld_tpu_torch.cli.common import save_frames
    from evoworld_tpu_torch.config import EvoWorldConfig, apply_overrides
    from evoworld_tpu_torch.eval import harness
    from evoworld_tpu_torch.eval import metrics as metrics_module
    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward

    config = apply_overrides(EvoWorldConfig(), list(overrides))
    last = config.loop.num_segments - 1
    root = os.path.join(workdir, "eval")
    layout = {"episode_000": (f"predictions_{last}", f"predictions_gt_{last}"),
              "episode_001": ("predictions", "predictions_gt")}
    for name, (gen_dir, gt_dir) in layout.items():
        os.makedirs(os.path.join(root, name))
        os.symlink(os.path.join(cli_out, gen_dir), os.path.join(root, name, "predictions_2"))
        os.symlink(os.path.join(cli_out, gt_dir), os.path.join(root, name, "predictions_gt_2"))
    save_frames(clip[0], os.path.join(root, "episode_002", "predictions_2"))
    save_frames(clip[1], os.path.join(root, "episode_002", "predictions_gt_2"))
    videos = {sub: [calculate_metrics.read_video_dir(os.path.join(root, e, sub), config.pipeline.num_frames)
                    for e in sorted(os.listdir(root)) if e.startswith("episode_")]
              for sub in ("predictions_2", "predictions_gt_2")}
    n = min(v.shape[0] for vs in videos.values() for v in vs)  # as the CLI cuts them
    gen, gt = (np.stack([v[-n:] for v in videos[sub]]) for sub in ("predictions_2", "predictions_gt_2"))
    cut_gen, cut_gt = gen[:2, -10:], gt[:2, -10:]  # what the card and the CPU both score
    t0 = time.perf_counter()
    weights = sensitive_metric_weights(cut_gen, cut_gt, dev)
    weights_dir = os.path.join(workdir, "metric_weights")
    os.makedirs(weights_dir)
    for name, sd in weights.items():
        torch.save(sd, os.path.join(weights_dir, f"{name}.pt"))
    weights_s = time.perf_counter() - t0
    argv = [f"--data.root={root}", f"--pipeline.num_frames={config.pipeline.num_frames}",
            f"--runtime.metric_weights_dir={weights_dir}"]
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    flash_attention.launches = flash_attention_backward.launches = 0
    try:
        t0 = time.perf_counter()
        scores = calculate_metrics.main(argv, device=dev)
        sync()
        cli_s = time.perf_counter() - t0
        nets = harness.FeatureNets(weights, device=dev)
        for name in weights:  # built before the timing
            nets.net(name)
        metrics = {"fvd": lambda: harness.calculate_fvd_batch(cut_gen, cut_gt, nets)} if n >= 10 else {}
        metrics.update(
            ssim=lambda: harness.calculate_ssim(cut_gen, cut_gt, dev),
            psnr=lambda: harness.calculate_psnr(cut_gen, cut_gt, dev),
            lpips=lambda: harness.calculate_lpips(cut_gen, cut_gt, nets),
            latent_mse=lambda: harness.calculate_latent_mse(cut_gen, cut_gt, nets),
            loop_closure_latent_mse=lambda: harness.calculate_latent_mse(cut_gen[:, -1:], cut_gt[:, -1:], nets))
        on_dev, metric_s = {}, {}  # calculate_all_metrics' result, one timed metric at a time
        for name, fn in metrics.items():
            sync()
            t0 = time.perf_counter()
            on_dev[name] = fn()
            sync()
            metric_s[name] = time.perf_counter() - t0
        # What the harness's own fp32 buys: every metric again with its guard
        # (`full_fp32`) made to do nothing, so the caller's TF32 reaches it.
        # Reported beside the guarded errors, not checked.
        guard = metrics_module.full_fp32, harness.full_fp32
        metrics_module.full_fp32 = harness.full_fp32 = contextlib.nullcontext
        try:
            unguarded = {name: fn() for name, fn in metrics.items()}
        finally:
            metrics_module.full_fp32, harness.full_fp32 = guard
        pair = (os.path.join(root, "episode_000", "predictions_2", sorted(os.listdir(
            os.path.join(root, "episode_000", "predictions_2")))[0]),
            os.path.join(root, "episode_000", "predictions_gt_2", sorted(os.listdir(
                os.path.join(root, "episode_000", "predictions_gt_2")))[0]))
        dreamsim = {}
        for variant in ("dino_vitb16", "ensemble"):
            t0 = time.perf_counter()
            got = calculate_dreamsim.main([f"--data.root={pair[0]}:{pair[1]}", f"--runtime.dreamsim_variant={variant}"],
                                          device=dev)
            sync()
            dreamsim[variant] = dict(score=got["dreamsim"], weights=got["weights"], seconds=time.perf_counter() - t0)
        sync()
        launches = [flash_attention.launches, flash_attention_backward.launches]
        flags_kept = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    on_cpu = harness.calculate_all_metrics(cut_gen, cut_gt, nets=harness.FeatureNets(weights, device="cpu"))
    for variant in dreamsim:
        dreamsim[variant]["cpu_score"] = calculate_dreamsim.main(
            [f"--data.root={pair[0]}:{pair[1]}", f"--runtime.dreamsim_variant={variant}"], device="cpu")["dreamsim"]

    def worst_rel(got, ref):
        return max(abs(got["value"][t] - ref["value"][t]) / max(abs(ref["value"][t]), 1e-30) for t in ref["value"])

    compared = {}
    for metric, ref in on_cpu.items():
        got = on_dev[metric]
        compared[metric] = dict(card=got["value_mean"], cpu=ref["value_mean"], worst_rel_err=worst_rel(got, ref),
                                max_abs_err=max(abs(got["value"][t] - ref["value"][t]) for t in ref["value"]),
                                unguarded_worst_rel_err=worst_rel(unguarded[metric], ref))
    result = dict(cli_seconds=cli_s, weights_seconds=weights_s, videos=list(gen.shape), timed_videos=list(cut_gen.shape),
                  metric_seconds=metric_s, launches=launches,
                  scores={k: v["value_mean"] for k, v in scores.items() if isinstance(v, dict)},
                  weights={k: v.get("weights") for k, v in scores.items() if isinstance(v, dict)},
                  compared=compared, dreamsim=dreamsim, tf32_flags_kept=flags_kept)
    log("eval " + json.dumps(result))
    want = {"ssim", "psnr", "lpips", "latent_mse", "loop_closure_latent_mse"} | ({"fvd"} if n >= 10 else set())
    if set(result["scores"]) != want or not all(math.isfinite(v) for v in result["scores"].values()):
        raise AssertionError(f"eval_score.json holds {result['scores']}, expected finite {sorted(want)}")
    if set(on_cpu) != set(on_dev):
        raise AssertionError(f"card and CPU results differ in keys: {sorted(on_dev)} and {sorted(on_cpu)}")
    unresolved = {k: v for k, v in result["scores"].items()
                  if k in ("fvd", "lpips", "latent_mse", "loop_closure_latent_mse") and abs(v) <= EVAL_FEATURE_FLOOR}
    if unresolved or set(result["weights"].values()) != {None, "converted"}:
        raise AssertionError(f"feature metrics {unresolved} are not above {EVAL_FEATURE_FLOOR}, or the nets were "
                             f"not the sensitive ones ({result['weights']})")
    for metric, c in compared.items():
        if not all(abs(on_dev[metric]["value"][t] - v) <= eval_tolerance(metric, v)
                   for t, v in on_cpu[metric]["value"].items()):
            raise AssertionError(f"{metric} on the card differs from the CPU: {c}")
    for variant, d in dreamsim.items():
        if not (d["score"] > EVAL_FEATURE_FLOOR and abs(d["score"] - d["cpu_score"]) <= DREAMSIM_ATOL):
            raise AssertionError(f"dreamsim {variant} on the card {d['score']} differs from the CPU {d['cpu_score']}")
    if launches != [0, 0] or not flags_kept:
        raise AssertionError(f"the evaluation launched the flash kernels {launches} times or changed the caller's "
                             f"TF32 flags ({flags_kept})")
    return result


def random_u2net_state(seed: int) -> dict:
    """A full-width U^2-Net state (upstream names, no batch-norm counters)
    drawn on the host from a numpy seed, the same on every machine: He-scaled
    conv kernels, small biases, batch-norm affines near (1, 0)."""
    import numpy as np

    from evoworld_tpu_torch.memory.u2net import U2Net

    rng = np.random.default_rng(seed)
    state = {}
    for name, t in U2Net().state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if t.dim() == 4:
            value = rng.normal(size=t.shape) * np.sqrt(2.0 / np.prod(t.shape[1:]))
        elif name.endswith("running_var"):
            value = 1.0 + 0.1 * np.abs(rng.normal(size=t.shape))
        elif name.endswith("bn_s1.weight"):
            value = 1.0 + 0.1 * rng.normal(size=t.shape)
        else:
            value = 0.1 * rng.normal(size=t.shape)
        state[name] = value.astype(np.float32)
    return state


def sensitive_skyseg_onnx(path: str, crops, dev, seed: int) -> None:
    """Write `path`, a skyseg.onnx (by the port's ONNX writer) of a random
    full-width U^2-Net made sensitive to `crops`, (N, H, W, 3) in [0, 1], as
    the sky mask feeds them (resized to 320 x 320, ImageNet-normalized, in
    fp32): batch-norm statistics from a pass over them
    (`sensitive_metric_net_`), then the fused head scaled so that its logit
    over them has median 0 and range 40. The sigmoid then saturates below
    the median, as a trained net's does off the sky, and the mask (kept
    where the min-max normalized map floors to 0) covers part of each crop
    instead of the few pixels at a continuous map's minimum."""
    import torch

    from evoworld_tpu_torch.eval.metrics import full_fp32
    from evoworld_tpu_torch.memory import skyseg
    from evoworld_tpu_torch.memory.onnx_io import write_onnx_initializers
    from evoworld_tpu_torch.memory.u2net import U2Net
    from evoworld_tpu_torch.ops.resize import resize_half_pixel

    net = skyseg.load_u2net_state_(U2Net(), random_u2net_state(seed)).to(dev)
    crops = torch.as_tensor(crops).to(dev, torch.float32)
    mean, std = (torch.tensor(c, device=dev) for c in (skyseg._IMAGENET_MEAN, skyseg._IMAGENET_STD))
    logits = []
    with full_fp32(), torch.no_grad():
        x = ((resize_half_pixel(crops, (skyseg.NET_SIZE, skyseg.NET_SIZE)) - mean) / std).permute(0, 3, 1, 2)
        sensitive_metric_net_(net, x.contiguous())
        hook = net.outconv.register_forward_hook(lambda module, args, out: logits.append(out))
        net(x.contiguous())
        hook.remove()
        z = logits[0]
        scale = 40.0 / (z.max() - z.min()).clamp_min(1e-12)
        net.outconv.weight.mul_(scale)
        net.outconv.bias.sub_(z.median()).mul_(scale)
    write_onnx_initializers(path, {k: v.cpu().numpy() for k, v in net.state_dict().items()
                                   if not k.endswith("num_batches_tracked")})


def write_cube_captures(root: str, layout: str, frames: int, face: int, seed: int) -> None:
    """`frames` synthetic captures of six `face` x `face` PNG faces (smooth
    seeded colour fields with a little noise) in the Unity layout (a
    directory per frame) or the UE one (flat `<id>_<face>.png` files)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from evoworld_tpu_torch.data.engine import FACE_ORDER
    from evoworld_tpu_torch.data.native_io import save_png_batch

    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((frames * 6, 3, 8, 8), generator=g)
    fine = F.interpolate(coarse, size=(face, face), mode="bicubic", align_corners=False)
    fine = fine + 0.02 * torch.randn(fine.shape, generator=g)
    faces = (fine.clamp(0, 1) * 255).to(torch.uint8).permute(0, 2, 3, 1).numpy().reshape(frames, 6, face, face, 3)
    paths = []
    for i in range(frames):
        for name in FACE_ORDER:
            if layout == "unity":
                os.makedirs(os.path.join(root, f"{i:03d}"), exist_ok=True)
                paths.append(os.path.join(root, f"{i:03d}", f"{name}.png"))
            else:
                os.makedirs(root, exist_ok=True)
                paths.append(os.path.join(root, f"{i + 1}_{name}.png"))
    save_png_batch(paths, np.ascontiguousarray(faces.reshape(-1, face, face, 3)))


def tree_state(root: str) -> dict:
    """{path: (size, mtime_ns)} of every file under `root` (links followed)."""
    out = {}
    for d, _, files in os.walk(root, followlinks=True):
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    return out


def full_prep(dev, workdir: str, seed: int, overrides: tuple = (), cube_face: int = CUBE_FACE,
              mask_crops: int = 4) -> dict:
    """Phase 14: the data-preparation CLIs on phase 11's files in `workdir`
    (`episode_000/`, `svd/model.pt`). A dataset of three episodes under
    `<workdir>/prep`: `ep_1` holds phase 11's panoramas (linked) and camera
    file, `ep_0` and `ep_2` no crops. `cli.pano_to_pers.main` crops `ep_1`;
    `cli.reproject.main` with `--data.start_idx=1 --data.end_idx=2` renders
    it with the sky mask of a sensitive random U^2-Net (skyseg.onnx from
    the port's writer), then again over all three (nothing to do); the sky
    mask of `mask_crops` crops on `dev` against the CPU; `cli.cube_to_pano.main`
    on two frames of each capture layout at faces of `cube_face`, on `dev`
    against the CPU. `overrides` (CLI flags) cut the configuration down for a
    rehearsal off the card."""
    import shutil

    import numpy as np
    import torch

    from evoworld_tpu_torch.cli import cube_to_pano, pano_to_pers, reproject
    from evoworld_tpu_torch.cli.common import load_frames
    from evoworld_tpu_torch.config import EvoWorldConfig, apply_overrides
    from evoworld_tpu_torch.data.native_io import image_size
    from evoworld_tpu_torch.memory.skyseg import SkySegmentation
    from evoworld_tpu_torch.ops.attention import FLASH_MIN_SEQ
    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from evoworld_tpu_torch.runtime import VGGT_PRESETS

    config = apply_overrides(EvoWorldConfig(), list(overrides))
    loop_cfg, height, width = config.loop, config.pipeline.height, config.pipeline.width
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    prep = os.path.join(workdir, "prep")
    episode = os.path.join(prep, "ep_1")
    for name in ("ep_0", "ep_2"):
        os.makedirs(os.path.join(prep, name, "panorama"))
    os.makedirs(episode)
    os.symlink(os.path.join(workdir, "episode_000", "panorama"), os.path.join(episode, "panorama"))
    shutil.copy(os.path.join(workdir, "episode_000", "camera_poses.txt"), episode)
    result = {}

    t0 = time.perf_counter()
    n_crops = pano_to_pers.main([f"--data.root={episode}", *overrides], device=dev)
    sync()
    result["crops_s"] = time.perf_counter() - t0
    pers_dir = os.path.join(episode, "perspective_look_at_center")
    crop_paths = [os.path.join(pers_dir, n) for n in sorted(os.listdir(pers_dir))]
    n_frames = len(os.listdir(os.path.join(episode, "panorama")))
    crop_sizes = {image_size(p) for p in crop_paths}
    sources = n_frames - loop_cfg.num_target_view

    few = torch.from_numpy(np.stack(load_frames(crop_paths[:mask_crops])))
    onnx = os.path.join(workdir, "skyseg.onnx")
    t0 = time.perf_counter()
    sensitive_skyseg_onnx(onnx, few, dev, seed + 14)
    result["skyseg_write_s"] = time.perf_counter() - t0

    builds, renders = [], []
    build, render = reproject.build_reconstructor, reproject.render_memory_panoramas

    def counting_build(*args, **kwargs):  # keeps each build's seconds (the checkpoint's load)
        t0 = time.perf_counter()
        built = build(*args, **kwargs)
        sync()
        builds.append(time.perf_counter() - t0)
        return built

    def keeping_render(*args, **kwargs):
        renders.append(render(*args, **kwargs))
        return renders[-1]

    argv = [f"--data.root={prep}", f"--runtime.vggt_checkpoint={workdir}/svd/model.pt",
            "--runtime.allow_random_weights=false", f"--runtime.skyseg_onnx={onnx}", *overrides]
    reproject.build_reconstructor, reproject.render_memory_panoramas = counting_build, keeping_render
    try:
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        flash_attention.launches = flash_attention_backward.launches = 0
        t0 = time.perf_counter()
        first = reproject.main(argv + ["--data.start_idx=1", "--data.end_idx=2"], device=dev)
        sync()
        result["reproject_s"] = time.perf_counter() - t0
        launches = [flash_attention.launches, flash_attention_backward.launches]
        result["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev) if on_card else None
        before = tree_state(prep)
        flash_attention.launches = flash_attention_backward.launches = 0
        t0 = time.perf_counter()
        second = reproject.main(argv, device=dev)
        sync()
        result["rerun_s"] = time.perf_counter() - t0
        rerun_launches = [flash_attention.launches, flash_attention_backward.launches]
        unchanged = tree_state(prep) == before
    finally:
        reproject.build_reconstructor, reproject.render_memory_panoramas = build, render

    out_dir = os.path.join(episode, config.data.reprojection_name)
    names = sorted(os.listdir(out_dir))
    pngs = np.stack(load_frames([os.path.join(out_dir, n) for n in names])) if names else np.zeros((0,))
    panos = renders[0] if renders else torch.zeros(0)
    stages = first[0]["stage_seconds"] if first else {}
    expected = vggt_launches(sources, (loop_cfg.pers_height, loop_cfg.pers_width),
                             VGGT_PRESETS["tiny" if config.runtime.vggt_tiny else "full"], FLASH_MIN_SEQ) \
        if on_card else 0

    # the sky mask of a few crops on the card against the CPU
    t0 = time.perf_counter()
    card_masks = SkySegmentation(onnx, dev).sky_masks(few).cpu()
    sync()
    mask_s = time.perf_counter() - t0
    cpu_masks = SkySegmentation(onnx, "cpu").sky_masks(few)

    # cube_to_pano on both capture layouts, on the card against the CPU
    cube_flags = [f"--data.height={CUBE_PANO[0]}", f"--data.width={CUBE_PANO[1]}", *overrides]
    cube_hw = apply_overrides(EvoWorldConfig(), cube_flags).data
    cube = {}
    for layout in ("unity", "ue"):
        captures = os.path.join(workdir, "cubes", layout)
        write_cube_captures(captures, layout, 2, cube_face, seed + 15)
        outs = {}
        for where, d in (("dev", dev), ("cpu", torch.device("cpu"))):
            outs[where] = os.path.join(workdir, "cubes", f"{layout}_{where}")
            flags = [f"--data.root={captures}", f"--runtime.save_dir={outs[where]}", f"--data.engine={layout}"]
            t0 = time.perf_counter()
            written = cube_to_pano.main(flags + cube_flags, device=d)
            sync()
            cube[f"{layout}_{where}_s"] = time.perf_counter() - t0
        a, b = (np.stack(load_frames([os.path.join(outs[w], n) for n in sorted(os.listdir(outs[w]))]))
                for w in ("dev", "cpu"))
        cube[layout] = dict(panoramas=len(written), shape=list(a.shape[1:]),
                            flipped=float((a != b).any(-1).mean()), std=float(a.std()))

    result.update(
        pers_crops=n_crops, crop_sizes=sorted(crop_sizes), sources=sources,
        vggt_s=stages.get("reconstruct"), sky_mask_s=stages.get("sky_mask"), render_s=stages.get("render"),
        first_call=[(os.path.basename(r["episode"]), r["rendered"]) for r in first],
        second_call=[(os.path.basename(r["episode"]), r["rendered"]) for r in second],
        vggt_builds=len(builds), vggt_load_s=builds[0] if builds else None, launches=launches, expected=[expected, 0], rerun_launches=rerun_launches,
        rerun_wrote_nothing=unchanged, renders=len(names), render_shape=list(pngs.shape[1:]),
        render_finite=bool(torch.isfinite(panos).all()) if len(renders) else False,
        render_std=float(pngs.std()) if names else 0.0,
        render_coverage=float((pngs.sum(-1) > 0).mean()) if names else 0.0,
        sky_mask_card_s=mask_s, sky_share=float((card_masks == 0).float().mean()),
        sky_mask_flipped=float((card_masks != cpu_masks).float().mean()), cube_to_pano=cube)
    log("prep " + json.dumps(result))
    want_first = [("ep_1", True)]
    want_second = [("ep_0", False), ("ep_1", False), ("ep_2", False)]
    if n_crops != n_frames or crop_sizes != {(loop_cfg.pers_height, loop_cfg.pers_width)}:
        raise AssertionError(f"pano_to_pers wrote {n_crops} crops of {crop_sizes}, expected {n_frames} of "
                             f"{(loop_cfg.pers_height, loop_cfg.pers_width)}")
    if result["first_call"] != want_first or result["second_call"] != want_second or len(builds) != 1:
        raise AssertionError(f"reproject selected {result['first_call']} and {result['second_call']} with "
                             f"{len(builds)} VGGT builds, expected {want_first}, {want_second} and 1")
    if names != [f"{i:02d}.png" for i in range(loop_cfg.num_target_view)] or result["render_shape"] != [
            height, width, 3] or not result["render_finite"] or result["render_std"] <= 0:
        raise AssertionError(f"reproject rendered {names} of {result['render_shape']}, finite "
                             f"{result['render_finite']}, std {result['render_std']}")
    if launches != [expected, 0] or rerun_launches != [0, 0] or not unchanged:
        raise AssertionError(f"reproject launched the flash kernels {launches} times (expected {[expected, 0]}), "
                             f"its rerun {rerun_launches} times, rerun left the files unchanged: {unchanged}")
    if not (0.02 < result["sky_share"] < 0.98) or result["sky_mask_flipped"] > PREP_MASK_MAX_FLIPPED:
        raise AssertionError(f"the sky mask on the card: sky share {result['sky_share']}, "
                             f"{result['sky_mask_flipped']} flipped against the CPU")
    for layout in ("unity", "ue"):
        c = cube[layout]
        if c["panoramas"] != 2 or c["shape"] != [cube_hw.height, cube_hw.width, 3] or c["std"] <= 0 \
                or c["flipped"] > CUBE_MAX_FLIPPED:
            raise AssertionError(f"cube_to_pano {layout}: {c}")
    return result


def full_fp16(dev, steps: int, seed: int, workdir: str, overrides: tuple = ()) -> dict:
    """Phase 15, the fp16 path, on phase 11's and 14's files in `workdir`:
    phase 11's pipeline checkpoints (`svd/`, bf16) written as fp32 safetensors
    (`svd_fp32/`, the form upstream ships, kept for phase 16) and halved by
    `cli.convert_checkpoint halve` into `svd_fp16/` (other files copied);
    every F32 tensor must come out as its `.to(float16)` bit for bit and every
    other tensor unchanged. `cli.convert_checkpoint validate` must exit 0 on
    `svd_fp16/` and 1 on a copy whose UNet shards (written as headers alone)
    change one tensor's shape, naming that tensor. Then `cli_paths` at
    `--runtime.compute_dtype=float16` from `svd_fp16/`. `overrides` (CLI
    flags) cut the configuration down for a rehearsal off the card."""
    import contextlib
    import io
    import shutil

    import torch

    from evoworld_tpu_torch.cli import convert_checkpoint
    from evoworld_tpu_torch.models.weights import (
        load_safetensors,
        safetensors_shapes,
        save_safetensors,
        save_safetensors_header,
    )

    # 1. phase 11's checkpoints as fp32, halved to fp16 by the converter
    svd, svd32, svd16 = (os.path.join(workdir, d) for d in ("svd", "svd_fp32", "svd_fp16"))
    halve_s, exact, tensors = 0.0, True, 0
    t0 = time.perf_counter()
    for sub in ("unet", "vae", "image_encoder"):
        for d in (svd32, svd16):
            os.makedirs(os.path.join(d, sub))
        for name in sorted(os.listdir(os.path.join(svd, sub))):
            src = os.path.join(svd, sub, name)
            if not name.endswith(".safetensors"):  # the sub-model's config files
                for d in (svd32, svd16):
                    shutil.copy(src, os.path.join(d, sub))
                continue
            f32 = {k: v.float() if v.is_floating_point() else v for k, v in load_safetensors(src).items()}
            save_safetensors(f32, os.path.join(svd32, sub, name))
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                convert_checkpoint.halve(os.path.join(svd32, sub, name), os.path.join(svd16, sub, name), "fp16")
            halve_s += time.perf_counter() - t1
            out = load_safetensors(os.path.join(svd16, sub, name))
            for k, v in f32.items():
                want = v.to(torch.float16) if v.dtype == torch.float32 else v
                exact &= out[k].dtype == want.dtype and out[k].shape == want.shape and torch.equal(
                    out[k].reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))
            exact &= set(out) == set(f32)
            tensors += len(f32)
            del f32, out
    convert_s = time.perf_counter() - t0
    fp16_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(svd16) for f in fs)

    # 2. validate: the fp16 directory, and a copy with one tensor's shape changed
    def validate(path):  # (exit code, printed lines)
        printed, code = io.StringIO(), None
        with contextlib.redirect_stdout(printed):
            try:
                convert_checkpoint.main(["validate", path])
            except SystemExit as done:
                code = done.code
        return code, printed.getvalue()

    t0 = time.perf_counter()
    valid_code, valid_out = validate(svd16)
    validate_s = time.perf_counter() - t0
    bad = os.path.join(workdir, "svd_fp16_bad")
    os.makedirs(os.path.join(bad, "unet"))
    for sub in ("vae", "image_encoder"):
        os.symlink(os.path.join(svd16, sub), os.path.join(bad, sub))
    changed = "conv_out.weight"
    for name in sorted(os.listdir(os.path.join(svd16, "unet"))):
        shapes = safetensors_shapes(os.path.join(svd16, "unet", name))
        if changed in shapes:
            dtype, shape = shapes[changed]
            shapes[changed] = (dtype, (*shape[:-1], shape[-1] + 1))
        save_safetensors_header(shapes, os.path.join(bad, "unet", name))
    bad_code, bad_out = validate(bad)
    conv = dict(tensors=tensors, exact=exact, seconds=convert_s, halve_s=halve_s, fp16_bytes=fp16_bytes,
                validate_code=valid_code, validate_s=validate_s, validate_out=valid_out.splitlines(),
                changed=changed, bad_code=bad_code, bad_out=bad_out.splitlines())
    log("fp16 convert " + json.dumps(conv))
    if not exact or conv["validate_code"] != 0 or conv["bad_code"] != 1 or changed not in bad_out \
            or "unet: OK" in bad_out:
        raise AssertionError(f"the converter's halve or validate: {conv}")
    paths = cli_paths(dev, steps, seed, workdir, (*overrides, "--runtime.compute_dtype=float16"), svd16, "fp16")
    for d in (svd16, bad):  # read by nothing after this phase (phase 12's checkpoints: the same reason)
        remove_later(d)
    return dict(convert=conv, **paths)


def full_fp32(dev, steps: int, seed: int, workdir: str, overrides: tuple = ()) -> dict:
    """Phase 16, the fp32 path, on the files of phases 11, 14 and 15 in
    `workdir`: `cli_paths` at `--runtime.compute_dtype=float32` from phase
    15's `svd_fp32/` (phase 11's checkpoints as fp32 safetensors), every
    attention of 4096 tokens or more on the fp32 kernels. It runs under
    torch's default TF32 flags, the state a user of the CLIs gets (matmuls in
    full fp32, cuDNN convolutions in TF32), printed and restored after. On
    the card the training step tries FP32_TRAIN_FRAMES in turn while the
    card runs out of memory, the frames given up reported as the cut; on the
    CPU it takes the configuration's frames."""
    import torch

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True  # torch's defaults
    tf32 = dict(matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    log("fp32 tf32 flags " + json.dumps(tf32))
    try:
        paths = cli_paths(dev, steps, seed, workdir, (*overrides, "--runtime.compute_dtype=float32"),
                          os.path.join(workdir, "svd_fp32"), "fp32",
                          train_frames=FP32_TRAIN_FRAMES if dev.type == "cuda" else (None,))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return dict(tf32=tf32, **paths)


def cli_paths(dev, steps: int, seed: int, workdir: str, flags: tuple, clip_dir: str, tag: str,
              train_frames: tuple = (None,)) -> dict:
    """The CLI paths of phases 15 and 16 on phase 11's and 14's files in
    `workdir`, at the compute dtype `flags` name (`tag`), on `dev`:
    `cli.run_single_segment.main` from the checkpoints in `clip_dir` (5N + 18
    flash launches, finite frames, the PNGs' counts and sizes; the RMS
    difference from phase 11's bf16 clip is reported, not checked),
    `cli.train.main` for 2 steps from phase 11's `svd/` with no validation
    (`expected_train_launches` a step, finite losses and gradient norms,
    level-0 norm1's gradient nonzero), and `cli.reproject.main` on a fresh
    copy of phase 14's `prep/ep_1` without its renders (the VGGT launches,
    finite renders that are not one value); seconds and peak memory of each.
    The training runs at the first frame count of `train_frames` (None: the
    configuration's) that does not run the card out of memory."""
    import gc
    import shutil

    import numpy as np
    import torch

    from evoworld_tpu_torch.cli import reproject, run_single_segment
    from evoworld_tpu_torch.cli import train as train_cli
    from evoworld_tpu_torch.cli.common import load_frames
    from evoworld_tpu_torch.config import EvoWorldConfig, apply_overrides
    from evoworld_tpu_torch.data.native_io import image_size
    from evoworld_tpu_torch.ops.attention import FLASH_MIN_SEQ
    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from evoworld_tpu_torch.runtime import PRESETS, VGGT_PRESETS

    config = apply_overrides(EvoWorldConfig(), list(flags))
    pc, loop_cfg = config.pipeline, config.loop
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    svd = os.path.join(workdir, "svd")

    def reset():
        flash_attention.launches = flash_attention_backward.launches = 0
        if on_card:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def launches():
        return [flash_attention.launches, flash_attention_backward.launches]

    def peak():
        return torch.cuda.max_memory_allocated(dev) if on_card else None

    # 1. the single-segment CLI from `clip_dir`
    episode = os.path.join(workdir, "episode_000")
    frames = []
    navigator = run_single_segment.Navigator

    class Keeping(navigator):
        def generate_segment(self, *args, **kwargs):
            frames.append(super().generate_segment(*args, **kwargs))
            return frames[-1]

    argv = [f"--data.root={episode}", f"--runtime.checkpoint_dir={clip_dir}", "--runtime.allow_random_weights=false",
            f"--pipeline.num_steps={steps}", f"--runtime.seed={seed}", f"--runtime.save_dir={workdir}/out_{tag}",
            *flags]
    reset()
    run_single_segment.Navigator = Keeping
    try:
        t0 = time.perf_counter()
        single = run_single_segment.main(argv, device=dev)[0]
        sync()
        single_s = time.perf_counter() - t0
    finally:
        run_single_segment.Navigator = navigator
    single_launches, single_peak = launches(), peak()
    clip = frames[0].float().cpu()

    def pngs(path):
        names = sorted(os.listdir(path))
        return len(names), sorted({image_size(os.path.join(path, n))[::-1] for n in names})

    got_pngs = {sub: pngs(os.path.join(single["out_dir"], sub)) for sub in ("predictions", "predictions_gt")}
    want_pngs = {sub: (pc.num_frames, [(pc.width, pc.height)]) for sub in got_pngs}
    bf16_dir = os.path.join(workdir, "out", os.path.basename(episode), "predictions")
    read = lambda d: np.stack(load_frames([os.path.join(d, n) for n in sorted(os.listdir(d))]))  # noqa: E731
    bf16_rms = float(np.sqrt(np.mean((read(os.path.join(single["out_dir"], "predictions")) - read(bf16_dir)) ** 2)))
    del frames

    # 2. two training steps from phase 11's checkpoints, no validation
    out = os.path.join(workdir, f"train_{tag}")
    layers = PRESETS[config.runtime.model_preset][0].layers_per_block
    cut = []  # (frames, the out-of-memory message) of each count that did not fit
    for at, want_frames in enumerate(train_frames):
        train_frame_count = want_frames or config.data.sequence_length
        train_argv = [f"--data.root={episode}", f"--runtime.checkpoint_dir={svd}",
                      "--runtime.allow_random_weights=false", f"--runtime.save_dir={out}", f"--runtime.seed={seed}",
                      "--train.total_steps=2",
                      "--train.warmup_steps=1", "--trainer.log_steps=1", *flags,
                      f"--data.sequence_length={train_frame_count}"]
        probe = TrainProbe(dev, (flash_attention, flash_attention_backward))
        reset()
        probe.last = probe._counts()
        out_of_memory = None
        with probe.installed():
            t0 = time.perf_counter()
            try:
                state = train_cli.main(train_argv, device=dev)
                sync()
            except torch.cuda.OutOfMemoryError as e:
                if at + 1 == len(train_frames):
                    raise
                out_of_memory = str(e).splitlines()[0]
            train_s = time.perf_counter() - t0
        if out_of_memory is None:
            break
        cut.append([train_frame_count, out_of_memory])
        log(f"{tag} training: {train_frame_count} frames ran out of device memory ({out_of_memory}); "
            f"next {train_frames[at + 1]}")
        shutil.rmtree(out, ignore_errors=True)
    with open(os.path.join(out, "train_metrics.jsonl")) as f:
        tracked = [json.loads(line) for line in f]
    norm1 = state.unet.down_blocks[0].attentions[0].transformer_blocks[0].norm1.weight.grad
    norm1_max = float(norm1.abs().max()) if norm1 is not None else 0.0
    expected_step = expected_train_launches(train_frame_count, config.train.vae_encode_chunk, layers) \
        if on_card else (0, 0)
    del state
    remove_later(os.path.join(out, "checkpoints"))  # the final save's, which nothing reads

    # 3. reproject on a fresh copy of phase 14's episode (its renders left out)
    src_ep = os.path.join(workdir, "prep", "ep_1")
    ep = os.path.join(workdir, f"prep_{tag}", "ep_1")
    os.makedirs(ep)
    for name in os.listdir(src_ep):
        if name != config.data.reprojection_name:
            os.symlink(os.path.join(src_ep, name), os.path.join(ep, name))
    renders = []
    render = reproject.render_memory_panoramas

    def keeping_render(*args, **kwargs):
        renders.append(render(*args, **kwargs))
        return renders[-1]

    prep_argv = [f"--data.root={ep}", f"--runtime.vggt_checkpoint={svd}/model.pt",
                 "--runtime.allow_random_weights=false", f"--runtime.skyseg_onnx={workdir}/skyseg.onnx", *flags]
    reset()
    reproject.render_memory_panoramas = keeping_render
    try:
        t0 = time.perf_counter()
        records = reproject.main(prep_argv, device=dev)
        sync()
        reproject_s = time.perf_counter() - t0
    finally:
        reproject.render_memory_panoramas = render
    prep_launches, prep_peak = launches(), peak()
    rendered = read(os.path.join(ep, config.data.reprojection_name))
    sources = len(os.listdir(os.path.join(ep, "panorama"))) - loop_cfg.num_target_view
    expected_prep = vggt_launches(sources, (loop_cfg.pers_height, loop_cfg.pers_width),
                                  VGGT_PRESETS["tiny" if config.runtime.vggt_tiny else "full"], FLASH_MIN_SEQ) \
        if on_card else 0
    stages = records[0]["stage_seconds"] if records else {}

    result = dict(
        single=dict(seconds=single_s, load_s=single["load_s"], generate_s=single["generate_s"], num_steps=steps,
                    launches=single_launches, expected=[5 * steps + 18 if on_card else 0, 0],
                    finite=bool(torch.isfinite(clip).all()), shape=list(clip.shape), pngs=got_pngs,
                    rms_from_bf16_clip=bf16_rms, peak_memory_bytes=single_peak),
        train=dict(seconds=train_s, frames=train_frame_count, cut=cut, steps=probe.steps,
                   losses=[r["train_loss"] for r in tracked], grad_norms=[r["grad_norm"] for r in tracked],
                   sec_per_step=[r["sec_per_step"] for r in tracked], expected_step_launches=list(expected_step),
                   norm1_grad_abs_max=norm1_max, saves=probe.saves),
        reproject=dict(seconds=reproject_s, vggt_s=stages.get("reconstruct"), launches=prep_launches,
                       expected=[expected_prep, 0], renders=len(rendered), render_shape=list(rendered.shape[1:]),
                       render_finite=bool(all(torch.isfinite(r).all() for r in renders)) and bool(renders),
                       render_std=float(rendered.std()), peak_memory_bytes=prep_peak))
    log(f"{tag} " + json.dumps(result))
    s = result["single"]
    if s["launches"] != s["expected"] or not s["finite"] or got_pngs != want_pngs:
        raise AssertionError(f"the {tag} clip launched {s['launches']} (expected {s['expected']}), finite "
                             f"{s['finite']}, wrote {got_pngs} (expected {want_pngs})")
    t = result["train"]
    if [r["step"] for r in tracked] != [1, 2] or any(
            (r["fwd_launches"], r["bwd_launches"]) != tuple(expected_step) for r in probe.steps):
        raise AssertionError(f"{tag} training logged {tracked} and launched {probe.steps}, expected "
                             f"{list(expected_step)} a step")
    if not all(math.isfinite(v) for v in t["losses"] + t["grad_norms"]) or not norm1_max > 0:
        raise AssertionError(f"{tag} training: losses {t['losses']}, gradient norms {t['grad_norms']}, "
                             f"level-0 norm1 gradient {norm1_max}")
    r = result["reproject"]
    if r["launches"] != r["expected"] or r["renders"] != loop_cfg.num_target_view or not r["render_finite"] \
            or not r["render_std"] > 0:
        raise AssertionError(f"{tag} reproject: {r}, expected {r['expected']} launches and "
                             f"{loop_cfg.num_target_view} renders")
    return result


def full_tools(dev, steps: int, seed: int, workdir: str, cloud: dict, overrides: tuple = ()) -> dict:
    """Phase 17, the last single-card tools, on phase 11's files in `workdir`
    and phase 10's first VGGT cloud: `cli.validate_parity.main` at full width
    (phase 11's `svd/` and `model.pt`, its episode, N steps, PSNR and LPIPS
    on random LPIPS features, `--parity.dry_run`) against phase 11's own
    single-segment frames (the gate must pass, 5N + 18 launches) and against
    them perturbed (it must exit with code 1, the JAX CLI's); then the cloud
    (its first EXPORT_POINTS points) written by `memory/export.py` as PLY
    and OBJ, each file's seconds and
    bytes, and its header and first line read back."""
    import os

    import numpy as np
    import torch

    from evoworld_tpu_torch.cli import validate_parity
    from evoworld_tpu_torch.cli.common import save_frames
    from evoworld_tpu_torch.cli.calculate_metrics import read_video_dir
    from evoworld_tpu_torch.memory.export import save_obj, save_ply
    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward

    on_card = dev.type == "cuda"
    own = os.path.join(workdir, "out", "episode_000", "predictions")  # phase 11's run_single_segment frames
    frames = read_video_dir(own, len(os.listdir(own)))
    rng = np.random.default_rng(seed)
    bad = os.path.join(workdir, "parity_perturbed")
    save_frames(np.clip(frames + rng.normal(scale=0.2, size=frames.shape), 0, 1), bad)
    argv = [f"--data.root={workdir}/episode_000", f"--runtime.svd_checkpoint={workdir}/svd",
            f"--runtime.vggt_checkpoint={workdir}/svd/model.pt", "--runtime.allow_random_weights=false",
            f"--pipeline.num_steps={steps}", f"--runtime.seed={seed}", f"--runtime.save_dir={workdir}/parity",
            "--parity.dry_run=true", *overrides]
    runs = {}
    for label, ref in (("own_frames", own), ("perturbed", bad)):
        flash_attention.launches = flash_attention_backward.launches = 0
        t0 = time.perf_counter()
        try:
            gate = validate_parity.main(argv + [f"--parity.reference_frames={ref}"], device=dev)
            code = 0
        except SystemExit as e:  # the gate's FAIL: checked against the JAX CLI's code below
            gate, code = None, e.code
        runs[label] = dict(seconds=time.perf_counter() - t0, exit_code=code,
                           launches=[flash_attention.launches, flash_attention_backward.launches],
                           scores=gate and {k: gate[k] for k in ("ours", "theirs")})
    expected = [5 * steps + 18 if on_card else 0, 0]
    points, colors = cloud["world_points"][:EXPORT_POINTS], cloud["colors"][:EXPORT_POINTS]
    files = {}
    for name, write in (("cloud.ply", save_ply), ("cloud.obj", save_obj)):
        path = os.path.join(workdir, name)
        t0 = time.perf_counter()
        write(points, colors, path)
        seconds = time.perf_counter() - t0
        with open(path) as f:
            head = [f.readline() for _ in range(10 if name.endswith(".ply") else 1)]
        files[name] = dict(seconds=seconds, bytes=os.path.getsize(path), points=int(points.shape[0]),
                           first_lines=head[-1:] if name.endswith(".obj") else head[2:3] + head[-1:])
        os.remove(path)
    result = dict(validate_parity=runs, expected_launches=expected, export=files)
    log("tools " + json.dumps(result))
    if runs["own_frames"]["exit_code"] != 0 or runs["perturbed"]["exit_code"] != 1:
        raise AssertionError(f"the parity gate did not pass against its own frames and fail (code 1) against "
                             f"perturbed ones: {runs}")
    if any(r["launches"] != expected for r in runs.values()):
        raise AssertionError(f"validate_parity launched the flash kernels {[r['launches'] for r in runs.values()]} "
                             f"times, expected {expected}")
    if files["cloud.ply"]["first_lines"][0] != f"element vertex {points.shape[0]}\n":
        raise AssertionError(f"the PLY header is {files['cloud.ply']['first_lines']}")
    if not torch.isfinite(points).all():
        raise AssertionError("the exported cloud is not finite")
    return result


@contextlib.contextmanager
def kept_memory_renders():
    """The inputs of every memory render the loop makes while the context is
    active, kept on the host in a list (the render itself is unchanged)."""
    from evoworld_tpu_torch.loop import unified

    render, kept = unified.render_memory_panoramas, []

    def keeping(points, colors, valid, target_c2w, height, width, **kwargs):
        kept.append(dict(points=points.cpu(), colors=colors.cpu(), valid=valid.cpu(), target_c2w=target_c2w.cpu(),
                         height=height, width=width))
        return render(points, colors, valid, target_c2w, height, width, **kwargs)

    unified.render_memory_panoramas = keeping
    try:
        yield kept
    finally:
        unified.render_memory_panoramas = render


@contextlib.contextmanager
def kept_latents(pipe):
    """The denoised latents each call of `pipe` decodes, kept on the host in
    a list while the context is active (the decode itself is unchanged)."""
    kept = []

    def keeping(latents):
        kept.append(latents.cpu())
        return type(pipe).decode(pipe, latents)

    pipe.decode = keeping
    try:
        yield kept
    finally:
        del pipe.decode


def gate_rank_keeping_renders(mesh, n_devices: int) -> dict:
    """`parallel.checks.gate_rank` with its memory renders' inputs kept (a
    rank function of phase 18(b), spawned as `chip_smoke:...`)."""
    from evoworld_tpu_torch.parallel import checks

    with kept_memory_renders() as kept:
        out = checks.gate_rank(mesh, n_devices)
    return dict(out, renders=kept)


def splat_coords(points, c2w, height: int, width: int):
    """Each point's distance from the camera and its pixel coordinates (v, u)
    before the floor, as `ops/splat.py` computes them for one pose of
    `render_memory_panoramas` (its rotation divided by its column norm
    first); the point's pixel is (floor(v) clamped, floor(u))."""
    import torch

    from evoworld_tpu_torch.geometry.pose import invert_pose

    rot = c2w[:, :3]
    pose = torch.cat([rot / torch.clamp(torch.linalg.norm(rot[:, 0]), min=1e-12), c2w[:, 3:]], dim=-1)
    w2c = invert_pose(pose.float())
    p_cam = points.float() @ w2c[:3, :3].T + w2c[:3, 3]
    depth = torch.linalg.norm(p_cam, dim=-1)
    d = p_cam / torch.clamp(depth, min=1e-12)[:, None]
    u = (torch.atan2(d[:, 0], d[:, 2]) / (2.0 * math.pi) + 0.5) * width
    v = (torch.asin(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi + 0.5) * height
    return depth, v, u


def memory_flip_reading(ref: dict, got: dict, ref_memory, got_memory, dev, atol: float = 3e-2, rows: int = 8
                        ) -> dict:
    """Where two runs' memory renders differ by more than `atol`, what
    changed at each such pixel. `ref` and `got` are the renders' inputs
    (`kept_memory_renders`), the memories (T, H, W, 3) what they rendered.
    Each side is rendered again on `dev` with point indices for colours, so
    the winning splat of every pixel is known on each side (`winners_reproduce`
    says whether the winners' colours are the memories'). Of the one or two
    winners of a flipped pixel, the kind of flip is: `same_winner` (its
    colour moved), `validity` (a winner inside the confidence mask on one
    side only), `pixel_edge` (a winner whose 2 x 2 footprint covers the
    pixel on one side only: its projected coordinates crossed a pixel edge),
    `depth_order` (both winners cover it and are valid on both sides: the
    nearer one changed) or `other`. Each row gives the winners' coordinates
    before the floor on both sides, and their distances' relative gap; the
    summary, for the winners whose pixel changed, the largest move of their
    coordinates in pixels and their nearest approach to the edge they
    crossed, beside the splat's depth quantum (the relative step of its
    log-depth key) and the largest relative move of any point."""
    import torch

    from evoworld_tpu_torch.memory.render import render_memory_panoramas
    from evoworld_tpu_torch.ops.splat import _depth_bits_for

    side = [{k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in r.items()} for r in (ref, got)]
    mems = [m.to(dev).float() for m in (ref_memory, got_memory)]
    flipped = ((mems[0] - mems[1]).abs() > atol).any(-1)
    height, width = side[0]["height"], side[0]["width"]
    n = side[0]["points"].shape[0]
    index = torch.arange(1, n + 1, dtype=torch.float32, device=dev)[:, None].expand(n, 3)
    win = [render_memory_panoramas(s["points"], index, s["valid"], s["target_c2w"], height, width)[..., 0].long() - 1
           for s in side]
    reproduce = all(bool(torch.equal(torch.where((w >= 0)[..., None], s["colors"].float()[w.clamp(min=0)],
                                                 torch.zeros_like(m)), m))
                    for w, s, m in zip(win, side, mems))
    kinds, table, crossed = {}, [], {}  # crossed: point -> (move, distance to the edge), in pixels
    for t, y, x in flipped.nonzero().tolist():
        pair = [win[0][t, y, x].item(), win[1][t, y, x].item()]
        row = dict(view=t, pixel=[y, x], color_diff=(mems[0][t, y, x] - mems[1][t, y, x]).abs().max().item(),
                   winners=pair)
        ids = sorted({i for i in pair if i >= 0})
        if pair[0] == pair[1]:
            row["kind"] = "same_winner"
        else:
            coords = [splat_coords(s["points"][ids], s["target_c2w"][t], height, width) for s in side]
            pix = [torch.stack([c[1].floor().clamp(0, height - 1), c[2].floor() % width], -1).long() for c in coords]
            covers = [[(0 <= y - pv < 2) and (x - pu) % width < 2 for pv, pu in p.tolist()] for p in pix]
            valid = [[bool(s["valid"][i]) for i in ids] for s in side]
            row.update(points=ids, valid=valid, covers=covers,
                       coords=[torch.stack([c[1], c[2]], -1).tolist() for c in coords])
            if len(ids) == 2:
                row["depth_gap"] = [abs(c[0][1] - c[0][0]).item() / c[0][0].item() for c in coords]
            for j in range(len(ids)):
                for axis in (0, 1):
                    a_, b_ = coords[0][1 + axis][j].item(), coords[1][1 + axis][j].item()
                    if math.floor(a_) != math.floor(b_):
                        edge = max(math.floor(a_), math.floor(b_))
                        crossed[ids[j]] = (abs(a_ - b_), min(abs(a_ - edge), abs(b_ - edge)))
            if valid[0] != valid[1]:
                row["kind"] = "validity"
            elif covers[0] != covers[1]:
                row["kind"] = "pixel_edge"
            elif len(ids) == 2 and all(valid[0] + valid[1] + covers[0] + covers[1]):
                row["kind"] = "depth_order"
            else:
                row["kind"] = "other"
        kinds[row["kind"]] = kinds.get(row["kind"], 0) + 1
        if len(table) < rows:
            table.append(row)
    ok = side[0]["valid"]
    depth = torch.stack([splat_coords(side[0]["points"][ok], c2w, height, width)[0] for c2w in side[0]["target_c2w"]])
    levels = (1 << _depth_bits_for(height * width)) - 1
    both = side[0]["valid"] & side[1]["valid"]
    shift = (side[0]["points"] - side[1]["points"]).norm(dim=-1) / side[0]["points"].norm(dim=-1).clamp(min=1e-12)
    return dict(flipped=int(flipped.sum()), pixels=int(flipped.numel()), kinds=kinds, winners_reproduce=reproduce,
                edge_crossings=len(crossed), max_edge_move_px=max((m for m, _ in crossed.values()), default=None),
                max_edge_distance_px=max((e for _, e in crossed.values()), default=None),
                depth_quantum=math.expm1((depth.log().amax(-1) - depth.log().amin(-1)).max().item() / levels),
                max_point_shift=shift[both].max().item() if both.any() else None,
                validity_changed=int((side[0]["valid"] != side[1]["valid"]).sum()), rows=table)


def segment_agreement(ref, got) -> dict:
    """A segment against another run's by the composed gate's rule
    (`parallel/checks.py::assert_episode_close`: at least 99% of pixels
    within 3e-2 and none more than 0.2 away), with the relative RMS error."""
    d = (got.float() - ref.float()).abs()
    out = dict(share_within_3e_2=(d <= 3e-2).float().mean().item(), max_abs=d.max().item(),
               rel_rms=((d.pow(2).mean() / ref.float().pow(2).mean()).sqrt()).item())
    out["passes"] = out["share_within_3e_2"] >= 0.99 and out["max_abs"] <= 0.2
    return out


def sharded_clip_launches(steps: int, cfg, world: int) -> int:
    """Flash launches of one rank's share of a clip: the UNet's level-0
    attention (5 a step, on the rank's frames, both halves), and the VAE's mid-block
    attention once for each of its ceil(chunks / W) encode and decode chunks."""
    encode_chunks, decode_chunks = (cfg.num_frames + 1) // cfg.encode_chunk, cfg.num_frames // cfg.decode_chunk
    return 5 * steps + math.ceil(encode_chunks / world) + math.ceil(decode_chunks / world)


def clip_rank(mesh, steps: int, seed: int) -> dict:
    """Phase 5's clip (full width, bf16, N = `steps`, random weights, inputs
    and draws from `seed`) with the frames split over `mesh`'s data axis, on
    this rank: its frames, seconds, stage seconds, peak memory, flash
    launches (counted from 0 around the clip alone), the clip's shape,
    finiteness and SHA-256 (the ranks' clips are compared by it), and on rank
    0 the frames and the denoised latents on the host. Phase 21's rank
    function."""
    import hashlib

    import torch

    from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
    from evoworld_tpu_torch.parallel.checks import _launch_counts, _reset_launch_counts
    from evoworld_tpu_torch.runtime import build_pipeline

    dev = mesh.device
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # as `main` runs phase 5
    cfg = PipelineConfig(num_steps=steps)
    pipe = build_pipeline(cfg, "full", seed=seed, compute_dtype=torch.bfloat16, device=dev, mesh=mesh)
    image, plucker, memory = clip_inputs(cfg, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    _reset_launch_counts()
    t0 = time.perf_counter()
    with kept_latents(pipe) as latents:
        frames = pipe(image, plucker, memory, generator=g, timings=timings)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    shard = pipe.frame_shard
    out = dict(rank=mesh.rank, world_size=mesh.size, data=mesh.data, model=mesh.model,
               frames=[shard.start, shard.stop], seconds=seconds, stage_seconds=timings,
               peak_memory_bytes=torch.cuda.max_memory_allocated(dev), launches=_launch_counts(),
               shape=list(frames.shape), finite=bool(torch.isfinite(frames).all()),
               sha256=hashlib.sha256(frames.contiguous().cpu().numpy().tobytes()).hexdigest(),
               clip=frames.cpu() if mesh.rank == 0 else None, latents=latents[0] if mesh.rank == 0 else None)
    del pipe, frames
    torch.cuda.empty_cache()
    return out


def episode_rank_tf32_off(mesh, *args) -> dict:
    """Phase 18(c)'s rank: `parallel/checks.py::episode_rank` with TF32 off,
    as `main` runs phase 10, whose first segment it is held to."""
    import torch

    from evoworld_tpu_torch.parallel.checks import episode_rank

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return episode_rank(mesh, *args)


def clip_reading(one_process: dict, ranks: list, steps: int, expected_launches: list) -> dict:
    """The ranks' `clip_rank` records against the one-process clip
    `one_process` (phase 5's frames and latents): the ranks' frames,
    seconds, peaks and launches, whether every rank's clip is finite and the
    same (SHA-256), rank 0's clip by `segment_agreement` and the same frames
    rolled by one decode chunk (which must fail it), and rank 0's denoised
    latents against the one-process clip's (max and relative RMS error:
    where the two clips part, before or in the decode)."""
    import torch

    from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig

    got = ranks[0]["clip"]
    d = (ranks[0]["latents"] - one_process["latents"]).abs()
    return dict(world_size=ranks[0]["world_size"], steps=steps, expected_launches=expected_launches,
                ranks=[{k: v for k, v in r.items() if k not in ("clip", "latents", "sha256")} for r in ranks],
                ranks_equal=len({r["sha256"] for r in ranks}) == 1 and all(r["finite"] for r in ranks),
                vs_one_process=segment_agreement(one_process["frames"], got),
                rolled_by_a_decode_chunk=segment_agreement(
                    one_process["frames"], torch.roll(got, PipelineConfig().decode_chunk, 0)),
                latents_vs_one_process=dict(max_abs=d.max().item(), rel_rms=(
                    d.pow(2).mean() / one_process["latents"].pow(2).mean()).sqrt().item()))


def check_clip_reading(reading: dict, label: str) -> None:
    """Phase 21's gate on a `clip_reading`: the ranks' clips
    finite and equal, every rank's launches as expected, rank 0's clip the
    one-process clip's by the gate's rule, and the rolled clip not."""
    launches = [r["launches"] for r in reading["ranks"]]
    if not reading["ranks_equal"]:
        raise AssertionError(f"{label}: the ranks' clips are not finite or differ: {reading}")
    if any(x != reading["expected_launches"] for x in launches):
        raise AssertionError(f"{label}: the ranks launched {launches}, expected {reading['expected_launches']}")
    if not (reading["vs_one_process"]["passes"] and not reading["rolled_by_a_decode_chunk"]["passes"]):
        raise AssertionError(f"{label}: the clip is not the one-process clip by the gate's rule, or the rule "
                             f"cannot tell a misplaced decode chunk: {reading}")


def prestart(workdir: str, name: str, world: int, mesh_model: int = 1):
    """`world` ranks of a later phase on the card started now, with no call
    (`parallel/launch.py::Ranks`): they import torch and the port and bring
    their group up while this process still runs an earlier phase (~0.5 GB
    of the card each meanwhile), and wait for the phase's `call`."""
    from evoworld_tpu_torch.parallel.launch import Ranks

    return Ranks(None, world, os.path.join(workdir, name), device="cuda", mesh_model=mesh_model, threads=2)


def mesh_gate(dev, workdir: str, ranks=None) -> dict:
    """Phase 18(b): the composed loop gate's episode on two ranks sharing
    `dev` (over gloo) against one rank in this process, teacher-forced at the
    memory and free-running, with the reading of the free runs' parting
    (`memory_flip_reading`, and the one-rank episode fed its own memory with
    only the flipped pixels taken from the ranks'); the teacher-forced and
    the swapped episodes must pass the gate. Runs on the CPU too (no flash
    launches there). `ranks`: two ranks started ahead (`prestart`)."""
    import torch

    from evoworld_tpu_torch.parallel import checks
    from evoworld_tpu_torch.parallel.launch import Ranks
    from evoworld_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    if ranks is None:
        ranks = Ranks("chip_smoke:gate_rank_keeping_renders", 2, os.path.join(workdir, "gate"), device=dev.type,
                      args=(2,), threads=2 if dev.type == "cuda" else 1, timeout=600)
    else:
        ranks.call("chip_smoke:gate_rank_keeping_renders", (2,), timeout=600)
    one = make_mesh(dev)  # W = 1: the same routes on one rank (the flash kernel on every head)
    with kept_memory_renders() as one_renders:
        free = checks.run_composed_loop(2, one, dev)
    gate_ranks = ranks.results()
    forced = checks.run_composed_loop(2, one, dev, memories=gate_ranks[0]["loop"]["memories"])
    free_memory, ranks_memory = free["memories"][0], gate_ranks[0]["loop"]["memories"][0]
    flips = memory_flip_reading(one_renders[0], gate_ranks[0]["renders"][0], free_memory, ranks_memory, dev)
    swapped_memory = torch.where(((free_memory - ranks_memory).abs() > 3e-2).any(-1, keepdim=True), ranks_memory,
                                 free_memory)
    swapped = checks.run_composed_loop(2, one, dev, memories=[swapped_memory])

    def compare(ref, got):
        out = {}
        for k in ("segments", "memories"):
            d = [(a - b).abs() for a, b in zip(ref[k], got[k])]
            out[k] = dict(max_abs=[x.max().item() for x in d], share_within_3e_2=[(x <= 3e-2).float().mean().item()
                                                                                  for x in d])
        return out

    gate = dict(seconds=time.perf_counter() - t0, launches=[r["launches"] for r in gate_ranks],
                teacher_forced=[compare(forced, r["loop"]) for r in gate_ranks],
                free_running=[compare(free, r["loop"]) for r in gate_ranks], flipped_pixels=flips,
                flipped_pixels_swapped=dict(vs_ranks=[compare(swapped, r["loop"]) for r in gate_ranks],
                                            vs_free_running=compare(free, swapped)))
    log("mesh gate " + json.dumps(gate))
    for r in gate_ranks:
        checks.assert_episode_close(forced, r["loop"])
        checks.assert_episode_close(swapped, r["loop"])  # those pixels alone part the free runs
    if dev.type == "cuda" and any(r["launches"][0] == 0 for r in gate_ranks):
        raise AssertionError(f"the gate's ranks launched no flash kernel: {gate}")
    return gate


def full_mesh(dev, steps: int, seed: int, workdir: str, first_segment, ranks=None) -> dict:
    """Phase 18, the multi-GPU serving path on the one card: W ranks spawned
    by `parallel/launch.py` sharing cuda:0 over gloo (NCCL refuses two ranks
    on one device). (a) The routes' forward at ROUTE_GRAD_SHAPE
    (`parallel/checks.py::route_rank`) runs in phase 20(a)'s ranks
    (`route_gradients`). (b) The composed loop
    gate at W = 2 against the same episode on one rank in this process (fp32,
    the same routes), teacher-forced at the memory: the one-rank run renders
    its own memory from its own frames (held to the ranks' by the gate's
    share) but conditions its second segment on the ranks' render, so that
    `assert_episode_close` holds each stage to the ranks' given the same
    inputs. The free-running episode's differences are reported beside it
    with their cause read off: `memory_flip_reading` of the memory pixels
    the one-rank and the ranks' free runs disagree on, and the one-rank
    episode fed its own memory with only those pixels taken from the ranks',
    which must pass the gate against the ranks. (c) A full-width episode at
    W = 2 (`LoopConfig()` cut to MESH_EPISODE_SEGMENTS segments, 1024x576,
    VGGT-1B, N steps, bf16): every output
    finite, both ranks' outputs equal (SHA-256), each rank's launches
    `sharded_clip_launches` a clip and 24 a rebuild, and its first segment
    held to `first_segment`, phase 10's (one process, the same seed, start
    image, camera path and N), by `segment_agreement`, which the same
    frames rolled by one decode chunk must fail; if two ranks run the card
    out of memory the steps are cut first, then the segments, the cut is
    reported, and a cut episode is not compared with phase 10's. Its clip's
    frames are split 13 + 12, both guidance halves a rank (phase 21 holds a
    split clip alone to phase 5's). (c)'s
    ranks start with (b) and run beside it (the episode's wall and its
    ranks' seconds take (b)'s share of the card and the host). `ranks`:
    {"gate": ..., "episode": ...}, two ranks each started ahead
    (`prestart`), (c)'s for its first try. VGGT's frames are split only
    where W divides their count: the 25 and 49 frames here do not, so the
    frame-sharded VGGT runs in the CPU gate alone."""
    import dataclasses

    import torch

    from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
    from evoworld_tpu_torch.loop.unified import LoopConfig
    from evoworld_tpu_torch.parallel.launch import Ranks

    torch.cuda.empty_cache()
    loop_cfg = dataclasses.replace(LoopConfig(), num_segments=MESH_EPISODE_SEGMENTS)
    tries = [(steps, loop_cfg.num_segments), (max(1, steps // 2), loop_cfg.num_segments), (1, 1)]

    def start(steps_, segments, ahead=None):
        scaled, camera_params = synthetic_path(segments * loop_cfg.num_target_view + loop_cfg.num_frames, seed)
        args = (steps_, segments, seed, scaled, camera_params)
        if ahead is not None:
            return ahead.call("chip_smoke:episode_rank_tf32_off", args, timeout=900)
        return Ranks("chip_smoke:episode_rank_tf32_off", 2, os.path.join(workdir, f"ep{steps_}_{segments}"),
                     device="cuda", args=args, threads=2, timeout=900)

    ranks = ranks or {}
    t0 = time.perf_counter()
    job = start(*tries[0], ahead=ranks.get("episode"))  # beside (b)'s, whose tiny fp32 models take a few GB
    try:
        result = {"gate": mesh_gate(dev, workdir, ranks=ranks.get("gate"))}
    except BaseException:
        for proc in job.procs:  # a failed gate leaves no rank of (c) running
            proc.kill()
        raise
    cuts = []
    for at, (steps_, segments) in enumerate(tries):
        try:
            ranks = job.results()
            break
        except RuntimeError as e:  # a cut is reported, and only out of memory makes one
            if "OutOfMemoryError" not in str(e) and "out of memory" not in str(e):
                raise
            cuts.append(dict(steps=steps_, segments=segments, error="out of memory"))
            log(f"mesh episode at {steps_} steps, {segments} segments: out of memory, cutting")
            if at + 1 < len(tries):
                job = start(*tries[at + 1])
    else:
        raise AssertionError(f"the sharded episode ran out of memory at every cut: {cuts}")
    cfg = PipelineConfig(num_steps=steps_)
    want = [segments * sharded_clip_launches(steps_, cfg, 2) + 24 * (segments - 1), 0]
    got = ranks[0]["first_segment"]
    compared = steps_ == steps  # phase 10 ran N steps; a cut episode has nothing to be held to
    episode = dict(wall_s=time.perf_counter() - t0, cuts=cuts, expected_launches=want,
                   first_segment_vs_one_process=compared and segment_agreement(first_segment, got),
                   rolled_by_a_decode_chunk=compared and segment_agreement(first_segment,
                                                                          torch.roll(got, cfg.decode_chunk, 0)),
                   ranks=[{k: v for k, v in r.items() if k not in ("outputs", "first_segment")} for r in ranks],
                   outputs=[{k: o[k] for k in ("kind", "shape", "finite")} for o in ranks[0]["outputs"]],
                   ranks_equal=[o["sha256"] for o in ranks[0]["outputs"]] == [o["sha256"] for o in ranks[1]["outputs"]])
    result["episode"] = episode
    log("mesh episode " + json.dumps(episode))
    if not (episode["ranks_equal"] and all(o["finite"] for r in ranks for o in r["outputs"])):
        raise AssertionError("the sharded episode's outputs are not finite or differ between the ranks")
    if any(r["launches"] != want for r in ranks):
        raise AssertionError(f"the sharded episode's ranks launched {[r['launches'] for r in ranks]}, expected {want}")
    if compared and not (episode["first_segment_vs_one_process"]["passes"]
                         and not episode["rolled_by_a_decode_chunk"]["passes"]):
        raise AssertionError("the sharded episode's first segment is not phase 10's by the gate's rule, or the rule "
                             f"cannot tell a misplaced decode chunk: {episode}")
    return result


def frame_clip(dev, steps: int, seed: int, workdir: str, one_clip, one_runs: list,
               world_sizes: tuple = FRAME_CLIP_RANKS, ranks=None) -> dict:
    """Phase 21: phase 5's clip (full width, bf16, N = `steps`, seed, inputs
    and draws) with the frames split over W ranks sharing `dev` over gloo
    (`clip_rank`), W the first of `world_sizes` at which the ranks fit on the
    card (each cut printed with its reason), held to `one_clip`, phase 5's
    one-process clip, by `check_clip_reading`: ranks bit for bit equal,
    launches `sharded_clip_launches` a rank, the gate's rule passed and the
    clip rolled by a decode chunk failing it. Prints each rank's frames,
    seconds and peak memory beside phase 5's runs' (`one_runs`). `ranks`:
    the first rank count's ranks started ahead (`prestart`). Ranks sharing a
    card measure nothing of multi-GPU speed."""
    import torch

    from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
    from evoworld_tpu_torch.parallel.launch import spawn

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cuts = []
    ahead = ranks
    for world in world_sizes:
        try:
            if ahead is not None and world == world_sizes[0]:
                ranks = ahead.call("chip_smoke:clip_rank", (steps, seed), timeout=420).results()
            else:
                ranks = spawn("chip_smoke:clip_rank", world, os.path.join(workdir, f"frame_clip{world}"),
                              device=dev.type, args=(steps, seed), threads=2, timeout=420)
            break
        except RuntimeError as e:  # only out of memory makes a cut
            if "OutOfMemoryError" not in str(e) and "out of memory" not in str(e):
                raise
            cuts.append(dict(world_size=world, reason=f"{world} ranks ran the card out of memory"))
            log(f"frame clip at W = {world}: the ranks ran the card out of memory, cutting")
    else:
        raise AssertionError(f"the frame-split clip ran out of memory at every rank count: {cuts}")
    expected = [sharded_clip_launches(steps, PipelineConfig(num_steps=steps), world), 0]
    result = clip_reading(one_clip, ranks, steps, expected)
    result.update(wall_s=time.perf_counter() - t0, cuts=cuts,
                  one_process={r["clip"]: {k: r[k] for k in ("seconds", "stage_seconds", "peak_memory_bytes")}
                               for r in one_runs})
    log("frame clip " + json.dumps(result))
    check_clip_reading(result, f"phase 21's clip at W = {world}")
    return result


def mesh_reproject(dev, workdir: str, overrides: tuple = ()) -> dict:
    """Phase 19(a): `cli.reproject.main` on W = 2 ranks sharing `dev` (gloo)
    on a fresh copy of phase 14's episode without its renders, with phase
    14's flags: VGGT sharded over the ranks (73 frames divide by no W, so
    only the global attention is, head-sharded). Rank 0's renders against
    phase 14's one-process ones (decoded PNGs: at most MESH_RENDER_ATOL
    levels apart and at least MESH_RENDER_EQUAL of the values equal; bit
    for bit is predicted), the ranks' records equal, rank 0 alone writing,
    and each rank's flash launches the one-process count."""
    import numpy as np

    from evoworld_tpu_torch.cli.common import load_frames
    from evoworld_tpu_torch.config import EvoWorldConfig, apply_overrides
    from evoworld_tpu_torch.ops.attention import FLASH_MIN_SEQ
    from evoworld_tpu_torch.parallel.launch import spawn
    from evoworld_tpu_torch.runtime import VGGT_PRESETS

    config = apply_overrides(EvoWorldConfig(), list(overrides))
    loop_cfg, name = config.loop, config.data.reprojection_name
    src_ep = os.path.join(workdir, "prep", "ep_1")
    ep = os.path.join(workdir, "prep_mesh", "ep_1")
    os.makedirs(ep)
    for entry in os.listdir(src_ep):
        if entry != name:
            os.symlink(os.path.join(src_ep, entry), os.path.join(ep, entry))
    argv = [f"--data.root={ep}", f"--runtime.vggt_checkpoint={workdir}/svd/model.pt",
            "--runtime.allow_random_weights=false", f"--runtime.skyseg_onnx={workdir}/skyseg.onnx", *overrides]
    t0 = time.perf_counter()
    ranks = spawn("evoworld_tpu_torch.parallel.checks:reproject_rank", 2, os.path.join(workdir, "mesh_reproject"),
                  device=dev.type, args=(argv,), threads=2 if dev.type == "cuda" else 1, timeout=600)
    wall_s = time.perf_counter() - t0

    def read(d):
        return np.stack(load_frames([os.path.join(d, n) for n in sorted(os.listdir(d))]))

    got, want = read(os.path.join(ep, name)), read(os.path.join(src_ep, name))
    levels = np.abs(np.round(got * 255).astype(np.int32) - np.round(want * 255).astype(np.int32))
    sources = len(os.listdir(os.path.join(ep, "panorama"))) - loop_cfg.num_target_view
    expected = vggt_launches(sources, (loop_cfg.pers_height, loop_cfg.pers_width),
                             VGGT_PRESETS["tiny" if config.runtime.vggt_tiny else "full"], FLASH_MIN_SEQ) \
        if dev.type == "cuda" else 0
    strip = lambda r: [(os.path.basename(x["episode"]), x["rendered"]) for x in r["records"]]  # noqa: E731
    result = dict(wall_s=wall_s, renders=len(got), shape=list(got.shape[1:]), max_levels=int(levels.max()),
                  equal_share=float((levels == 0).mean()), expected_launches=[expected, 0],
                  ranks=[dict(rank=r["rank"], launches=r["launches"], seconds=r["seconds"], saved=len(r["saved"]),
                              records=strip(r), peak_memory_bytes=r["peak_memory_bytes"],
                              stage_seconds=r["records"][0]["stage_seconds"]) for r in ranks])
    log("mesh reproject " + json.dumps(result))
    if got.shape != want.shape or result["max_levels"] > MESH_RENDER_ATOL or result["equal_share"] < MESH_RENDER_EQUAL:
        raise AssertionError(f"the ranks' renders are not phase 14's: {result}")
    if [r["saved"] for r in result["ranks"]] != [1, 0] or strip(ranks[0]) != strip(ranks[1]):
        raise AssertionError(f"rank 0 alone must write and every rank return the same records: {result['ranks']}")
    if any(r["launches"] != [expected, 0] for r in ranks):
        raise AssertionError(f"the ranks launched {[r['launches'] for r in ranks]}, expected {[expected, 0]}")
    return result


def step_agreement(a: dict, b: dict, lr: float, dev) -> dict:
    """Two checkpoints' contents (`params`, `opt_state`) after one step from
    the same state, compared on `dev`: the share of trainable values (those
    with moments) within 0.1 lr of each other (Adam's update is about
    lr sign(g) where the gradients dominate the moments, so a value whose
    gradient changes sign between the two moves up to 2 lr apart), the
    largest difference in units of lr, and the RMS-relative differences of
    the first moments (which take the clipped gradients times 1 - b1) and
    the second."""
    import torch

    from evoworld_tpu_torch.train.train_step import TRAINABLE_KEYS

    names = list(a["params"])  # the optimizer's parameters: the trainable ones in this order
    trainable = [n for n in names if any(key in n.lower() for key in TRAINABLE_KEYS)]
    if [tuple(a["params"][n].shape) for n in trainable] != [tuple(a["opt_state"]["state"][i]["mu"].shape)
                                                             for i in range(len(trainable))]:
        raise AssertionError("the checkpoint's moments do not line up with its trainable parameters")
    close = total = 0
    worst = 0.0
    sq = {"mu": [0.0, 0.0], "nu": [0.0, 0.0]}
    for i, n in enumerate(trainable):
        d = (a["params"][n].to(dev) - b["params"][n].to(dev)).abs()
        close += int((d <= 0.1 * lr).sum())
        total += d.numel()
        worst = max(worst, float(d.max()) / lr)
        for k in sq:
            ma, mb = (c["opt_state"]["state"][i][k].to(dev, torch.float64) for c in (a, b))
            sq[k][0] += float((ma - mb).pow(2).sum())
            sq[k][1] += float(mb.pow(2).sum())
    frozen_equal = all(torch.equal(a["params"][n].to(dev), b["params"][n].to(dev)) for n in names
                       if n not in trainable)
    return dict(within_tenth_lr=close / total, max_diff_lr=worst, frozen_equal=frozen_equal,
                **{f"{k}_rel_rms": math.sqrt(v[0] / v[1]) for k, v in sq.items()},
                counts=[c["opt_state"]["param_groups"][0]["count"] for c in (a, b)])


def mesh_train_argv(workdir: str, seed: int, overrides: tuple, frames: int) -> tuple[list, list, str]:
    """Phase 19(b)'s flags: the one-process runs' common argv, the ranks'
    two runs' argv and the ranks' save directory."""
    out = os.path.join(workdir, "train_mesh")
    base = [f"--data.root={os.path.join(workdir, 'episode_000')}", f"--runtime.checkpoint_dir={workdir}/svd",
            "--runtime.allow_random_weights=false", f"--runtime.seed={seed}", "--train.warmup_steps=0",
            "--trainer.log_steps=1", *overrides, f"--data.sequence_length={frames}"]
    runs = [[*base, f"--runtime.save_dir={out}", "--train.total_steps=1"],
            [*base, f"--runtime.save_dir={out}", "--train.total_steps=2", "--train.zero_stage=2"]]
    return base, runs, out


def mesh_train_ranks(dev, workdir: str, seed: int, overrides: tuple = (), frames: int = MESH_TRAIN_FRAMES):
    """Phase 19(b)'s two ranks started (`parallel/launch.py::Ranks`), for a
    caller that runs other work while they run (phase 19(a) in `main`)."""
    from evoworld_tpu_torch.parallel.launch import Ranks

    _, runs, out = mesh_train_argv(workdir, seed, overrides, frames)
    return Ranks("evoworld_tpu_torch.parallel.checks:train_cli_rank", 2, os.path.join(workdir, "mesh_train"),
                 device=dev.type, args=(runs, out), threads=2 if dev.type == "cuda" else 1, timeout=900)


def mesh_train(dev, workdir: str, seed: int, overrides: tuple = (), frames: int = MESH_TRAIN_FRAMES,
               job=None) -> dict:
    """Phase 19(b): `cli.train.main` on W = 2 ranks sharing `dev` (gloo),
    per-device batch 1 (global 2), from phase 11's checkpoints and episode,
    cut to `frames` frames so that two ranks fit on one card: a ZeRO-1 step
    and its checkpoint, then a ZeRO-2 step resumed at W = 2 from it, and
    its checkpoint. In this process, at W = 1 and batch 2 (its checkpoints
    not written, the steps held to the ranks' in memory): a fresh step 1,
    which makes the global batch's draws from the same seed, against the
    ranks' ZeRO-1 step; and a resume from the ranks' step-1 checkpoint,
    which brings the loss generator's state, so that its step 2 takes the
    ranks' batch and draws, against their ZeRO-2 step. Checks each rank's
    launches a step (`expected_train_launches`), that rank 0 alone wrote
    under the run's directory, and each step against the one-process one:
    loss and gradient norm within MESH_TRAIN_RTOL, the masters and moments
    by `step_agreement` (at least MESH_TRAIN_WITHIN_LR of the masters
    within 0.1 lr, the first moments within MESH_TRAIN_MU_RMS). The fresh
    one-process step runs while the ranks run (12.7 GB each, 14.9 GB); `job`:
    the ranks already started by `mesh_train_ranks`."""
    import shutil

    import torch

    from evoworld_tpu_torch.config import EvoWorldConfig, apply_overrides
    from evoworld_tpu_torch.parallel.checks import probed_train_cli
    from evoworld_tpu_torch.runtime import PRESETS
    from evoworld_tpu_torch.train import trainer

    on_card = dev.type == "cuda"
    base, runs, out = mesh_train_argv(workdir, seed, overrides, frames)
    one_out = os.path.join(workdir, "train_mesh_one")
    config = apply_overrides(EvoWorldConfig(), runs[0])
    if job is None:
        if on_card:
            torch.cuda.empty_cache()
        job = mesh_train_ranks(dev, workdir, seed, overrides, frames)

    agreement, one_runs, ranks = {}, {}, None
    save = trainer.CheckpointManager.save
    trainer.CheckpointManager.save = lambda *args, **kwargs: None  # a check's runs, compared in memory
    try:
        for zero, step, save_dir in (("zero1", 1, os.path.join(workdir, "train_mesh_fresh")), ("zero2", 2, one_out)):
            if zero == "zero2":  # resumed from the ranks' step-1 checkpoint
                os.makedirs(os.path.join(one_out, "checkpoints"))
                os.link(os.path.join(out, "checkpoints", "1.pt"), os.path.join(one_out, "checkpoints", "1.pt"))
            one_runs[zero], one_state = probed_train_cli(
                [*base, f"--runtime.save_dir={save_dir}", f"--train.total_steps={step}",
                 "--trainer.per_device_batch_size=2"], dev)
            if ranks is None:
                ranks = job.results()
                ranks_s = time.monotonic() - job.started
            t1 = time.perf_counter()
            agreement[zero] = step_agreement(
                torch.load(os.path.join(out, "checkpoints", f"{step}.pt"), map_location="cpu", weights_only=True,
                           mmap=True),
                {"params": one_state.unet.state_dict(), "opt_state": one_state.optimizer.state_dict()},
                config.train.learning_rate, dev)
            agreement[zero]["seconds"] = time.perf_counter() - t1
            del one_state
            if on_card:
                torch.cuda.empty_cache()
    finally:
        trainer.CheckpointManager.save = save
        job.kill()  # a failed one-process run leaves no rank running

    with open(os.path.join(out, "train_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    ones = [one_runs[z]["steps"][0] if one_runs[z]["steps"] else {} for z in ("zero1", "zero2")]
    layers = PRESETS[config.runtime.model_preset][0].layers_per_block
    expected = list(expected_train_launches(frames, config.train.vae_encode_chunk, layers)) if on_card else [0, 0]
    rank0_files = sorted({path for _, path in ranks[0]["writes"]})
    result = dict(
        ranks_s=ranks_s, frames=frames, expected_step_launches=expected,
        ranks=[dict(rank=r["rank"], runs=r["runs"], writes=len(r["writes"])) for r in ranks],
        rank0_files=rank0_files, tracked=[{k: r[k] for k in ("step", "train_loss", "grad_norm", "sec_per_step")}
                                          for r in rows],
        one_process=one_runs, step_agreement=agreement,
        loss_rel=[abs(r["train_loss"] - o.get("loss", math.nan)) / abs(r["train_loss"]) for r, o in zip(rows, ones)],
        grad_norm_rel=[abs(r["grad_norm"] - o.get("grad_norm", math.nan)) / abs(r["grad_norm"])
                       for r, o in zip(rows, ones)])
    log("mesh train " + json.dumps(result))
    steps_seen = [[st for x in r["runs"] for st in x["steps"]] for r in ranks]
    if [x["step"] for x in ranks[0]["runs"]] != [1, 2] or [r["step"] for r in rows] != [1, 2] \
            or [(one_runs[z]["step"], len(one_runs[z]["steps"])) for z in ("zero1", "zero2")] != [(1, 1), (2, 1)]:
        raise AssertionError(f"the mesh runs ended at {[x['step'] for x in ranks[0]['runs']]}, logged "
                             f"{[r['step'] for r in rows]}, the W = 1 runs at "
                             f"{[one_runs[z]['step'] for z in ('zero1', 'zero2')]}")
    if any(list(st["launches"]) != expected for seen in steps_seen for st in seen) or \
            any(len(seen) != 2 for seen in steps_seen):
        raise AssertionError(f"each rank's step must launch {expected}: "
                             f"{[[st['launches'] for st in seen] for seen in steps_seen]}")
    if ranks[1]["writes"] or not {"checkpoints/1.pt", "checkpoints/2.pt", "train_metrics.jsonl"} <= set(rank0_files):
        raise AssertionError(f"rank 1 wrote {ranks[1]['writes']}; rank 0 {rank0_files}")
    if not all(math.isfinite(r[k]) for r in rows for k in ("train_loss", "grad_norm")):
        raise AssertionError(f"the mesh runs logged {rows}")
    for i, zero in enumerate(("zero1", "zero2")):
        a = agreement[zero]
        if not (result["loss_rel"][i] <= MESH_TRAIN_RTOL and result["grad_norm_rel"][i] <= MESH_TRAIN_RTOL
                and a["within_tenth_lr"] >= MESH_TRAIN_WITHIN_LR and a["mu_rel_rms"] <= MESH_TRAIN_MU_RMS
                and a["frozen_equal"] and a["counts"] == [i + 1, i + 1]):
            raise AssertionError(f"step {i + 1} ({zero}) on two ranks is not the one-process step: {result}")
    for d in (out, one_out):  # ~7 GB a checkpoint at full width, read by nothing after this phase
        remove_later(os.path.join(d, "checkpoints"))
    return result


def route_gradients(dev, workdir: str, seed: int, shape: tuple = ROUTE_GRAD_SHAPE, min_seq=None, ranks=None) -> dict:
    """Phase 20(a): the gradient of sum(out * cotangent) through the mesh
    routes at `shape` in bf16, the head-sharded route at W = 2 and the ring
    at W = 3 (H must split over 2 and not over 3), on ranks sharing `dev`
    (gloo; routed from `min_seq` tokens): rank 0's dq, dk and dv
    against the plain fp32 backward (the plain forward's output and
    log-sum-exp, the bf16 cotangent) within the bf16 limits, every rank's
    gradients equal to rank 0's (SHA-256), and each rank's launches of the
    routed forward and backward: [1, 1] head-sharded (8 heads a rank),
    [W, W] on the ring (a block each of ceil(S / W) rows). The limits must fail
    the plain gradients with one ring block's dK and dV left without one
    query shard's part (a block that did not come home whole). On the card
    each rank first runs phase 18(a)'s forward check of its route
    (`route_rank`: within the bf16 limits of the plain fp32 forward, its
    launches [1, 0] or [W, 0], its milliseconds). Runs on the CPU too (no
    launches there: the plain versions; no forward check). The two routes'
    ranks run at the same time (their tensors take a few hundred MB), so
    each route's wall is the two spawns' together. `ranks`: {2: ..., 3: ...},
    the ranks of each W started ahead (`prestart`)."""
    import torch

    from evoworld_tpu_torch.ops.flash_attention import _plain_forward, flash_attention_backward_plain
    from evoworld_tpu_torch.parallel.checks import route_inputs
    from evoworld_tpu_torch.parallel.launch import Ranks

    t0 = time.perf_counter()
    target, args = "evoworld_tpu_torch.parallel.checks:route_grad_rank", (shape, "bfloat16", seed, min_seq)
    jobs = [ranks[world].call(target, args, timeout=600) if ranks else
            Ranks(target, world, os.path.join(workdir, f"route_grad{world}"), device=dev.type, args=args,
                  threads=2 if dev.type == "cuda" else 1, timeout=600) for world in (2, 3)]
    try:
        runs = [dict(ranks=job.results()) for job in jobs]
    finally:
        for job in jobs:  # a failed route leaves no rank of the other running
            job.kill()
    for run in runs:
        run["wall_s"] = time.perf_counter() - t0
    q, k, v, cot = route_inputs(shape, "bfloat16", seed, dev)
    scale = 1.0 / shape[-1] ** 0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), cot.to(torch.bfloat16).float()
    del q, k, v, cot
    o, lse = _plain_forward(qf, kf, vf, scale, shape[1], False)
    ref = flash_attention_backward_plain(qf, kf, vf, o, dof, lse, scale)
    n = -(-shape[1] // 3)  # the ring's rows a rank at W = 3; block 1 without query shard 0's part
    _, gk, gv = flash_attention_backward_plain(qf[:, :n], kf[:, n:2 * n], vf[:, n:2 * n], o[:, :n], dof[:, :n],
                                               lse[:, :, :n].contiguous(), scale)
    cut = [ref[0], ref[1].clone(), ref[2].clone()]
    cut[1][:, n:2 * n] -= gk
    cut[2][:, n:2 * n] -= gv
    del qf, kf, vf, dof, o, lse, gk, gv
    cut_errs = {name: errors(a, r) for name, a, r in zip(("dq", "dk", "dv"), cut, ref)}
    del cut
    result = dict(shape=list(shape), dropped_block_errors=cut_errs, routes=[])
    for run in runs:
        first = run["ranks"][0]
        errs = {name: errors(a.to(dev), r) for name, a, r in zip(("dq", "dk", "dv"), first["grads"], ref)}
        world = first["world_size"]
        want = [1, 1] if first["route"] == "head_sharded" else [world, world]
        result["routes"].append(dict(
            expected_launches=want if dev.type == "cuda" else [0, 0],
            route=first["route"], world_size=world, wall_s=run["wall_s"], errors=errs,
            ranks=[{k: r[k] for k in ("rank", "launches", "seconds", "finite")} for r in run["ranks"]],
            forward=[r["forward"] for r in run["ranks"] if r["forward"] is not None],
            ranks_equal=all(r["sha256"] == first["sha256"] for r in run["ranks"])))
    del ref
    log("route gradients " + json.dumps(result))
    check_route_gradients(result)
    return result


def check_route_gradients(result: dict) -> None:
    """Phase 20(a)'s gate: every route's gradients within the bf16 limits,
    equal on every rank, finite, with the expected launches on each rank;
    and the limits catching the short ring block."""
    if all(within_limits(e) for e in result["dropped_block_errors"].values()):
        raise AssertionError(f"the limits do not catch a ring block's dK / dV left short: "
                             f"{result['dropped_block_errors']}")
    for r in result["routes"]:
        if not (all(within_limits(e) for e in r["errors"].values()) and r["ranks_equal"]
                and all(x["finite"] and x["launches"] == r["expected_launches"] for x in r["ranks"])):
            raise AssertionError(f"the {r['route']} route's gradients at W = {r['world_size']}: {r}")
        for f in r["forward"]:  # phase 18(a): the forward alone
            if not (within_limits(f) and f["finite"] and f["launches"] == [r["expected_launches"][0], 0]):
                raise AssertionError(f"the {f['route']} route on rank {f['rank']} of {f['world_size']}: {f}")


def model_parallel_steps(dev, workdir: str, seed: int, ranks=None) -> dict:
    """Phase 20(b) and (c): one full-width bf16 step (`parallel/checks.py::
    _card_step`, ZeRO-1) from phase 11's checkpoints on two ranks sharing
    `dev` (gloo) for each of (b) `frame_step_rank` (the frames over the
    data axis, FRAME_STEP_FRAMES) and (c) `tp_step_rank` (a 1 x 2
    tensor-parallel mesh, TP_STEP_FRAMES), the four ranks at once (16.8,
    14.8 and twice 6.0 GB); then each against the same step in this process
    at the same frames, batch and draws, (c)'s run while the ranks run
    (10.3 GB) and (b)'s after them (25.4 GB). The ranks' step against it: loss
    and gradient norm within MESH_TRAIN_RTOL, the masters and moments by
    `step_agreement` (MESH_TRAIN_WITHIN_LR, MESH_TRAIN_MU_RMS); each rank's
    launches those of a step at its frame count (`expected_train_launches`).
    Each record's `ranks_s` is the two groups' wall together. `ranks`:
    {"frame_step": ..., "tp_step": ...}, each group started ahead
    (`prestart`, the tensor-parallel one on a 1 x 2 mesh)."""
    import torch

    from evoworld_tpu_torch.parallel.checks import _card_step
    from evoworld_tpu_torch.parallel.launch import Ranks
    from evoworld_tpu_torch.parallel.mesh import split_sizes
    from evoworld_tpu_torch.train.train_step import TrainConfig

    ckpt = os.path.join(workdir, "svd")
    specs = {"frame_step": ("frame_step_rank", FRAME_STEP_FRAMES, 1),
             "tp_step": ("tp_step_rank", TP_STEP_FRAMES, 2)}
    saves = {name: os.path.join(workdir, f"{target}_{frames}.pt") for name, (target, frames, _) in specs.items()}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    jobs = {name: ranks[name].call(f"evoworld_tpu_torch.parallel.checks:{target}", (ckpt, frames, seed, saves[name]),
                                   timeout=600) if ranks else
            Ranks(f"evoworld_tpu_torch.parallel.checks:{target}", 2, os.path.join(workdir, f"{target}{frames}"),
                  device="cuda", args=(ckpt, frames, seed, saves[name]), mesh_model=mesh_model, threads=2, timeout=600)
            for name, (target, frames, mesh_model) in specs.items()}
    one, one_s = {}, {}
    try:
        t1 = time.perf_counter()
        one["tp_step"] = _card_step(None, ckpt, TP_STEP_FRAMES, seed, None, shard_frames=False)
        one_s["tp_step"] = time.perf_counter() - t1
        ranks = {name: job.results() for name, job in jobs.items()}
    finally:
        for job in jobs.values():  # a failed group leaves no rank of the other running
            job.kill()
    ranks_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    one["frame_step"] = _card_step(None, ckpt, FRAME_STEP_FRAMES, seed, None, shard_frames=False)
    one_s["frame_step"] = time.perf_counter() - t1
    lr = TrainConfig(warmup_steps=0).learning_rate
    out = {}
    for name, (target, frames, _) in specs.items():
        agreement = step_agreement(torch.load(saves[name], map_location="cpu", weights_only=True, mmap=True),
                                   one[name].pop("state"), lr, dev)
        os.remove(saves[name])
        torch.cuda.empty_cache()
        local = split_sizes(frames, 2) if target == "frame_step_rank" else [frames, frames]
        expected = [list(expected_train_launches(f, 8, 2)) for f in local]
        result = dict(target=target, frames=frames, ranks_s=ranks_s, one_process_s=one_s[name],
                      expected_launches=expected, ranks=ranks[name], one_process=one[name], step_agreement=agreement,
                      loss_rel=[abs(r["loss"] - one[name]["loss"]) / abs(one[name]["loss"]) for r in ranks[name]],
                      grad_norm_rel=[abs(r["grad_norm"] - one[name]["grad_norm"]) / abs(one[name]["grad_norm"])
                                     for r in ranks[name]])
        result["expected_one_process_launches"] = list(expected_train_launches(frames, 8, 2))
        log(f"{target} " + json.dumps(result))
        check_model_parallel_step(result)
        out[name] = result
    return out


def check_model_parallel_step(result: dict) -> None:
    """Phase 20(b) and (c)'s gate: each rank's and the one-process step's
    launches as expected, and the ranks' step the one-process step's (loss
    and norm within MESH_TRAIN_RTOL, masters and moments by `step_agreement`
    within MESH_TRAIN_WITHIN_LR and MESH_TRAIN_MU_RMS, one update each)."""
    ranks, one, a = result["ranks"], result["one_process"], result["step_agreement"]
    if [r["launches"] for r in ranks] != result["expected_launches"] \
            or one["launches"] != result["expected_one_process_launches"]:
        raise AssertionError(f"{result['target']}: the ranks launched {[r['launches'] for r in ranks]} (expected "
                             f"{result['expected_launches']}), one process {one['launches']}")
    if not (max(result["loss_rel"] + result["grad_norm_rel"]) <= MESH_TRAIN_RTOL
            and a["within_tenth_lr"] >= MESH_TRAIN_WITHIN_LR and a["mu_rel_rms"] <= MESH_TRAIN_MU_RMS
            and a["counts"] == [1, 1] and all(math.isfinite(r["loss"]) for r in ranks)):
        raise AssertionError(f"{result['target']} on two ranks is not the one-process step: {result}")


def mesh_model_parallel(dev, workdir: str, seed: int, ranks=None) -> dict:
    """Phase 20, the model-parallel half of training on ranks sharing `dev`
    over gloo: (a) `route_gradients`; (b) the frame-sharded step at W = 2
    and (c) the tensor-parallel step on a 1 x 2 mesh, both against the
    one-process step (`model_parallel_steps`); each rank's peak memory beside
    the one-process step's, (c) each rank's bytes of parameters and moments
    beside the one-process state's. `ranks`: {"route": {2: ..., 3: ...},
    "steps": {"frame_step": ..., "tp_step": ...}}, every group started ahead
    (`prestart`). Ranks sharing a card measure nothing of multi-GPU speed."""
    ranks = ranks or {}
    t0 = time.perf_counter()
    out = {"route_gradients": route_gradients(dev, workdir, seed, ranks=ranks.get("route"))}
    out["route_gradients"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out.update(model_parallel_steps(dev, workdir, seed, ranks=ranks.get("steps")))
    for k in ("frame_step", "tp_step"):
        out[k]["seconds"] = time.perf_counter() - t0  # the two steps' phase together
    summary = dict(
        seconds={k: v["seconds"] for k, v in out.items()},
        route_launches={f"{r['route']}_w{r['world_size']}": [x["launches"] for x in r["ranks"]]
                        for r in out["route_gradients"]["routes"]},
        **{k: dict(frames=out[k]["frames"],
                   peak_memory_bytes=dict(ranks=[r["peak_memory_bytes"] for r in out[k]["ranks"]],
                                          one_process=out[k]["one_process"]["peak_memory_bytes"]),
                   state_bytes=dict(ranks=[r["param_bytes"] + r["moment_bytes"] for r in out[k]["ranks"]],
                                    one_process=out[k]["one_process"]["param_bytes"]
                                    + out[k]["one_process"]["moment_bytes"]),
                   launches=[r["launches"] for r in out[k]["ranks"]],
                   step_seconds=dict(ranks=[r["seconds"] for r in out[k]["ranks"]],
                                     one_process=out[k]["one_process"]["seconds"]))
           for k in ("frame_step", "tp_step")})
    log("model parallel " + json.dumps(summary))
    return out


def offload_episode(dev, steps: int, seed: int, offloaded: dict) -> dict:
    """Phase 19(c): phase 10's episode again with VGGT's parameters kept on
    the card (`offload_params=False`), cut to its first two segments (one
    rebuild), against phase 10's run with them offloaded (the default):
    outputs bit for bit, each stage's peak memory over what the process
    held before the episode was built, and the seconds of the stages both
    runs have."""
    import torch

    kept = full_loop(dev, steps, seed, num_segments=2, offload_params=False)
    on, off = offloaded, kept
    equal = all(torch.equal(a, b) for k in ("segments", "memories") for a, b in zip(on["kept"][k], off["kept"][k]))

    def two_segments(run):  # the stages both runs have: two clips, one rebuild
        return sum(v for k, v in run["stage_seconds"].items() if k in off["stage_seconds"])

    def over_baseline(run, stage, n):
        return [b - run["baseline_bytes"] for b in run["stage_peak_bytes"][stage][:n]]

    result = dict(
        vggt_bytes=on["vggt_bytes"], offloaded=[on["offloaded"], off["offloaded"]], outputs_equal=equal,
        launches=off["flash_launches"], baseline_bytes=dict(on=on["baseline_bytes"], off=off["baseline_bytes"]),
        generate_peak_bytes=dict(on=over_baseline(on, "generate", 2), off=over_baseline(off, "generate", 2)),
        reconstruct_peak_bytes=dict(on=over_baseline(on, "reconstruct", 1), off=over_baseline(off, "reconstruct", 1)),
        two_segments_s=dict(on=two_segments(on), off=two_segments(off)),
        reconstruct_s=dict(on=on["stage_seconds"]["reconstruct_s0"], off=off["stage_seconds"]["reconstruct_s0"]),
        episode_s=dict(on_three_segments=on["seconds"], off_two_segments=off["seconds"]))
    log("offload " + json.dumps(result))
    if not (equal and result["offloaded"] == [True, False]):
        raise AssertionError(f"the episode with VGGT's parameters on the card is not the offloaded one's: {result}")
    return result


def full_clips(dev, steps: int, seed: int) -> tuple[list[dict], dict]:
    """Two full-width clips (cold, warm); checks launch counts and outputs.
    Returns the runs' records and the warm clip's frames and denoised latents
    on the host (the one-process clip phase 21 is held to)."""
    import torch

    from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
    from evoworld_tpu_torch.ops.flash_attention import flash_attention
    from evoworld_tpu_torch.runtime import build_pipeline

    cfg = PipelineConfig(num_steps=steps)
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, "full", seed=seed, compute_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = {n: sum(p.numel() for p in getattr(pipe, n).parameters()) for n in ("unet", "vae", "clip_tower")}
    log(f"full pipeline built in {time.perf_counter() - t0:.3f} s, params {n_params}")
    image, plucker, memory = clip_inputs(cfg, dev, seed)
    expected = 5 * steps + 18
    runs = []
    for label in ("cold", "warm"):
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        torch.cuda.reset_peak_memory_stats(dev)
        timings: dict = {}
        flash_attention.launches = 0
        t0 = time.perf_counter()
        with kept_latents(pipe) as latents:
            frames = pipe(image, plucker, memory, generator=g, timings=timings)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = flash_attention.launches
        run = dict(clip=label, num_steps=steps, seconds=total, stage_seconds=timings,
                   seconds_per_denoise_step=timings["denoise"] / steps,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
                   flash_launches=launches, expected_launches=expected)
        log("clip " + json.dumps(run))
        if launches != expected:
            raise AssertionError(f"{label} clip launched the flash kernel {launches} times, expected {expected}")
        if tuple(frames.shape) != (cfg.num_frames, cfg.height, cfg.width, 3):
            raise AssertionError(f"output shape {tuple(frames.shape)}")
        if not bool(torch.isfinite(frames).all()) or frames.min() < 0 or frames.max() > 1:
            raise AssertionError("output frames are not finite values in [0, 1]")
        log(f"{label} clip output: shape {tuple(frames.shape)}, mean {frames.mean().item():.6f}, "
            f"std {frames.std().item():.6f}")
        runs.append(run)
    return runs, dict(frames=frames.cpu(), latents=latents[0])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an NVIDIA card", file=sys.stderr)
        return 1
    from evoworld_tpu_torch.data import native_io, native_video
    from evoworld_tpu_torch.ops import _build
    from evoworld_tpu_torch.ops.flash_attention import BWD_SOURCE, FP32_SOURCE, SOURCE

    wall0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    # Full fp32 where the port computes in fp32 (the resize, CLIP, the
    # small-clip and small-step reference checks): no TF32 in matmuls or
    # cuDNN convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} count {torch.cuda.device_count()}")

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:  # one compiler per source, started together
        list(pool.map(_build.load, (SOURCE, BWD_SOURCE, FP32_SOURCE, native_io.SOURCE, native_video.SOURCE)))
    build_s = time.perf_counter() - t0
    log(f"nvcc build of {SOURCE}, {BWD_SOURCE} and {FP32_SOURCE}, g++ build of {native_io.SOURCE} and "
        f"{native_video.SOURCE}: {build_s:.3f} s")
    for source in (SOURCE, BWD_SOURCE, FP32_SOURCE):
        check_ptxas(source, ptxas_report(_build.build_log(source)), fp32=source == FP32_SOURCE)
    from evoworld_tpu_torch.compare_kernels import sass_entries

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    fp32_sass = fp32_sass_rows(sass_entries(str(_build._lib_path(FP32_SOURCE)), cuobjdump))
    check_fp32_sass(fp32_sass)

    check_jpeg_fixtures()
    check_mp4_fixtures()
    h264_rows = check_mp4_fixtures(H264_FIXTURES)
    log(f"h264 fixtures on {smi}: " + ", ".join(f"{r['name']} {r['frames_per_s']:.1f} frames/s" for r in h264_rows))

    watts = re.search(r",\s*([\d.]+) W", smi)  # "[N/A]" where the limit cannot be read
    power_limit_w = float(watts.group(1)) if watts else 0.0
    flash = check_flash_kernel(dev, power_limit_w)
    flash_bwd = check_flash_backward(dev, power_limit_w)
    vae_grad = check_vae_mid_gradient(dev)
    check_small_clip_against_cpu(dev, SEED)
    runs, one_clip = full_clips(dev, STEPS, SEED)
    torch.cuda.empty_cache()
    check_small_loop_against_cpu(dev, SEED)
    loop_run = full_loop(dev, STEPS, SEED)
    cloud, first_segment, loop_kept = loop_run.pop("cloud"), loop_run.pop("first_segment"), loop_run.pop("kept")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")  # phases 11-22 share it
    try:
        t0 = time.perf_counter()
        cli_run = full_cli(dev, STEPS, SEED, workdir=workdir)
        log(f"cli phase wall seconds {time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        train_cli_run = full_train_cli(dev, STEPS, SEED, workdir)
        log(f"train cli phase wall seconds {time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        eval_run = full_eval(dev, workdir, cli_run["out_dir"], train_cli_run.pop("clip"))
        log(f"eval phase wall seconds {time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        scores_run = full_scores(dev, workdir, cli_run["out_dir"])
        log(f"scores phase wall seconds {time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        prep_run = full_prep(dev, workdir, SEED)
        log(f"prep phase wall seconds {time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        fp16_run = full_fp16(dev, STEPS, SEED, workdir)
        log(f"fp16 phase wall seconds {time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        fp32_run = full_fp32(dev, STEPS, SEED, workdir)
        log(f"fp32 phase wall seconds {time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        # The ranks of phases 18, 20 and 21 start during the phase before theirs: their imports,
        # the card's context and the group come up meanwhile (~0.5 GB of the card a rank).
        mesh_ranks = {"gate": prestart(workdir, "gate", 2), "episode": prestart(workdir, "episode", 2)}
        tools_run = full_tools(dev, STEPS, SEED, workdir, cloud)
        log(f"tools phase wall seconds {time.perf_counter() - t0:.3f}")
        del cloud
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        clip_ranks = prestart(workdir, "frame_clip", FRAME_CLIP_RANKS[0])
        mesh_run = full_mesh(dev, STEPS, SEED, workdir, first_segment, ranks=mesh_ranks)
        del first_segment
        log(f"mesh phase wall seconds {time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        frame_clip_run = frame_clip(dev, STEPS, SEED, workdir, one_clip, runs, ranks=clip_ranks)
        del one_clip
        log(f"frame clip phase wall seconds {time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        # 19(b)'s ranks run beside 19(a)'s (12.7 and 17.9 GB each); none start during phase 21,
        # whose four ranks (15.6 GB each) leave too little of the card (four waiting ranks ran one out of it)
        train_ranks = mesh_train_ranks(dev, workdir, SEED)
        try:
            mesh_prep_run = mesh_reproject(dev, workdir)
        except BaseException:
            train_ranks.kill()
            raise
        log(f"mesh reproject phase wall seconds {time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        ranks_20 = {"route": {w: prestart(workdir, f"route_grad{w}", w) for w in (2, 3)},
                    "steps": {"frame_step": prestart(workdir, "frame_step", 2),
                              "tp_step": prestart(workdir, "tp_step", 2, mesh_model=2)}}
        mesh_train_run = mesh_train(dev, workdir, SEED, job=train_ranks)
        log(f"mesh train phase wall seconds {time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        mp_run = mesh_model_parallel(dev, workdir, SEED, ranks=ranks_20)
        log(f"model parallel phase wall seconds {time.perf_counter() - t0:.3f}")
    finally:
        remove_later(workdir)  # deleted while the last phases run
    t0 = time.perf_counter()
    offload_run = offload_episode(dev, STEPS, SEED, dict(loop_run, kept=loop_kept))
    del loop_kept
    log(f"offload phase wall seconds {time.perf_counter() - t0:.3f}")
    torch.cuda.empty_cache()
    check_level0_transformer(dev)
    check_small_train_step_against_cpu(dev, SEED)
    train_run = full_train(dev, TRAIN_STEPS, SEED)

    fwd_row = flash["shapes"][0]  # UNet level-0 attention: 5 of every 5N + 18 launches of a clip
    wide_row = next(r for r in flash["shapes"] if r["label"] == "vae_encoder_mid_train")  # 6 of 8 a step
    bwd_row = flash_bwd["shapes"][0]  # the training shape: 5 launches per step
    d512_row = next(r for r in flash_bwd["shapes"] if r["label"] == "vae_mid_d512")
    d128_row = next(r for r in flash_bwd["shapes"] if r["label"] == "head_dim_128")
    fwd_total, bwd_total = train_run["summary"]["launches_total"]
    cli_train = [sum(r["launches"][i] for r in train_cli_run["runs"]) for i in (0, 1)]
    fp16_train = [sum(r[k] for r in fp16_run["train"]["steps"]) for k in ("fwd_launches", "bwd_launches")]
    fp32_train = [sum(r[k] for r in fp32_run["train"]["steps"]) for k in ("fwd_launches", "bwd_launches")]
    twin_keys = ("label", "shape", "ms", "twin_ms", "twin_ratio", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "max_abs_err", "kernel_types")
    fwd16 = next(r for r in flash["shapes"] if r["label"] == "unet_l0_spatial_fp16")
    bwd16 = next(r for r in flash_bwd["shapes"] if r["label"] == "unet_l0_train_fp16")
    fwd32 = next(r for r in flash["shapes"] if r["label"] == "unet_l0_spatial_fp32")
    bwd32 = next(r for r in flash_bwd["shapes"] if r["label"] == "unet_l0_train_fp32")
    # The fp32 kernels' launches on phase 16's paths, each read with the counts set to 0 just before it.
    fp32_fwd_paths = {"fp32_single_segment": fp32_run["single"]["launches"][0], "fp32_train": fp32_train[0],
                      "fp32_reproject": fp32_run["reproject"]["launches"][0]}
    fp32_bwd_paths = {"fp32_single_segment": fp32_run["single"]["launches"][1], "fp32_train": fp32_train[1],
                      "fp32_reproject": fp32_run["reproject"]["launches"][1]}
    if not all(fp32_fwd_paths.values()) or not fp32_train[1]:
        raise AssertionError(f"an fp32 kernel was not launched on phase 16's paths: {fp32_fwd_paths}, "
                             f"{fp32_bwd_paths}")
    fp32_keys = twin_keys + ("split_bound_ms", "kernel_ms", "max_rel_err", "mean_rel_err")
    # Phases 17, 18 and 21: launches summed over the runs and ranks of each path, each read with its counts set to 0.
    mesh_paths = {"validate_parity": sum(r["launches"][0] for r in tools_run["validate_parity"].values()),
                  **{f"mesh_{run['route']}": sum(f["launches"][0] for f in run["forward"])
                     for run in mp_run["route_gradients"]["routes"]},
                  "mesh_episode": sum(r["launches"][0] for r in mesh_run["episode"]["ranks"]),
                  f"frame_clip_w{frame_clip_run['world_size']}": sum(r["launches"][0]
                                                                    for r in frame_clip_run["ranks"])}
    # Phase 19: each path's launches summed over its ranks (and steps), each read with its counts set to 0.
    train_steps_19 = [st for r in mesh_train_run["ranks"] for x in r["runs"] for st in x["steps"]] + \
        [st for run in mesh_train_run["one_process"].values() for st in run["steps"]]
    mesh_paths.update(mesh_reproject=sum(r["launches"][0] for r in mesh_prep_run["ranks"]),
                      mesh_train=sum(st["launches"][0] for st in train_steps_19),
                      loop_without_offload=offload_run["launches"])
    mesh_bwd_paths = {"mesh_train": sum(st["launches"][1] for st in train_steps_19)}
    # Phase 20: each path's launches summed over its ranks, each read with its counts set to 0.
    for r in mp_run["route_gradients"]["routes"]:
        key = f"route_grad_{r['route']}_w{r['world_size']}"
        mesh_paths[key] = sum(x["launches"][0] for x in r["ranks"])
        mesh_bwd_paths[key] = sum(x["launches"][1] for x in r["ranks"])
    for k in ("frame_step", "tp_step"):
        mesh_paths[k] = sum(r["launches"][0] for r in mp_run[k]["ranks"])
        mesh_bwd_paths[k] = sum(r["launches"][1] for r in mp_run[k]["ranks"])
    if not all(mesh_paths.values()) or not all(mesh_bwd_paths.values()):
        raise AssertionError(f"a kernel was not launched on phase 17's, 18's, 19's, 20's or 21's paths: {mesh_paths}, "
                             f"{mesh_bwd_paths}")
    fp32_fwd_paths["mesh_gate"] = sum(r[0] for r in mesh_run["gate"]["launches"])
    kernels = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "evoworld_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "evoworld_tpu/ops/attention.py:170",
        "also_replaces": "evoworld_tpu/ops/flash_attention.py:137",
        "launches": loop_run["flash_launches"],
        "launches_by_path": {"loop": loop_run["flash_launches"], "train_steps": fwd_total,
                             "clip": runs[-1]["flash_launches"], "vae_mid_gradient": vae_grad["launches_fwd_bwd"][0],
                             "cli_single_segment": cli_run["single"]["launches"][0],
                             "cli_unified": cli_run["unified"]["launches"][0],
                             "cli_train": cli_train[0], "eval": eval_run["launches"][0],
                             "scores": scores_run["launches"][0], "reproject": prep_run["launches"][0],
                             "fp16_single_segment": fp16_run["single"]["launches"][0],
                             "fp16_train": fp16_train[0], "fp16_reproject": fp16_run["reproject"]["launches"][0],
                             **mesh_paths},
        "max_abs_err": max(r["max_abs_err"] for r in flash["shapes"]),
        "ms": fwd_row["ms"],
        "plain_ms": fwd_row["plain_ms"],
        "bound_ms": fwd_row["bound_ms"],
        "bound_by": fwd_row["bound_by"],
        "library_ms": fwd_row["library_ms"],
        "timed_at": fwd_row["shape"],
        "designs": {str(d): n for d, n in FWD_KERNELS.items()},
        "dtypes": ["bf16", "fp16"],
        "fp16": {k: fwd16[k] for k in twin_keys},
        "wide": {k: wide_row[k] for k in ("kernel", "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                           "max_abs_err")},
        "shapes": flash["shapes"],
        "ok": True,
    }, {
        "name": "flash_attn_bwd",
        "route": "cuda",
        "source": "evoworld_tpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "also_replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "reached_from": "evoworld_tpu/ops/attention.py:170",
        "launches": bwd_total,
        "launches_by_path": {"train_steps": bwd_total, "clip": 0, "loop": loop_run["bwd_launches"],
                             "vae_mid_gradient": vae_grad["launches_fwd_bwd"][1],
                             "cli_single_segment": cli_run["single"]["launches"][1],
                             "cli_unified": cli_run["unified"]["launches"][1],
                             "cli_train": cli_train[1], "eval": eval_run["launches"][1],
                             "scores": scores_run["launches"][1], "reproject": prep_run["launches"][1],
                             "fp16_single_segment": fp16_run["single"]["launches"][1],
                             "fp16_train": fp16_train[1], "fp16_reproject": fp16_run["reproject"]["launches"][1],
                             **mesh_bwd_paths},
        "max_abs_err": max(r["max_abs_err"] for r in flash_bwd["shapes"]),
        "ms": bwd_row["ms"],
        "design": bwd_row["design"],
        "designs": {str(d): design for d, (design, _) in BWD_DESIGNS.items()},
        "dtypes": ["bf16", "fp16"],
        "fp16": {k: bwd16[k] for k in twin_keys},
        "d128": {k: d128_row[k] for k in ("shape", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                          "max_abs_err", "repeat")},
        "d512": {k: d512_row[k] for k in ("shape", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                          "max_abs_err", "repeat")},
        "kernel_ms": bwd_row["kernel_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
        "timed_at": bwd_row["shape"],
        "shapes": flash_bwd["shapes"],
        "ok": True,
    }, {
        "name": "flash_attn_fp32_fwd",
        "route": "cuda",
        "source": "evoworld_tpu_torch/csrc/flash_attn_fp32.cu",
        "replaces": "evoworld_tpu/ops/attention.py:170",
        "also_replaces": "evoworld_tpu/ops/flash_attention.py:137",
        "launches": sum(fp32_fwd_paths.values()),
        "launches_by_path": fp32_fwd_paths,
        "max_abs_err": max(r["max_abs_err"] for r in flash["shapes"] if r["dtype"] == "fp32"),
        **{k: fwd32[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "split_bound_ms")},
        "timed_at": fwd32["shape"],
        "design": FP32_FWD_KERNEL,
        "sass": [r for r in fp32_sass if r["kernel"] == FP32_FWD_KERNEL],
        "dtypes": ["fp32"],
        "rows": [{k: r[k] for k in fp32_keys} for r in flash["shapes"] if r["dtype"] == "fp32"],
        "ok": True,
    }, {
        "name": "flash_attn_fp32_bwd",
        "route": "cuda",
        "source": "evoworld_tpu_torch/csrc/flash_attn_fp32.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "also_replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "reached_from": "evoworld_tpu/ops/attention.py:170",
        "launches": sum(fp32_bwd_paths.values()),
        "launches_by_path": fp32_bwd_paths,
        "max_abs_err": max(r["max_abs_err"] for r in flash_bwd["shapes"] if r["dtype"] == "fp32"),
        **{k: bwd32[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "split_bound_ms",
                                 "kernel_ms")},
        "timed_at": bwd32["shape"],
        "design": FP32_BWD_DESIGN[0],
        "sass": [r for r in fp32_sass if r["kernel"] in FP32_BWD_DESIGN[1]],
        "dtypes": ["fp32"],
        "rows": [{k: r[k] for k in ("label", "shape", "ms", "twin_ms", "twin_ratio", "plain_ms", "bound_ms",
                                     "split_bound_ms", "library_ms", "max_abs_err", "kernel_ms", "repeat")}
                 for r in flash_bwd["shapes"] if r["dtype"] == "fp32"],
        "ok": True,
    }]
    wait_removals()
    log(f"wall seconds {time.perf_counter() - wall0:.3f}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        wait_removals()
