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
     library call; each row prints its TFLOP/s and its share of the bound;
  4. a small clip on the card against the same clip on the CPU (tiny widths,
     fp32), the port's own reference check;
  5. two full-width clips (1024x576, 25 frames, bf16, random weights from
     seed 0, N = 4 denoise steps), cold then warm, through `build_pipeline`
     and the pipeline's `__call__`; the kernel launch counts are reset just
     before each clip and must equal 5*N + 18 after it.
The training slice (EDM fine-tuning) adds:
  3b. the forward kernel's log-sum-exp and the backward kernel
     (flash_attn_bwd.cu) against the plain forward and backward: the LSE,
     dQ, dK, dV at the training shape, at D = 128 and at the ragged row,
     within the same RMS-relative limits, which the plain backward without
     its last DROPPED_KEYS keys must fail; a second call on the same inputs
     must give the same dK and dV bit for bit and dQ within one bf16 step
     (the fused D = 64 pass sums dQ with global reductions in no fixed
     order); timed beside its bound, its plain version and
     scaled_dot_product_attention's backward, each kernel of the call apart;
     on a card at its full power limit the D = 64 rows must keep to
     BWD_MS_LINES;
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
It prints, in order before the last line, the run's wall seconds, the card's
name and power limit, a JSON line of the kernels, and ends with the JSON line
{"ok": true, "device": {...}}. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import logging
import math
import re
import subprocess
import sys
import time
import types

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bandwidth
# Kernel against plain version, error over the RMS of the plain output (about
# sqrt(e / kv_len) for these inputs). bf16 rounding of P and of the output sits
# near 0.03 max / 0.002 mean; leaving out one 32-key tile moves the output by
# about 0.05 mean, which DROPPED_KEYS checks the limits catch.
MAX_REL_ERR, MEAN_REL_ERR = 0.1, 0.01
DROPPED_KEYS = 32
# Forward kernel's row log-sum-exp against the plain one (about 9.6 for 9216
# keys): fp32 accumulation order moves it by ~1e-5; dropping DROPPED_KEYS of
# kv_len keys moves it by about -log(1 - 32 / kv_len), 3.5e-3 or more here.
LSE_ATOL = 1e-3
STEPS = 4  # denoise steps per full-width clip (production: 25), cut for the time limit
SEED = 0
TRAIN_STEPS = 3  # full-width training steps, the first cold
# Kernel route against the plain route through a whole level-0 block, and
# the card against the CPU for a tiny fp32 step: relative RMS error limits
# (||a - b|| / ||b|| per tensor). The two bf16 routes round P, dS and the
# attention output at different places (about 1% of a gradient's RMS); a
# gradient that missed the attention would be off by 100%.
BLOCK_REL_RMS = 0.05
# The backward's kernels by head dim, as named in a profiler trace: the fused
# wgmma pass between its two small passes, or the mma.sync pair.
BWD_DESIGNS = {
    64: ("fused wgmma pass", ("flash_bwd_fused", "flash_bwd_store_dq", "flash_bwd_delta")),
    128: ("mma.sync dK/dV and dQ kernels", ("flash_bwd_dkdv", "flash_bwd_dq", "flash_bwd_delta")),
}
# Two calls of the fused backward add the same fp32 terms into dQ in another
# order, which can move a sum across a bf16 rounding boundary: one bf16 step
# (2^-7 of the value), beside 1e-4 of dQ's RMS for sums that nearly cancel.
DQ_REPEAT_RTOL, DQ_REPEAT_RMS_ATOL = 2.0 ** -7, 1e-4
# The lines the D = 64 backward is held to in PERF.md, in ms on an H100 at its
# full power limit, FULL_POWER_W: asserted there, only printed on a card set
# below it (which runs slower under load).
BWD_MS_LINES = {"unet_l0_train": 19.5, "ragged_padded_kv": 0.95}
FULL_POWER_W = 700.0
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-4, 1e-5  # a tenth of one update at lr 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn` over `reps` launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def within_limits(e: dict) -> bool:
    return e["max_rel_err"] <= MAX_REL_ERR and e["mean_rel_err"] <= MEAN_REL_ERR


def check_flash_kernel(dev) -> dict:
    """Flash kernel against flash_attention_plain (fp32 on the same bf16 inputs).

    The padded case gives the kernel keys and values past `kv_len` that would
    swamp the output if the mask missed them (K = 10, V = 100). Each case also
    checks that the limits catch a wrong result: the plain version without
    the last DROPPED_KEYS keys must fail them. The training row also writes
    the log-sum-exp, held against the plain one within LSE_ATOL.
    """
    import torch
    import torch.nn.functional as F

    from evoworld_tpu_torch.ops.flash_attention import _plain_forward, flash_attention_forward

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
    ]
    g = torch.Generator(device=dev).manual_seed(1234)
    shapes = []
    for label, b, sq, skv, h, d, kv_len, use_exp2, with_lse in cases:
        scale = d ** -0.5
        q = torch.randn((b, sq, h, d), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((b, skv, h, d), generator=g, device=dev).bfloat16() for _ in range(2))
        k[:, kv_len:], v[:, kv_len:] = 10.0, 100.0

        def run():
            return flash_attention_forward(q, k, v, scale, kv_len, use_exp2, with_lse=with_lse)

        out, lse = run()
        torch.cuda.synchronize()
        qf, kf, vf = q.float(), k.float(), v.float()
        ref, ref_lse = _plain_forward(qf, kf, vf, scale, kv_len, use_exp2)
        err = errors(out, ref)
        cut = errors(_plain_forward(qf, kf, vf, scale, kv_len - DROPPED_KEYS, use_exp2)[0], ref)
        lse_err = (lse - ref_lse).abs().max().item() if with_lse else None
        del ref, ref_lse
        flops = 4 * b * h * sq * kv_len * d
        nbytes = (2 * sq + 2 * kv_len) * b * h * d * 2 + (b * h * sq * 4 if with_lse else 0)
        ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        ms = cuda_ms(run, reps=5)
        plain_ms = cuda_ms(lambda: _plain_forward(qf, kf, vf, scale, kv_len, use_exp2), reps=1)
        qt, kt, vt = q.transpose(1, 2), k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=5)
        bound_ms = max(ops_ms, bytes_ms)
        row = dict(label=label, shape=[b, sq, h, d], skv=skv, kv_len=kv_len, use_exp2=use_exp2,
                   with_lse=with_lse, **err, lse_max_abs_err=lse_err,
                   dropped_keys_rel_err=[cut["max_rel_err"], cut["mean_rel_err"]],
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   tflops=flops / ms / 1e9, bound_share=bound_ms / ms)
        log("kernel flash_attn_fwd " + json.dumps(row))
        if not within_limits(err):
            raise AssertionError(f"flash kernel disagrees with its plain version at {label}: {err}")
        if within_limits(cut):
            raise AssertionError(f"the limits do not catch {DROPPED_KEYS} dropped keys at {label}: {cut}")
        if with_lse and not lse_err <= LSE_ATOL:
            raise AssertionError(f"forward kernel's log-sum-exp off by {lse_err} at {label} (limit {LSE_ATOL})")
        shapes.append(row)
        del q, k, v, qf, kf, vf, out, lse
        torch.cuda.empty_cache()
    return {"shapes": shapes}


def ptxas_report(log_text: str) -> list[dict]:
    """Registers and spill bytes of each kernel entry in an nvcc -Xptxas -v log."""
    import re

    rows = []
    for line in log_text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            rows.append(dict(entry=entry.group(1)))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and rows:
            rows[-1].update(spill_stores=int(spill.group(1)), spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and rows:
            rows[-1]["registers"] = int(regs.group(1))
        if "wgmma" in line and "serialized" in line and rows:
            rows[-1]["wgmma_serialized"] = line.strip()
    return rows


def check_flash_backward(dev, power_limit_w: float) -> dict:
    """Forward-with-LSE and backward kernels against the plain chain on the same bf16 inputs.

    The reference is flash_attention_backward_plain (fp32) fed with the plain
    forward's own output and log-sum-exp. The kernel's log-sum-exp must be
    within LSE_ATOL of the plain one, which the plain one over DROPPED_KEYS
    fewer keys must miss. dQ, dK and dV each within the RMS-relative limits
    at the training shape, a D = 128 shape and the ragged row (keys past
    `kv_len` set to K = 10, V = 100, whose dK and dV rows must be exactly
    zero); the plain backward
    without the last DROPPED_KEYS keys must fail them. A second call must
    repeat dK and dV exactly and dQ within DQ_REPEAT_RTOL. With the card at
    FULL_POWER_W the D = 64 rows must also keep to BWD_MS_LINES. Times: the whole
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
    ]
    g = torch.Generator(device=dev).manual_seed(4321)
    shapes = []
    for label, b, sq, skv, h, d, kv_len in cases:
        scale = d ** -0.5
        q = torch.randn((b, sq, h, d), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((b, skv, h, d), generator=g, device=dev).bfloat16() for _ in range(2))
        k[:, kv_len:], v[:, kv_len:] = 10.0, 100.0
        out, lse = flash_attention_forward(q, k, v, scale, kv_len, with_lse=True)
        do = torch.randn(out.shape, generator=g, device=dev).bfloat16()
        grads = flash_attention_backward(q, k, v, out, do, lse, scale, kv_len)
        again = flash_attention_backward(q, k, v, out, do, lse, scale, kv_len)
        torch.cuda.synchronize()
        dq_gap = (again[0].float() - grads[0].float()).abs()
        dq_rms = grads[0].float().pow(2).mean().sqrt()
        repeat = dict(dkdv_equal=torch.equal(again[1], grads[1]) and torch.equal(again[2], grads[2]),
                      dq_max_abs_gap=dq_gap.max().item(),
                      dq_ok=bool((dq_gap <= DQ_REPEAT_RTOL * grads[0].float().abs() + DQ_REPEAT_RMS_ATOL * dq_rms).all()))
        del again, dq_gap
        # The reference chain is plain end to end: the plain forward's own
        # output and log-sum-exp on the same bf16 inputs feed the plain backward.
        ref_out, ref_lse = _plain_forward(q, k, v, scale, kv_len, False)
        lse_err = (lse - ref_lse).abs().max().item()
        cut_lse_err = (_plain_forward(q, k, v, scale, kv_len - DROPPED_KEYS, False)[1] - ref_lse).abs().max().item()
        f32 = [t.float() for t in (q, k, v, ref_out, do)]
        del ref_out
        ref = flash_attention_backward_plain(*f32, ref_lse, scale, kv_len)
        errs = {n: errors(a, r) for n, a, r in zip(("dq", "dk", "dv"), grads, ref)}
        cut = flash_attention_backward_plain(*f32, ref_lse, scale, kv_len - DROPPED_KEYS)
        cut_errs = {n: errors(a, r) for n, a, r in zip(("dq", "dk", "dv"), cut, ref)}
        del cut, ref
        masked_zero = not grads[1][:, kv_len:].any() and not grads[2][:, kv_len:].any()

        def bwd():
            flash_attention_backward(q, k, v, out, do, lse, scale, kv_len)

        ms = cuda_ms(bwd, reps=3)
        design, names = BWD_DESIGNS[d]
        split = kernel_ms_from_trace(bwd, names)
        plain_ms = cuda_ms(lambda: flash_attention_backward_plain(*f32, ref_lse, scale, kv_len), reps=1)
        del f32, ref_lse
        torch.cuda.empty_cache()
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k[:, :kv_len], v[:, :kv_len]))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qt, kt, vt).backward(dot)

        with torch.no_grad():
            sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=3)
        library_ms = cuda_ms(sdpa_fwd_bwd, reps=3) - sdpa_fwd_ms
        flops = 10 * b * h * sq * kv_len * d
        nbytes = (4 * sq + 4 * kv_len) * b * h * d * 2 + 2 * b * h * sq * 4
        ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        row = dict(label=label, shape=[b, sq, h, d], skv=skv, kv_len=kv_len,
                   **{f"{n}_{key}": e[key] for n, e in errs.items() for key in e},
                   max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                   lse_max_abs_err=lse_err, dropped_keys_lse_err=cut_lse_err,
                   dropped_keys_rel_err={n: [e["max_rel_err"], e["mean_rel_err"]] for n, e in cut_errs.items()},
                   masked_rows_zero=masked_zero, repeat=repeat, design=design, ms=ms,
                   kernel_ms={n.removeprefix("flash_bwd_"): t for n, t in split.items()}, plain_ms=plain_ms,
                   library_ms=library_ms, library_fwd_ms=sdpa_fwd_ms,
                   bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   tflops=flops / ms / 1e9, bound_share=max(ops_ms, bytes_ms) / ms,
                   ms_line=BWD_MS_LINES.get(label), within_ms_line=ms <= BWD_MS_LINES.get(label, math.inf),
                   at_most_library=ms <= library_ms)
        log("kernel flash_attn_bwd " + json.dumps(row))
        if not all(within_limits(e) for e in errs.values()):
            raise AssertionError(f"backward kernel disagrees with its plain version at {label}: {errs}")
        if all(within_limits(e) for e in cut_errs.values()):
            raise AssertionError(f"the limits do not catch {DROPPED_KEYS} dropped keys at {label}: {cut_errs}")
        if not lse_err <= LSE_ATOL or cut_lse_err <= LSE_ATOL:
            raise AssertionError(f"forward kernel's log-sum-exp off by {lse_err} at {label} (limit {LSE_ATOL}, "
                                 f"{DROPPED_KEYS} dropped keys give {cut_lse_err})")
        if not masked_zero:
            raise AssertionError(f"dK/dV rows past kv_len are not zero at {label}")
        if not (repeat["dkdv_equal"] and repeat["dq_ok"]):
            raise AssertionError(f"a second backward call differs from the first at {label}: {repeat}")
        if power_limit_w >= FULL_POWER_W and not row["within_ms_line"]:
            raise AssertionError(f"backward kernel took {ms:.3f} ms at {label}, over its line of {row['ms_line']} ms")
        shapes.append(row)
        del q, k, v, out, lse, do, grads, qt, kt, vt, dot
        torch.cuda.empty_cache()
    return {"shapes": shapes}


def kernel_ms_from_trace(fn, names, reps: int = 3) -> dict:
    """Mean device milliseconds per call of each named kernel in `fn`, from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    totals = {n: 0.0 for n in names}
    for ev in prof.key_averages():
        for n in names:
            if n in ev.key:
                totals[n] += getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
    if not any(totals.values()):
        raise AssertionError(f"the profiler trace holds no device time for {names}")
    return {n: t / 1e3 / reps for n, t in totals.items()}


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
    models = {d: build_trainer("tiny", seed=seed, compute_dtype=torch.float32, device=d) for d in (dev, "cpu")}
    for gpu, cpu in zip(models[dev], models["cpu"]):
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
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


class StepProbe(logging.Handler):
    """Reads the kernel launch counts and the peak device memory at each of
    `train`'s "step N" log lines (log_steps = 1), then resets the peak."""

    def __init__(self, dev, counters):
        super().__init__(logging.INFO)
        self.dev, self.counters, self.rows = dev, counters, []
        self.last = [c.launches for c in counters]

    def emit(self, record) -> None:
        import torch

        if not record.getMessage().startswith("step "):
            return
        counts = [c.launches for c in self.counters]
        self.rows.append(dict(fwd_launches=counts[0] - self.last[0], bwd_launches=counts[1] - self.last[1],
                              peak_memory_bytes=torch.cuda.max_memory_allocated(self.dev)))
        self.last = counts
        torch.cuda.reset_peak_memory_stats(self.dev)


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
        trainer_log = logging.getLogger(trainer_module.__name__)
        level = trainer_log.level
        trainer_log.setLevel(logging.INFO)
        torch.cuda.reset_peak_memory_stats(dev)
        flash_attention.launches = flash_attention_backward.launches = 0
        probe = StepProbe(dev, (flash_attention, flash_attention_backward))
        trainer_log.addHandler(probe)
        t0 = time.perf_counter()
        try:
            state = trainer_module.train(unet, vae, clip, data, cfg, tc, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
        finally:
            trainer_log.removeHandler(probe)
            trainer_log.setLevel(level)
        seconds = time.perf_counter() - t0
        launches = [flash_attention.launches, flash_attention_backward.launches]
        # the checkpoint's save, after the last step's log line
        peak = max([r["peak_memory_bytes"] for r in probe.rows] + [torch.cuda.max_memory_allocated(dev)])
        with open(os.path.join(out_dir, "train_metrics.jsonl")) as f:
            rows = [{**json.loads(line), **probed, "expected_launches": list(expected)}
                    for line, probed in zip(f, probe.rows)]
        ckpt_dir = os.path.join(out_dir, "checkpoints")
        ckpt_files = sorted(os.listdir(ckpt_dir))
        ckpt_path = os.path.join(ckpt_dir, f"{steps}.pt")
        ckpt_bytes = os.path.getsize(ckpt_path)
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    for row in rows:
        log("train step " + json.dumps(row))
    if [r["step"] for r in rows] != list(range(1, steps + 1)) or len(probe.rows) != steps:
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


def check_small_clip_against_cpu(dev, seed: int) -> float:
    """Tiny-width fp32 clip on the card against the same clip on the CPU."""
    import torch

    from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
    from evoworld_tpu_torch.runtime import build_pipeline

    cfg = PipelineConfig(height=64, width=128, num_frames=5, num_steps=2)
    gpu = build_pipeline(cfg, "tiny", seed=seed, compute_dtype=torch.float32, device=dev)
    cpu = build_pipeline(cfg, "tiny", seed=seed, compute_dtype=torch.float32, device="cpu")
    for name in ("unet", "vae", "clip_tower"):
        getattr(cpu, name).load_state_dict({k: v.cpu() for k, v in getattr(gpu, name).state_dict().items()})
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


def full_clips(dev, steps: int, seed: int) -> list[dict]:
    """Two full-width clips (cold, warm); checks launch counts and outputs."""
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
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an NVIDIA card", file=sys.stderr)
        return 1
    from evoworld_tpu_torch.ops import _build
    from evoworld_tpu_torch.ops.flash_attention import BWD_SOURCE, SOURCE

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
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        list(pool.map(_build.load, (SOURCE, BWD_SOURCE)))
    log(f"nvcc build of {SOURCE} and {BWD_SOURCE}: {time.perf_counter() - t0:.3f} s")
    for source in (SOURCE, BWD_SOURCE):
        for row in ptxas_report(_build.build_log(source)):
            log(f"ptxas {source} " + json.dumps(row))
            if row.get("spill_stores") or row.get("spill_loads") or "wgmma_serialized" in row:
                raise AssertionError(f"{source}: a kernel entry spills or serializes its wgmma: {row}")

    flash = check_flash_kernel(dev)
    watts = re.search(r",\s*([\d.]+) W", smi)  # "[N/A]" where the limit cannot be read
    flash_bwd = check_flash_backward(dev, float(watts.group(1)) if watts else 0.0)
    check_small_clip_against_cpu(dev, SEED)
    runs = full_clips(dev, STEPS, SEED)
    torch.cuda.empty_cache()
    check_level0_transformer(dev)
    check_small_train_step_against_cpu(dev, SEED)
    train_run = full_train(dev, TRAIN_STEPS, SEED)

    fwd_row = flash["shapes"][0]  # UNet level-0 attention: 5 of every 5N + 18 launches of a clip
    bwd_row = flash_bwd["shapes"][0]  # the training shape: 5 launches per step
    fwd_total, bwd_total = train_run["summary"]["launches_total"]
    kernels = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "evoworld_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "evoworld_tpu/ops/attention.py:170",
        "also_replaces": "evoworld_tpu/ops/flash_attention.py:137",
        "launches": fwd_total,
        "launches_by_path": {"train_steps": fwd_total, "clip": runs[-1]["flash_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in flash["shapes"]),
        "ms": fwd_row["ms"],
        "plain_ms": fwd_row["plain_ms"],
        "bound_ms": fwd_row["bound_ms"],
        "bound_by": fwd_row["bound_by"],
        "library_ms": fwd_row["library_ms"],
        "timed_at": fwd_row["shape"],
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
        "launches_by_path": {"train_steps": bwd_total, "clip": 0},
        "max_abs_err": max(r["max_abs_err"] for r in flash_bwd["shapes"]),
        "ms": bwd_row["ms"],
        "design": bwd_row["design"],
        "kernel_ms": bwd_row["kernel_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
        "timed_at": bwd_row["shape"],
        "shapes": flash_bwd["shapes"],
        "ok": True,
    }]
    log(f"wall seconds {time.perf_counter() - wall0:.3f}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
