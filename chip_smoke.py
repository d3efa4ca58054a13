#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`evoworld_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build the port's CUDA source with nvcc for sm_90a;
  3. hold each kernel against its plain PyTorch version at the shapes the
     main path gives it (plus a ragged length with padded, masked keys),
     within limits relative to the plain output's RMS that a deliberately
     wrong result must fail, and time the kernel, the plain version and, as
     a yardstick only, one PyTorch library call;
  4. a small clip on the card against the same clip on the CPU (tiny widths,
     fp32), the port's own reference check;
  5. two full-width clips (1024x576, 25 frames, bf16, random weights from
     seed 0, N = 4 denoise steps), cold then warm, through `build_pipeline`
     and the pipeline's `__call__`; the kernel launch counts are reset just
     before each clip and must equal 5*N + 18 after it.
It prints, in order before the last line, the card's name and power limit,
a JSON line of the kernels, and ends with the JSON line
{"ok": true, "device": {...}}. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bandwidth
# Kernel against plain version, error over the RMS of the plain output (about
# sqrt(e / kv_len) for these inputs). bf16 rounding of P and of the output sits
# near 0.03 max / 0.002 mean; leaving out one 32-key tile moves the output by
# about 0.05 mean, which DROPPED_KEYS checks the limits catch.
MAX_REL_ERR, MEAN_REL_ERR = 0.1, 0.01
DROPPED_KEYS = 32
STEPS = 4  # denoise steps per full-width clip (production: 25), cut for the time limit
SEED = 0


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
    the last DROPPED_KEYS keys must fail them.
    """
    import torch
    import torch.nn.functional as F

    from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    cases = [  # (label, B, Sq, Skv, H, D, kv_len, use_exp2)
        ("unet_l0_spatial", 50, 9216, 9216, 5, 64, 9216, False),
        ("vae_encoder_mid", 2, 9216, 9216, 1, 512, 9216, False),
        ("vae_decoder_mid", 5, 9216, 9216, 1, 512, 9216, False),
        # VGGT's global attention over 5 frames x 1041 tokens, keys padded to
        # K1's 512-key block multiple and masked past the real length
        ("ragged_padded_kv", 1, 5205, 5632, 16, 64, 5205, False),
        ("ragged_padded_kv_exp2", 1, 5205, 5632, 16, 64, 5205, True),
    ]
    g = torch.Generator(device=dev).manual_seed(1234)
    shapes = []
    for label, b, sq, skv, h, d, kv_len, use_exp2 in cases:
        q = torch.randn((b, sq, h, d), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((b, skv, h, d), generator=g, device=dev).bfloat16() for _ in range(2))
        k[:, kv_len:], v[:, kv_len:] = 10.0, 100.0
        out = flash_attention(q, k, v, kv_len=kv_len, use_exp2=use_exp2)
        torch.cuda.synchronize()
        qf, kf, vf = q.float(), k.float(), v.float()
        ref = flash_attention_plain(qf, kf, vf, kv_len=kv_len, use_exp2=use_exp2)
        err = errors(out, ref)
        cut = errors(flash_attention_plain(qf, kf, vf, kv_len=kv_len - DROPPED_KEYS, use_exp2=use_exp2), ref)
        del ref
        flops = 4 * b * h * sq * kv_len * d
        nbytes = (2 * sq + 2 * kv_len) * b * h * d * 2
        ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        ms = cuda_ms(lambda: flash_attention(q, k, v, kv_len=kv_len, use_exp2=use_exp2), reps=5)
        plain_ms = cuda_ms(lambda: flash_attention_plain(qf, kf, vf, kv_len=kv_len, use_exp2=use_exp2), reps=1)
        qt, kt, vt = q.transpose(1, 2), k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=5)
        row = dict(label=label, shape=[b, sq, h, d], skv=skv, kv_len=kv_len, use_exp2=use_exp2, **err,
                   dropped_keys_rel_err=[cut["max_rel_err"], cut["mean_rel_err"]],
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   tflops=flops / ms / 1e9)
        log("kernel flash_attn_fwd " + json.dumps(row))
        if not within_limits(err):
            raise AssertionError(f"flash kernel disagrees with its plain version at {label}: {err}")
        if within_limits(cut):
            raise AssertionError(f"the limits do not catch {DROPPED_KEYS} dropped keys at {label}: {cut}")
        shapes.append(row)
        del q, k, v, qf, kf, vf, out
        torch.cuda.empty_cache()
    return {"shapes": shapes}


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
    from evoworld_tpu_torch.ops.flash_attention import SOURCE, flash_attention

    dev = torch.device("cuda", 0)
    # Full fp32 where the port computes in fp32 (the resize, CLIP, the
    # small-clip reference check): no TF32 in matmuls or cuDNN convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.load(SOURCE)
    log(f"nvcc build of {SOURCE}: {time.perf_counter() - t0:.3f} s")
    for line in _build.build_log(SOURCE).splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    flash = check_flash_kernel(dev)
    check_small_clip_against_cpu(dev, SEED)
    runs = full_clips(dev, STEPS, SEED)

    main_row = flash["shapes"][0]  # UNet level-0 attention: 5 of every 5N + 18 launches
    kernels = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "evoworld_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "evoworld_tpu/ops/attention.py:170",
        "also_replaces": "evoworld_tpu/ops/flash_attention.py:137",
        "launches": runs[-1]["flash_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in flash["shapes"]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "timed_at": main_row["shape"],
        "shapes": flash["shapes"],
        "ok": True,
    }]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
