"""Device-time breakdown of one full-width clip on the card.

    python -m evoworld_tpu_torch.profile_clip [--out chiprun_out/profile_clip.json]

Builds the full-width pipeline (random weights, seed 0, one denoise step:
the step repeats N times in a clip of N steps), runs one warm-up clip, then
traces one clip with `torch.profiler` (CPU + CUDA activities). Prints and
writes: the host wall time of the traced clip, the summed device time of
its kernels, the device's idle share (1 - device time / wall time; one
stream, so kernels do not overlap), device time by kernel category, and
the 25 kernels with the most device time. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from evoworld_tpu_torch.diffusion.pipeline import PipelineConfig
from evoworld_tpu_torch.runtime import build_pipeline

#: Kernel-name substrings -> category, first match wins.
CATEGORIES = (
    ("flash_attn_fwd (ours)", ("flash_fwd_",)),
    ("flash_attn_bwd (ours)", ("flash_bwd_",)),
    ("softmax", ("softmax",)),
    ("norm", ("group_norm", "groupnorm", "layer_norm", "layernorm", "rowwisemoments", "welford",
              "computefusedparams", "compute_stats")),
    ("conv", ("conv", "implicit", "cudnn", "fprop", "winograd")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "ampere_", "cublas")),
    ("copy/cat/transpose", ("copy", "cat", "transpose", "permute", "contiguous")),
    ("elementwise/reduce", ("elementwise", "vectorized", "reduce", "unrolled")),
)


def categorise(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile_clip.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_clip needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = PipelineConfig(num_steps=1)
    pipe = build_pipeline(cfg, "full", seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    image = torch.rand((cfg.height, cfg.width, 3), generator=g, device=dev) * 2 - 1
    plucker = torch.randn((cfg.num_frames, 6, cfg.latent_height, cfg.latent_width), generator=g, device=dev)
    memory = torch.rand((cfg.num_frames, cfg.height, cfg.width, 3), generator=g, device=dev) * 2 - 1

    pipe(image, plucker, memory, generator=g)  # warm-up: cuDNN autotune, allocator, kernel build
    torch.cuda.synchronize()
    timings: dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(image, plucker, memory, generator=g, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels: dict[str, list] = {}
    for evt in prof.events():
        # device kernels only: a record_function range (e.g. Optimizer.step) is mirrored
        # on the device timeline as a user annotation that spans its kernels
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            k = kernels.setdefault(evt.name, [0.0, 0])
            k[0] += evt.time_range.elapsed_us() / 1e6
            k[1] += 1
    device_s = sum(v[0] for v in kernels.values())
    by_cat: dict[str, float] = {}
    for name, (secs, _) in kernels.items():
        by_cat[categorise(name)] = by_cat.get(categorise(name), 0.0) + secs
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    result = {
        "device": torch.cuda.get_device_name(0),
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60).stdout.strip(),
        "num_steps": cfg.num_steps,
        "wall_seconds": wall,
        "stage_seconds": timings,
        "device_kernel_seconds": device_s,
        "idle_share": 1.0 - device_s / wall,
        "by_category_seconds": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "top_kernels": [
            {"name": n[:160], "seconds": s, "calls": c, "category": categorise(n)} for n, (s, c) in top
        ],
    }
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "top_kernels"}))
    for row in result["top_kernels"][:12]:
        print(f"  {row['seconds']:.4f} s  {row['calls']:5d}x  {row['category']:22s} {row['name'][:90]}")
    return result


if __name__ == "__main__":
    main()
