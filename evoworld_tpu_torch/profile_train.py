"""Device-time and memory breakdown of one full-width training step on the card.

    python -m evoworld_tpu_torch.profile_train [--out outputs/profile_train.json]

Builds the full-width trainer (`build_trainer`, random weights, seed 0,
block remat, bf16), takes two warm-up steps on a synthetic batch
(1024x576, 25 frames, batch 1), then traces one step with `torch.profiler`
(CPU + CUDA activities). Prints and writes: the host wall time of the traced
step, the summed device time of its kernels, the device's idle share
(1 - device time / wall time; one stream), device time by kernel category
(the categories of `profile_clip`), the 25 kernels with the most device
time, the memory the training state holds before a step and the step's
peak, and, timed apart with the device synchronised, the frozen encoders'
share (VAE encode of the frames and conditioning frames, CLIP) and one
optimizer update. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from evoworld_tpu_torch.models.clip import clip_preprocess
from evoworld_tpu_torch.ops.resize import resize_antialiased
from evoworld_tpu_torch.profile_clip import categorise
from evoworld_tpu_torch.runtime import build_trainer
from evoworld_tpu_torch.train.train_step import TrainConfig, make_train_state, train_step


def _seconds(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="outputs/profile_train.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs an NVIDIA card")
    dev = torch.device("cuda", 0)

    f, h, w = 25, 576, 1024
    unet, vae, clip = build_trainer("full", seed=0, device=dev)
    cfg = TrainConfig(warmup_steps=1)
    state = make_train_state(cfg, unet)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"pixel_values": torch.rand((1, f, h, w, 3), generator=g, device=dev) * 2 - 1,
             "memory_values": torch.rand((1, f, h, w, 3), generator=g, device=dev) * 2 - 1,
             "plucker": torch.randn((1, f, h // 8, w // 8, 6), generator=g, device=dev)}
    for _ in range(2):  # warm-up: cuDNN set-up, allocator, kernel build
        train_step(state, vae, clip, [batch], cfg, generator=g)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = train_step(state, vae, clip, [batch], cfg, generator=g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)

    def encoders():
        with torch.no_grad():
            px = batch["pixel_values"][0].permute(0, 3, 1, 2)
            for n in (f, f + 1):
                images = px[:1].expand(n, -1, -1, -1)
                noise = torch.randn((n, 4, h // 8, w // 8), generator=g, device=dev)
                vae.encode_sample(images, noise, cfg.vae_encode_chunk)
            x224 = resize_antialiased(batch["pixel_values"][:, 0], (224, 224))
            clip(clip_preprocess((x224 + 1.0) / 2.0).permute(0, 3, 1, 2).bfloat16())

    encode_s = _seconds(encoders)
    optimizer_s = _seconds(state.optimizer.step)

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
        "shape": {"frames": f, "height": h, "width": w, "batch": 1, "remat": unet.config.remat},
        "loss": metrics["loss"],
        "wall_seconds": wall,
        "device_kernel_seconds": device_s,
        "idle_share": 1.0 - device_s / wall,
        "encoders_seconds": encode_s,
        "optimizer_seconds": optimizer_s,
        "state_bytes": state_bytes,
        "peak_memory_bytes": peak,
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
