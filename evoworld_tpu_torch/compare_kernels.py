"""Compare this checkout's flash kernels with another checkout's on one card.

    python -m evoworld_tpu_torch.compare_kernels --other <root of another checkout> \\
        [--parts sass,bf16_ab,fp32_ab,twins,vggt,power] [--out chiprun_out/compare_kernels.json]

Six parts (all by default), each printed as one JSON line and all written
to `--out`:

1. `sass`: both checkouts build their kernel libraries (each with its own
   `ops/_build.py`, the two in parallel), `cuobjdump -sass` dumps them, and
   every kernel entry's instructions (encodings included) are compared with
   the other checkout's entry of the same kernel, head dim and element type.
   An entry whose name carries no element type is bf16 (the kernels before
   the type became a template parameter), except the fp32 kernels
   (`flash_fp32_*`, a source of their own, built where a checkout has it),
   which are fp32 and paired by kernel and head dim alone. Within this
   checkout, each fp16 entry is compared with its bf16 twin: the lines that
   differ, counted by the pair of opcodes in which they differ (fp32 entries
   have no twin).
2. `bf16_ab`: each checkout times the bf16 rows of ROWS in a process of its
   own, in the order other, this, this, other, by CUDA events.
3. `fp32_ab`: the same for the fp32 rows of ROWS (`csrc/flash_attn_fp32.cu`
   where a checkout has it), so that an fp32 kernel's before and after come
   from one card in one run.
4. `twins`: in this checkout, each row in bf16 and fp16 interleaved (bf16,
   fp16, fp16, bf16), by CUDA events around the whole call and by the
   profiler's device time of the `flash_` kernels, and the ratios of the two
   types by each.
5. `vggt`: VGGT-1B with random weights (seed 0) on 73 random crops of
   384 x 512 (`cli/reproject.py` on a 97-frame episode), in bf16 and fp16 in
   one process, in both orders: each type's first call and the mean of the
   three calls after it.
6. `power`: in this checkout, each of POWER_ROWS called back to back for
   POWER_S seconds a type (bf16, fp16, fp16, bf16) while `nvidia-smi`
   samples the card's power draw and SM clock every 100 ms: the means of
   both after the first POWER_SETTLE_S seconds, beside the ms a call.

Needs a card. Timing processes import the package of the checkout they time.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

SOURCES = ("flash_attn_fwd.cu", "flash_attn_bwd.cu", "flash_attn_fp32.cu")
KERNELS = ("flash_fwd_wgmma", "flash_fwd_wide", "flash_bwd_delta", "flash_bwd_fused", "flash_bwd_store_dq",
           "flash_bwd_wide_dv", "flash_bwd_wide_dk", "flash_bwd_wide_dq",
           "flash_fp32_fwd", "flash_fp32_bwd_delta", "flash_fp32_bwd_dkdv", "flash_fp32_bwd_dq")
# (label, direction, B, Sq, Skv, H, D, kv_len, with_lse): the main path's shapes
ROWS = (
    ("unet_l0_spatial", "fwd", 50, 9216, 9216, 5, 64, 9216, False),
    ("unet_l0_train_lse", "fwd", 25, 9216, 9216, 5, 64, 9216, True),
    ("vggt_global_49", "fwd", 1, 51009, 51009, 16, 64, 51009, False),
    ("vggt_global_73", "fwd", 1, 75993, 75993, 16, 64, 75993, False),
    ("ragged_padded_kv", "fwd", 1, 5205, 5632, 16, 64, 5205, False),
    ("vae_encoder_mid", "fwd", 2, 9216, 9216, 1, 512, 9216, False),
    ("vae_encoder_mid_train", "fwd", 8, 9216, 9216, 1, 512, 9216, False),
    ("vae_decoder_mid", "fwd", 5, 9216, 9216, 1, 512, 9216, False),
    ("unet_l0_train", "bwd", 25, 9216, 9216, 5, 64, 9216, True),
    ("head_dim_128_fwd", "fwd", 2, 9216, 9216, 2, 128, 9216, False),
    ("head_dim_128", "bwd", 2, 9216, 9216, 2, 128, 9216, True),
    ("vae_mid_d512", "bwd", 8, 9216, 9216, 1, 512, 9216, True),
)
PARTS = ("sass", "bf16_ab", "fp32_ab", "twins", "vggt", "power")
AB_PARTS = {"bf16_ab": "bf16", "fp32_ab": "fp32"}  # the parts that time both checkouts, and their type
DTYPES = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}
POWER_ROWS = ("unet_l0_train", "vae_mid_d512", "vggt_global_49", "unet_l0_spatial")
POWER_S, POWER_SETTLE_S = 4.0, 1.0
FILL_MS = 200.0  # each timing repeats a call until about this much device time has passed
VGGT_FRAMES, VGGT_HW = 73, (384, 512)
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sass_entries(lib: str, cuobjdump: str) -> dict[tuple, list[str]]:
    """{(kernel, head dim or None, element type): SASS lines} of a library."""
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    out, key = {}, None
    for line in text.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            key = entry_key(func.group(1))
            out[key] = []
        elif key and line.strip() and not line.strip().startswith(".") and "....." not in line:
            out[key].append(line.strip())
    return out


def entry_key(mangled: str) -> tuple:
    """(kernel, head dim or None, element type) of a mangled kernel name."""
    for name in sorted(KERNELS, key=len, reverse=True):
        at = mangled.find(f"{len(name)}{name}")
        if at >= 0:
            d = re.match(r"ILi(\d+)E", mangled[at + len(str(len(name))) + len(name):])
            elem = "fp32" if name.startswith("flash_fp32_") else "fp16" if "6__half" in mangled else "bf16"
            return name, int(d.group(1)) if d else None, elem
    return mangled, None, None


def opcode(line: str) -> str:
    """The opcode of a SASS line with its modifiers, or "encoding" for a line
    that holds only the second half of an instruction's encoding."""
    m = re.match(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", line)
    return m.group(1) if m else "encoding"


def twin_diff(bf16: list[str], fp16: list[str]) -> dict:
    """An fp16 entry's SASS against its bf16 twin's, line by line."""
    pairs = Counter((opcode(a), opcode(b)) for a, b in zip(bf16, fp16) if a != b)
    return dict(lines=len(fp16), bf16_lines=len(bf16), differing_lines=sum(pairs.values()),
                differing_opcodes=[[a, b, n] for (a, b), n in sorted(pairs.items())])


def compare_sass(other: str) -> dict:
    """Part 1: build both checkouts (in parallel) and compare their entries."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        mine, theirs = pool.map(lambda root: run_worker(root, "build"), (HERE, other))
    cuobjdump = os.path.join(os.path.dirname(mine["nvcc"]), "cuobjdump")
    entries, twins = [], []
    for src in SOURCES:
        a, b = ({} if src not in lib["libs"] else sass_entries(lib["libs"][src], cuobjdump) for lib in (mine, theirs))
        for key in sorted(set(a) | set(b), key=str):
            row = dict(source=src, kernel=key[0], d=key[1], dtype=key[2], lines=len(a.get(key, [])),
                       other_lines=len(b.get(key, [])))
            if key in a and key in b:
                row["identical"] = a[key] == b[key]
                row["differing_lines"] = sum(x != y for x, y in zip(a[key], b[key])) + abs(len(a[key]) - len(b[key]))
            entries.append(row)
            if key[2] == "fp16" and (key[0], key[1], "bf16") in a:
                twins.append(dict(source=src, kernel=key[0], d=key[1], **twin_diff(a[(key[0], key[1], "bf16")], a[key])))
    summary = {}
    for elem in ("bf16", "fp16", "fp32"):
        typed = [e for e in entries if e["dtype"] == elem]
        summary.update({f"{elem}_identical": bool(typed) and all(e.get("identical") for e in typed),
                        f"{elem}_entries": len(typed), f"{elem}_paired": sum("identical" in e for e in typed)})
    return dict(build_s=time.perf_counter() - t0, entries=entries, fp16_against_bf16=twins, **summary)


def worker(mode: str) -> dict:
    """Runs in a process whose `sys.path` starts at the checkout it measures."""
    import torch

    if mode == "build":
        from evoworld_tpu_torch.ops import _build

        sources = [s for s in SOURCES if (_build.CSRC / s).exists()]  # an older checkout lacks the fp32 source
        with ThreadPoolExecutor(len(sources)) as pool:
            list(pool.map(_build.load, sources))
        return dict(nvcc=_build._nvcc(), libs={s: str(_build._lib_path(s)) for s in sources})
    if mode in AB_PARTS.values():
        return {label: time_row(row, getattr(torch, DTYPES[mode]))[0] for label, *row in ROWS}
    if mode == "twins":
        out = {}
        for label, *row in ROWS:
            reads = {t: [] for t in ("bf16", "fp16")}
            for t in ("bf16", "fp16", "fp16", "bf16"):
                reads[t].append(time_row(row, getattr(torch, DTYPES[t]), trace=True))
            mean = {t: [sum(r[i] for r in v) / len(v) for i in (0, 1)] for t, v in reads.items()}
            out[label] = dict(events_ms=[mean["bf16"][0], mean["fp16"][0]], trace_ms=[mean["bf16"][1], mean["fp16"][1]],
                              events_ratio=mean["fp16"][0] / mean["bf16"][0],
                              trace_ratio=mean["fp16"][1] / mean["bf16"][1], reads=reads)
        return out
    if mode == "power":
        rows = {label: row for label, *row in ROWS}
        return {label: [dict(dtype=t, **power_read(rows[label], getattr(torch, DTYPES[t])))
                        for t in ("bf16", "fp16", "fp16", "bf16")] for label in POWER_ROWS}
    if mode.startswith("vggt:"):
        return time_vggt(mode.removeprefix("vggt:").split(","))
    raise ValueError(mode)


def cuda_ms(fn) -> float:
    """Mean device milliseconds of `fn` over as many launches as fill FILL_MS."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(3, int(FILL_MS / max(start.elapsed_time(end), 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def trace_ms(fn, reps: int = 5) -> float:
    """Mean device milliseconds a call of the `flash_` kernels in `fn`, from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
                for ev in prof.key_averages() if "flash_" in ev.key)
    return total / 1e3 / reps


def row_call(row: tuple, dtype):
    """A function that makes one row's kernel call in `dtype`, on inputs drawn from a fixed seed."""
    import torch

    from evoworld_tpu_torch.ops.flash_attention import flash_attention_backward, flash_attention_forward

    direction, b, sq, skv, h, d, kv_len, with_lse = row
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((b, sq, h, d), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((b, skv, h, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    scale = d ** -0.5
    if direction == "fwd":
        return lambda: flash_attention_forward(q, k, v, scale, kv_len, with_lse=with_lse)
    out, lse = flash_attention_forward(q, k, v, scale, kv_len, with_lse=True)
    do = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    return lambda: flash_attention_backward(q, k, v, out, do, lse, scale, kv_len)


def time_row(row: tuple, dtype, trace: bool = False) -> list[float]:
    """[events ms] of one row's call in `dtype` (and the trace's ms with `trace`)."""
    import torch

    call = row_call(row, dtype)
    reads = [cuda_ms(call)] + ([trace_ms(call)] if trace else [])
    del call
    torch.cuda.empty_cache()
    return reads


def power_read(row: tuple, dtype) -> dict:
    """Part 5 for one row and type: ms a call, and the card's mean power draw
    (W) and SM clock (MHz) over the calls after the first POWER_SETTLE_S s."""
    import torch

    call = row_call(row, dtype)
    call()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=power.draw,clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    calls, settled, start = 0, None, None
    while time.perf_counter() - t0 < POWER_S:
        call()
        torch.cuda.synchronize()
        if settled is None and time.perf_counter() - t0 >= POWER_SETTLE_S:
            settled, start = time.perf_counter(), calls + 1
        calls += 1
    end = time.perf_counter()
    smi.terminate()
    lines = smi.communicate()[0].splitlines()
    samples = [[float(x) for x in line.split(",")] for line in lines if re.match(r"\s*[\d.]+\s*,\s*[\d.]+\s*$", line)]
    kept = samples[int(len(samples) * POWER_SETTLE_S / POWER_S):]
    del call
    torch.cuda.empty_cache()
    return dict(ms=(end - settled) * 1e3 / max(calls - start, 1),
                power_w=sum(s[0] for s in kept) / len(kept) if kept else None,
                sm_mhz=sum(s[1] for s in kept) / len(kept) if kept else None, samples=len(kept))


def time_vggt(order: list[str]) -> dict:
    """Part 4 in one process: VGGT-1B built and called in each type of `order`."""
    import torch

    from evoworld_tpu_torch.runtime import build_reconstructor

    g = torch.Generator(device="cuda").manual_seed(0)
    imgs = torch.rand((VGGT_FRAMES, *VGGT_HW, 3), generator=g, device="cuda")
    out = {}
    for name in order:
        model = build_reconstructor("full", 0, getattr(torch, DTYPES[name]), "cuda")
        seconds = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                model(imgs)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        out[name] = dict(first_s=seconds[0], warm_s=sum(seconds[1:]) / 3, seconds=seconds)
        del model
        torch.cuda.empty_cache()
    return out


def ab_times(runs: list[tuple[str, dict]], other: str) -> dict:
    """{label: other's and this checkout's ms, and the ratio of their sums} from
    the (root, {label: ms}) runs of an A B B A part; a row that a checkout
    does not time (an older checkout lacks it) gets no ratio."""
    out = {}
    for label, *_ in ROWS:
        mine = [r[label] for root, r in runs if root != other and label in r]
        theirs = [r[label] for root, r in runs if root == other and label in r]
        out[label] = dict(other_ms=theirs, this_ms=mine,
                          ratio=sum(mine) / sum(theirs) if mine and theirs else None)
    return out


def run_worker(root: str, mode: str) -> dict:
    """`worker(mode)` in a new process that imports the package of the checkout at `root`."""
    done = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", mode, "--root", root],
                          capture_output=True, text=True, check=False)
    if done.returncode:
        raise RuntimeError(f"worker {mode} in {root} failed ({done.returncode}):\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.splitlines()[-1])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the checkout to compare with (parts sass, bf16_ab and fp32_ab)")
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--out", default="chiprun_out/compare_kernels.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        sys.path[0] = os.path.abspath(args.root)  # that checkout's package, not the script's own directory
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    parts = args.parts.split(",")
    if set(parts) - set(PARTS):
        ap.error(f"unknown parts {sorted(set(parts) - set(PARTS))}; known: {','.join(PARTS)}")
    other = os.path.abspath(args.other) if args.other else None
    if other is None and {"sass", *AB_PARTS} & set(parts):
        ap.error("parts sass, bf16_ab and fp32_ab need --other")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    result = {"device": smi}
    print(smi, flush=True)
    if "sass" in parts:
        result["sass"] = compare_sass(other)
        print(json.dumps({"sass": {k: v for k, v in result["sass"].items() if k != "entries"}}), flush=True)
        print(json.dumps({"sass_entries": result["sass"]["entries"]}), flush=True)
    for part, elem in AB_PARTS.items():
        if part in parts:
            result[part] = ab_times([(root, run_worker(root, elem)) for root in (other, HERE, HERE, other)], other)
            print(json.dumps({part: result[part]}), flush=True)
    if "twins" in parts:
        result["twins"] = run_worker(HERE, "twins")
        print(json.dumps({"twins": {k: {m: v[m] for m in ("events_ms", "trace_ms", "events_ratio", "trace_ratio")}
                                    for k, v in result["twins"].items()}}), flush=True)
    if "vggt" in parts:
        result["vggt"] = {order: run_worker(HERE, f"vggt:{order}") for order in ("bf16,fp16", "fp16,bf16")}
        print(json.dumps({"vggt": result["vggt"]}), flush=True)
    if "power" in parts:
        result["power"] = run_worker(HERE, "power")
        print(json.dumps({"power": result["power"]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
