"""One-command weights-day parity gate (counterpart of
`evoworld_tpu/cli/validate_parity.py`).

Chains, in order:
  [1/4] converter validation: the SVD pipeline directory's safetensors
        headers against the port's full-width models
        (`cli/convert_checkpoint.py::validate_pipeline_dir`) and the VGGT
        `model.pt` against the VGGT of `runtime.vggt_tiny`'s preset;
  [2/4] single-segment generation on the episode of `data.root`;
  [3/4] PSNR and LPIPS of the generated frames against the GT
        (`eval/harness.py`, the reference's formulas);
  [4/4] pass or fail against the reference's scores within
        `--parity.tolerance` (relative, 1% by default).
It prints `PARITY GATE: PASS (...)` and returns, or `PARITY GATE: FAIL (...)`
and exits with code 1, as the JAX CLI does. `--parity.resize_reference=true`
resizes reference frames of another size as the JAX CLI's PIL route does
(`cli/calculate_metrics.py::pil_bilinear_resize`, byte for byte PIL's
BILINEAR), with the same warning.

Usage (on the card; under `torchrun --nproc-per-node W` the clip is sharded
as `run_unified`'s is):
  python -m evoworld_tpu_torch.cli.validate_parity \\
      --runtime.svd_checkpoint=<diffusers pipeline dir> --runtime.vggt_checkpoint=<model.pt> \\
      --data.root=<episode> --parity.reference_scores=<reference eval_score.json>
  # or --parity.reference_frames=<dir of reference PNGs>;
  # --parity.dry_run=true gates the run against itself on random weights

From Python, `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from evoworld_tpu_torch.cli.common import frames_from_minus1_1, logger, parse_config, save_frames
from evoworld_tpu_torch.data.native_io import image_size


def _step(n: int, msg: str) -> None:
    logger.info(f"[{n}/4] {msg}")


def _load_png_dir(path: str, num: int, size_hw, allow_resize: bool = False) -> np.ndarray:
    """Last `num` PNGs of a directory -> (num, H, W, 3) in [0, 1].

    Fails loudly on a frame-size mismatch unless `allow_resize`: a silently
    resampled reference shifts PSNR and LPIPS and could flip the gate."""
    from evoworld_tpu_torch.cli.calculate_metrics import read_video_dir

    names = sorted(f for f in os.listdir(path) if f.lower().endswith(".png"))
    if names:
        found_h, found_w = image_size(os.path.join(path, names[-1]))
        if (found_w, found_h) != (size_hw[1], size_hw[0]):
            if not allow_resize:
                raise SystemExit(
                    f"{path}: reference frames are {found_w}x{found_h} "
                    f"but generated frames are {size_hw[1]}x{size_hw[0]}; "
                    "resampling would bias the parity scores. Re-render at the "
                    "matching size, or pass --parity.resize_reference=true to "
                    "resize anyway (logged, scores are then approximate)."
                )
            logger.warning(
                f"{path}: resizing reference frames {found_w}x{found_h} "
                f"-> {size_hw[1]}x{size_hw[0]} (--parity.resize_reference); "
                "PSNR/LPIPS are biased by the resample."
            )
    frames = read_video_dir(path, num, size_hw=tuple(size_hw))
    if frames.shape[0] < num:
        raise SystemExit(f"{path}: need {num} frames, found {frames.shape[0]}")
    return frames


def _score(gen: np.ndarray, gt: np.ndarray, nets, metrics) -> dict:
    """(F, H, W, 3) [0, 1] -> {"psnr": mean, "lpips": mean} (the reference's formulas)."""
    from evoworld_tpu_torch.eval.harness import calculate_lpips, calculate_psnr

    out = {}
    if "psnr" in metrics:
        out["psnr"] = calculate_psnr(gen[None], gt[None], nets.device)["value_mean"]
    if "lpips" in metrics:
        out["lpips"] = calculate_lpips(gen[None], gt[None], nets)["value_mean"]
    return out


def _reference_scores_from_json(path: str, metrics) -> dict:
    """{metric: value_mean} of a reference eval_score.json; a missing or
    misshapen entry is the gate's FAIL exit, not a raw KeyError."""
    with open(path) as fh:
        ref_json = json.load(fh)
    try:
        return {m: float(ref_json[m]["value_mean"]) for m in metrics}
    except (KeyError, TypeError) as exc:
        print(f"PARITY GATE: FAIL ({path} has no <metric>.value_mean entry "
              f"for {exc!r}; metrics requested: {', '.join(metrics)})")
        sys.exit(1)


def _gate(ours: dict, theirs: dict, metrics, tolerance: float, source: str, log=None) -> list:
    """The metrics whose relative difference from the reference exceeds `tolerance`."""
    failed = []
    for m in metrics:
        rel = abs(ours[m] - theirs[m]) / max(abs(theirs[m]), 1e-12)
        status = "ok" if rel <= tolerance else "FAIL"
        if log is not None:
            log(f"  {m}: ours={ours[m]:.6f} reference={theirs[m]:.6f} "
                f"rel-diff={rel:.4%} [{status}] (reference: {source})")
        if rel > tolerance:
            failed.append(m)
    return failed


def _vggt_problems(path: str, tiny: bool) -> list:
    """Names and shapes of a VGGT `model.pt` against the preset's model, built on the meta device."""
    from evoworld_tpu_torch.models.vggt.model import VGGT
    from evoworld_tpu_torch.models.weights import checkpoint_mismatches, load_vggt_checkpoint
    from evoworld_tpu_torch.runtime import VGGT_PRESETS

    with torch.device("meta"):
        model = VGGT(VGGT_PRESETS["tiny" if tiny else "full"])
    return checkpoint_mismatches(model, load_vggt_checkpoint(path))


def main(argv=None, device: str | torch.device = "cuda") -> dict:
    """Run the gate; returns {"ours": scores, "theirs": scores, "failed": []}
    on PASS, exits with code 1 on FAIL."""
    config = parse_config(argv, __doc__)
    p, rt, data = config.parity, config.runtime, config.data
    metrics = tuple(m.strip() for m in p.metrics.split(",") if m.strip())
    problems: list[str] = []

    # ---- [1/4] converter validation ---------------------------------
    _step(1, "converter validation")
    svd_dir = rt.svd_checkpoint or rt.checkpoint_dir
    if svd_dir and os.path.isdir(svd_dir):
        from evoworld_tpu_torch.cli.convert_checkpoint import validate_pipeline_dir

        problems += validate_pipeline_dir(svd_dir)
    elif not p.dry_run:
        problems.append("no --runtime.svd_checkpoint pipeline dir given")
    else:
        logger.info("  dry run: skipping SVD converter check (random weights)")
    if rt.vggt_checkpoint and os.path.exists(rt.vggt_checkpoint):
        report = _vggt_problems(rt.vggt_checkpoint, rt.vggt_tiny)
        problems += [f"vggt: {r}" for r in report]
        logger.info(f"  vggt: {'OK' if not report else report[:5]}")
    elif not p.dry_run:
        logger.warning("  no --runtime.vggt_checkpoint (single-segment gate "
                       "does not need it; the unified loop does)")
    if problems:
        for pr in problems[:20]:
            logger.error(f"  converter problem: {pr}")
        print("PARITY GATE: FAIL (converter validation)")
        sys.exit(1)

    # ---- [2/4] single-segment generation on the episode -------------
    _step(2, f"single-segment generation on {data.root}")
    from evoworld_tpu_torch.config import compute_dtype
    from evoworld_tpu_torch.data.dataset import EpisodeDataset
    from evoworld_tpu_torch.loop.navigator import Navigator
    from evoworld_tpu_torch.runtime import build_pipeline, check_compute_dtype, inference_setup

    dtype = compute_dtype(rt)
    check_compute_dtype(device, dtype)
    dev, mesh = inference_setup(device, rt.mesh_data, rt.mesh_model)
    dataset = EpisodeDataset(
        data.root,
        height=config.pipeline.height,
        width=config.pipeline.width,
        sequence_length=data.sequence_length,
        sampling="reprojection",
        reprojection_name=data.reprojection_name,
        memory_path=data.memory_path,
        pos_scale=data.pos_scale,
        single_episode=True,
    )
    sample = dataset[0]
    pipeline = build_pipeline(config.pipeline, rt.model_preset, rt.seed, dtype, dev,
                              checkpoint_dir=svd_dir, allow_random_weights=rt.allow_random_weights, mesh=mesh)
    navigator = Navigator(pipeline, num_frames=config.pipeline.num_frames)
    frames = navigator.generate_segment(
        sample.cam_traj,
        torch.from_numpy(sample.pixel_values[0]).to(dev),
        torch.from_numpy(sample.memory_values[: config.pipeline.num_frames]).to(dev),
        use_memory=True,
        generator=torch.Generator(device=dev).manual_seed(rt.seed),
    ).cpu().numpy()
    gt = frames_from_minus1_1(sample.pixel_values[: frames.shape[0]])
    writer = mesh is None or mesh.rank == 0
    if rt.save_dir and writer:
        out_dir = os.path.join(rt.save_dir, "validate_parity")
        save_frames(frames, os.path.join(out_dir, "predictions"))
        save_frames(gt, os.path.join(out_dir, "predictions_gt"))
        logger.info(f"  wrote frames to {out_dir}")

    # ---- [3/4] metric scoring vs GT ----------------------------------
    _step(3, f"scoring {'+'.join(metrics)} vs GT")
    from evoworld_tpu_torch.eval.harness import FeatureNets
    from evoworld_tpu_torch.eval.weights import load_metric_weights

    weights = load_metric_weights(rt.metric_weights_dir)
    if "lpips" in metrics and "lpips" not in weights:
        # Without real AlexNet features LPIPS is seed-0 random projections:
        # self-consistent, but not what the reference measured.
        if p.dry_run:
            logger.warning("  no lpips weights in --runtime.metric_weights_dir:"
                           " scoring with random features (dry run only)")
        else:
            print("PARITY GATE: FAIL (lpips requested but no lpips.pt under "
                  "--runtime.metric_weights_dir — random-feature LPIPS would "
                  "not measure what the reference measured)")
            sys.exit(1)
    nets = FeatureNets(weights, device=dev)
    ours = _score(frames, np.asarray(gt), nets, metrics)
    for k, v in ours.items():
        logger.info(f"  ours.{k} = {v:.6f}")

    # ---- [4/4] gate vs the reference ---------------------------------
    _step(4, f"gate: within {p.tolerance:.1%} of the reference")
    if p.reference_scores:
        theirs = _reference_scores_from_json(p.reference_scores, metrics)
        source = p.reference_scores
    elif p.reference_frames:
        ref_frames = _load_png_dir(p.reference_frames, frames.shape[0], frames.shape[1:3],
                                   allow_resize=p.resize_reference)
        theirs = _score(ref_frames, np.asarray(gt), nets, metrics)
        source = p.reference_frames
    elif p.dry_run:
        theirs = dict(ours)  # plumbing check: our scores against themselves
        source = "dry-run self-comparison"
    else:
        print("PARITY GATE: FAIL (no --parity.reference_scores or "
              "--parity.reference_frames given)")
        sys.exit(1)

    failed = _gate(ours, theirs, metrics, p.tolerance, source, log=logger.info)

    tag = " (DRY RUN — random weights; re-run with real checkpoints)" if p.dry_run else ""
    if failed:
        print(f"PARITY GATE: FAIL ({', '.join(failed)} outside "
              f"{p.tolerance:.1%}){tag}")
        sys.exit(1)
    print(f"PARITY GATE: PASS ({', '.join(metrics)} within {p.tolerance:.1%}){tag}")
    return {"ours": ours, "theirs": theirs, "failed": failed}


if __name__ == "__main__":
    main()
