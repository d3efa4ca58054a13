"""Writes the H.264 fixtures of this directory, cv2's decode of each as one
PNG strip, and the coding tools each holds (`h264_fixtures.json`).

    python tests/torch_port_data/make_h264_fixtures.py

The streams come from `h264_writer.py` (random but valid syntax from a
numpy seed; no H.264 encoder exists on the machines the port is tested on)
over the smooth colour blobs and the textured field of
`make_mp4_fixtures.py`. Beside each, `<name>.png` holds cv2's decode of it
(BGR turned to RGB), the frames stacked from top to bottom. The machine with
the card has no cv2, so `chip_smoke.py` phase 2c holds the port's decoder
against these strips there; `tests/test_torch_port_h264.py` does so here
too, and against cv2 itself.

  h264_cabac_64: 64x64, 17 frames, High profile, CABAC: a B-pyramid (the
    middle B a reference, unmarked by MMCO 1 in the next P), 3 reference
    frames with list modification, the 8x8 transform, explicit weighted P
    and implicit weighted B, spatial direct, VUI num_reorder_frames 2.
  h264_cavlc_200x120: coded 208x128 and cropped to 200x120, 26 frames,
    High profile, CAVLC: two slices a picture (deblocking disabled at
    slice edges or everywhere in some), a second IDR at frame 13, temporal
    direct, explicit weighted B, custom scaling matrices in SPS and PPS,
    I_PCM, long-term references (an IDR marked long-term, MMCO 2, 3, 4 and
    6), no VUI (FFmpeg guesses the reorder depth).
  h264_baseline_64: 64x64, 12 frames, Constrained Baseline in `avc3` with
    the parameter sets in band, I and P only, POC type 2, constrained
    intra prediction, list modification.
"""

import json
import os
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import h264_writer as w  # noqa: E402
from make_mp4_fixtures import blobs, texture  # noqa: E402


def gop_cavlc() -> list:
    """Two IDR periods of I, P, b: long-term references in each."""
    gop = w.gop_ibp(6, long_term=True)
    second = [(0, "I", True, [])]
    for k in range(6):
        ops = [("max_long", 1), ("to_long", 2, 0)] if k == 1 else [("current_long", 0)] if k == 3 else []
        second += [(2 * k + 2, "P", True, ops), (2 * k + 1, "B", False, [])]
    return gop + second


# name -> (config, source frames (coded size), seed)
FIXTURES = {
    "h264_cabac_64": (w.Config(cabac=True, transform_8x8=True, weighted_pred=True, weighted_bipred_idc=2,
                               direct_spatial=True, num_reorder_frames=2, max_refs=3, reorder_lists=True,
                               gop=w.gop_pyramid(4)), "blobs", 20),
    "h264_cavlc_200x120": (w.Config(width=208, height=128, crop=(0, 8, 0, 8), cabac=False, transform_8x8=True,
                                    scaling_sps=True, scaling_pps=True, weighted_bipred_idc=1, direct_spatial=False,
                                    slices=2, deblock_idc=(0, 2, 2, 1), pcm_share=0.7, pcm_later=0.1, max_refs=3,
                                    gop=gop_cavlc()), "texture", 21),
    "h264_baseline_64": (w.Config(profile=66, constraint_flags=0xC0, cabac=False, avc3=True, poc_type=2,
                                  constrained_intra=True, reorder_lists=True, max_refs=3, deblock_idc=(0, 0, 1, 2),
                                  gop=w.gop_ippp(12)), "blobs", 22),
}


def source(kind: str, cfg: w.Config, seed: int) -> np.ndarray:
    frames = max(len(cfg.gop), 1)
    rng = np.random.default_rng(seed)
    return (blobs if kind == "blobs" else texture)(rng, cfg.height, cfg.width, frames)


def cv2_decode(path: str) -> np.ndarray:
    """(T, H, W, 3) RGB uint8: every frame cv2 reads from `path`."""
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])
    cap.release()
    return np.stack(frames)


def main() -> None:
    tools = {}
    for name, (cfg, kind, seed) in FIXTURES.items():
        mp4 = os.path.join(HERE, f"{name}.mp4")
        tools[name] = sorted(w.write_mp4(mp4, source(kind, cfg, seed), cfg, seed))
        decoded = cv2_decode(mp4)
        height, width = cfg.height - cfg.crop[2] - cfg.crop[3], cfg.width - cfg.crop[0] - cfg.crop[1]
        assert decoded.shape == (len(cfg.gop), height, width, 3), decoded.shape
        cv2.imwrite(os.path.join(HERE, f"{name}.png"), decoded.reshape(-1, width, 3)[..., ::-1],
                    [cv2.IMWRITE_PNG_COMPRESSION, 9])
    with open(os.path.join(HERE, "h264_fixtures.json"), "w") as f:
        json.dump(tools, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
