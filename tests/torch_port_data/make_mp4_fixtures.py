"""Writes the MPEG-4 Part 2 (`mp4v`) fixtures of this directory and cv2's
decode of each as one PNG strip.

    python tests/torch_port_data/make_mp4_fixtures.py

The files come from OpenCV's FFmpeg writer (`cv2.VideoWriter` with the
`mp4v` fourcc: FFmpeg's default `mpeg4` encode, I- and P-VOPs, a GOP of 12)
from seeded numpy frames at 8 frames a second. Beside each, `<name>.png`
holds cv2's decode of it (BGR turned to RGB), the frames stacked from top to
bottom (a strip of frames with coding noise in them packs poorly: the
200x120 one takes most of a megabyte). The machine with the card has no cv2, so `chip_smoke.py` holds the
port's decoder (`data/native_video.py`) against these strips there;
`tests/test_torch_port_video.py` does so here too, and against cv2 itself.

  mp4v_64: 64x64, 14 frames of smooth colour blobs moving by sub-pixel
    steps (half-pel vectors; frame 12 starts the second GOP);
  mp4v_200x120: 200x120 (no multiple of 16), 26 frames of a textured field
    that moves several pixels a frame and runs off the edges.
"""

import os

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FPS = 8
# name -> (height, width, frames, seed)
FIXTURES = {"mp4v_64": (64, 64, 14, 0), "mp4v_200x120": (120, 200, 26, 1)}


def blobs(rng, height: int, width: int, frames: int) -> np.ndarray:
    """(frames, H, W, 3) uint8: six Gaussian colour blobs on a gradient,
    each drifting 0.3-1.2 pixels a frame."""
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    centre = rng.uniform(0, 1, (6, 2)) * (height, width)
    step = rng.uniform(0.3, 1.2, (6, 2)) * rng.choice([-1, 1], (6, 2))
    colour = rng.uniform(-120, 120, (6, 3))
    sigma = rng.uniform(0.12, 0.3, 6) * min(height, width)
    out = np.empty((frames, height, width, 3), np.uint8)
    for t in range(frames):
        img = np.stack([60 + 80 * x / width, 90 + 60 * y / height, 128 + 0 * x], -1)
        for c, s, col, sg in zip(centre, step, colour, sigma):
            cy, cx = c + t * s
            img += col * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * sg * sg))[..., None]
        out[t] = np.clip(np.rint(img), 0, 255)
    return out


def texture(rng, height: int, width: int, frames: int) -> np.ndarray:
    """(frames, H, W, 3) uint8: a smooth random field with sharp-edged
    rectangles on it, sampled through a window that moves (3.5, -2.25)
    pixels a frame, so that content enters and leaves at every edge."""
    big_h, big_w = height + 4 * frames + 16, width + 4 * frames + 16
    coarse = rng.integers(0, 256, (big_h // 24 + 2, big_w // 24 + 2, 3), dtype=np.uint8)
    field = cv2.resize(coarse, (big_w, big_h), interpolation=cv2.INTER_CUBIC).astype(np.float64)
    for _ in range(12):
        y0, x0 = rng.integers(0, big_h - 12), rng.integers(0, big_w - 12)
        field[y0:y0 + rng.integers(6, 30), x0:x0 + rng.integers(6, 30)] = rng.integers(0, 256, 3)
    out = np.empty((frames, height, width, 3), np.uint8)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    for t in range(frames):
        ox, oy = 8 + 3.5 * t, 8 + 4 * frames - 2.25 * t
        frame = cv2.remap(field.astype(np.float32), x + ox, y + oy, cv2.INTER_LINEAR)
        out[t] = np.clip(np.rint(frame), 0, 255)
    return out


def write_mp4v(path: str, frames: np.ndarray, fps: int = FPS) -> None:
    """RGB uint8 frames -> an `mp4v` MP4 through cv2."""
    height, width = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
    if not writer.isOpened():
        raise RuntimeError(f"cv2 cannot write mp4v to {path}")
    for frame in frames:
        writer.write(np.ascontiguousarray(frame[..., ::-1]))
    writer.release()


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
    for name, (height, width, frames, seed) in FIXTURES.items():
        rng = np.random.default_rng(seed)
        video = (blobs if name == "mp4v_64" else texture)(rng, height, width, frames)
        mp4 = os.path.join(HERE, f"{name}.mp4")
        write_mp4v(mp4, video)
        decoded = cv2_decode(mp4)
        assert decoded.shape == video.shape, (decoded.shape, video.shape)
        cv2.imwrite(os.path.join(HERE, f"{name}.png"), decoded.reshape(-1, width, 3)[..., ::-1],
                    [cv2.IMWRITE_PNG_COMPRESSION, 9])


if __name__ == "__main__":
    main()
