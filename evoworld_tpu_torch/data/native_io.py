"""Batch image IO on a C++ thread pool (counterpart of `evoworld_tpu/data/native_io.py`
and `native/imageio.cpp`).

`csrc/imageio.cpp`, built at first use with g++ against zlib into the
git-ignored `build/` beside the CUDA kernels (`ops/_build.py`), decodes PNG
and JPEG files, resizes them bilinearly (half-pixel centres, no
antialiasing: the JAX package's native loader's arithmetic) and writes PNG
files at deflate level 1 with no row filter, and animated GIFs (a palette of
256 colours a frame, LZW). The H100 machine the port runs
on has zlib but neither libpng, libjpeg nor PIL, so PNG is parsed, inflated
and un-filtered in that file on zlib alone, and JPEG is decoded there in
libjpeg's own integer arithmetic (the islow IDCT, fancy upsampling, the
fixed-point YCbCr tables), giving the bytes libjpeg's default decode gives.
A file is taken as PNG or JPEG by its first bytes, not its name. What the
decoders refuse (arithmetic-coded, lossless, 12-bit or CMYK JPEGs, other
chroma sampling, among others: `_REASONS`) raises an error naming the file.
The C calls release the GIL (ctypes), so a writer thread's encode overlaps
the caller's work.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

from evoworld_tpu_torch.ops import _build

SOURCE = "imageio.cpp"
_REASONS = {
    1: "cannot be read",
    2: "is neither a PNG nor a JPEG",
    3: "is a PNG variant the decoder does not take, or corrupt",
    4: "cannot be written",
    5: "is a corrupt or truncated JPEG",
    6: "is an arithmetic-coded JPEG (the decoder takes Huffman coding only)",
    7: "is a lossless, hierarchical or 12-bit JPEG (the decoder takes 8-bit DCT frames only)",
    8: "is a JPEG with neither 1 nor 3 components (CMYK and YCCK have 4)",
    9: "is a JPEG with chroma sampling other than 4:4:4, 4:2:2 and 4:2:0",
    10: "is a progressive JPEG whose scans leave low coefficients unrefined (libjpeg smooths those)",
}


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if lib.evt_load_images.argtypes is None:
        c_int, p_int = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        lib.evt_load_images.argtypes = [ctypes.POINTER(ctypes.c_char_p), c_int, ctypes.POINTER(ctypes.c_float),
                                        c_int, c_int, c_int, c_int, p_int]
        lib.evt_load_images.restype = c_int
        lib.evt_save_pngs.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint8),
                                      c_int, c_int, c_int, c_int, p_int]
        lib.evt_save_pngs.restype = c_int
        lib.evt_save_gif.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), c_int, c_int, c_int, c_int,
                                     c_int]
        lib.evt_save_gif.restype = c_int
    return lib


def _threads(n_threads: int) -> int:
    return n_threads or min(os.cpu_count() or 1, 8)


def _raise_failures(paths: Sequence[str], status) -> None:
    bad = [(p, s) for p, s in zip(paths, status) if s]
    if bad:
        shown = "; ".join(f"{p} {_REASONS.get(s, f'failed ({s})')}" for p, s in bad[:4])
        raise IOError(f"{len(bad)} of {len(paths)} images failed: {shown}")


def load_image_batch(
    paths: Sequence[str], height: int, width: int, minus1_1: bool = True, n_threads: int = 0
) -> np.ndarray:
    """Load N PNG or JPEG images -> (N, height, width, 3) float32 in [-1, 1] (or [0, 1]).

    An image already at (height, width) is converted as (v / 255) * 2 - 1 with
    no resize, as the JAX package's PIL route does; any other size is resized
    with `native/imageio.cpp`'s arithmetic. Raises IOError naming each image
    that cannot be read or decoded.
    """
    n = len(paths)
    out = np.empty((n, height, width, 3), np.float32)
    if n == 0:
        return out
    status = (ctypes.c_int * n)()
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    _lib().evt_load_images(names, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), height, width,
                           int(minus1_1), _threads(n_threads), status)
    _raise_failures(paths, status)
    return out


# JPEG frame headers (SOFn): every marker C0-CF but C4 (DHT), C8 (JPG) and CC (DAC).
_JPEG_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def image_size(path: str) -> tuple[int, int]:
    """(height, width) of a PNG or JPEG file, read from its header: a PNG's
    IHDR chunk, or a JPEG's first frame header (SOFn), found by walking the
    marker segments as the decoder does. The format is the one the first
    bytes name, as for the decoder, whatever the file's name. Raises IOError
    naming the file for one that is neither, or whose header is cut short."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == b"\x89PNG\r\n\x1a\n":
            if len(head) < 24 or head[12:16] != b"IHDR":
                raise IOError(f"{path} {_REASONS[3]}")
            return int.from_bytes(head[20:24], "big"), int.from_bytes(head[16:20], "big")
        if head[:2] != b"\xff\xd8":
            raise IOError(f"{path} {_REASONS[2]}")
        data = head + f.read()
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:  # up to a marker, then past its fill bytes
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos + 2 >= len(data) or data[pos] == 0xD9:  # the end, or EOI, before any frame header
            raise IOError(f"{path} {_REASONS[5]}")
        marker = data[pos]
        pos += 1
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # RSTn, TEM: no length
            continue
        if marker in _JPEG_SOF:
            if pos + 7 > len(data):
                raise IOError(f"{path} {_REASONS[5]}")
            return int.from_bytes(data[pos + 3:pos + 5], "big"), int.from_bytes(data[pos + 5:pos + 7], "big")
        pos += int.from_bytes(data[pos:pos + 2], "big")


def save_png_batch(paths: Sequence[str], frames: np.ndarray, n_threads: int = 0) -> None:
    """Write (N, H, W, 3) uint8 frames to PNG files; raises IOError naming each failed write."""
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, c = frames.shape
    if c != 3 or n != len(paths):
        raise ValueError(f"frames {frames.shape} for {len(paths)} paths: need (N, H, W, 3)")
    if n == 0:
        return
    status = (ctypes.c_int * n)()
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    _lib().evt_save_pngs(names, frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w,
                         _threads(n_threads), status)
    _raise_failures(paths, status)


def save_gif(path: str, frames: np.ndarray, delay_cs: int, n_threads: int = 0) -> None:
    """Write (N, H, W, 3) uint8 frames to `path` as an animated GIF that loops
    forever, each frame shown for `delay_cs` hundredths of a second; raises
    IOError when the file cannot be written."""
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3 or not len(frames):
        raise ValueError(f"frames {frames.shape}: need (N, H, W, 3) with N >= 1")
    n, h, w, _ = frames.shape
    if max(h, w) > 65535 or not 0 <= delay_cs <= 65535:
        raise ValueError(f"a GIF holds sizes and delays below 65536, got {h}x{w} and {delay_cs}")
    status = _lib().evt_save_gif(os.fsencode(path), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w,
                                 int(delay_cs), _threads(n_threads))
    _raise_failures([path], [status])
