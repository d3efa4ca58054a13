"""The port's PNG decoder on interlaced (Adam7) files, and its image-size
reader (`data/native_io.py::image_size`), against the non-interlaced twin,
PIL and the files' own headers.

PIL writes no interlaced PNG, so the files here are written by hand
(`_png`): IHDR, PLTE for palettes, one zlib IDAT stream, with every row's
filter type drawn from a seed, so that each of the five filters meets the
start of each pass. Each case decodes, byte for byte, to what the same
pixels written without interlacing decode to; where PIL and libpng agree
(8-bit samples) both also equal PIL's RGB. The sizes 1 x 1, 3 x 2 and 17 x
13 leave some of the seven passes empty (no bytes at all, not even filter
bytes), and the sub-byte depths round each pass's rows to whole bytes.
"""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from evoworld_tpu_torch.data import native_io
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

DATA = os.path.join(os.path.dirname(__file__), "torch_port_data")
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(rows: list[bytes], bpp: int, rng) -> bytes:
    """Each row behind a filter byte drawn from `rng`, filtered against the row above."""
    out, prev = bytearray(), bytes(len(rows[0]))
    for row in rows:
        kind = int(rng.integers(0, 5))
        enc = bytearray(len(row))
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b, c = prev[i], prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
            enc[i] = (x - pred) & 0xFF
        out += bytes([kind]) + enc
        prev = row
    return bytes(out)


def _pack(samples: np.ndarray, depth: int) -> bytes:
    """One row of (w, channels) samples as PNG's big-endian, MSB-first bytes."""
    flat = samples.reshape(-1).astype(np.uint32)
    if depth == 16:
        return flat.astype(">u2").tobytes()
    if depth == 8:
        return flat.astype(np.uint8).tobytes()
    per_byte = 8 // depth
    flat = np.concatenate([flat, np.zeros((-len(flat)) % per_byte, np.uint32)])
    shifts = (per_byte - 1 - np.arange(per_byte)) * depth
    return (flat.reshape(-1, per_byte) << shifts).sum(axis=1).astype(np.uint8).tobytes()


def _png(path: str, samples: np.ndarray, color: int, depth: int, interlace: bool, seed: int,
         palette: np.ndarray | None = None) -> None:
    """Write (h, w, channels) samples as a PNG of `color` and `depth`."""
    h, w, channels = samples.shape
    bpp = max(1, channels * depth // 8)
    rng = np.random.default_rng(seed)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:  # an empty pass has no bytes at all
            raw += _filtered([_pack(r, depth) for r in sub], bpp, rng)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _decode(path: str, h: int, w: int) -> np.ndarray:
    got = native_io.load_image_batch([path], h, w, minus1_1=False)[0]
    byte = np.round(got * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(byte.astype(np.float32) / np.float32(255.0), got)  # v / 255, nothing else
    return byte


CASES = [(color, depth) for color in (0, 3) for depth in (1, 2, 4, 8)] + [(0, 16)] + [
    (color, depth) for color in (2, 4, 6) for depth in (8, 16)]


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (13, 17)], ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("color,depth", CASES, ids=[f"type{c}_{d}bit" for c, d in CASES])
def test_adam7_decodes_as_its_plain_twin(tmp_path, color, depth, size):
    h, w = size
    rng = np.random.default_rng(color * 100 + depth + h)
    samples = rng.integers(0, 1 << depth, (h, w, CHANNELS[color]), dtype=np.int64)
    palette = None
    if color == 3:
        palette = rng.integers(0, 256, (1 << depth, 3))
    plain, laced = str(tmp_path / "plain.png"), str(tmp_path / "laced.png")
    _png(plain, samples, color, depth, False, seed=1, palette=palette)
    _png(laced, samples, color, depth, True, seed=2, palette=palette)
    want = _decode(plain, h, w)
    np.testing.assert_array_equal(_decode(laced, h, w), want)
    if depth == 8:  # PIL's 8-bit decode is libpng's; at 16 bits PIL clips where libpng keeps the high byte
        np.testing.assert_array_equal(want, np.asarray(Image.open(plain).convert("RGB")))
        np.testing.assert_array_equal(want, np.asarray(Image.open(laced).convert("RGB")))
    assert native_io.image_size(laced) == (h, w)


def test_adam7_truncated_pass_is_refused_by_name(tmp_path):
    """A stream one byte short of its seven passes is a corrupt PNG."""
    samples = np.random.default_rng(0).integers(0, 256, (13, 17, 3))
    path = str(tmp_path / "cut.png")
    _png(path, samples, 2, 8, True, seed=0)
    data = open(path, "rb").read()
    at = data.index(b"IDAT") - 4
    length = struct.unpack(">I", data[at:at + 4])[0]
    raw = zlib.decompress(data[at + 8:at + 8 + length])
    idat = zlib.compress(raw[:-1])
    with open(path, "wb") as f:
        f.write(data[:at] + _chunk(b"IDAT", idat) + data[at + 12 + length:])
    with pytest.raises(IOError, match="cut.png is a PNG variant the decoder does not take, or corrupt"):
        native_io.load_image_batch([path], 13, 17)


@pytest.mark.parametrize("name", ["baseline_420", "progressive_420", "restart_422", "grey"])
def test_image_size_reads_png_and_jpeg_headers(name):
    """The committed JPEGs (baseline, progressive, with restart markers,
    grey) and their PNGs: the size PIL reads."""
    for ext in ("jpg", "png"):
        path = os.path.join(DATA, f"{name}.{ext}")
        w, h = Image.open(path).size
        assert native_io.image_size(path) == (h, w)


def test_image_size_goes_by_first_bytes_and_refuses_the_rest(tmp_path):
    """A JPEG under a `.png` name is sized as a JPEG; a DHT (C4) before the
    frame header is skipped, not read as one; a file that is neither
    format is refused by name, as the decoder refuses it."""
    img = Image.fromarray(np.random.default_rng(3).integers(0, 256, (21, 34, 3), dtype=np.uint8))
    jpeg_named_png = str(tmp_path / "frame.png")
    img.save(jpeg_named_png, format="JPEG", quality=90)
    assert native_io.image_size(jpeg_named_png) == (21, 34)
    data = open(jpeg_named_png, "rb").read()
    sof = data.index(b"\xff\xc0")
    dht = b"\xff\xc4" + struct.pack(">H", 20) + b"\x00" + bytes([1] + [0] * 15) + b"\x00"  # one 1-bit DC code
    moved = str(tmp_path / "dht_first.jpg")
    with open(moved, "wb") as f:
        f.write(data[:sof] + dht + data[sof:])
    assert native_io.image_size(moved) == (21, 34)
    (tmp_path / "notes.png").write_bytes(b"GIF89a not a PNG")
    with pytest.raises(IOError, match="notes.png is neither a PNG nor a JPEG"):
        native_io.image_size(str(tmp_path / "notes.png"))
    (tmp_path / "cut.jpg").write_bytes(data[:sof])
    with pytest.raises(IOError, match="cut.jpg is a corrupt or truncated JPEG"):
        native_io.image_size(str(tmp_path / "cut.jpg"))
