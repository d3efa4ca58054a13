"""The port's JPEG decoder (`csrc/imageio.cpp`, `data/native_io.py`) against libjpeg.

libjpeg's default decode to RGB is the reference on both of the JAX
package's routes: PIL's `Image.open(p).convert("RGB")` (`data/dataset.py::
_load_image`) and `native/imageio.cpp::decode_jpeg` (`out_color_space =
JCS_RGB`). The port decodes in libjpeg's own integer arithmetic, so:

- at the image's own size every byte equals PIL's, for the JPEGs PIL writes
  (4:4:4, 4:2:2, 4:2:0 at qualities 75 and 95, grey, restart intervals,
  progressive, a size that is no multiple of the MCU): the loader returns
  v / 255 in float32, which holds each byte exactly;
- resized, the floats equal `native/imageio.cpp`'s, built here from the
  repository's file with g++ (skipped where libpng's or libjpeg's header is
  missing);
- a file is recognised by its SOI marker, not by its name;
- what the decoder does not take (arithmetic coding, four components, 4:1:1
  sampling, a progressive file left unrefined) raises an error naming the
  file and the reason;
- the committed fixtures that `chip_smoke.py` decodes on the card, where
  there is no PIL, still hold PIL's decode.
"""

import ctypes
import gc
import os
import subprocess

import numpy as np
import pytest
from PIL import Image

from evoworld_tpu_torch.data import native_io
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

DATA = os.path.join(os.path.dirname(__file__), "torch_port_data")
FIXTURES = ("baseline_420", "restart_422", "progressive_420", "grey")
REPO = os.path.join(os.path.dirname(__file__), "..")


def _image(seed: int, height: int, width: int) -> Image.Image:
    """A smooth colour field with noise: the kind of content a JPEG encoder meets."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (height // 8 + 2, width // 8 + 2, 3), dtype=np.uint8)
    field = np.asarray(Image.fromarray(coarse).resize((width, height), Image.BICUBIC), np.int16)
    return Image.fromarray(np.clip(field + rng.integers(-16, 17, field.shape), 0, 255).astype(np.uint8))


def _decoded_bytes(path: str, height: int, width: int) -> np.ndarray:
    """The port's decode at the image's own size, as the bytes it came from."""
    got = native_io.load_image_batch([path], height, width, minus1_1=False)[0]
    byte = np.round(got * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(byte.astype(np.float32) / np.float32(255.0), got)  # v / 255, nothing else
    return byte


def _pil_rgb(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("name,size,grey,options", [
    ("444_q75", (64, 128), False, dict(quality=75, subsampling=0)),
    ("444_q95", (64, 128), False, dict(quality=95, subsampling=0)),
    ("422_q75", (64, 128), False, dict(quality=75, subsampling=1)),
    ("422_q95", (64, 128), False, dict(quality=95, subsampling=1)),
    ("420_q75", (64, 128), False, dict(quality=75, subsampling=2)),
    ("420_q95", (64, 128), False, dict(quality=95, subsampling=2)),
    ("grey", (64, 128), True, dict(quality=90)),
    ("restart_4", (64, 128), False, dict(quality=90, subsampling=2, restart_marker_blocks=4)),
    ("progressive", (64, 128), False, dict(quality=90, subsampling=2, progressive=True)),
    # no multiple of the 16 x 16 MCU: partial blocks, the upsampler's edges
    ("37x53", (37, 53), False, dict(quality=90, subsampling=2)),
])
def test_jpeg_decode_matches_pil(tmp_path, name, size, grey, options):
    height, width = size
    img = _image(sum(map(ord, name)), height, width)
    path = str(tmp_path / f"{name}.jpg")
    (img.convert("L") if grey else img).save(path, **options)
    np.testing.assert_array_equal(_decoded_bytes(path, height, width), _pil_rgb(path))


def test_jpeg_resize_matches_native_imageio(tmp_path):
    """Down- and upsampled, [-1, 1] and [0, 1]: bit for bit the JAX package's
    native loader (libjpeg's decode, then its bilinear resize)."""
    lib_path = tmp_path / "libevoworld_io.so"
    build = subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", os.path.join(REPO, "native", "imageio.cpp"), "-o",
                            str(lib_path), "-shared", "-lpng", "-ljpeg", "-lpthread"], capture_output=True, text=True)
    if build.returncode != 0 and ("png.h" in build.stderr or "jpeglib.h" in build.stderr):
        pytest.skip("libpng or libjpeg headers missing: native/imageio.cpp cannot be built here")
    assert build.returncode == 0, build.stderr
    lib = ctypes.CDLL(str(lib_path))
    lib.ev_load_image.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int]
    for sub, progressive in ((2, False), (1, True), (0, False)):
        path = str(tmp_path / f"src_{sub}.jpg")
        _image(5 + sub, 37, 53).save(path, quality=85, subsampling=sub, progressive=progressive)
        for th, tw in ((20, 31), (70, 90)):
            for minus1_1 in (True, False):
                want = np.empty((th, tw, 3), np.float32)
                assert lib.ev_load_image(path.encode(), want.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), th, tw,
                                         int(minus1_1)) == 0
                np.testing.assert_array_equal(native_io.load_image_batch([path], th, tw, minus1_1)[0], want)
    del lib
    gc.collect()


def test_formats_are_told_by_their_first_bytes(tmp_path):
    """A JPEG named .png and a PNG named .jpg each decode as what they are."""
    img = _image(11, 24, 40)
    jpeg_named_png, png_named_jpg = str(tmp_path / "frame.png"), str(tmp_path / "frame.jpg")
    img.save(jpeg_named_png, format="JPEG", quality=90)
    img.save(png_named_jpg, format="PNG")
    np.testing.assert_array_equal(_decoded_bytes(jpeg_named_png, 24, 40), _pil_rgb(jpeg_named_png))
    np.testing.assert_array_equal(_decoded_bytes(png_named_jpg, 24, 40), np.asarray(img))
    (tmp_path / "notes.jpg").write_bytes(b"not an image")
    with pytest.raises(IOError, match="notes.jpg is neither a PNG nor a JPEG"):
        native_io.load_image_batch([str(tmp_path / "notes.jpg")], 24, 40)


def test_cmyk_jpeg_is_refused_by_name(tmp_path):
    """Four components: libjpeg's decode with JCS_RGB cannot convert them either."""
    good, cmyk = str(tmp_path / "good.jpg"), str(tmp_path / "ink.jpg")
    _image(12, 16, 24).save(good, quality=90)
    Image.fromarray(np.full((16, 24, 4), 40, np.uint8), "CMYK").save(cmyk, quality=90)
    with pytest.raises(IOError, match=r"1 of 2 images failed: .*ink\.jpg is a JPEG with neither 1 nor 3 components"):
        native_io.load_image_batch([good, cmyk], 16, 24)


def _first_huffman_table(data: bytes, table_class: int) -> tuple[int, int]:
    """Offsets of the counts and of the symbols of the first Huffman table of
    a class (0 DC, 1 AC) in a JPEG's DHT segments."""
    pos = 2
    while data[pos + 1] != 0xDA:  # up to the first scan
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == 0xC4:
            at = pos + 4
            while at < pos + 2 + length:
                if data[at] >> 4 == table_class:
                    return at + 1, at + 17
                at += 17 + sum(data[at + 1:at + 17])
        pos += 2 + length
    raise AssertionError(f"no Huffman table of class {table_class}")


@pytest.mark.parametrize("fault", ["oversubscribed", "all_1_bit", "dc_symbol_20"])
def test_corrupt_huffman_table_is_refused_by_name(tmp_path, fault):
    """A DHT whose codes outgrow their length (three 1-bit DC codes, or every
    AC code 1 bit long, whose lookahead entries would reach 80 KiB past the
    table), or a DC table with a symbol past 15 bits, fails as corrupt and
    names the file. The decoder checks each code before it is placed."""
    path = str(tmp_path / "frame.jpg")
    _image(13, 16, 24).save(path, quality=90)
    data = bytearray(open(path, "rb").read())
    counts, vals = _first_huffman_table(bytes(data), 1 if fault == "all_1_bit" else 0)
    n = sum(data[counts:counts + 16])  # kept, so that the segment's layout stays
    if fault == "oversubscribed":
        largest = max(range(16), key=lambda i: data[counts + i])
        data[counts + largest] -= 3
        data[counts] += 3
    elif fault == "all_1_bit":
        data[counts:counts + 16] = bytes([n] + [0] * 15)
    else:
        data[vals + n - 1] = 20
    bad = str(tmp_path / f"{fault}.jpg")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(IOError, match=f"{fault}.jpg is a corrupt or truncated JPEG"):
        native_io.load_image_batch([bad], 16, 24)


# Writes a 24 x 16 RGB JPEG with libjpeg in a variant PIL cannot write:
# "arith" arithmetic coding (SOF9), "h4v1" luma sampled 4:1 across (4:1:1),
# "unrefined" a progressive script whose AC scans stop at Al = 1.
VARIANT_WRITER = r"""
#include <cstdio>
#include <cstring>
#include <jpeglib.h>
int main(int, char** argv) {
  jpeg_compress_struct c;
  jpeg_error_mgr err;
  c.err = jpeg_std_error(&err);
  jpeg_create_compress(&c);
  FILE* f = fopen(argv[1], "wb");
  jpeg_stdio_dest(&c, f);
  c.image_width = 24;
  c.image_height = 16;
  c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  static jpeg_scan_info scans[4] = {{3, {0, 1, 2}, 0, 0, 0, 0}, {1, {0}, 1, 63, 0, 1}, {1, {1}, 1, 63, 0, 1},
                                    {1, {2}, 1, 63, 0, 1}};
  if (strcmp(argv[2], "arith") == 0) c.arith_code = TRUE;
  if (strcmp(argv[2], "h4v1") == 0) c.comp_info[0].h_samp_factor = 4, c.comp_info[0].v_samp_factor = 1;
  if (strcmp(argv[2], "unrefined") == 0) c.scan_info = scans, c.num_scans = 4;
  jpeg_start_compress(&c, TRUE);
  unsigned char row[24 * 3];
  while (c.next_scanline < c.image_height) {
    for (int i = 0; i < 24 * 3; ++i) row[i] = (unsigned char)(i * 3 + c.next_scanline * 7);
    JSAMPROW rows[1] = {row};
    jpeg_write_scanlines(&c, rows, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  return fclose(f);
}
"""


@pytest.mark.parametrize("variant,reason", [
    ("arith", "is an arithmetic-coded JPEG"),
    ("h4v1", "is a JPEG with chroma sampling other than 4:4:4, 4:2:2 and 4:2:0"),
    ("unrefined", "is a progressive JPEG whose scans leave low coefficients unrefined"),
])
def test_libjpeg_variants_are_refused_by_name(tmp_path, variant, reason):
    """JPEGs that libjpeg reads but the decoder does not take, written with
    libjpeg (PIL writes none of them): each raises an error naming the file."""
    (tmp_path / "writer.cpp").write_text(VARIANT_WRITER)
    exe = str(tmp_path / "writer")
    build = subprocess.run(["g++", str(tmp_path / "writer.cpp"), "-o", exe, "-ljpeg"], capture_output=True, text=True)
    if build.returncode != 0 and "jpeglib.h" in build.stderr:
        pytest.skip("libjpeg's header missing: these variants cannot be written here")
    assert build.returncode == 0, build.stderr
    path = str(tmp_path / f"{variant}.jpg")
    subprocess.run([exe, path, variant], check=True)
    assert _pil_rgb(path).shape == (16, 24, 3)  # a JPEG that libjpeg itself reads
    with pytest.raises(IOError, match=f"{variant}.jpg {reason}"):
        native_io.load_image_batch([path], 16, 24)


@pytest.mark.parametrize("name", FIXTURES)
def test_committed_fixtures_match_pil(name):
    """Each fixture's PNG is PIL's decode of its JPEG (the reference
    `chip_smoke.py` holds the port to on the card), and the port gives it."""
    jpg, png = os.path.join(DATA, f"{name}.jpg"), os.path.join(DATA, f"{name}.png")
    want = _pil_rgb(jpg)
    np.testing.assert_array_equal(_pil_rgb(png), want)
    np.testing.assert_array_equal(_decoded_bytes(jpg, *want.shape[:2]), want)
    assert os.path.getsize(jpg) < 16384 and os.path.getsize(png) < 16384
