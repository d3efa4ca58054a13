"""The port's MP4 video IO (`csrc/video.cpp`, `data/native_video.py`) against
OpenCV, which the JAX package's scoring CLI reads MP4 through.

- The committed `mp4v` fixtures (`torch_port_data/make_mp4_fixtures.py`,
  which `chip_smoke.py` phase 2c decodes on the card:
  FFmpeg's default `mpeg4` encode through `cv2.VideoWriter`, with half-pel
  vectors, every escape mode, not-coded and intra macroblocks in P-VOPs,
  vop_fcode 2 and a frame size that is no multiple of 16) decode within
  MAX_LEVELS of every byte of cv2's decode and MEAN_LEVELS on average,
  against the strip stored beside each and, where cv2 is installed, against
  `cv2.VideoCapture` itself, and so do fresh cv2 files at 64x64 and
  1024x576. (The decoder works in FFmpeg's arithmetic, so it meets both
  limits with every byte equal; the limits are what the scorer can bear.)
- A P-VOP predicts from the frame before it, so a decoder whose IDCT or
  motion compensation rounds otherwise than the encoder's drifts from
  P-VOP to P-VOP until the next I-VOP: the last P-VOP before each I-VOP must
  sit within one level of the I-VOP's own error.
- `resize_linear_u8` equals `cv2.resize` (INTER_LINEAR) byte for byte,
  downscales and upscales alike (an upscale needs OpenCV's float32 centres
  and its vertical weights left unclamped at the edges, where only the rows
  read are clamped).
- `save_mp4` writes files cv2 reads with the frame count and rate asked
  for, within 1.5 levels of smooth frames on average, which the port
  decodes within MAX_LEVELS of cv2.
- What the decoder does not take raises an error naming the file and the
  reason: each case patches a fixture's bytes.
- `chip_smoke.py` phases 2c and 22 run here at small sizes, the CPU
  standing in for the card.

The file imports no JAX, and the tests that need cv2 skip without it, so
it also runs on the card's machine:

    python -m pytest tests/test_torch_port_video.py --noconftest -q
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from chip_smoke import ENCODE_LUMA_MAE, check_mp4_fixtures, full_scores
from chip_smoke import MP4_FIXTURES as FIXTURES
from chip_smoke import MP4_MAX_LEVELS as MAX_LEVELS
from chip_smoke import MP4_MEAN_LEVELS as MEAN_LEVELS
from evoworld_tpu_torch.data import native_io, native_video

try:
    import cv2
except ImportError:  # the card's machine
    cv2 = None

DATA = os.path.join(os.path.dirname(__file__), "torch_port_data")
FPS = 8  # make_mp4_fixtures.py's rate
needs_cv2 = pytest.mark.skipif(cv2 is None, reason="needs OpenCV (cv2), the reference decoder")


def stored_decode(name: str) -> np.ndarray:
    """cv2's decode of a fixture, from the PNG strip beside it."""
    t, h, w = FIXTURES[name]
    path = os.path.join(DATA, f"{name}.png")
    strip = native_io.load_image_batch([path], t * h, w, minus1_1=False)[0]
    return np.rint(strip * 255).astype(np.uint8).reshape(t, h, w, 3)


def cv2_decode(path: str) -> np.ndarray:
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])
    cap.release()
    return np.stack(frames)


def frame_errors(ours: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each frame's largest absolute difference, after the limits are met."""
    assert ours.shape == ref.shape and ours.dtype == np.uint8, (ours.shape, ref.shape, ours.dtype)
    err = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    assert err.max() <= MAX_LEVELS, (err.max(), np.argwhere(err > MAX_LEVELS)[:5])
    assert err.mean() < MEAN_LEVELS, err.mean()
    return err.reshape(len(err), -1).max(1)


def vop_types(path: str) -> list[str]:
    """The coding type of each VOP in the file ("I", "P", "B", "S")."""
    data = open(path, "rb").read()
    types, at = [], data.find(b"\x00\x00\x01\xb6")
    while at >= 0:
        types.append("IPBS"[data[at + 4] >> 6])
        at = data.find(b"\x00\x00\x01\xb6", at + 4)
    return types


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_stored_decode(name):
    path = os.path.join(DATA, f"{name}.mp4")
    t, h, w = FIXTURES[name]
    assert native_video.mp4_info(path) == {"frames": t, "fps": FPS, "height": h, "width": w}
    frame_errors(native_video.read_mp4(path), stored_decode(name))


@needs_cv2
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_cv2(name):
    path = os.path.join(DATA, f"{name}.mp4")
    ref = cv2_decode(path)
    frame_errors(native_video.read_mp4(path), ref)
    np.testing.assert_array_equal(ref, stored_decode(name))  # the strip is still cv2's decode
    cap = cv2.VideoCapture(path)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == FIXTURES[name][0] and cap.get(cv2.CAP_PROP_FPS) == FPS


def test_fixture_phase_passes_on_the_cpu():
    """`chip_smoke.py` phase 2c, as the card runs it."""
    rows = check_mp4_fixtures()
    assert [r["name"] for r in rows] == list(FIXTURES) and all(r["max_abs_diff"] <= MAX_LEVELS for r in rows)


@needs_cv2
@pytest.mark.parametrize("name", FIXTURES)
def test_luma_plane_matches_cv2(name):
    """The decoded Y plane against cv2's own (its raw frames without the
    conversion to BGR): the codec apart from the colour conversion."""
    path = os.path.join(DATA, f"{name}.mp4")
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    ref = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        ref.append(frame)
    luma, cb, cr = native_video.read_mp4_planes(path)
    t, h, w = FIXTURES[name]
    assert luma.shape == (t, h, w) and cb.shape == cr.shape == (t, h // 2, w // 2)
    frame_errors(luma[..., None], np.stack(ref)[:, :h, :w, None])


@pytest.mark.parametrize("name", FIXTURES)
def test_no_drift_across_a_gop(name):
    """The stored fixtures hold I-VOPs at 0 and 12 (and 24) with P-VOPs
    between: the error of the last P-VOP before each I-VOP is no more than
    one level above that I-VOP's own."""
    path = os.path.join(DATA, f"{name}.mp4")
    types = vop_types(path)
    intra = [i for i, t in enumerate(types) if t == "I"]
    assert intra[:2] == [0, 12] and set(types) == {"I", "P"}, types
    err = frame_errors(native_video.read_mp4(path), stored_decode(name))
    for start, end in zip(intra, intra[1:]):
        assert err[end - 1] <= err[start] + 1, (start, end, err)


@needs_cv2
@pytest.mark.parametrize("height,width,frames", [(64, 64, 14), (576, 1024, 13)])
def test_fresh_cv2_file(tmp_path, height, width, frames):
    spec = importlib.util.spec_from_file_location("make_mp4_fixtures", os.path.join(DATA, "make_mp4_fixtures.py"))
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    rng = np.random.default_rng(height)
    video = (maker.blobs if height == 64 else maker.texture)(rng, height, width, frames)
    path = str(tmp_path / "fresh.mp4")
    maker.write_mp4v(path, video)
    assert "P" in vop_types(path)
    frame_errors(native_video.read_mp4(path), cv2_decode(path))


@needs_cv2
@pytest.mark.parametrize("src,dst", [
    ((576, 1024), (64, 64)), ((144, 256), (64, 64)), ((100, 70), (64, 64)),   # the scorer's downscales
    ((120, 200), (64, 64)), ((128, 128), (64, 64)),                           # the 2x2 area mean
    ((576, 1024), (37, 61)), ((32, 48), (64, 64)), ((10, 10), (64, 64)),      # odd sizes, upscales
])
def test_resize_matches_cv2(src, dst):
    frames = np.random.default_rng(sum(src)).integers(0, 256, (2, *src, 3), dtype=np.uint8)
    ours = native_video.resize_linear_u8(frames, *dst)
    for frame, got in zip(frames, ours):
        np.testing.assert_array_equal(got, cv2.resize(frame, dst[::-1]))


def smooth_frames(n: int, height: int = 576, width: int = 1024) -> np.ndarray:
    """(n, H, W, 3) uint8 smooth colour fields: a cosine series over a few
    cycles a frame, moving from frame to frame."""
    y, x = np.mgrid[0:height, 0:width] / max(height, width)
    rng = np.random.default_rng(3)
    out = np.empty((n, height, width, 3), np.uint8)
    for t in range(n):
        img = np.zeros((height, width, 3))
        for _ in range(4):
            fy, fx, phase = rng.uniform(0.5, 3, 3) * (1, 1, 6)
            img += rng.uniform(-40, 40, 3) * np.cos(2 * np.pi * (fy * y + fx * x) + phase + 0.2 * t)[..., None]
        out[t] = np.clip(np.rint(128 + img), 0, 255)
    return out


@pytest.mark.parametrize("fps", [10, 8, 29.97])
def test_save_mp4_reads_back(tmp_path, fps):
    """The port writes intra-only files it reads back: the frame count and
    rate asked for, within 1.5 levels of smooth frames on average."""
    frames = smooth_frames(4)
    path = str(tmp_path / "out.mp4")
    native_video.save_mp4(path, frames, fps=fps)
    info = native_video.mp4_info(path)
    assert (info["frames"], info["height"], info["width"]) == (4, 576, 1024)
    assert abs(info["fps"] - fps) < 1e-9 * fps, info
    assert vop_types(path) == ["I"] * 4
    ours = native_video.read_mp4(path)
    assert np.abs(ours.astype(np.int16) - frames).mean() < 1.5


@needs_cv2
@pytest.mark.parametrize("fps", [10, 8])
def test_save_mp4_reads_in_cv2(tmp_path, fps):
    frames = smooth_frames(5)
    path = str(tmp_path / "out.mp4")
    native_video.save_mp4(path, frames, fps=fps)
    cap = cv2.VideoCapture(path)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 5 and cap.get(cv2.CAP_PROP_FPS) == fps
    ref = cv2_decode(path)
    assert ref.shape == frames.shape
    assert np.abs(ref.astype(np.int16) - frames).mean() < 1.5
    frame_errors(native_video.read_mp4(path), ref)


# ---- refusals, each made by patching a fixture's bytes

class Bits:
    """Big-endian bit access to a bytearray."""

    def __init__(self, data: bytearray, start: int):
        self.data, self.pos = data, start * 8

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | (self.data[self.pos >> 3] >> (7 - (self.pos & 7)) & 1)
            self.pos += 1
        return v

    def mark(self, n: int) -> int:
        """The position of the next n-bit field, which is skipped."""
        at = self.pos
        self.read(n)
        return at


def set_bits(data: bytearray, pos: int, n: int, value: int) -> None:
    for i in range(n):
        bit, p = value >> (n - 1 - i) & 1, pos + i
        data[p >> 3] = data[p >> 3] & ~(0x80 >> (p & 7)) | bit << (7 - (p & 7))


def vol_fields(data: bytearray) -> dict:
    """Bit positions of the VOL's fields, walking the header as ISO 14496-2
    lays it out (the paths OpenCV's writer takes; the VOL sits in esds)."""
    at = data.find(b"\x00\x00\x01\x20", data.find(b"moov")) + 4
    b, f = Bits(data, at), {"start": at}
    b.read(9)
    verid = 1
    if b.read(1):
        f["verid"] = b.pos
        verid = b.read(4)
        b.read(3)
    if b.read(4) == 15:
        b.read(16)
    assert b.read(1), "the fixtures' VOLs carry vol_control_parameters"
    b.read(2)
    f["low_delay"] = b.mark(1)
    if b.read(1):
        b.read(79)
    f["shape"] = b.mark(2)
    b.read(1)
    f["time_bits"] = max(1, (b.read(16) - 1).bit_length())
    b.read(1)
    if b.read(1):
        b.read(f["time_bits"])
    b.read(29)
    f["interlaced"] = b.mark(1)
    f["obmc_disable"] = b.mark(1)
    f["sprite_enable"] = b.mark(1 if verid == 1 else 2)
    f["not_8_bit"] = b.mark(1)
    f["quant_type"] = b.mark(1)
    assert verid == 1, "the fixtures' VOLs are version 1: no quarter_sample field"
    f["after_quant_type"] = b.pos
    f["complexity_estimation_disable"] = b.mark(1)
    f["resync_marker_disable"] = b.mark(1)
    f["data_partitioned"] = b.mark(1)
    f["scalability"] = b.mark(1)
    f["end"] = data.find(b"\x00\x00\x01", at) * 8
    return f


def insert_bits(data: bytearray, at: int, end: int, bits: str) -> None:
    """Insert `bits` at bit `at`, shifting the bits up to `end` along and
    dropping as many at `end`."""
    b = Bits(data, 0)
    b.pos = at
    tail = "".join(str(b.read(1)) for _ in range(end - at))
    new = (bits + tail)[: end - at]
    for i, c in enumerate(new):
        set_bits(data, at + i, 1, int(c))


def quarter_sample(data: bytearray) -> None:
    """VOL version 2 with quarter_sample = 1: a second sprite_enable bit and
    the quarter_sample bit come in after quant_type."""
    f = vol_fields(data)
    set_bits(data, f["verid"], 4, 2)
    insert_bits(data, f["after_quant_type"], f["end"], "1")
    insert_bits(data, f["sprite_enable"], f["end"], "0")


def first_vop(data: bytearray, kind: str) -> int:
    """The byte after the start code of the first VOP of `kind`."""
    at = data.find(b"\x00\x00\x01\xb6")
    while "IPBS"[data[at + 4] >> 6] != kind:
        at = data.find(b"\x00\x00\x01\xb6", at + 4)
    return at + 4


def ac_pred(data: bytearray) -> None:
    """ac_pred_flag = 1 in the first I-VOP's first macroblock."""
    time_bits = vol_fields(data)["time_bits"]
    b = Bits(data, first_vop(data, "I"))
    b.read(2)  # vop_coding_type
    while b.read(1):  # modulo_time_base
        pass
    b.read(1 + time_bits + 1 + 1 + 3 + 5)  # marker, increment, marker, vop_coded, intra_dc_vlc_thr, vop_quant
    code, n = b.read(1), 1  # the macroblock's MCBPC: 1, 001, 010, 011 or 0001
    while (code, n) not in ((1, 1), (1, 3), (2, 3), (3, 3), (1, 4)):
        code, n = code << 1 | b.read(1), n + 1
        assert n <= 4, "not an I-VOP MCBPC without stuffing"
    set_bits(data, b.pos, 1, 1)


def patch_vol(field: str, value: int):
    def patch(data: bytearray) -> None:
        f = vol_fields(data)
        width = 2 if field == "shape" else 1
        set_bits(data, f[field], width, value)
    return patch


def sample_entry(fourcc: bytes):
    def patch(data: bytearray) -> None:
        at = data.find(b"mp4v", data.find(b"stsd"))
        data[at:at + 4] = fourcc
    return patch


def vop_type(kind: int):
    def patch(data: bytearray) -> None:
        at = first_vop(data, "P")
        data[at] = data[at] & 0x3F | kind << 6
    return patch


def no_video(data: bytearray) -> None:
    """The track's handler says sound."""
    at = data.find(b"vide", data.find(b"hdlr"))
    data[at:at + 4] = b"soun"


def cut_mdat(data: bytearray) -> None:
    del data[data.find(b"mdat") + len(data) // 3:]


def garble_last_vop(data: bytearray) -> None:
    """Zeros over the macroblocks of the last VOP: codes no table holds."""
    at = data.rfind(b"\x00\x00\x01\xb6") + 8
    data[at:at + 64] = bytes(64)


REFUSALS = {
    "no_video_track": (no_video, 3),
    "avc1": (sample_entry(b"avc1"), 4),
    "hev1": (sample_entry(b"hev1"), 4),
    "s263": (sample_entry(b"s263"), 5),
    "low_delay": (patch_vol("low_delay", 0), 6),
    "b_vop": (vop_type(2), 6),
    "s_vop": (vop_type(3), 7),
    "sprite_enable": (patch_vol("sprite_enable", 1), 7),
    "quarter_sample": (quarter_sample, 8),
    "interlaced": (patch_vol("interlaced", 1), 9),
    "data_partitioned": (patch_vol("data_partitioned", 1), 10),
    "shape": (patch_vol("shape", 1), 11),
    "not_8_bit": (patch_vol("not_8_bit", 1), 12),
    "scalability": (patch_vol("scalability", 1), 13),
    "quant_type": (patch_vol("quant_type", 1), 14),
    "ac_pred": (ac_pred, 15),
    "resync_marker_disable": (patch_vol("resync_marker_disable", 0), 17),
    "cut_mdat": (cut_mdat, 18),
    "garbled_vop": (garble_last_vop, 18),
    "obmc": (patch_vol("obmc_disable", 0), 20),
}


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_name_file_and_reason(tmp_path, case):
    patch, status = REFUSALS[case]
    data = bytearray(open(os.path.join(DATA, "mp4v_64.mp4"), "rb").read())
    patch(data)
    path = str(tmp_path / f"{case}.mp4")
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError) as err:
        native_video.read_mp4(path)
    assert str(err.value) == f"{path} {native_video._REASONS[status]}"


def test_files_that_are_no_mp4_or_cannot_be_read_or_written(tmp_path):
    path = str(tmp_path / "frame.mp4")
    native_io.save_png_batch([path], np.zeros((1, 8, 8, 3), np.uint8))
    with pytest.raises(IOError, match=f"{path} is not an MP4"):
        native_video.mp4_info(path)
    with pytest.raises(IOError, match="cannot be read"):
        native_video.read_mp4(str(tmp_path / "absent.mp4"))
    with pytest.raises(IOError, match="cannot be written"):
        native_video.save_mp4(str(tmp_path / "absent" / "out.mp4"), np.zeros((1, 16, 16, 3), np.uint8))


@pytest.fixture
def one_thread():
    """Torch on one CPU thread, as the port's other CPU test files hold it
    (several test workers share the host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_scores_phase_runs_at_tiny_size_on_the_cpu(tmp_path, one_thread):
    """`chip_smoke.full_scores` (phase 22) on small PNG clips laid out as
    phase 11 leaves them, the CPU standing in for the card."""
    rng = np.random.default_rng(22)
    y, x = np.mgrid[0:48, 0:80] / 80
    out = tmp_path / "cli_out"
    for i, sub in enumerate(("predictions_1", "predictions_gt_1", "predictions", "predictions_gt")):
        os.makedirs(out / sub)
        phase = rng.uniform(0, 6, 3)
        video = np.stack([128 + 90 * np.cos(5 * x + i + 0.4 * t)[..., None] * np.sin(3 * y[..., None] + phase)
                          for t in range(10)])
        native_io.save_png_batch([str(out / sub / f"{t:03d}.png") for t in range(10)],
                                 np.clip(np.rint(video), 0, 255).astype(np.uint8))
    result = full_scores(torch.device("cpu"), str(tmp_path), str(out),
                                    overrides=("--loop.num_segments=2", "--pipeline.num_frames=10"))
    compared = result["compared"]
    assert set(compared) == {"fvd", "ssim", "psnr", "lpips"} and all(c["ok"] for c in compared.values())
    assert result["videos"] == [2, 10, 64, 64, 3] and result["launches"] == [0, 0]
    assert set(result["metric_seconds"]) == {"fvd", "ssim", "psnr", "lpips"}
    assert all(f["luma_mae"] <= ENCODE_LUMA_MAE for f in result["files"])
