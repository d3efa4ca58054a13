"""The port's H.264 decoder (`csrc/h264.h`, read through `csrc/video.cpp`
and `data/native_video.py`) against OpenCV, whose FFmpeg the JAX package's
scoring CLI reads H.264 through.

H.264 decoding is exact by the standard, so the port's decode must equal
OpenCV's byte for byte: the luma plane against cv2's raw Y
(`CAP_PROP_CONVERT_RGB` 0), the RGB frames against cv2's BGR turned to RGB,
with the same frame count and order as cv2's read loop.

- The committed fixtures (`torch_port_data/make_h264_fixtures.py`, which
  `chip_smoke.py` phase 2c decodes on the card) against the PNG strip of
  cv2's decode stored beside each and, where cv2 is installed, against
  `cv2.VideoCapture` itself; `mp4_info` against cv2's `CAP_PROP_*`.
- Fresh streams from the fixtures' writer (`torch_port_data/h264_writer.py`,
  random but valid syntax), one per seed with its tools drawn at random.
- Between them the fixtures and the seeds hold every tool the decoder
  takes (REQUIRED_TOOLS): the test asserts it from the tools the writer
  reports.
- What the decoder does not take raises an IOError naming the file and the
  reason: each case patches a fixture's bytes.

The file imports no JAX, and the tests that need cv2 skip without it, so
it also runs on the card's machine:

    python -m pytest tests/test_torch_port_h264.py --noconftest -q
"""

import importlib.util
import json
import os
import struct
import sys

import numpy as np
import pytest

from chip_smoke import H264_FIXTURES as FIXTURES
from chip_smoke import check_mp4_fixtures
from evoworld_tpu_torch.data import native_io, native_video

try:
    import cv2
except ImportError:  # the card's machine
    cv2 = None

DATA = os.path.join(os.path.dirname(__file__), "torch_port_data")
FPS = 8  # the writer's rate
needs_cv2 = pytest.mark.skipif(cv2 is None, reason="needs OpenCV (cv2), the reference decoder")


def _load(name: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, os.path.join(DATA, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


writer = _load("h264_writer")
SEEDS = (1, 2, 3, 4, 5)
# Every tool of the decoder's set, as the writer names them.
REQUIRED_TOOLS = {
    "cabac", "cavlc", "avc1", "avc3", "i_slices", "p_slices", "b_slices", "b_reference", "transform_8x8",
    "scaling_sps", "scaling_pps", "weighted_explicit_p", "weighted_explicit_b", "weighted_implicit_b",
    "direct_spatial", "direct_temporal", "several_slices", "cropping", "long_term_refs", "mmco", "i_pcm",
    "i4x4", "i8x8", "i16x16", "p_skip", "b_skip", "b_direct_16x16", "b_direct_8x8", "sub_8x8_partitions",
    "partitions_16x8_8x16", "ref_list_modification", "constrained_intra_pred", "poc_type_1", "poc_type_2",
    "vui_num_reorder_frames", "deblock_idc_0", "deblock_idc_1", "deblock_idc_2", "mb_qp_delta", "large_levels",
    "large_vectors", "second_chroma_qp_offset", "cabac_init_idc_0", "cabac_init_idc_1", "cabac_init_idc_2",
}


def stored_decode(name: str) -> np.ndarray:
    """cv2's decode of a fixture, from the PNG strip beside it."""
    t, h, w = FIXTURES[name]
    strip = native_io.load_image_batch([os.path.join(DATA, f"{name}.png")], t * h, w, minus1_1=False)[0]
    return np.rint(strip * 255).astype(np.uint8).reshape(t, h, w, 3)


def cv2_read(path: str, rgb: bool = True) -> np.ndarray:
    """Every frame cv2's read loop gives: RGB, or the raw Y plane."""
    cap = cv2.VideoCapture(path)
    if not rgb:
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1] if rgb else frame)
    cap.release()
    return np.stack(frames)


def assert_equals_cv2(path: str) -> None:
    """RGB and luma byte-equal to cv2's, frame count and order included;
    mp4_info equal to cv2's properties."""
    ref = cv2_read(path)
    ours = native_video.read_mp4(path)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    differing = int((ours != ref).sum())
    assert differing == 0, f"{differing} bytes differ from cv2 in frames {np.unique(np.argwhere(ours != ref)[:, 0])}"
    luma = native_video.read_mp4_planes(path)[0]
    t, h, w = luma.shape
    np.testing.assert_array_equal(luma, cv2_read(path, rgb=False)[:, :h, :w])
    cap = cv2.VideoCapture(path)
    info = native_video.mp4_info(path)
    assert (info["frames"], info["height"], info["width"]) == (
        cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FRAME_HEIGHT), cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    assert abs(info["fps"] - cap.get(cv2.CAP_PROP_FPS)) < 1e-9


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_stored_decode(name):
    path = os.path.join(DATA, f"{name}.mp4")
    t, h, w = FIXTURES[name]
    assert native_video.mp4_info(path) == {"frames": t, "fps": FPS, "height": h, "width": w}
    np.testing.assert_array_equal(native_video.read_mp4(path), stored_decode(name))
    y, cb, cr = native_video.read_mp4_planes(path)
    assert y.shape == (t, h, w) and cb.shape == cr.shape == (t, h // 2, w // 2)


@needs_cv2
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_cv2(name):
    path = os.path.join(DATA, f"{name}.mp4")
    assert_equals_cv2(path)
    np.testing.assert_array_equal(cv2_read(path), stored_decode(name))  # the strip is still cv2's decode


def test_fixture_phase_passes_on_the_cpu():
    """`chip_smoke.py` phase 2c's H.264 rows, as the card runs them."""
    rows = check_mp4_fixtures(FIXTURES)
    assert [r["name"] for r in rows] == list(FIXTURES)
    assert all(r["differing_bytes"] == 0 and r["frames_per_s"] > 0 for r in rows), rows


@needs_cv2
@pytest.mark.parametrize("seed", SEEDS)
def test_fresh_seeded_stream_matches_cv2(tmp_path, seed):
    cfg = writer.random_config(seed)
    frames = _load("make_mp4_fixtures").blobs(np.random.default_rng(seed), cfg.height, cfg.width, len(cfg.gop))
    path = str(tmp_path / f"seed{seed}.mp4")
    writer.write_mp4(path, frames, cfg, seed)
    assert_equals_cv2(path)


def test_streams_hold_every_tool(tmp_path):
    """The tools of the committed fixtures (as the writer recorded them)
    and of the fresh seeds cover the decoder's set."""
    tools = set().union(*json.load(open(os.path.join(DATA, "h264_fixtures.json"))).values())
    for seed in SEEDS:
        cfg = writer.random_config(seed)
        frames = np.full((len(cfg.gop), cfg.height, cfg.width, 3), 128, np.uint8)
        tools |= writer.write_mp4(str(tmp_path / f"{seed}.mp4"), frames, cfg, seed)
    assert REQUIRED_TOOLS <= tools, sorted(REQUIRED_TOOLS - tools)


@needs_cv2
@pytest.mark.parametrize("vui,colr", [((0, 1, 1, 6), None), ((0, 5, 6, 5), (6, 13, 6, 0)), (None, (7, 8, 2, 0))])
def test_colour_descriptions_opencv_converts_as_none(tmp_path, vui, colr):
    """Colour descriptions that leave OpenCV's conversion as without one
    (BT.709 primaries and transfer over a BT.601 matrix, BT.601 in full,
    others in a colr box) decode as cv2 decodes them; what changes its
    conversion is refused (the colour cases of REFUSALS)."""
    cfg = writer.Config(gop=writer.gop_ippp(3), colour=vui, colr=colr)
    path = str(tmp_path / "colour.mp4")
    writer.write_mp4(path, np.full((3, 64, 64, 3), 90, np.uint8) + np.arange(64, dtype=np.uint8)[:, None, None], cfg, 0)
    assert_equals_cv2(path)


@needs_cv2
def test_fixtures_are_the_writers(tmp_path):
    """make_h264_fixtures.py still writes the committed files (so
    h264_fixtures.json lists their tools)."""
    maker = _load("make_h264_fixtures")
    for name, (cfg, kind, seed) in maker.FIXTURES.items():
        path = str(tmp_path / f"{name}.mp4")
        writer.write_mp4(path, maker.source(kind, cfg, seed), cfg, seed)
        assert open(path, "rb").read() == open(os.path.join(DATA, f"{name}.mp4"), "rb").read(), name


# ---- refusals, each made by patching a fixture's bytes


class Mp4:
    """A fixture's samples and parameter sets, and its rebuild as an MP4."""

    def __init__(self, name: str):
        self.data = bytearray(open(os.path.join(DATA, f"{name}.mp4"), "rb").read())
        d = bytes(self.data)
        at = d.find(b"stsz")
        n = struct.unpack(">I", d[at + 12:at + 16])[0]
        sizes = struct.unpack(f">{n}I", d[at + 16:at + 16 + 4 * n])
        at = d.find(b"stco")
        offsets = struct.unpack(f">{n}I", d[at + 12:at + 12 + 4 * n])
        self.samples = [bytearray(d[o:o + s]) for o, s in zip(offsets, sizes)]
        at = d.find(b"avcC") + 4
        self.profile = d[at + 1]
        self.avc3 = d.find(b"avc3") >= 0
        self.sps = self.pps = b""
        if d[at + 5] & 31:
            n = struct.unpack(">H", d[at + 6:at + 8])[0]
            self.sps = bytearray(d[at + 8:at + 8 + n])
            k = at + 8 + n + 1
            self.pps = bytearray(d[k + 2:k + 2 + struct.unpack(">H", d[k:k + 2])[0]])
        at = d.find(b"tkhd") + 4 + 4 + 20 + 8 + 8 + 36
        self.width, self.height = (v >> 16 for v in struct.unpack(">II", d[at:at + 8]))
        self.colr = None

    def nals(self, k: int) -> list:
        """(start, length) of each NAL unit of sample k."""
        out, i, s = [], 0, self.samples[k]
        while i < len(s):
            n = struct.unpack(">I", s[i:i + 4])[0]
            out.append((i + 4, n))
            i += 4 + n
        return out

    def build(self) -> bytes:
        idr = [any(self.samples[k][a] & 31 == 5 for a, _ in self.nals(k)) for k in range(len(self.samples))]
        return writer.mp4([bytes(s) for s in self.samples], list(range(len(self.samples))), idr, self.width,
                          self.height, bytes(self.sps), bytes(self.pps), self.profile, self.avc3, FPS, self.colr)


def rbsp_bits(nal: bytes) -> str:
    """The RBSP after a NAL header (emulation prevention bytes removed) as a
    string of bits."""
    out, zeros = bytearray(), 0
    for b in nal[1:]:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        zeros = zeros + 1 if b == 0 else 0
        out.append(b)
    return "".join(f"{b:08b}" for b in out)


def nal_of(header: int, bits: str) -> bytes:
    bits = bits.rstrip("0")[:-1]  # drop the old trailing bits
    bits += "1" + "0" * ((7 - len(bits)) % 8)
    return writer.nal(header & 31, header >> 5, bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)))


class Walk:
    """Reads fields of a bit string, keeping the position of each."""

    def __init__(self, bits: str):
        self.bits, self.pos, self.at = bits, 0, {}

    def u(self, name: str, n: int) -> int:
        self.at[name] = (self.pos, n)
        v = int(self.bits[self.pos:self.pos + n], 2)
        self.pos += n
        return v

    def ue(self, name: str) -> int:
        start, z = self.pos, 0
        while self.bits[self.pos] == "0":
            z, self.pos = z + 1, self.pos + 1
        v = int(self.bits[self.pos:self.pos + z + 1], 2) - 1
        self.pos += z + 1
        self.at[name] = (start, self.pos - start)
        return v

    def replace(self, name: str, new: str) -> str:
        start, n = self.at[name]
        return self.bits[:start] + new + self.bits[start + n:]


def sps_walk(sps: bytes) -> Walk:
    """The fields of the cabac fixture's SPS (High profile, no scaling
    lists, POC type 0, VUI with bitstream_restriction) up to the VUI's
    video_signal_type_present_flag."""
    w = Walk(rbsp_bits(sps))
    w.u("profile_idc", 8), w.u("constraints", 8), w.u("level", 8), w.ue("sps_id")
    w.ue("chroma_format_idc"), w.ue("bit_depth_luma"), w.ue("bit_depth_chroma"), w.u("bypass", 1)
    assert w.u("scaling", 1) == 0
    w.ue("log2_max_frame_num")
    assert w.ue("poc_type") == 0
    w.ue("log2_max_poc_lsb"), w.ue("max_refs"), w.u("gaps", 1), w.ue("mb_width"), w.ue("mb_height")
    w.u("frame_mbs_only", 1), w.u("direct_8x8_inference", 1)
    assert w.u("cropping", 1) == 0 and w.u("vui", 1) == 1  # (cropping: frame_cropping_flag)
    w.u("aspect", 1), w.u("overscan", 1), w.u("video_signal_type", 1)
    return w


def patch_sps(field: str, new: str):
    def patch(m: Mp4):
        w = sps_walk(m.sps)
        m.sps = nal_of(m.sps[0], w.replace(field, new))
    return patch


def patch_pps(field_index: int, new: str):
    """Replaces the PPS field at `field_index` among pps_id, sps_id, cabac,
    bottom_field_pic_order, num_slice_groups, num_ref_idx l0, l1, weighted,
    bipred (2 bits), qp, qs, chroma offset, deblocking, constrained intra,
    redundant_pic_cnt_present."""
    def patch(m: Mp4):
        w = Walk(rbsp_bits(m.pps))
        kinds = ["ue", "ue", 1, 1, "ue", "ue", "ue", 1, 2, "ue", "ue", "ue", 1, 1, 1]
        for i, kind in enumerate(kinds[:field_index + 1]):
            w.ue(str(i)) if kind == "ue" else w.u(str(i), kind)
        m.pps = nal_of(m.pps[0], w.replace(str(field_index), new))
    return patch


def patch_nal_type(new_type: int):
    def patch(m: Mp4):
        start, _ = m.nals(1)[0]
        m.samples[1][start] = m.samples[1][start] & 0xE0 | new_type
    return patch


def sp_slice(m: Mp4):
    """slice_type 5 (P) to 3 (SP), 6 (B) to 4 (SI): codes of one length."""
    for k in range(len(m.samples)):
        for start, n in m.nals(k):
            w = Walk("".join(f"{b:08b}" for b in m.samples[k][start + 1:start + 9]))
            w.ue("first_mb")
            t = w.ue("slice_type")
            if t in (5, 6):
                bits = w.replace("slice_type", "00100" if t == 5 else "00101")
                m.samples[k][start + 1:start + 9] = bytes(int(bits[i:i + 8], 2) for i in range(0, 64, 8))
                return
    raise AssertionError("no slice of type 5 or 6")


def mmco5(m: Mp4):
    """MMCO 5 in the second picture of the baseline fixture (a P slice of
    POC type 2, no weights): adaptive_ref_pic_marking_mode_flag set, then
    memory_management_control_operation 5 and 0."""
    start, n = m.nals(1)[0]
    nal = bytes(m.samples[1][start:start + n])
    w = Walk(rbsp_bits(nal))
    w.ue("first_mb"), w.ue("slice_type"), w.ue("pps_id"), w.u("frame_num", 5)
    if w.u("override", 1):
        w.ue("num_ref")
    if w.u("modification", 1):
        while w.ue("idc") != 3:
            w.ue("value")
    w.u("adaptive", 1)
    new = nal_of(nal[0], w.replace("adaptive", "1" + "00110" + "1"))
    m.samples[1][start - 4:start + n] = struct.pack(">I", len(new)) + new


def colr_box(primaries: int, transfer: int, matrix: int, full_range: int):
    def patch(m: Mp4):
        m.colr = (primaries, transfer, matrix, full_range)
    return patch


def insert_nal(nal_type: int):
    def patch(m: Mp4):
        unit = writer.nal(nal_type, 0, b"\x80")
        m.samples[1][0:0] = struct.pack(">I", len(unit)) + unit
    return patch


def drop_sample(k: int):
    def patch(m: Mp4):
        del m.samples[k]
    return patch


def entry(fourcc: bytes):
    def patch(data: bytearray):
        at = data.find(b"stsd") + 16  # the sample entry's type (ftyp names avc1 as a brand too)
        data[at:at + 4] = fourcc
    return patch


def no_avcc(data: bytearray):
    at = data.find(b"avcC")
    data[at:at + 4] = b"avcX"


def late_edit(data: bytearray):
    """The elst's media_time one frame past the first presented sample."""
    at = data.find(b"elst") + 4 + 4 + 4 + 4
    media_time = struct.unpack(">i", data[at:at + 4])[0]
    data[at:at + 4] = struct.pack(">i", media_time + 2048)


def cut(data: bytearray):
    del data[data.find(b"mdat") + (len(data) - data.find(b"mdat")) // 2:]


def garble(data: bytearray):
    """Zeros over the middle of the last sample: codes no table holds."""
    m = Mp4("h264_cavlc_200x120")
    last = bytes(m.samples[-1])
    at = bytes(data).find(last) + len(last) // 2
    data[at:at + 64] = bytes(64)


# case -> (fixture, what the patch edits: "stream" (the parsed samples and
# parameter sets, rebuilt as an MP4) or "bytes" (the file), patch, status)
REFUSALS = {
    "interlaced": ("h264_cabac_64", "stream", patch_sps("frame_mbs_only", "00"), 21),
    "chroma_422": ("h264_cabac_64", "stream", patch_sps("chroma_format_idc", "011"), 22),
    "monochrome": ("h264_cabac_64", "stream", patch_sps("chroma_format_idc", "1"), 22),
    "bit_depth_10": ("h264_cabac_64", "stream", patch_sps("bit_depth_luma", "011"), 23),
    "separate_colour_planes": ("h264_cabac_64", "stream", patch_sps("chroma_format_idc", "00100" + "1"), 24),
    "high_10_profile": ("h264_cabac_64", "stream", patch_sps("profile_idc", f"{110:08b}"), 25),
    "high_444_profile": ("h264_cabac_64", "stream", patch_sps("profile_idc", f"{244:08b}"), 25),
    "transform_bypass": ("h264_cabac_64", "stream", patch_sps("bypass", "1"), 26),
    "data_partitioning": ("h264_cabac_64", "stream", patch_nal_type(2), 27),
    "sp_si_slices": ("h264_cavlc_200x120", "stream", sp_slice, 28),
    "slice_groups": ("h264_cabac_64", "stream", patch_pps(4, "010"), 29),
    "redundant_pictures": ("h264_cabac_64", "stream", patch_pps(14, "1"), 30),
    "frame_num_gap": ("h264_baseline_64", "stream", drop_sample(3), 31),
    "svc_profile": ("h264_cabac_64", "stream", patch_sps("profile_idc", f"{83:08b}"), 32),
    "svc_nal": ("h264_cabac_64", "stream", insert_nal(14), 32),
    "mvc_nal": ("h264_cabac_64", "stream", insert_nal(20), 32),
    "colour_bt709": ("h264_cabac_64", "stream",
                     patch_sps("video_signal_type", "1" + "101" + "0" + "1" + f"{1:08b}" * 3), 33),
    "colour_full_range": ("h264_cabac_64", "stream", patch_sps("video_signal_type", "1" + "101" + "1" + "0"), 33),
    "colour_pq_transfer": ("h264_cabac_64", "stream",
                           patch_sps("video_signal_type", "1" + "101" + "0" + "1" + f"{2:08b}{16:08b}{6:08b}"), 33),
    "colr_box_bt709": ("h264_cabac_64", "stream", colr_box(1, 1, 1, 0), 33),
    "left_crop": ("h264_cabac_64", "stream", patch_sps("cropping", "1" + "010" + "1" + "1" + "1"), 39),
    "colr_box_full_range": ("h264_cabac_64", "stream", colr_box(2, 2, 6, 1), 33),
    "mmco_5": ("h264_baseline_64", "stream", mmco5, 34),
    "no_idr_first": ("h264_cabac_64", "stream", drop_sample(0), 35),
    "late_edit_list": ("h264_cabac_64", "bytes", late_edit, 36),
    "hevc": ("h264_cabac_64", "bytes", entry(b"hvc1"), 4),
    "avc1_without_avcc": ("h264_cabac_64", "bytes", no_avcc, 4),
    "vp9": ("h264_cabac_64", "bytes", entry(b"vp09"), 37),
    "av1": ("h264_cabac_64", "bytes", entry(b"av01"), 38),
    "motion_jpeg": ("h264_cabac_64", "bytes", entry(b"mjpa"), 5),
    "cut_mdat": ("h264_cavlc_200x120", "bytes", cut, 18),
    "garbled_slice": ("h264_cavlc_200x120", "bytes", garble, 18),
}


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_name_file_and_reason(tmp_path, case):
    name, kind, patch, status = REFUSALS[case]
    m = Mp4(name)
    if kind == "bytes":
        patch(m.data)
        data = bytes(m.data)
    else:
        patch(m)
        data = m.build()
    path = str(tmp_path / f"{case}.mp4")
    open(path, "wb").write(data)
    with pytest.raises(IOError) as err:
        native_video.read_mp4(path)
    assert str(err.value) == f"{path} {native_video._REASONS[status]}"


def test_rebuilt_fixture_still_decodes(tmp_path):
    """The refusals' rebuild of a fixture, unpatched, decodes as the fixture:
    what each refusal raises comes from its patch alone."""
    for name in FIXTURES:
        path = str(tmp_path / f"{name}.mp4")
        open(path, "wb").write(Mp4(name).build())
        np.testing.assert_array_equal(native_video.read_mp4(path), stored_decode(name))
