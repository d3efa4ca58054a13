"""A writer of random but valid H.264 streams in MP4, the test fixtures of
the port's H.264 decoder (`evoworld_tpu_torch/csrc/h264.h`).

No H.264 encoder exists on the machines the port is tested on (OpenCV's
writer refuses avc1, and there is no x264, ffmpeg or PyAV), and H.264
decoding is exact by the standard: every conforming decoder gives the same
planes. So this module writes streams whose syntax is drawn at random from a
numpy seed, and OpenCV's FFmpeg decode of them is the oracle. It needs no
reconstruction of its own: the first IDR picture is mostly I_PCM (the
source frames written as samples), and every later macroblock is a random
prediction mode, vector and small residual on top of what the decoder
reconstructed. It writes length-prefixed NAL units (no start codes) in an
MP4 laid out as FFmpeg's muxer lays out libx264's output: `avc1` with
`avcC` (or `avc3` with the parameter sets in band), stts, ctts with the
B-frame offsets, stss and an elst.

The entropy coders (CAVLC, and the CABAC arithmetic coder with every
context the decoder reads) follow ITU-T H.264 clause 9; their tables are
read from the decoder's source, so a wrong entry shows as a difference
from OpenCV, not as a writer that agrees with the decoder by accident of
typing. `Stream(...).tools` lists the coding tools a stream used.

    from tests.torch_port_data.h264_writer import Config, write_mp4
    tools = write_mp4("out.mp4", frames_rgb, Config(cabac=True, ...), seed=0)
"""

from __future__ import annotations

import dataclasses
import os
import re
import struct

import numpy as np

HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "evoworld_tpu_torch", "csrc", "h264.h")


def _tables() -> dict:
    """The decoder's constant tables by name, as nested lists of ints."""
    text = open(HEADER).read()
    out = {}
    for m in re.finditer(r"const (?:u?int8_t|int) (k\w+)((?:\[\w+\])+) = (\{.*?\});", text, re.S):
        name, body = m.group(1), m.group(3)
        body = re.sub(r"//[^\n]*", "", body)
        body = body.replace("{", "[").replace("}", "]")
        out[name] = eval(body)  # noqa: S307 - literal integer arrays of the source
    return out


T = _tables()
ZZ4, ZZ8 = T["kZigzag4"], T["kZigzag8"]
BLK_RASTER = T["kBlkRaster"]


# ---------------------------------------------------------------- bits


class Bits:
    def __init__(self):
        self.bits: list[int] = []

    def u(self, n: int, v: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def ue(self, v: int) -> None:
        v += 1
        n = v.bit_length()
        self.u(n - 1, 0)
        self.u(n, v)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def te(self, rng_max: int, v: int) -> None:
        if rng_max == 1:
            self.u(1, 1 - v)
        else:
            self.ue(v)

    def align_zero(self) -> None:
        while len(self.bits) % 8:
            self.bits.append(0)

    def trailing(self) -> None:
        self.bits.append(1)
        self.align_zero()

    def bytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for k in range(8):
                b = b << 1 | self.bits[i + k]
            out.append(b)
        return bytes(out)


def nal(nal_type: int, ref_idc: int, rbsp: bytes) -> bytes:
    """A NAL unit: its header byte, and the RBSP with emulation prevention."""
    out = bytearray([ref_idc << 5 | nal_type])
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class Cabac:
    """The arithmetic encoder of 9.3.4.2 writing into a Bits."""

    def __init__(self, bits: Bits):
        self.b = bits
        self.state = [0] * 460
        self.start()

    def start(self):
        self.low, self.range, self.first, self.outstanding = 0, 510, True, 0

    def init_contexts(self, column: int, qp: int) -> None:
        for i, row in enumerate(T["kCabacInit"]):
            m, n = row[column]
            pre = min(max(((m * min(max(qp, 0), 51)) >> 4) + n, 1), 126)
            self.state[i] = ((63 - pre) << 1) if pre <= 63 else ((pre - 64) << 1 | 1)

    def _put(self, bit: int) -> None:
        if self.first:
            self.first = False
        else:
            self.b.bits.append(bit)
        while self.outstanding:
            self.b.bits.append(1 - bit)
            self.outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: int, bin_: int) -> None:
        s = self.state[ctx]
        p, mps = s >> 1, s & 1
        lps = T["kRangeLps"][p][(self.range >> 6) & 3]
        self.range -= lps
        if bin_ != mps:
            self.low += self.range
            self.range = lps
            if p == 0:
                mps = 1 - mps
            p = T["kTransLps"][p]
        else:
            p = min(p + 1, 62)
        self.state[ctx] = p << 1 | mps
        self._renorm()

    def bypass(self, bin_: int) -> None:
        self.low <<= 1
        if bin_:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, bin_: int) -> None:
        self.range -= 2
        if bin_:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.b.u(2, ((self.low >> 7) & 3) | 1)
        else:
            self._renorm()

    def egk(self, v: int, k: int) -> None:
        while v >= (1 << k):
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        while k:
            k -= 1
            self.bypass((v >> k) & 1)


# ---------------------------------------------------------------- configuration


@dataclasses.dataclass
class Config:
    """The tools of one stream. `gop` lists the pictures in decode order as
    (display index, type "I"/"P"/"B", is reference, [marking ops]); an "I" at
    display 0 of a period is an IDR. Marking ops: ("unmark", display) (MMCO 1),
    ("to_long", display, idx) (MMCO 3), ("unmark_long", idx) (MMCO 2),
    ("max_long", n) (MMCO 4), ("current_long", idx) (MMCO 6), and
    ("idr_long",) on an IDR (long_term_reference_flag)."""

    width: int = 64
    height: int = 64
    crop: tuple = (0, 0, 0, 0)  # left, right, top, bottom in luma samples
    profile: int = 100
    constraint_flags: int = 0
    cabac: bool = True
    avc3: bool = False
    transform_8x8: bool = False
    scaling_sps: bool = False
    scaling_pps: bool = False
    weighted_pred: bool = False
    weighted_bipred_idc: int = 0
    direct_spatial: bool = True
    direct_8x8_inference: bool = True
    constrained_intra: bool = False
    num_reorder_frames: int | None = None  # VUI bitstream_restriction when set
    colour: tuple | None = None  # VUI (video_full_range_flag, colour_primaries, transfer, matrix) when set
    colr: tuple | None = None  # an MP4 colr box (nclx: primaries, transfer, matrix, full range) when set
    max_refs: int = 3
    poc_type: int = 0
    log2_max_frame_num: int = 5
    slices: int = 1
    deblock_idc: tuple = (0,)  # disable_deblocking_filter_idc drawn from these
    pcm_share: float = 0.8  # of the first IDR's macroblocks
    pcm_later: float = 0.0  # of intra macroblocks after it
    reorder_lists: bool = False
    num_ref_active: int | None = None  # list 0 size in P and B slices (None: every reference)
    gop: list = dataclasses.field(default_factory=list)
    fps: int = 8
    mvd_large: float = 0.1  # share of vector differences up to 64 px


def gop_ippp(n: int, idr_every: int = 0) -> list:
    """I then P pictures, every one a reference; an IDR every `idr_every`."""
    return [(i if not idr_every else i % idr_every, "I" if (i == 0 or (idr_every and i % idr_every == 0)) else "P", True, [])
            for i in range(n)]


def gop_pyramid(minigops: int) -> list:
    """I0, then P4 B2 b1 b3, P8 B6 b5 b7, ...: a B-pyramid whose middle B is a
    reference, unmarked by MMCO 1 in the next P (as libx264 does)."""
    gop, prev = [(0, "I", True, [])], None
    for k in range(minigops):
        ops = [("unmark", prev)] if prev is not None else []
        gop += [(4 * k + 4, "P", True, ops), (4 * k + 2, "B", True, []), (4 * k + 1, "B", False, []),
                (4 * k + 3, "B", False, [])]
        prev = 4 * k + 2
    return gop


def gop_ibp(pairs: int, long_term: bool = False) -> list:
    """I0, then P2 b1, P4 b3, ...: non-reference B pictures between P
    pictures. With `long_term`, the IDR is a long-term reference, unmarked
    (MMCO 2) at the third P."""
    gop = [(0, "I", True, [("idr_long",)] if long_term else [])]
    for k in range(pairs):
        gop += [(2 * k + 2, "P", True, [("unmark_long", 0)] if long_term and k == 2 else []), (2 * k + 1, "B", False, [])]
    return gop


def random_config(seed: int) -> Config:
    """A 64x64 stream of 7-9 pictures whose tools are drawn from `seed`."""
    rng = np.random.default_rng(seed)
    pick = lambda p: bool(rng.random() < p)  # noqa: E731
    cabac, bframes = pick(0.5), pick(0.7)
    high = pick(0.7)
    cfg = Config(cabac=cabac, profile=100 if high else 77, transform_8x8=high and pick(0.6),
                 scaling_sps=high and pick(0.3), scaling_pps=high and pick(0.3), constrained_intra=pick(0.3),
                 slices=int(rng.integers(1, 3)), deblock_idc=(0, 1, 2) if pick(0.5) else (0,), reorder_lists=pick(0.5),
                 max_refs=int(rng.integers(2, 4)), avc3=pick(0.3), pcm_later=0.05 if pick(0.3) else 0.0,
                 direct_8x8_inference=pick(0.7))
    if bframes:
        cfg.gop = gop_pyramid(2) if pick(0.5) else gop_ibp(4, long_term=pick(0.5))
        cfg.max_refs = 3
        cfg.weighted_bipred_idc = int(rng.integers(0, 3))
        cfg.weighted_pred = pick(0.4)
        cfg.direct_spatial = pick(0.5)
        cfg.num_reorder_frames = (2 if len(cfg.gop) == 9 and cfg.gop[2][1] == "B" else 1) if pick(0.6) else None
    else:
        cfg.gop = gop_ippp(8)
        cfg.poc_type = int(rng.integers(0, 3))
        cfg.weighted_pred = pick(0.4)
        cfg.log2_max_frame_num = 4
        if not cabac and not cfg.weighted_pred and pick(0.5):
            cfg.profile, cfg.transform_8x8, cfg.scaling_sps, cfg.scaling_pps = 66, False, False, False
    return cfg


# ---------------------------------------------------------------- the writer


class Pic:
    def __init__(self, pid, poc, frame_num, disp, period):
        self.id, self.poc, self.frame_num, self.disp, self.period = pid, poc, frame_num, disp, period
        self.short = self.long = False
        self.long_idx = 0
        self.wrap = frame_num
        self.blk_ref = None  # per macroblock, per 4x4: (list 0 picture id or None for intra / unused)
        self.mb_intra = None


class MbState:
    __slots__ = ("slice", "intra", "pcm", "skip", "i16", "inxn", "t8x8", "direct16", "cbp", "chroma_mode", "ipred",
                 "nz", "nzc", "cbf_luma", "cbf_dc", "cbf_ac", "ref_ctx", "mvd")

    def __init__(self):
        self.slice = -1
        self.intra = self.pcm = self.skip = self.i16 = self.inxn = self.t8x8 = self.direct16 = False
        self.cbp = 0
        self.chroma_mode = 0
        self.ipred = [2] * 16
        self.nz = [0] * 16
        self.nzc = [[0] * 4, [0] * 4]
        self.cbf_luma = [False] * 16
        self.cbf_dc = [False] * 3
        self.cbf_ac = [[False] * 4, [False] * 4]
        self.ref_ctx = [[0] * 16, [0] * 16]
        self.mvd = [[[0, 0] for _ in range(16)], [[0, 0] for _ in range(16)]]


P_PARTS = {0: (1, 0, (1, 1)), 1: (2, 1, (1, 1)), 2: (2, 2, (1, 1)), 3: (4, 3, (1, 1))}
B_PARTS = [(0, 0, (0, 0)), (1, 0, (1, 0)), (1, 0, (2, 0)), (1, 0, (3, 0)), (2, 1, (1, 1)), (2, 2, (1, 1)),
           (2, 1, (2, 2)), (2, 2, (2, 2)), (2, 1, (1, 2)), (2, 2, (1, 2)), (2, 1, (2, 1)), (2, 2, (2, 1)),
           (2, 1, (1, 3)), (2, 2, (1, 3)), (2, 1, (2, 3)), (2, 2, (2, 3)), (2, 1, (3, 1)), (2, 2, (3, 1)),
           (2, 1, (3, 2)), (2, 2, (3, 2)), (2, 1, (3, 3)), (2, 2, (3, 3)), (4, 3, (0, 0))]
P_SUB = [(1, 2, 2, 1), (2, 2, 1, 1), (2, 1, 2, 1), (4, 1, 1, 1)]
B_SUB = [(4, 1, 1, 0), (1, 2, 2, 1), (1, 2, 2, 2), (1, 2, 2, 3), (2, 2, 1, 1), (2, 1, 2, 1), (2, 2, 1, 2),
         (2, 1, 2, 2), (2, 2, 1, 3), (2, 1, 2, 3), (4, 1, 1, 1), (4, 1, 1, 2), (4, 1, 1, 3)]
B_BINS = {0: "0", 1: "100", 2: "101", 3: "110000", 4: "110001", 5: "110010", 6: "110011", 7: "110100", 8: "110101",
          9: "110110", 10: "110111", 11: "111110", 12: "1110000", 13: "1110001", 14: "1110010", 15: "1110011",
          16: "1110100", 17: "1110101", 18: "1110110", 19: "1110111", 20: "1111000", 21: "1111001", 22: "111111"}
B_SUB_BINS = {0: "0", 1: "100", 2: "101", 3: "11000", 4: "11001", 5: "11010", 6: "11011", 7: "111000",
              8: "111001", 9: "111010", 10: "111011", 11: "11110", 12: "11111"}


def rgb_to_yuv420(frame: np.ndarray):
    f = frame.astype(np.float64)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    u = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    v = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    sub = lambda c: (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2]) / 4  # noqa: E731
    return (np.clip(np.rint(y), 0, 255).astype(np.uint8), np.clip(np.rint(sub(u)), 0, 255).astype(np.uint8),
            np.clip(np.rint(sub(v)), 0, 255).astype(np.uint8))


class Stream:
    """Writes the access units of one stream; `samples` (bytes each, decode
    order), `sps`, `pps` and `tools` after `run()`."""

    def __init__(self, frames: np.ndarray, cfg: Config, seed: int):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.frames = frames  # (N, H, W, 3) RGB, coded size
        self.mbw, self.mbh = cfg.width // 16, cfg.height // 16
        self.tools: set[str] = {"cabac" if cfg.cabac else "cavlc", "avc3" if cfg.avc3 else "avc1"}
        self.samples: list[bytes] = []
        self.sps = self.pps = b""
        self.dpb: list[Pic] = []
        self.next_id = 1
        self.max_long = -1
        self.scaling4 = self.scaling8 = None

    # ------------------------------------------------------ parameter sets

    def _scaling_lists(self, b: Bits, count: int, pps_level: bool) -> None:
        for i in range(count):
            present = bool(self.rng.random() < 0.7)
            b.u(1, int(present))
            if not present:
                continue
            size = 16 if i < 6 else 64
            if self.rng.random() < 0.15:  # the default list, by a first delta to zero
                b.se(-8)
                self.tools.add("scaling_default_signalled")
                continue
            last = 8
            for _ in range(size):
                nxt = int(self.rng.integers(6, 40))
                delta = (nxt - last + 128) % 256 - 128
                b.se(delta)
                last = nxt
            self.tools.add("scaling_pps" if pps_level else "scaling_sps")

    def write_sps(self) -> bytes:
        c = self.cfg
        b = Bits()
        b.u(8, c.profile)
        b.u(8, c.constraint_flags)
        b.u(8, 30)
        b.ue(0)
        if c.profile == 100:
            b.ue(1)  # chroma_format_idc
            b.ue(0), b.ue(0)
            b.u(1, 0)
            b.u(1, int(c.scaling_sps))
            if c.scaling_sps:
                self._scaling_lists(b, 8, False)
        b.ue(c.log2_max_frame_num - 4)
        b.ue(c.poc_type)
        if c.poc_type == 0:
            b.ue(8 - 4)  # log2_max_pic_order_cnt_lsb 8
        elif c.poc_type == 1:
            b.u(1, 0)  # delta_pic_order_always_zero_flag
            b.se(-1)  # offset_for_non_ref_pic
            b.se(0)
            b.ue(1)
            b.se(2)  # offset_for_ref_frame[0]
            self.tools.add("poc_type_1")
        if c.poc_type == 2:
            self.tools.add("poc_type_2")
        b.ue(c.max_refs)
        b.u(1, 0)
        b.ue(self.mbw - 1)
        b.ue(self.mbh - 1)
        b.u(1, 1)  # frame_mbs_only
        b.u(1, int(c.direct_8x8_inference))
        crop = any(c.crop)
        b.u(1, int(crop))
        if crop:
            for v in c.crop:
                b.ue(v // 2)
            self.tools.add("cropping")
        vui = c.num_reorder_frames is not None or c.colour is not None
        b.u(1, int(vui))
        if vui:
            b.u(1, 0)  # aspect ratio
            b.u(1, 0)  # overscan
            b.u(1, int(c.colour is not None))  # video signal type
            if c.colour is not None:
                b.u(3, 5), b.u(1, c.colour[0]), b.u(1, 1)
                for v in c.colour[1:]:
                    b.u(8, v)
                self.tools.add("vui_colour")
            b.u(1, 0)  # chroma location
            b.u(1, 1)  # timing
            b.u(32, 1), b.u(32, 2 * c.fps), b.u(1, 1)
            b.u(1, 0), b.u(1, 0)  # HRD
            b.u(1, 0)  # pic_struct_present
            b.u(1, int(c.num_reorder_frames is not None))  # bitstream_restriction
            if c.num_reorder_frames is not None:
                b.u(1, 1)
                b.ue(0), b.ue(0), b.ue(16), b.ue(16)
                b.ue(c.num_reorder_frames)
                b.ue(c.max_refs)
                self.tools.add("vui_num_reorder_frames")
        b.trailing()
        return nal(7, 3, b.bytes())

    def write_pps(self) -> bytes:
        c = self.cfg
        b = Bits()
        b.ue(0), b.ue(0)
        b.u(1, int(c.cabac))
        b.u(1, 0)
        b.ue(0)  # one slice group
        b.ue(0), b.ue(0)  # num_ref_idx defaults: overridden in every slice
        b.u(1, int(c.weighted_pred))
        b.u(2, c.weighted_bipred_idc)
        self.init_qp = 26
        b.se(0)
        b.se(0)
        self.cqp_offset = [int(self.rng.integers(-3, 4)), 0]
        b.se(self.cqp_offset[0])
        b.u(1, 1)  # deblocking_filter_control_present
        b.u(1, int(c.constrained_intra))
        b.u(1, 0)
        if c.constrained_intra:
            self.tools.add("constrained_intra_pred")
        if c.profile == 100:
            b.u(1, int(c.transform_8x8))
            b.u(1, int(c.scaling_pps))
            if c.scaling_pps:
                self._scaling_lists(b, 6 + 2 * c.transform_8x8, True)
            self.cqp_offset[1] = int(self.rng.integers(-3, 4))
            b.se(self.cqp_offset[1])
            if self.cqp_offset[1] != self.cqp_offset[0]:
                self.tools.add("second_chroma_qp_offset")
        else:
            self.cqp_offset[1] = self.cqp_offset[0]
        b.trailing()
        if c.weighted_pred:
            self.tools.add("weighted_explicit_p")
        if c.weighted_bipred_idc == 1:
            self.tools.add("weighted_explicit_b")
        if c.weighted_bipred_idc == 2:
            self.tools.add("weighted_implicit_b")
        if c.transform_8x8:
            self.tools.add("transform_8x8_mode")
        return nal(8, 3, b.bytes())

    # ------------------------------------------------------ pictures and lists

    def max_frame_num(self):
        return 1 << self.cfg.log2_max_frame_num

    def ref_lists(self, kind: str, cur: Pic):
        shorts = [p for p in self.dpb if p.short]
        longs = sorted([p for p in self.dpb if p.long], key=lambda p: p.long_idx)
        if kind == "P":
            l0 = sorted(shorts, key=lambda p: -p.wrap) + longs
            return [l0, []]
        before = sorted([p for p in shorts if p.poc < cur.poc], key=lambda p: -p.poc)
        after = sorted([p for p in shorts if p.poc > cur.poc], key=lambda p: p.poc)
        l0 = before + after + longs
        l1 = after + before + longs
        if len(l1) > 1 and l0 == l1:
            l1[0], l1[1] = l1[1], l1[0]
        return [l0, l1]

    def mmco_commands(self, cur: Pic, ops: list) -> list:
        """The memory_management_control_operations of `ops` for a non-IDR
        reference picture, from the references before its marking."""
        by_disp = {p.disp: p for p in self.dpb if p.period == cur.period}
        codes = {"unmark_long": 2, "max_long": 4, "current_long": 6}
        cmds = []
        for op in ops:
            if op[0] in ("unmark", "to_long"):  # by picNumX = CurrPicNum - (difference + 1)
                cmds.append((1 if op[0] == "unmark" else 3, cur.frame_num - by_disp[op[1]].wrap - 1, *op[2:]))
            else:
                cmds.append((codes[op[0]], op[1]))
        return cmds

    def mark(self, cur: Pic, idr: bool, ops: list) -> None:
        """Marks reference picture `cur` after its decoding (8.2.5)."""
        if idr:
            self.dpb = [cur]
            if ("idr_long",) in ops:
                cur.long, cur.long_idx, self.max_long = True, 0, 0
                self.tools.add("long_term_refs")
            else:
                cur.short, self.max_long = True, -1
            return

        def unmark_long(keep):
            for q in self.dpb:
                if q.long and not keep(q.long_idx):
                    q.long = False

        by_disp = {p.disp: p for p in self.dpb if p.period == cur.period}
        for op in ops:
            if op[0] == "unmark":
                by_disp[op[1]].short = False
            elif op[0] == "to_long":
                unmark_long(lambda idx: idx != op[2])
                p = by_disp[op[1]]
                p.short, p.long, p.long_idx = False, True, op[2]
                self.tools.add("long_term_refs")
            elif op[0] == "unmark_long":
                unmark_long(lambda idx: idx != op[1])
            elif op[0] == "max_long":
                self.max_long = op[1] - 1
                unmark_long(lambda idx: idx <= self.max_long)
            elif op[0] == "current_long":
                unmark_long(lambda idx: idx != op[1])
                cur.long, cur.long_idx = True, op[1]
                self.tools.add("long_term_refs")
        if ops:
            self.tools.add("mmco")
        elif sum(1 for p in self.dpb if p.short or p.long) >= max(self.cfg.max_refs, 1):  # the sliding window
            min((p for p in self.dpb if p.short), key=lambda p: p.wrap).short = False
        cur.short = not cur.long
        self.dpb = [p for p in self.dpb if p.short or p.long] + [cur]
        assert len(self.dpb) <= self.cfg.max_refs, "too many references"

    def modification(self, l: int, init: list, count: int, cur_fn: int):
        """Random ref_pic_list_modification commands and the list they make."""
        cands = init[:]
        if not cands or self.rng.random() < 0.4:
            return [], init[:count]
        order = list(self.rng.permutation(len(cands)))[: int(self.rng.integers(1, min(len(cands), count) + 1))]
        cmds, lst, pred = [], init[:], cur_fn  # pred: picNumLXPred, before wrapping
        maxn = self.max_frame_num()
        for idx, k in enumerate(order):
            p = cands[k]
            if p.long:
                cmds.append((2, p.long_idx))
            else:
                no_wrap = p.wrap + maxn if p.wrap < 0 else p.wrap
                if no_wrap == pred:
                    return [], init[:count]  # a zero difference cannot be coded: leave the list as it is
                cmds.append((0, pred - no_wrap - 1) if no_wrap < pred else (1, no_wrap - pred - 1))
                pred = no_wrap
            lst = lst[:idx] + [p] + [q for q in lst[idx:] if q is not p]
        self.tools.add("ref_list_modification")
        return cmds, lst[:count]

    # ------------------------------------------------------ the whole stream

    def run(self) -> None:
        c = self.cfg
        self.sps, self.pps = self.write_sps(), self.write_pps()
        period, last_ref_fn, base, seen = -1, 0, 0, 0
        self.display, self.idr = [], []
        for disp, kind, is_ref, ops in c.gop:
            idr = kind == "I" and disp == 0
            if idr:
                period += 1
                base = seen
                fn = 0
            else:
                fn = (last_ref_fn + 1) % self.max_frame_num()
            poc = 2 * disp
            cur = Pic(self.next_id, poc, fn, disp, period)
            self.next_id += 1
            self.frame_index = base + disp
            seen = max(seen, base + disp + 1)
            self.display.append(base + disp)
            self.idr.append(idr)
            for p in self.dpb:
                if p.short:
                    p.wrap = p.frame_num - self.max_frame_num() if p.frame_num > fn else p.frame_num
            self.tools.add({"I": "i_slices", "P": "p_slices", "B": "b_slices"}[kind])
            if kind == "B":
                if is_ref:
                    self.tools.add("b_reference")
            au = bytearray()
            if c.avc3 and idr:
                for unit in (self.sps, self.pps):
                    au += struct.pack(">I", len(unit)) + unit
            mmco = self.mmco_commands(cur, ops) if is_ref and not idr else []
            self.begin_picture(cur, kind)
            bounds = sorted(set([0] + [int(x) for x in self.rng.integers(1, self.mbw * self.mbh, c.slices - 1)]))
            for si, first in enumerate(bounds):
                last = bounds[si + 1] if si + 1 < len(bounds) else self.mbw * self.mbh
                unit = self.write_slice(cur, kind, idr, is_ref, fn, mmco, ops, first, last, si)
                au += struct.pack(">I", len(unit)) + unit
            if len(bounds) > 1:
                self.tools.add("several_slices")
            self.samples.append(bytes(au))
            if is_ref:
                self.mark(cur, idr, ops)
                last_ref_fn = fn

    # ------------------------------------------------------ slices

    def begin_picture(self, cur: Pic, kind: str) -> None:
        self.cur = cur
        self.mbs = [MbState() for _ in range(self.mbw * self.mbh)]
        cur.blk_ref = [[None] * 16 for _ in range(self.mbw * self.mbh)]
        cur.mb_intra = [False] * (self.mbw * self.mbh)
        cur.kind = kind
        self.pic_lists = None
        self.yuv = rgb_to_yuv420(self.frames[self.frame_index])

    def write_slice(self, cur, kind, idr, is_ref, fn, mmco, ops, first, last, slice_num) -> bytes:
        c = self.cfg
        rng = self.rng
        b = Bits()
        b.ue(first)
        stype = {"P": 0, "B": 1, "I": 2}[kind]
        b.ue(stype + 5 if rng.random() < 0.5 else stype)
        b.ue(0)
        b.u(c.log2_max_frame_num, fn)
        if idr:
            b.ue(cur.period % 2)
        if c.poc_type == 0:
            b.u(8, cur.poc % 256)
        elif c.poc_type == 1:
            b.se(0)  # delta_pic_order_cnt[0]
        # lists
        init = self.ref_lists(kind, cur) if kind != "I" else [[], []]
        num = [0, 0]
        lists = [[], []]
        mods = [[], []]
        if self.pic_lists is not None:
            # every slice of a picture gets the same lists: FFmpeg's temporal
            # direct reads the co-located picture's references through the
            # lists of its last slice
            num, lists, mods = self.pic_lists
        elif kind != "I":
            for l in range(2 if kind == "B" else 1):
                avail = len(init[l])
                assert avail, "a P or B slice needs a reference"
                n = avail if c.num_ref_active is None else min(c.num_ref_active, avail)
                if kind == "B" and l == 1:
                    n = min(n, 2)
                num[l] = n
                mods[l], lists[l] = ([], init[l][:n])
                if c.reorder_lists and not (kind == "B" and l == 1 and not c.direct_spatial):
                    mods[l], lists[l] = self.modification(l, init[l], n, fn)
            self.pic_lists = (num, lists, mods)
        if kind == "B":
            b.u(1, int(c.direct_spatial))
        if kind != "I":
            b.u(1, 1)
            b.ue(num[0] - 1)
            if kind == "B":
                b.ue(num[1] - 1)
            for l in range(2 if kind == "B" else 1):
                b.u(1, int(bool(mods[l])))
                if mods[l]:
                    for cmd in mods[l]:
                        b.ue(cmd[0])
                        b.ue(cmd[1])
                    b.ue(3)
        self.lists, self.num_ref = lists, num
        explicit = (c.weighted_pred and kind == "P") or (c.weighted_bipred_idc == 1 and kind == "B")
        if explicit:
            ld, cd = int(rng.integers(0, 7)), int(rng.integers(0, 7))
            b.ue(ld), b.ue(cd)
            # in B slices every w0 + w1 must lie in [-128, 128] (7.4.3.2): no weight above 64
            top = 64 if kind == "B" else 127

            def weight(denom):
                return int(np.clip((1 << denom) + rng.integers(-(1 << denom) // 3 - 1, (1 << denom) // 3 + 2), -64, top))

            for l in range(2 if kind == "B" else 1):
                for _ in range(num[l]):
                    on = rng.random() < 0.7
                    b.u(1, int(on))
                    if on:
                        b.se(weight(ld))
                        b.se(int(rng.integers(-12, 13)))
                    on = rng.random() < 0.5
                    b.u(1, int(on))
                    if on:
                        for _ in range(2):
                            b.se(weight(cd))
                            b.se(int(rng.integers(-10, 11)))
        if is_ref:
            if idr:
                b.u(1, 0)
                b.u(1, int(("idr_long",) in ops))
            else:
                b.u(1, int(bool(mmco)))
                for cmd in mmco:
                    b.ue(cmd[0])
                    for v in cmd[1:]:
                        b.ue(v)
                if mmco:
                    b.ue(0)
        if c.cabac and kind != "I":
            idc = int(rng.integers(0, 3))
            b.ue(idc)
            self.tools.add(f"cabac_init_idc_{idc}")
        qp = int(rng.integers(0, 8)) if rng.random() < 0.15 else int(rng.integers(16, 35))
        b.se(qp - self.init_qp)
        dis = int(rng.choice(c.deblock_idc))
        b.ue(dis)
        if dis != 1:
            b.se(int(rng.integers(-3, 4)))
            b.se(int(rng.integers(-3, 4)))
        self.tools.add(f"deblock_idc_{dis}")
        # slice data
        self.slice_num = slice_num
        self.kind, self.qp, self.prev_dqp = kind, qp, False
        if c.cabac:
            while len(b.bits) % 8:  # cabac_alignment_one_bit
                b.bits.append(1)
            self.cabac = Cabac(b)
            self.cabac.init_contexts(0 if kind == "I" else 1 + idc, qp)
        self.b = b
        skip_run = 0
        for addr in range(first, last):
            self.begin_mb(addr)
            skip = kind != "I" and rng.random() < 0.18 and not (idr and kind == "I")
            if kind == "B" and skip and not self.direct_ok():
                skip = False
            if c.cabac:
                if kind != "I":
                    self.put_skip_flag(int(skip))
                if skip:
                    self.skip_mb()
                else:
                    self.write_mb(idr)
                self.cabac.terminate(int(addr == last - 1))
            else:
                if skip:
                    skip_run += 1
                    self.skip_mb()
                    continue
                if kind != "I":
                    b.ue(skip_run)
                    skip_run = 0
                self.write_mb(idr)
        if not c.cabac:
            if skip_run:
                b.ue(skip_run)
            b.trailing()
        else:
            b.align_zero()
        return nal(5 if idr else 1, (2 if kind != "B" else 1) if is_ref else 0, b.bytes())

    # ------------------------------------------------------ neighbours

    def begin_mb(self, addr):
        self.addr = addr
        self.mx, self.my = addr % self.mbw, addr // self.mbw
        m = MbState()
        m.slice = self.slice_num
        self.mbs[addr] = m
        self.m = m

    def nb(self, x, y):
        mx, my = self.mx, self.my
        if x < 0:
            mx, x = mx - 1, x + 16
        elif x >= 16:
            mx, x = mx + 1, x - 16
        if y < 0:
            my, y = my - 1, y + 16
        if mx < 0 or mx >= self.mbw or my < 0 or (my == self.my and mx > self.mx):
            return None, 0
        a = my * self.mbw + mx
        if a != self.addr and self.mbs[a].slice != self.slice_num:
            return None, 0
        return a, (y >> 2) * 4 + (x >> 2)

    def mb_at(self, dx, dy):
        mx, my = self.mx + dx, self.my + dy
        if mx < 0 or mx >= self.mbw or my < 0:
            return None
        a = my * self.mbw + mx
        return a if self.mbs[a].slice == self.slice_num else None

    def intra_avail(self, a):
        return a is not None and (not self.cfg.constrained_intra or self.mbs[a].intra)

    # ------------------------------------------------------ syntax elements

    def put_skip_flag(self, v):
        a, b_ = self.mb_at(-1, 0), self.mb_at(0, -1)
        inc = (a is not None and not self.mbs[a].skip) + (b_ is not None and not self.mbs[b_].skip)
        self.cabac.decision((24 if self.kind == "B" else 11) + inc, v)

    def put_i_type(self, itype, in_i):
        cb = self.cabac
        if in_i:
            a, b_ = self.mb_at(-1, 0), self.mb_at(0, -1)
            inc = (a is not None and not self.mbs[a].inxn) + (b_ is not None and not self.mbs[b_].inxn)
            cb.decision(3 + inc, int(itype != 0))
            base = 3
        else:
            base = 17 if self.kind == "P" else 32
            cb.decision(base, int(itype != 0))
        if itype == 0:
            return
        cb.terminate(int(itype == 25))
        if itype == 25:
            return
        t = itype - 1
        pred, chroma, luma = t % 4, (t // 4) % 3, t // 12
        cb.decision(base + (3 if in_i else 1), luma)
        cb.decision(base + (4 if in_i else 2), int(chroma > 0))
        if chroma:
            cb.decision(base + (5 if in_i else 2), int(chroma == 2))
        cb.decision(base + (6 if in_i else 3), pred >> 1)
        cb.decision(base + (7 if in_i else 3), pred & 1)

    def put_mb_type(self, kind_code):
        """kind_code: ("I", itype) or ("P", type 0-4) or ("B", type 0-22)."""
        k, t = kind_code
        if not self.cfg.cabac:
            if k == "I":
                self.b.ue(t + {"I": 0, "P": 5, "B": 23}[self.kind])
            else:
                self.b.ue(t)
            return
        cb = self.cabac
        if self.kind == "I":
            self.put_i_type(t, True)
            return
        if self.kind == "P":
            if k == "I":
                cb.decision(14, 1)
                self.put_i_type(t, False)
                return
            cb.decision(14, 0)
            bins = {0: (0, 0), 3: (0, 1), 1: (1, 1), 2: (1, 0)}[t]
            cb.decision(15, bins[0])
            cb.decision(16 if bins[0] == 0 else 17, bins[1])
            return
        a, b_ = self.mb_at(-1, 0), self.mb_at(0, -1)
        cond = lambda n: n is not None and not self.mbs[n].skip and not self.mbs[n].direct16  # noqa: E731
        bins = "111101" if k == "I" else B_BINS[t]
        for i, ch in enumerate(bins):
            if i == 0:
                ctx = 27 + cond(a) + cond(b_)
            elif i == 1:
                ctx = 27 + 3
            elif i == 2:
                ctx = 27 + (4 if bins[1] == "1" else 5)
            else:
                ctx = 27 + 5
            cb.decision(ctx, int(ch))
        if k == "I":
            self.put_i_type(t, False)

    def put_sub_type(self, t):
        if not self.cfg.cabac:
            self.b.ue(t)
            return
        cb = self.cabac
        if self.kind == "P":
            bins = {0: [(21, 1)], 1: [(21, 0), (22, 0)], 2: [(21, 0), (22, 1), (23, 1)], 3: [(21, 0), (22, 1), (23, 0)]}[t]
            for ctx, v in bins:
                cb.decision(ctx, v)
            return
        bins = B_SUB_BINS[t]
        ctxs = [36, 37, 38, 39, 39, 39]
        if bins[:2] == "10":
            ctxs = [36, 37, 39]
        elif bins[:4] == "1111":
            ctxs = [36, 37, 38, 39, 39]
        for ch, ctx in zip(bins, ctxs):
            cb.decision(ctx, int(ch))

    def ref_ctx_of(self, x, y, l):
        a, blk = self.nb(x, y)
        if a is None:
            return 0
        m = self.mbs[a]
        if m.skip or m.intra:
            return 0
        return int(m.ref_ctx[l][blk] > 0)

    def put_ref(self, x, y, l, v):
        n = self.num_ref[l]
        if not self.cfg.cabac:
            self.b.te(n - 1, v)
            return
        cb = self.cabac
        cb.decision(54 + self.ref_ctx_of(x - 1, y, l) + 2 * self.ref_ctx_of(x, y - 1, l), int(v > 0))
        if v > 0:
            cb.decision(54 + 4, int(v > 1))
            for k in range(2, v + 1):
                cb.decision(54 + 5, int(k < v))

    def mvd_abs_of(self, x, y, l, comp):
        a, blk = self.nb(x, y)
        if a is None:
            return 0
        return self.mbs[a].mvd[l][blk][comp]

    def put_mvd(self, x, y, l, comp, v):
        if not self.cfg.cabac:
            self.b.se(v)
            return
        cb = self.cabac
        base = 47 if comp else 40
        s = self.mvd_abs_of(x - 1, y, l, comp) + self.mvd_abs_of(x, y - 1, l, comp)
        inc = 0 if s < 3 else 1 if s <= 32 else 2
        a = abs(v)
        cb.decision(base + inc, int(a > 0))
        if a == 0:
            return
        incs = [3, 4, 5, 6, 6, 6, 6, 6]
        for k in range(1, min(a, 9)):
            cb.decision(base + incs[k - 1], 1)
        if a < 9:
            cb.decision(base + incs[a - 1], 0)
        else:
            cb.egk(a - 9, 3)
        cb.bypass(int(v < 0))

    def put_cbp(self, cbp, intra):
        if not self.cfg.cabac:
            table = T["kCbpIntra"] if intra else T["kCbpInter"]
            self.b.ue(table.index(cbp))
            return
        cb = self.cabac
        a, b_ = self.mb_at(-1, 0), self.mb_at(0, -1)

        def luma_bits(n):
            if n is None or self.mbs[n].pcm:
                return 0xF
            return 0 if self.mbs[n].skip else self.mbs[n].cbp & 0xF

        def chroma_of(n):
            if n is None:
                return 0
            m = self.mbs[n]
            return 2 if m.pcm else 0 if m.skip else m.cbp >> 4

        la, lb = luma_bits(a), luma_bits(b_)
        for i in range(4):
            x, y = i & 1, i >> 1
            left = (cbp >> (i - 1)) & 1 if x else (la >> (i + 1)) & 1
            top = (cbp >> (i - 2)) & 1 if y else (lb >> (i + 2)) & 1
            cb.decision(73 + (1 - left) + 2 * (1 - top), (cbp >> i) & 1)
        ca, cc = chroma_of(a), chroma_of(b_)
        ch = cbp >> 4
        cb.decision(77 + (ca > 0) + 2 * (cc > 0), int(ch > 0))
        if ch:
            cb.decision(77 + 4 + (ca == 2) + 2 * (cc == 2), int(ch == 2))

    def put_qp_delta(self, d):
        if not self.cfg.cabac:
            self.b.se(d)
            return
        k = 2 * d - 1 if d > 0 else -2 * d
        cb = self.cabac
        cb.decision(60 + int(self.prev_dqp), int(k > 0))
        if k > 0:
            cb.decision(60 + 2, int(k > 1))
            for i in range(2, k + 1):
                cb.decision(60 + 3, int(i < k))

    def put_intra_mode(self, pred, mode):
        if self.cfg.cabac:
            cb = self.cabac
            cb.decision(68, int(mode == pred))
            if mode != pred:
                rem = mode if mode < pred else mode - 1
                for k in range(3):
                    cb.decision(69, (rem >> k) & 1)
        else:
            self.b.u(1, int(mode == pred))
            if mode != pred:
                self.b.u(3, mode if mode < pred else mode - 1)

    def put_chroma_mode(self, mode):
        if not self.cfg.cabac:
            self.b.ue(mode)
            return
        a, b_ = self.mb_at(-1, 0), self.mb_at(0, -1)

        def cond(n):
            return n is not None and self.mbs[n].intra and not self.mbs[n].pcm and self.mbs[n].chroma_mode != 0

        cb = self.cabac
        cb.decision(64 + cond(a) + cond(b_), int(mode > 0))
        if mode > 0:
            cb.decision(64 + 3, int(mode > 1))
            if mode > 1:
                cb.decision(64 + 3, int(mode > 2))

    def put_t8x8(self, v):
        if not self.cfg.cabac:
            self.b.u(1, int(v))
            if v:
                self.tools.add("transform_8x8")
            return
        a, b_ = self.mb_at(-1, 0), self.mb_at(0, -1)
        inc = (a is not None and self.mbs[a].t8x8) + (b_ is not None and self.mbs[b_].t8x8)
        self.cabac.decision(399 + inc, int(v))
        if v:
            self.tools.add("transform_8x8")

    # ------------------------------------------------------ residual blocks

    def nz_of(self, x, y):
        a, blk = self.nb(x, y)
        if a is None:
            return -1
        m = self.mbs[a]
        return 16 if m.pcm else m.nz[blk]

    def nzc_of(self, c, x, y):
        dx = -1 if x < 0 else 0
        dy = -1 if y < 0 else 0
        x, y = x % 2, y % 2
        a = self.addr if (dx, dy) == (0, 0) else self.mb_at(dx, dy)
        if a is None:
            return -1
        m = self.mbs[a]
        return 16 if m.pcm else m.nzc[c][y * 2 + x]

    @staticmethod
    def nc_from(na, nb):
        if na >= 0 and nb >= 0:
            return (na + nb + 1) >> 1
        return na if na >= 0 else nb if nb >= 0 else 0

    def cavlc_block(self, nc, coeffs, maxn):
        """coeffs: the block's levels by scanning position (len maxn). Returns TotalCoeff."""
        b = self.b
        nzpos = [i for i in range(maxn) if coeffs[i]]
        total = len(nzpos)
        levels = [coeffs[i] for i in reversed(nzpos)]  # highest frequency first
        ones = 0
        for v in levels:
            if abs(v) == 1 and ones < 3:
                ones += 1
            else:
                break
        if nc == -1:
            b.u(T["kChromaDcTokenLen"][4 * total + ones], T["kChromaDcTokenBits"][4 * total + ones])
        elif nc >= 8:
            b.u(6, 3 if total == 0 else ((total - 1) << 2 | ones))
        else:
            t = 0 if nc < 2 else 1 if nc < 4 else 2
            b.u(T["kTokenLen"][t][4 * total + ones], T["kTokenBits"][t][4 * total + ones])
        if not total:
            return 0
        suffix_len = 1 if total > 10 and ones < 3 else 0
        for i, v in enumerate(levels):
            if i < ones:
                b.u(1, int(v < 0))
                continue
            code = 2 * v - 2 if v > 0 else -2 * v - 1
            if i == ones and ones < 3:
                code -= 2
            if suffix_len == 0:
                if code < 14:
                    prefix, size, suffix = code, 0, 0
                elif code < 30:
                    prefix, size, suffix = 14, 4, code - 14
                else:
                    prefix, size, suffix = 15, 12, code - 30
            elif code < (15 << suffix_len):
                prefix, size, suffix = code >> suffix_len, suffix_len, code & ((1 << suffix_len) - 1)
            else:
                prefix, size, suffix = 15, 12, code - (15 << suffix_len)
            assert suffix < (1 << size) or size == 0, "a level too large for the writer"
            b.u(prefix + 1, 1)
            if size:
                b.u(size, suffix)
            if suffix_len == 0:
                suffix_len = 1
            if abs(v) > (3 << (suffix_len - 1)) and suffix_len < 6:
                suffix_len += 1
        zeros = (nzpos[-1] + 1) - total
        if total < maxn:
            if nc == -1:
                b.u(T["kChromaDcZerosLen"][total - 1][zeros], T["kChromaDcZerosBits"][total - 1][zeros])
            else:
                b.u(T["kTotalZerosLen"][total - 1][zeros], T["kTotalZerosBits"][total - 1][zeros])
        left = zeros
        pos = list(reversed(nzpos))
        for i in range(total - 1):
            if left <= 0:
                break
            run = pos[i] - pos[i + 1] - 1
            t = min(left, 7) - 1
            b.u(T["kRunLen"][t][run], T["kRunBits"][t][run])
            left -= run
        return total

    def cbf_cond(self, n, v):
        if n is None:
            return int(self.m.intra)
        if self.mbs[n].pcm:
            return 1
        return int(v)

    def cbf_inc(self, cat, idx):
        va = vb = 0
        if cat in (0, 3):
            ma, mb_ = self.mb_at(-1, 0), self.mb_at(0, -1)
            k = 0 if cat == 0 else 1 + idx
            if ma is not None:
                va = self.mbs[ma].cbf_dc[k] and (cat == 3 or self.mbs[ma].i16)
            if mb_ is not None:
                vb = self.mbs[mb_].cbf_dc[k] and (cat == 3 or self.mbs[mb_].i16)
        elif cat in (1, 2):
            x, y = (idx & 3) * 4, (idx >> 2) * 4
            ma, ba = self.nb(x - 1, y)
            mb_, bb = self.nb(x, y - 1)
            if ma is not None:
                va = self.mbs[ma].cbf_luma[ba]
            if mb_ is not None:
                vb = self.mbs[mb_].cbf_luma[bb]
        else:
            c, blk = idx >> 2, idx & 3
            x, y = blk & 1, blk >> 1
            if x:
                ma, va = self.addr, self.m.cbf_ac[c][blk - 1]
            else:
                ma = self.mb_at(-1, 0)
                if ma is not None:
                    va = self.mbs[ma].cbf_ac[c][blk + 1]
            if y:
                mb_, vb = self.addr, self.m.cbf_ac[c][blk - 2]
            else:
                mb_ = self.mb_at(0, -1)
                if mb_ is not None:
                    vb = self.mbs[mb_].cbf_ac[c][blk + 2]
        return self.cbf_cond(ma, va) + 2 * self.cbf_cond(mb_, vb)

    def cabac_block(self, cat, idx, coeffs, maxn):
        cb = self.cabac
        nzpos = [i for i in range(maxn) if coeffs[i]]
        if cat != 5:
            cb.decision(85 + [0, 4, 8, 12, 16][cat] + self.cbf_inc(cat, idx), int(bool(nzpos)))
            if not nzpos:
                return 0
        assert nzpos, "an 8x8 block with cbp set needs a coefficient"
        so = [0, 15, 29, 44, 47]
        sig_base = 402 if cat == 5 else 105 + so[min(cat, 4)]
        last_base = 417 if cat == 5 else 166 + so[min(cat, 4)]
        abs_base = 426 if cat == 5 else 227 + [0, 10, 20, 30, 39][min(cat, 4)]
        last = nzpos[-1]
        for i in range(maxn - 1):
            inc = T["kSig8"][i] if cat == 5 else min(i, 2) if cat == 3 else i
            sig = int(coeffs[i] != 0)
            cb.decision(sig_base + inc, sig)
            if sig:
                linc = T["kLast8"][i] if cat == 5 else min(i, 2) if cat == 3 else i
                cb.decision(last_base + linc, int(i == last))
                if i == last:
                    break
        eq1 = gt1 = 0
        for i in reversed(nzpos):
            a = abs(coeffs[i])
            cb.decision(abs_base + (0 if gt1 else min(4, 1 + eq1)), int(a > 1))
            if a > 1:
                ctx = abs_base + 5 + min(4 - (cat == 3), gt1)
                prefix = min(a - 1, 14)
                for k in range(1, prefix):
                    cb.decision(ctx, 1)
                if prefix < 14:
                    cb.decision(ctx, 0)
                else:
                    cb.egk(a - 1 - 14, 0)
            if a == 1:
                eq1 += 1
            else:
                gt1 += 1
            cb.bypass(int(coeffs[i] < 0))
        return len(nzpos)

    def random_block(self, n, start, dense=False, limit=3):
        """Levels by scanning position: a few small ones, low frequencies
        first, none above `limit` (which keeps every dequantised coefficient
        and transform value in the 16 bits the standard allows)."""
        rng = self.rng
        out = [0] * n
        count = int(rng.integers(1, 4 if not dense else 9))
        for _ in range(count):
            pos = start + int(min(rng.exponential(2.5 if n <= 16 else 6), n - 1 - start))
            big = limit >= 15 and rng.random() < 0.2
            mag = int(rng.integers(15, limit + 1)) if big else min(int(rng.choice([1, 1, 1, 2, 2, 3])), limit)
            if big:
                self.tools.add("large_levels")
            out[pos] = mag * int(rng.choice([-1, 1]))
        return out

    @staticmethod
    def level_limit(qp, gain):
        """The largest level whose dequantised value stays near 3000 at `qp`,
        `gain` being the largest scale a level takes before the 2^(qp/6) step."""
        return max(1, min(40, int(3000 / (gain * 2 ** (qp // 6)))))

    # ------------------------------------------------------ macroblocks

    def skip_mb(self):
        m = self.m
        m.skip = True
        self.prev_dqp = False
        if self.kind == "P":
            self.cur.blk_ref[self.addr] = [self.lists[0][0].id] * 16
            self.tools.add("p_skip")
        else:
            m.direct16 = True
            self.tools.add("b_skip")
            self.tools.add("direct_spatial" if self.cfg.direct_spatial else "direct_temporal")

    def direct_ok(self, quads=0xF):
        """Temporal direct needs each co-located block's reference in list 0."""
        if self.cfg.direct_spatial:
            return True
        col = self.lists[1][0]
        if col.kind == "B":
            return False  # the writer does not follow a B picture's direct references
        if col.mb_intra[self.addr]:
            return True
        ids = {p.id for p in self.lists[0]}
        for q in range(4):
            if not quads >> q & 1:
                continue
            blks = [(q >> 1) * 12 + (q & 1) * 3] if self.cfg.direct_8x8_inference else [
                ((q >> 1) * 2 + k // 2) * 4 + (q & 1) * 2 + k % 2 for k in range(4)]
            for blk in blks:
                r = col.blk_ref[self.addr][blk]
                if r is not None and r not in ids:
                    return False
        return True

    def pred_mode(self, x, y):
        def mode(n):
            a, blk = n
            if a is None:
                return -1
            k = self.mbs[a]
            if not k.intra and self.cfg.constrained_intra:
                return -1
            return k.ipred[blk] if k.inxn else 2

        ma, mb_ = mode(self.nb(x - 1, y)), mode(self.nb(x, y - 1))
        return 2 if ma < 0 or mb_ < 0 else min(ma, mb_)

    def edges(self, x, y):
        lm, tm, tl = self.mb_at(-1, 0), self.mb_at(0, -1), self.mb_at(-1, -1)
        left = x > 0 or self.intra_avail(lm)
        top = y > 0 or self.intra_avail(tm)
        corner = (x > 0 and y > 0) or (x == 0 and y > 0 and self.intra_avail(lm)) or \
                 (y == 0 and x > 0 and self.intra_avail(tm)) or (x == 0 and y == 0 and self.intra_avail(tl))
        return top, left, corner

    def pick_mode(self, x, y):
        top, left, corner = self.edges(x, y)
        modes = [2] + ([0, 3, 7] if top else []) + ([1, 8] if left else []) + ([4, 5, 6] if top and left and corner else [])
        return int(self.rng.choice(modes))

    def write_mb(self, idr):
        c, rng, m = self.cfg, self.rng, self.m
        first_idr = idr and self.cur.period == 0
        intra_share = 1.0 if self.kind == "I" else 0.12
        if rng.random() < intra_share:
            pcm = rng.random() < (c.pcm_share if first_idr else c.pcm_later)
            if pcm:
                return self.write_pcm()
            return self.write_intra()
        return self.write_inter()

    def write_pcm(self):
        m = self.m
        m.intra = m.pcm = True
        self.cur.mb_intra[self.addr] = True
        m.cbp = 0x2F
        m.nz = [16] * 16
        m.cbf_luma = [True] * 16
        self.put_mb_type(("I", 25))
        self.tools.add("i_pcm")
        b = self.b
        b.align_zero()
        y, u, v = self.yuv
        for plane, n in ((y, 16), (u, 8), (v, 8)):
            blk = plane[self.my * n: self.my * n + n, self.mx * n: self.mx * n + n]
            for val in blk.reshape(-1):
                b.u(8, int(val))
        if self.cfg.cabac:
            self.cabac.start()
        self.prev_dqp = False

    def write_intra(self):
        c, rng, m = self.cfg, self.rng, self.m
        m.intra = True
        self.cur.mb_intra[self.addr] = True
        choice = rng.random()
        if choice < 0.35:
            # Intra_16x16
            top, left, corner = self.edges(0, 0)
            modes = [2] + ([0] if top else []) + ([1] if left else []) + ([3] if top and left and corner else [])
            pred = int(rng.choice(modes))
            chroma = int(rng.integers(0, 3))
            luma = int(rng.random() < 0.5)
            m.i16 = True
            m.cbp = chroma << 4 | (15 if luma else 0)
            self.put_mb_type(("I", 1 + pred + 4 * chroma + 12 * luma))
            self.tools.add("i16x16")
        else:
            m.inxn = True
            t8 = c.transform_8x8 and rng.random() < 0.5
            self.put_mb_type(("I", 0))
            if c.transform_8x8:
                self.put_t8x8(t8)
            m.t8x8 = t8
            if t8:
                for q in range(4):
                    x, y = (q & 1) * 8, (q >> 1) * 8
                    mode = self.pick_mode(x, y)
                    self.put_intra_mode(self.pred_mode(x, y), mode)
                    for k in range(4):
                        m.ipred[((y >> 2) + (k >> 1)) * 4 + (x >> 2) + (k & 1)] = mode
                self.tools.add("i8x8")
            else:
                for i in range(16):
                    r = BLK_RASTER[i]
                    x, y = (r & 3) * 4, (r >> 2) * 4
                    mode = self.pick_mode(x, y)
                    self.put_intra_mode(self.pred_mode(x, y), mode)
                    m.ipred[r] = mode
                self.tools.add("i4x4")
            m.cbp = int(rng.integers(0, 48))
        top, left, corner = self.edges(0, 0)
        cmodes = [0] + ([2] if top else []) + ([1] if left else []) + ([3] if top and left and corner else [])
        m.chroma_mode = int(rng.choice(cmodes))
        self.put_chroma_mode(m.chroma_mode)
        if not m.i16:
            self.put_cbp(m.cbp, True)
        self.write_residual()

    def write_inter(self):
        c, rng, m = self.cfg, self.rng, self.m
        kind = self.kind
        small = False
        refs_used = [None] * 16  # list 0 picture id per 4x4 (for temporal direct later)
        if kind == "P":
            t = int(rng.choice([0, 0, 1, 2, 3]))
            ref0 = t == 3 and not c.cabac and self.num_ref[0] > 1 and rng.random() < 0.3
            self.put_mb_type(("P", 4 if ref0 else t))
            parts = P_PARTS[t]
        else:
            options = list(range(0, 23))
            t = int(rng.choice(options))
            if t == 0 and not self.direct_ok():
                t = 1
            self.put_mb_type(("B", t))
            parts = B_PARTS[t]
            ref0 = False
        if kind == "B" and t == 0:
            m.direct16 = True
            small = not c.direct_8x8_inference
            self.tools.add("b_direct_16x16")
            self.tools.add("direct_spatial" if c.direct_spatial else "direct_temporal")
        elif parts[0] == 4:
            subs = []
            for i in range(4):
                if kind == "P":
                    s = int(rng.integers(0, 4))
                else:
                    s = int(rng.integers(0, 13))
                    if s == 0 and not self.direct_ok(1 << i):
                        s = 1
                subs.append(s)
                self.put_sub_type(s)
            table = P_SUB if kind == "P" else B_SUB
            direct_quads = sum(1 << i for i in range(4) if kind == "B" and subs[i] == 0)
            if direct_quads:
                self.tools.add("b_direct_8x8")
                self.tools.add("direct_spatial" if c.direct_spatial else "direct_temporal")
            for i in range(4):
                if kind == "B" and subs[i] == 0:
                    if not c.direct_8x8_inference:
                        small = True
                elif table[subs[i]][0] > 1:
                    small = True
                    self.tools.add("sub_8x8_partitions")
            refs = [[0] * 4, [0] * 4]
            for l in range(2):
                for i in range(4):
                    if direct_quads >> i & 1:
                        continue
                    si = table[subs[i]]
                    if not si[3] >> l & 1:
                        continue
                    x, y = (i & 1) * 8, (i >> 1) * 8
                    ref = 0
                    if self.num_ref[l] > 1 and not ref0:
                        ref = int(rng.integers(0, self.num_ref[l]))
                        self.put_ref(x, y, l, ref)
                    refs[l][i] = ref
                    for k in range(4):
                        m.ref_ctx[l][((y >> 2) + (k >> 1)) * 4 + (x >> 2) + (k & 1)] = ref
                    if l == 0:
                        for k in range(4):
                            refs_used[((y >> 2) + (k >> 1)) * 4 + (x >> 2) + (k & 1)] = self.lists[0][ref].id
            for l in range(2):
                for i in range(4):
                    if direct_quads >> i & 1:
                        continue
                    si = table[subs[i]]
                    if not si[3] >> l & 1:
                        continue
                    x0, y0 = (i & 1) * 2, (i >> 1) * 2
                    for p in range(si[0]):
                        px = x0 + (0 if si[1] == 2 else (p & 1 if si[0] == 4 else p))
                        py = y0 + (0 if si[2] == 2 else (p >> 1 if si[0] == 4 else p))
                        self.write_mvd_pair(px, py, si[1], si[2], l)
        else:
            count, shape, pred = parts
            refs = [[0, 0], [0, 0]]
            for l in range(2):
                for p in range(count):
                    if not pred[p] >> l & 1:
                        continue
                    x, y = (8 * p if shape == 2 else 0), (8 * p if shape == 1 else 0)
                    w, h = (2 if shape == 2 else 4), (2 if shape == 1 else 4)
                    ref = 0
                    if self.num_ref[l] > 1:
                        ref = int(rng.integers(0, self.num_ref[l]))
                        self.put_ref(x, y, l, ref)
                    refs[l][p] = ref
                    for yy in range(y // 4, y // 4 + h):
                        for xx in range(x // 4, x // 4 + w):
                            m.ref_ctx[l][yy * 4 + xx] = ref
                            if l == 0:
                                refs_used[yy * 4 + xx] = self.lists[0][ref].id
            for l in range(2):
                for p in range(count):
                    if not pred[p] >> l & 1:
                        continue
                    x, y = (2 * p if shape == 2 else 0), (2 * p if shape == 1 else 0)
                    w, h = (2 if shape == 2 else 4), (2 if shape == 1 else 4)
                    self.write_mvd_pair(x, y, w, h, l)
            if shape:
                self.tools.add("partitions_16x8_8x16")
        if kind == "P":
            self.cur.blk_ref[self.addr] = refs_used
        m.cbp = int(rng.integers(0, 48))
        self.put_cbp(m.cbp, False)
        if (m.cbp & 15) and c.transform_8x8 and not small:
            m.t8x8 = bool(rng.random() < 0.5)
            self.put_t8x8(m.t8x8)
        self.write_residual()

    def write_mvd_pair(self, px, py, w, h, l):
        rng, m = self.rng, self.m
        d = []
        for comp in range(2):
            if rng.random() < self.cfg.mvd_large:
                v = int(rng.integers(-256, 257))
                self.tools.add("large_vectors")
            else:
                v = int(rng.integers(-12, 13))
            d.append(v)
            self.put_mvd(px * 4, py * 4, l, comp, v)
        for yy in range(py, py + h):
            for xx in range(px, px + w):
                m.mvd[l][yy * 4 + xx] = [min(abs(d[0]), 64), min(abs(d[1]), 64)]

    def write_residual(self):
        c, rng, m = self.cfg, self.rng, self.m
        if not m.cbp and not m.i16:
            self.prev_dqp = False
            return
        d = int(rng.choice([0, 0, 0, 1, -1, 2, -3]))
        if not 0 <= self.qp + d <= 36:
            d = 0
        self.put_qp_delta(d)
        self.prev_dqp = d != 0
        self.qp += d
        if d:
            self.tools.add("mb_qp_delta")
        lim4, lim8 = self.level_limit(self.qp, 65.7), self.level_limit(self.qp, 38.1)
        qpc = min(self.qp + 3, 51)
        limc, limdc = self.level_limit(qpc, 65.7), max(1, self.level_limit(qpc, 32.9) // 4)
        if m.i16:
            blk = self.random_block(16, 0, limit=max(1, self.level_limit(self.qp, 16.5) // 3)) if rng.random() < 0.7 else [0] * 16
            if c.cabac:
                n = self.cabac_block(0, 0, blk, 16)
            else:
                n = self.cavlc_block(self.nc_from(self.nz_of(-1, 0), self.nz_of(0, -1)), blk, 16)
            m.cbf_dc[0] = n > 0
        for q in range(4):
            coded = m.cbp >> q & 1
            if m.t8x8:
                if not coded:
                    continue
                blk = self.random_block(64, 0, dense=True, limit=lim8)
                if c.cabac:
                    total = self.cabac_block(5, q, blk, 64)
                    for k in range(4):
                        m.nz[((q >> 1) * 2 + (k >> 1)) * 4 + (q & 1) * 2 + (k & 1)] = total
                else:
                    for k in range(4):
                        r = BLK_RASTER[4 * q + k]
                        part = [blk[4 * j + k] for j in range(16)]
                        x, y = (r & 3) * 4, (r >> 2) * 4
                        m.nz[r] = self.cavlc_block(self.nc_from(self.nz_of(x - 1, y), self.nz_of(x, y - 1)), part, 16)
                for k in range(4):
                    m.cbf_luma[((q >> 1) * 2 + (k >> 1)) * 4 + (q & 1) * 2 + (k & 1)] = True
                continue
            for k in range(4):
                r = BLK_RASTER[4 * q + k]
                if not coded:
                    continue
                x, y = (r & 3) * 4, (r >> 2) * 4
                if m.i16:
                    blk = [0] + self.random_block(15, 0, limit=lim4) if rng.random() < 0.6 else [0] * 16
                    ac = blk[1:]
                    if c.cabac:
                        n = self.cabac_block(1, r, ac, 15)
                    else:
                        n = self.cavlc_block(self.nc_from(self.nz_of(x - 1, y), self.nz_of(x, y - 1)), ac, 15)
                else:
                    blk = self.random_block(16, 0, limit=lim4) if rng.random() < 0.6 else [0] * 16
                    if c.cabac:
                        n = self.cabac_block(2, r, blk, 16)
                    else:
                        n = self.cavlc_block(self.nc_from(self.nz_of(x - 1, y), self.nz_of(x, y - 1)), blk, 16)
                m.nz[r] = n
                m.cbf_luma[r] = n > 0
        if m.cbp >> 4:
            for ch in range(2):
                blk = self.random_block(4, 0, limit=limdc) if rng.random() < 0.7 else [0] * 4
                if c.cabac:
                    n = self.cabac_block(3, ch, blk, 4)
                else:
                    n = self.cavlc_block(-1, blk, 4)
                m.cbf_dc[1 + ch] = n > 0
        if m.cbp >> 4 == 2:
            for ch in range(2):
                for k in range(4):
                    blk = self.random_block(15, 0, limit=limc) if rng.random() < 0.5 else [0] * 15
                    if c.cabac:
                        n = self.cabac_block(4, ch * 4 + k, blk, 15)
                    else:
                        x, y = k & 1, k >> 1
                        n = self.cavlc_block(self.nc_from(self.nzc_of(ch, x - 1, y), self.nzc_of(ch, x, y - 1)), blk, 15)
                    m.nzc[ch][k] = n
                    m.cbf_ac[ch][k] = n > 0


# ---------------------------------------------------------------- MP4


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags), *parts)


def mp4(samples: list, display: list, idr: list, width: int, height: int, sps: bytes, pps: bytes,
        profile: int, avc3: bool, fps: int, colr: tuple | None = None) -> bytes:
    """An MP4 of one H.264 track, laid out as FFmpeg's muxer lays out
    libx264's output (timescale 2^k * fps above 10000, one sample a chunk),
    with an nclx `colr` box (primaries, transfer, matrix, full range) in
    the sample entry where `colr` is given."""
    timescale = fps
    while timescale < 10000:
        timescale *= 2
    delta = timescale // fps
    n = len(samples)
    delay = max(max(i - d for i, d in enumerate(display)), 0)
    avcc = bytes([1, profile, 0, 30, 0xFF])
    if avc3:
        avcc += bytes([0xE0, 0])
    else:
        avcc += bytes([0xE1]) + struct.pack(">H", len(sps)) + sps + bytes([1]) + struct.pack(">H", len(pps)) + pps
    if profile == 100:
        avcc += bytes([0xFD, 0xF8, 0xF8, 0])
    entry = (bytes(6) + struct.pack(">H", 1) + bytes(16) + struct.pack(">HH", width, height) +
             struct.pack(">III", 0x480000, 0x480000, 0) + struct.pack(">H", 1) + bytes(32) + struct.pack(">Hh", 0x18, -1) +
             _box(b"avcC", avcc) +
             (_box(b"colr", b"nclx", struct.pack(">HHHB", *colr[:3], colr[3] << 7)) if colr else b""))
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), _box(b"avc3" if avc3 else b"avc1", entry))
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, delta))
    ctts_entries = [(display[i] + delay - i) * delta for i in range(n)]
    ctts = _full(b"ctts", 0, 0, struct.pack(">I", n), b"".join(struct.pack(">II", 1, o) for o in ctts_entries)) if delay else b""
    stss = _full(b"stss", 0, 0, struct.pack(">I", sum(idr)), b"".join(struct.pack(">I", i + 1) for i in range(n) if idr[i]))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n), b"".join(struct.pack(">I", len(s)) for s in samples))
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomiso2avc1mp41")

    def build(first_offset: int) -> bytes:
        offsets, at = [], first_offset
        for s in samples:
            offsets.append(at)
            at += len(s)
        stco = _full(b"stco", 0, 0, struct.pack(">I", n), b"".join(struct.pack(">I", o) for o in offsets))
        stbl = _box(b"stbl", stsd, stts, ctts, stss, stsc, stsz, stco)
        vmhd = _full(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1)))
        minf = _box(b"minf", vmhd, dinf, stbl)
        hdlr = _full(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\x00")
        duration = n * delta
        mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0))
        mdia = _box(b"mdia", mdhd, hdlr, minf)
        movie_ms = duration * 1000 // timescale
        elst = _full(b"elst", 0, 0, struct.pack(">IIiHH", 1, movie_ms, delay * delta, 1, 0))
        edts = _box(b"edts", elst)
        matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie_ms), bytes(8), struct.pack(">hhhH", 0, 0, 0, 0),
                     matrix, struct.pack(">II", width << 16, height << 16))
        trak = _box(b"trak", tkhd, edts, mdia)
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, movie_ms), struct.pack(">IH", 0x10000, 0x100),
                     bytes(10), matrix, bytes(24), struct.pack(">I", 2))
        return _box(b"moov", mvhd, trak)

    mdat_head = 8
    moov = build(0)
    moov = build(len(ftyp) + len(moov) + mdat_head)
    return ftyp + moov + _box(b"mdat", b"".join(samples))


def write_mp4(path: str, frames: np.ndarray, cfg: Config, seed: int) -> set:
    """Writes frames (display order, RGB uint8 at the coded size) as `cfg`
    lays out the stream; returns the tools it used."""
    assert frames.shape[1:3] == (cfg.height, cfg.width)
    s = Stream(frames, cfg, seed)
    s.run()
    data = mp4(s.samples, s.display, s.idr, cfg.width - cfg.crop[0] - cfg.crop[1], cfg.height - cfg.crop[2] - cfg.crop[3],
               s.sps, s.pps, cfg.profile, cfg.avc3, cfg.fps, cfg.colr)
    with open(path, "wb") as f:
        f.write(data)
    return s.tools

