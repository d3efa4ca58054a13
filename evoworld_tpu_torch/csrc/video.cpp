// MP4 video IO of the scoring CLI and the video export: an MP4 (ISO BMFF)
// reader, an MPEG-4 Part 2 Simple Profile decoder (ISO/IEC 14496-2), and an
// intra-only MPEG-4 Part 2 encoder with its MP4 writer. A plain C interface,
// loaded with ctypes by evoworld_tpu_torch/data/native_video.py and built at
// first use with g++ by ops/_build.py. No library is used: the H100 machine
// the port runs on has no video decoder (no FFmpeg, OpenCV or PyAV).
//
// The decoder takes what FFmpeg's default `mpeg4` encode holds (OpenCV's
// `mp4v` writer): I- and P-VOPs; intra DC prediction with the DC VLCs; the
// intra and inter TCOEF VLCs with their three escape modes, in zig-zag
// order; H.263 inverse quantisation with dquant; not-coded macroblocks; one
// half-pel vector a macroblock with median prediction, vop_fcode and
// unrestricted vectors over a reference extended past its edges; the rounding
// type of each P-VOP; any frame size. Its inverse DCT is FFmpeg's integer
// "simple" IDCT in that arithmetic (a row pass kept in 16 bits, then a
// column pass; 14-bit cosines), which the encoder that made the file also
// reconstructs its references with: a P-VOP predicted from another
// arithmetic's reference would drift from the file's frames until the next
// I-VOP. Frames are turned to RGB from 4:2:0 limited-range BT.601 in the
// arithmetic of FFmpeg's swscale conversion to BGR24, which OpenCV's
// VideoCapture asks for: each chroma sample serves its 2x2 luma samples,
// and the products are taken in 16-bit fixed point (`frame_to_rgb`).
//
// H.264 tracks (avc1, avc3) go to the decoder of h264.h. Every tool outside
// these sets is refused by name (the status codes below, one per reason of
// native_video.py's _REASONS): HEVC, VP9 and AV1 tracks, any other sample
// entry, an edit list that drops or repeats frames, a `colr` box OpenCV
// converts otherwise than BT.601 at limited range, B-VOPs and S-VOPs (low_delay 0, sprites, GMC),
// quarter-pel, interlace, data partitioning and reversible VLCs,
// non-rectangular shape, not-8-bit video, scalability, MPEG quantisation,
// AC prediction, four vectors a macroblock, resync markers, and truncated
// or corrupt files.
//
// The encoder writes I-VOPs only, at one quantiser (kEncodeQuant), with DC
// prediction and no AC prediction, and an MP4 of ftyp, mdat and a moov whose
// stsd/mp4v/esds carries the VOL; each frame is encoded on a pool of
// threads.

#include <algorithm>
#include <array>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <memory>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Status : int {
  kOk = 0,
  kUnreadable = 1,
  kNotMp4 = 2,
  kNoVideo = 3,
  kAvc = 4,
  kOtherCodec = 5,
  kBVop = 6,
  kSprite = 7,
  kQuarterPel = 8,
  kInterlaced = 9,
  kPartitioned = 10,
  kShape = 11,
  kNot8Bit = 12,
  kScalable = 13,
  kMpegQuant = 14,
  kAcPred = 15,
  kFourMv = 16,
  kResync = 17,
  kCorrupt = 18,
  kUnwritable = 19,
  kOtherTool = 20,
  kH264Interlaced = 21,
  kH264Chroma = 22,
  kH264BitDepth = 23,
  kH264SeparatePlanes = 24,
  kH264Profile = 25,
  kH264Bypass = 26,
  kH264Partitioned = 27,
  kH264SpSi = 28,
  kH264SliceGroups = 29,
  kH264Redundant = 30,
  kH264FrameGap = 31,
  kH264Svc = 32,
  kColour = 33,
  kH264Mmco5 = 34,
  kH264NoIdr = 35,
  kEditList = 36,
  kVp9 = 37,
  kAv1 = 38,
  kH264LeftCrop = 39,
};

struct Fail {
  int code;
};
[[noreturn]] void fail(int code) { throw Fail{code}; }

// The quantiser of every macroblock the encoder writes (H.263 quantisation:
// a step of 2 * 2 = 4 in the DCT domain, reconstructed at 4 |L| + 1).
constexpr int kEncodeQuant = 2;

// ---------------------------------------------------------------- bits

struct BitReader {
  const uint8_t* data;
  size_t nbytes;
  size_t pos = 0;  // in bits

  BitReader(const uint8_t* d, size_t n) : data(d), nbytes(n) {}
  uint32_t peek(int k) const {  // k <= 32; zeros past the end
    uint64_t w = 0;
    size_t byte = pos >> 3;
    if (byte + 8 <= nbytes) {
      std::memcpy(&w, data + byte, 8);
      w = __builtin_bswap64(w);
    } else {
      for (int i = 0; i < 8; ++i) w = (w << 8) | (byte + i < nbytes ? data[byte + i] : 0);
    }
    return k ? static_cast<uint32_t>((w << (pos & 7)) >> (64 - k)) : 0;
  }
  void skip(int k) {
    pos += k;
    if (pos > nbytes * 8) fail(kCorrupt);
  }
  uint32_t get(int k) {
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  bool bit() { return get(1) != 0; }
  void marker() { get(1); }  // marker bits are not checked, as FFmpeg's decoder does not
  size_t left() const { return nbytes * 8 - pos; }
};

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int n = 0;

  void put(uint32_t v, int k) {  // k <= 32
    if (!k) return;
    acc = (acc << k) | (v & (k == 32 ? 0xFFFFFFFFu : ((1u << k) - 1)));
    n += k;
    while (n >= 8) {
      out.push_back(static_cast<uint8_t>(acc >> (n - 8)));
      n -= 8;
    }
    acc &= (1ull << n) - 1;
  }
  // next_start_code(): a zero bit, then ones up to the byte boundary.
  void stuff() {
    put(0, 1);
    while (n) put(1, 1);
  }
  void start_code(uint8_t code) { put(0x000001u << 8 | code, 32); }
};

// ---------------------------------------------------------------- VLCs

// A prefix code read through one table of 2^bits entries.
struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;

  Vlc() = default;
  // codes[i] = {code, length}; symbol i. A length of 0 leaves the symbol out.
  Vlc(const uint16_t (*codes)[2], int n) {
    for (int i = 0; i < n; ++i) bits = std::max<int>(bits, codes[i][1]);
    sym.assign(size_t(1) << bits, -1);
    len.assign(size_t(1) << bits, 0);
    for (int i = 0; i < n; ++i) {
      int l = codes[i][1];
      if (!l) continue;
      size_t base = size_t(codes[i][0]) << (bits - l);
      for (size_t j = 0; j < (size_t(1) << (bits - l)); ++j) {
        sym[base + j] = static_cast<int16_t>(i);
        len[base + j] = static_cast<uint8_t>(l);
      }
    }
  }
  int read(BitReader& b) const {
    uint32_t v = b.peek(bits);
    if (!len[v]) fail(kCorrupt);
    b.skip(len[v]);
    return sym[v];
  }
};

// H.263 / ISO 14496-2 tables. MCBPC of I-VOPs: index = (dquant << 2) | cbpc;
// 8 is stuffing.
const uint16_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4}, {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// MCBPC of P-VOPs: index = (type << 2) | cbpc, type 0 inter, 1 intra,
// 2 inter + dquant, 3 intra + dquant, 4 inter 4MV, 5 stuffing (index 20),
// 6 inter 4MV + dquant.
const uint16_t kInterMcbpc[28][2] = {
    {1, 1}, {3, 4},  {2, 4},  {5, 6},  {3, 5}, {4, 8}, {3, 8}, {3, 7}, {3, 3},  {7, 7},
    {6, 7}, {5, 9},  {4, 6},  {4, 9},  {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7},  {5, 8},
    {1, 9}, {0, 0},  {0, 0},  {0, 0},  {2, 11}, {12, 13}, {14, 13}, {15, 13}};
// CBPY by its value for an intra macroblock (an inter one reads 15 - value).
const uint16_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                               {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// Motion vector differences by magnitude in half pels (a sign bit follows a
// nonzero one).
const uint16_t kMvd[33][2] = {{1, 1},  {1, 2},  {1, 3},  {1, 4},  {3, 6},  {5, 7},  {4, 7},  {3, 7},  {11, 9},
                              {10, 9}, {9, 9},  {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
                              {10, 10}, {9, 10}, {8, 10}, {7, 10}, {6, 10}, {5, 10}, {4, 10}, {7, 11}, {6, 11},
                              {5, 11}, {4, 11}, {3, 11}, {2, 11}, {3, 12}, {2, 12}};
// dct_dc_size of luminance and chrominance blocks, sizes 0..12.
const uint16_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                                {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint16_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6},
                                  {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// TCOEF codes (a sign bit follows each), in the order of their events:
// LAST = 0 then 1, by run, by level. Entry 102 is the escape.
const uint16_t kInterCodes[103][2] = {
    {2, 2},   {15, 4},  {21, 6},  {23, 7},  {31, 8},  {37, 9},  {36, 9},  {33, 10}, {32, 10}, {7, 11},  {6, 11},
    {32, 11}, {6, 3},   {20, 6},  {30, 8},  {15, 10}, {33, 11}, {80, 12}, {14, 4},  {29, 8},  {14, 10}, {81, 12},
    {13, 5},  {35, 9},  {13, 10}, {12, 5},  {34, 9},  {82, 12}, {11, 5},  {12, 10}, {83, 12}, {19, 6},  {11, 10},
    {84, 12}, {18, 6},  {10, 10}, {17, 6},  {9, 10},  {16, 6},  {8, 10},  {22, 7},  {85, 12}, {21, 7},  {20, 7},
    {28, 8},  {27, 8},  {33, 9},  {32, 9},  {31, 9},  {30, 9},  {29, 9},  {28, 9},  {27, 9},  {26, 9},  {34, 11},
    {35, 11}, {86, 12}, {87, 12}, {7, 4},   {25, 9},  {5, 11},  {15, 6},  {4, 11},  {14, 6},  {13, 6},  {12, 6},
    {19, 7},  {18, 7},  {17, 7},  {16, 7},  {26, 8},  {25, 8},  {24, 8},  {23, 8},  {22, 8},  {21, 8},  {20, 8},
    {19, 8},  {24, 9},  {23, 9},  {22, 9},  {21, 9},  {20, 9},  {19, 9},  {18, 9},  {17, 9},  {7, 10},  {6, 10},
    {5, 10},  {4, 10},  {36, 11}, {37, 11}, {38, 11}, {39, 11}, {88, 12}, {89, 12}, {90, 12}, {91, 12}, {92, 12},
    {93, 12}, {94, 12}, {95, 12}, {3, 7}};
const uint16_t kIntraCodes[103][2] = {
    {2, 2},   {6, 3},   {15, 4},  {13, 5},  {12, 5},  {21, 6},  {19, 6},  {18, 6},  {23, 7},  {31, 8},  {30, 8},
    {29, 8},  {37, 9},  {36, 9},  {35, 9},  {33, 9},  {33, 10}, {32, 10}, {15, 10}, {14, 10}, {7, 11},  {6, 11},
    {32, 11}, {33, 11}, {80, 12}, {81, 12}, {82, 12}, {14, 4},  {20, 6},  {22, 7},  {28, 8},  {32, 9},  {31, 9},
    {13, 10}, {34, 11}, {83, 12}, {85, 12}, {11, 5},  {21, 7},  {30, 9},  {12, 10}, {86, 12}, {17, 6},  {27, 8},
    {29, 9},  {11, 10}, {16, 6},  {34, 9},  {10, 10}, {13, 6},  {28, 9},  {8, 10},  {18, 7},  {27, 9},  {84, 12},
    {20, 7},  {26, 9},  {87, 12}, {25, 8},  {9, 10},  {24, 8},  {35, 11}, {23, 8},  {25, 9},  {24, 9},  {7, 10},
    {88, 12}, {7, 4},   {12, 6},  {22, 8},  {23, 9},  {6, 10},  {5, 11},  {4, 11},  {89, 12}, {15, 6},  {22, 9},
    {5, 10},  {14, 6},  {4, 10},  {17, 7},  {36, 11}, {16, 7},  {37, 11}, {19, 7},  {90, 12}, {21, 8},  {91, 12},
    {20, 8},  {19, 8},  {26, 8},  {21, 9},  {20, 9},  {19, 9},  {18, 9},  {17, 9},  {38, 11}, {39, 11}, {92, 12},
    {93, 12}, {94, 12}, {95, 12}, {3, 7}};
// The number of levels of each run, LAST = 0 then LAST = 1 (the LMAX tables).
const int kInterLevels[2][41] = {
    {12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1}};
const int kIntraLevels[2][41] = {{27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1},
                                 {8, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}};
constexpr int kEscape = 102;

struct Tcoef {
  Vlc vlc;
  int8_t last[102], run[102], level[102];
  int lmax[2][64] = {};   // the largest level of (last, run)
  int rmax[2][64] = {};   // the largest run of (last, level)
  int16_t index[2][64][32];  // (last, run, level) -> event, or -1

  Tcoef(const uint16_t (*codes)[2], const int (*levels)[41]) : vlc(codes, 103) {
    std::memset(index, -1, sizeof(index));
    int e = 0;
    for (int l = 0; l < 2; ++l)
      for (int r = 0; r < 41; ++r)
        for (int lv = 1; lv <= levels[l][r]; ++lv, ++e) {
          last[e] = l, run[e] = r, level[e] = lv;
          lmax[l][r] = std::max(lmax[l][r], lv);
          rmax[l][lv] = std::max(rmax[l][lv], r);
          index[l][r][lv] = e;
        }
    if (e != 102) fail(kCorrupt);  // the tables above are inconsistent
  }
  // Whether (last, run, level) has a code: an event, or -1.
  int find(int l, int r, int lv) const { return (r < 64 && lv > 0 && lv < 32) ? index[l][r][lv] : -1; }
};

struct Tables {
  Vlc intra_mcbpc{kIntraMcbpc, 9}, inter_mcbpc{kInterMcbpc, 28}, cbpy{kCbpy, 16}, mvd{kMvd, 33};
  Vlc dc_lum{kDcLum, 13}, dc_chrom{kDcChrom, 13};
  Tcoef inter{kInterCodes, kInterLevels}, intra{kIntraCodes, kIntraLevels};
};
const Tables& tables() {
  static const Tables t;
  return t;
}

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

int dc_scaler(int q, bool luma) {
  if (q < 5) return 8;
  if (luma) return q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16;
  return q < 25 ? (q + 13) / 2 : q - 6;
}

// ---------------------------------------------------------------- IDCT

// FFmpeg's "simple" IDCT at 8 bits: cos(k pi / 16) sqrt(2) in 14 bits (W4
// one below 2^14), a row pass rounded to 16 bits at a shift of 11, a column
// pass at a shift of 20. A row of DC alone is taken as DC << 3.
constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
constexpr int kRowShift = 11, kColShift = 20;

void idct_row(int16_t* r) {
  if (!(r[1] | r[2] | r[3] | r[4] | r[5] | r[6] | r[7])) {
    int16_t v = static_cast<int16_t>(static_cast<uint16_t>(r[0] * 8));
    for (int i = 0; i < 8; ++i) r[i] = v;
    return;
  }
  int a0 = W4 * r[0] + (1 << (kRowShift - 1));
  int a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * r[2];
  a1 += W6 * r[2];
  a2 -= W6 * r[2];
  a3 -= W2 * r[2];
  int b0 = W1 * r[1] + W3 * r[3];
  int b1 = W3 * r[1] - W7 * r[3];
  int b2 = W5 * r[1] - W1 * r[3];
  int b3 = W7 * r[1] - W5 * r[3];
  a0 += W4 * r[4] + W6 * r[6];
  a1 += -W4 * r[4] - W2 * r[6];
  a2 += -W4 * r[4] + W2 * r[6];
  a3 += W4 * r[4] - W6 * r[6];
  b0 += W5 * r[5] + W7 * r[7];
  b1 += -W1 * r[5] - W5 * r[7];
  b2 += W7 * r[5] + W3 * r[7];
  b3 += W3 * r[5] - W1 * r[7];
  r[0] = static_cast<int16_t>((a0 + b0) >> kRowShift);
  r[7] = static_cast<int16_t>((a0 - b0) >> kRowShift);
  r[1] = static_cast<int16_t>((a1 + b1) >> kRowShift);
  r[6] = static_cast<int16_t>((a1 - b1) >> kRowShift);
  r[2] = static_cast<int16_t>((a2 + b2) >> kRowShift);
  r[5] = static_cast<int16_t>((a2 - b2) >> kRowShift);
  r[3] = static_cast<int16_t>((a3 + b3) >> kRowShift);
  r[4] = static_cast<int16_t>((a3 - b3) >> kRowShift);
}

// One column of the block to 8 values before clipping.
void idct_col(const int16_t* c, int out[8]) {
  int a0 = W4 * (c[0] + ((1 << (kColShift - 1)) / W4));
  int a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * c[16];
  a1 += W6 * c[16];
  a2 -= W6 * c[16];
  a3 -= W2 * c[16];
  int b0 = W1 * c[8] + W3 * c[24];
  int b1 = W3 * c[8] - W7 * c[24];
  int b2 = W5 * c[8] - W1 * c[24];
  int b3 = W7 * c[8] - W5 * c[24];
  a0 += W4 * c[32] + W6 * c[48];
  a1 += -W4 * c[32] - W2 * c[48];
  a2 += -W4 * c[32] + W2 * c[48];
  a3 += W4 * c[32] - W6 * c[48];
  b0 += W5 * c[40] + W7 * c[56];
  b1 += -W1 * c[40] - W5 * c[56];
  b2 += W7 * c[40] + W3 * c[56];
  b3 += W3 * c[40] - W1 * c[56];
  out[0] = (a0 + b0) >> kColShift;
  out[7] = (a0 - b0) >> kColShift;
  out[1] = (a1 + b1) >> kColShift;
  out[6] = (a1 - b1) >> kColShift;
  out[2] = (a2 + b2) >> kColShift;
  out[5] = (a2 - b2) >> kColShift;
  out[3] = (a3 + b3) >> kColShift;
  out[4] = (a3 - b3) >> kColShift;
}

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// The block's inverse transform put into (add = false) or added to (add =
// true) the 8x8 pixels at dst.
void idct_block(int16_t* blk, uint8_t* dst, int stride, bool add) {
  for (int i = 0; i < 8; ++i) idct_row(blk + 8 * i);
  for (int x = 0; x < 8; ++x) {
    int col[8];
    idct_col(blk + x, col);
    for (int y = 0; y < 8; ++y) {
      uint8_t* p = dst + y * stride + x;
      *p = clip8(add ? *p + col[y] : col[y]);
    }
  }
}

// ---------------------------------------------------------------- frames

struct Plane {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  void resize(int width, int height) {
    w = width, h = height;
    px.assign(size_t(w) * h, 0);
  }
  uint8_t* at(int x, int y) { return px.data() + size_t(y) * w + x; }
  const uint8_t* at(int x, int y) const { return px.data() + size_t(y) * w + x; }
};

// Planes of a whole number of macroblocks.
struct Frame {
  Plane y, u, v;
  void resize(int mbw, int mbh) {
    y.resize(mbw * 16, mbh * 16);
    u.resize(mbw * 8, mbh * 8);
    v.resize(mbw * 8, mbh * 8);
  }
};

// 4:2:0 limited-range BT.601 to RGB as FFmpeg's swscale converts yuv420p to
// BGR24 for OpenCV: each chroma sample serves its 2x2 block of luma samples;
// samples are taken to 16 bits (<< 3, less 16 << 3 or 128 << 3), each term
// is a high multiply ((a * b) >> 16) by a coefficient in 2^-13 units, and a
// channel is its terms' sum, clipped to 8 bits. The coefficients round
// swscale's BT.601 table (16.16: crv 104597, cbu 132201, cgu 25675, cgv
// 53279; luma 2^16 * 255 / 219) to 2^-13. This matched every byte of
// OpenCV's decode of the fixtures under tests/torch_port_data/.
constexpr int kYCoeff = (76309 * 8192 + (1 << 15)) >> 16;     // 9539
constexpr int kVRed = (104597 * 8192 + (1 << 15)) >> 16;      // 13075
constexpr int kUBlue = (132201 * 8192 + (1 << 15)) >> 16;     // 16525
constexpr int kUGreen = -((25675 * 8192 + (1 << 15)) >> 16);  // -3209
constexpr int kVGreen = -((53279 * 8192 + (1 << 15)) >> 16);  // -6660

inline int mulhi(int a, int b) { return (a * b) >> 16; }

// Whether OpenCV converts video of this colour description (ITU-T H.273
// code points, as an H.264 VUI or an MP4 `colr` box gives them) exactly as
// it converts one with none: BT.601 at limited range, `frame_to_rgb`. Its
// swscale honours the description (BT.709 or FCC matrices, full range,
// BT.2020 and wider primaries, log, PQ and HLG transfers all convert
// otherwise); these are the code points a written stream showed to make no
// difference, reserved values left out.
bool converts_as_bt601(int primaries, int transfer, int matrix, bool full_range) {
  const bool p = primaries == 1 || primaries == 2 || (primaries >= 4 && primaries <= 7);
  const bool t = transfer == 1 || transfer == 2 || (transfer >= 4 && transfer <= 8) ||
                 (transfer >= 11 && transfer <= 15) || transfer == 17;
  const bool m = matrix == 2 || matrix == 5 || matrix == 6;
  return p && t && m && !full_range;
}

void frame_to_rgb(const Frame& f, int width, int height, uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* ly = f.y.at(0, y);
    const uint8_t* lu = f.u.at(0, y >> 1);
    const uint8_t* lv = f.v.at(0, y >> 1);
    uint8_t* o = out + size_t(y) * width * 3;
    for (int x = 0; x < width; ++x, o += 3) {
      const int l = mulhi(8 * ly[x] - 128, kYCoeff), u = 8 * lu[x >> 1] - 1024, v = 8 * lv[x >> 1] - 1024;
      o[0] = clip8(l + mulhi(v, kVRed));
      o[1] = clip8(l + mulhi(u, kUGreen) + mulhi(v, kVGreen));
      o[2] = clip8(l + mulhi(u, kUBlue));
    }
  }
}

// ---------------------------------------------------------------- decoder

struct Vol {
  bool have = false;
  int width = 0, height = 0, time_bits = 1;
};

// Reads a VOL header (after its start code), refusing every tool the
// decoder does not take.
Vol parse_vol(BitReader& b) {
  Vol v;
  b.get(1);  // random_accessible_vol
  int object_type = b.get(8);
  int verid = 1;
  if (b.bit()) {
    verid = b.get(4);
    b.get(3);
  }
  if (b.get(4) == 15) b.get(16);  // aspect ratio, extended PAR
  int low_delay;
  if (b.bit()) {                    // vol_control_parameters
    if (b.get(2) != 1) fail(kOtherTool);  // chroma_format other than 4:2:0
    low_delay = b.get(1);
    if (b.bit()) {  // vbv_parameters: 79 bits
      b.get(31), b.get(32), b.get(16);
    }
  } else {
    low_delay = (object_type == 1 || object_type == 17) ? 1 : 0;  // Simple and Advanced Simple, as FFmpeg
  }
  if (b.get(2) != 0) fail(kShape);
  b.marker();
  int resolution = b.get(16);
  if (!resolution) fail(kCorrupt);
  b.marker();
  v.time_bits = 1;
  while ((1 << v.time_bits) < resolution) ++v.time_bits;
  if (b.bit()) b.get(v.time_bits);  // fixed_vop_rate, fixed_vop_time_increment
  b.marker();
  v.width = b.get(13);
  b.marker();
  v.height = b.get(13);
  b.marker();
  if (!v.width || !v.height) fail(kCorrupt);
  if (b.bit()) fail(kInterlaced);
  if (!b.bit()) fail(kOtherTool);  // obmc_disable = 0
  if (b.get(verid == 1 ? 1 : 2)) fail(kSprite);
  if (b.bit()) fail(kNot8Bit);
  if (b.bit()) fail(kMpegQuant);
  if (verid != 1 && b.bit()) fail(kQuarterPel);
  if (!b.bit()) fail(kOtherTool);  // complexity_estimation_disable = 0
  if (!b.bit()) fail(kResync);     // resync_marker_disable = 0
  if (b.bit()) fail(kPartitioned);  // data_partitioned (and reversible_vlc)
  if (verid != 1) {
    if (b.bit()) fail(kOtherTool);  // newpred_enable
    if (b.bit()) fail(kOtherTool);  // reduced_resolution_vop_enable
  }
  if (b.bit()) fail(kScalable);
  if (!low_delay) fail(kBVop);
  v.have = true;
  return v;
}

const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kDquant[4] = {-1, -2, 1, 2};

class Decoder {
 public:
  Vol vol;
  int mbw = 0, mbh = 0;
  Frame cur, ref;
  bool have_ref = false;

  void set_vol(const Vol& v) {
    if (have_ref && (v.width != vol.width || v.height != vol.height)) fail(kCorrupt);  // a size change mid-stream
    vol = v;
    mbw = (v.width + 15) / 16;
    mbh = (v.height + 15) / 16;
  }

  // Decodes one sample; true when it produced a frame (in `cur`). A VOP
  // with vop_coded = 0 produces none, as in FFmpeg's decoder.
  bool decode_sample(const uint8_t* d, size_t n) {
    bool produced = false;
    size_t i = 0;
    while (i + 4 <= n) {
      if (d[i] || d[i + 1] || d[i + 2] != 1) {
        ++i;
        continue;
      }
      uint8_t code = d[i + 3];
      size_t start = i + 4, end = start;
      while (end + 3 <= n && (d[end] || d[end + 1] || d[end + 2] != 1)) ++end;
      if (end + 3 > n) end = n;
      if (code >= 0x20 && code <= 0x2F) {
        BitReader b(d + start, end - start);
        set_vol(parse_vol(b));
      } else if (code == 0xB6) {
        if (!vol.have) fail(kCorrupt);
        BitReader b(d + start, n - start);
        produced = decode_vop(b) || produced;
        break;  // a sample holds one VOP
      }
      i = end;
    }
    return produced;
  }

 private:
  std::vector<int> dc_y, dc_u, dc_v;  // dequantised DC of each block, borders at 1024
  std::vector<int> mv;                // (x, y) of each macroblock, a zero border
  int qscale = 1;

  int& dc_at(int n, int mbx, int mby) {
    if (n < 4) return dc_y[size_t(2 * mby + (n >> 1) + 1) * (2 * mbw + 1) + 2 * mbx + (n & 1) + 1];
    std::vector<int>& p = n == 4 ? dc_u : dc_v;
    return p[size_t(mby + 1) * (mbw + 1) + mbx + 1];
  }
  int* mv_at(int mbx, int mby) { return &mv[(size_t(mby + 1) * (mbw + 2) + mbx + 1) * 2]; }

  // DC prediction (7.4.3.1): from the block above or on the left, whichever
  // the gradient names; returns the predicted level (rounded division).
  int predict_dc(int n, int mbx, int mby, int scale) {
    const int stride = n < 4 ? 2 * mbw + 1 : mbw + 1;
    const int* x = &dc_at(n, mbx, mby);
    int a = x[-1], b = x[-1 - stride], c = x[-stride];
    int pred = std::abs(a - b) < std::abs(b - c) ? c : a;
    return (pred + (scale >> 1)) / scale;
  }

  void reset_dc(int mbx, int mby) {
    for (int n = 0; n < 6; ++n) dc_at(n, mbx, mby) = 1024;
  }

  // TCOEF events from zig-zag position `pos` into blk (levels as coded).
  // Inter blocks (and type-3 escapes there) are dequantised here, as in
  // FFmpeg: level * 2q +- ((q - 1) | 1), a fixed-length level clipped to
  // [-2048, 2047] after it.
  void read_coefs(BitReader& b, int16_t* blk, int pos, bool intra, int q) {
    const Tcoef& t = intra ? tables().intra : tables().inter;
    const int qmul = intra ? 1 : 2 * q, qadd = intra ? 0 : (q - 1) | 1;
    while (true) {
      int e = t.vlc.read(b);
      int last, run, level;
      bool fixed = false;
      if (e == kEscape) {
        if (!b.bit()) {  // type 1: level + LMAX
          e = t.vlc.read(b);
          if (e == kEscape) fail(kCorrupt);
          last = t.last[e], run = t.run[e], level = t.level[e] + t.lmax[last][run];
          if (b.bit()) level = -level;
        } else if (!b.bit()) {  // type 2: run + RMAX + 1
          e = t.vlc.read(b);
          if (e == kEscape) fail(kCorrupt);
          last = t.last[e], run = t.run[e], level = t.level[e];
          run += t.rmax[last][level] + 1;
          if (b.bit()) level = -level;
        } else {  // type 3: fixed length
          last = b.get(1);
          run = b.get(6);
          b.marker();
          level = static_cast<int>(b.get(12) << 20) >> 20;
          b.marker();
          fixed = true;
        }
      } else {
        last = t.last[e], run = t.run[e], level = t.level[e];
        if (b.bit()) level = -level;
      }
      if (qmul != 1) {
        level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
        if (fixed) level = std::clamp(level, -2048, 2047);
      }
      pos += run;
      if (pos > 63) fail(kCorrupt);
      blk[kZigzag[pos++]] = static_cast<int16_t>(level);
      if (last) return;
    }
  }

  void decode_intra_block(BitReader& b, int16_t* blk, int n, int mbx, int mby, bool coded, bool dc_vlc) {
    const Tables& t = tables();
    std::memset(blk, 0, 64 * sizeof(int16_t));
    int level = 0;
    if (dc_vlc) {
      int size = (n < 4 ? t.dc_lum : t.dc_chrom).read(b);
      if (size) {
        int v = b.get(size);
        level = (v >> (size - 1)) ? v : v - (1 << size) + 1;
        if (size > 8) b.marker();
      }
    }
    if (coded) read_coefs(b, blk, dc_vlc ? 1 : 0, true, qscale);
    if (!dc_vlc) level = blk[0];
    const int scale = dc_scaler(qscale, n < 4);
    level += predict_dc(n, mbx, mby, scale);
    int stored = level * scale;
    if (stored & ~2047) stored = stored < 0 ? 0 : 2047;
    dc_at(n, mbx, mby) = stored;
    blk[0] = static_cast<int16_t>(level * scale);
    const int qmul = 2 * qscale, qadd = (qscale - 1) | 1;
    for (int i = 1; i < 64; ++i)
      if (blk[i]) blk[i] = static_cast<int16_t>(blk[i] > 0 ? blk[i] * qmul + qadd : blk[i] * qmul - qadd);
  }

  // H.263 MVD with vop_fcode: a vector component in half pels, wrapped into
  // [-16 << fcode, (16 << fcode) - 1] around the prediction.
  int read_mv(BitReader& b, int pred, int fcode) {
    int code = tables().mvd.read(b);
    if (!code) return pred;
    bool negative = b.bit();
    int shift = fcode - 1, val = code;
    if (shift) val = (((val - 1) << shift) | static_cast<int>(b.get(shift))) + 1;
    if (negative) val = -val;
    val += pred;
    const int bits = 5 + fcode;
    return static_cast<int>(static_cast<uint32_t>(val) << (32 - bits)) >> (32 - bits);
  }

  static int median(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

  // Half-pel prediction of a size x size block whose top-left sits at
  // (x, y) + (hx, hy) / 2 in `src`, every sample outside [0, edge_w) x
  // [0, edge_h) taken from the nearest one inside (unrestricted vectors).
  static void predict(const Plane& src, int edge_w, int edge_h, int x, int y, int hx, int hy, int size, int rounding,
                      uint8_t* dst, int stride) {
    uint8_t patch[17 * 17];
    const uint8_t* p;
    int ps;
    if (x >= 0 && y >= 0 && x + size + hx <= edge_w && y + size + hy <= edge_h) {
      p = src.at(x, y);
      ps = src.w;
    } else {
      for (int j = 0; j <= size; ++j) {
        int sy = std::clamp(y + j, 0, edge_h - 1);
        for (int i = 0; i <= size; ++i) patch[j * 17 + i] = *src.at(std::clamp(x + i, 0, edge_w - 1), sy);
      }
      p = patch;
      ps = 17;
    }
    for (int j = 0; j < size; ++j) {
      const uint8_t* r0 = p + j * ps;
      const uint8_t* r1 = r0 + ps;
      uint8_t* o = dst + j * stride;
      if (!hx && !hy)
        std::memcpy(o, r0, size);
      else if (hx && !hy)
        for (int i = 0; i < size; ++i) o[i] = static_cast<uint8_t>((r0[i] + r0[i + 1] + 1 - rounding) >> 1);
      else if (!hx)
        for (int i = 0; i < size; ++i) o[i] = static_cast<uint8_t>((r0[i] + r1[i] + 1 - rounding) >> 1);
      else
        for (int i = 0; i < size; ++i)
          o[i] = static_cast<uint8_t>((r0[i] + r0[i + 1] + r1[i] + r1[i + 1] + 2 - rounding) >> 2);
    }
  }

  // The reference is extended from its whole macroblocks, as FFmpeg's
  // decoder and encoder of these streams extend it (a frame of 200x120 from
  // 208x128): edges at the frame's own size drift from the file's frames.
  void motion_compensate(int mbx, int mby, int mx, int my, int rounding) {
    const int ew = mbw * 16, eh = mbh * 16;
    predict(ref.y, ew, eh, mbx * 16 + (mx >> 1), mby * 16 + (my >> 1), mx & 1, my & 1, 16, rounding,
            cur.y.at(mbx * 16, mby * 16), cur.y.w);
    const int cx = mbx * 8 + (mx >> 2), cy = mby * 8 + (my >> 2), chx = (mx & 3) != 0, chy = (my & 3) != 0;
    predict(ref.u, ew >> 1, eh >> 1, cx, cy, chx, chy, 8, rounding, cur.u.at(mbx * 8, mby * 8), cur.u.w);
    predict(ref.v, ew >> 1, eh >> 1, cx, cy, chx, chy, 8, rounding, cur.v.at(mbx * 8, mby * 8), cur.v.w);
  }

  uint8_t* block_dst(int n, int mbx, int mby, int* stride) {
    if (n < 4) {
      *stride = cur.y.w;
      return cur.y.at(mbx * 16 + (n & 1) * 8, mby * 16 + (n >> 1) * 8);
    }
    Plane& p = n == 4 ? cur.u : cur.v;
    *stride = p.w;
    return p.at(mbx * 8, mby * 8);
  }

  bool decode_vop(BitReader& b) {
    const Tables& t = tables();
    int type = b.get(2);
    if (type == 2) fail(kBVop);
    if (type == 3) fail(kSprite);
    while (b.bit()) {
    }  // modulo_time_base
    b.marker();
    b.get(vol.time_bits);
    b.marker();
    if (!b.bit()) return false;  // vop_coded = 0
    const bool p_vop = type == 1;
    if (p_vop && !have_ref) fail(kCorrupt);
    int rounding = p_vop ? b.get(1) : 0;
    int thr = kDcThreshold[b.get(3)];
    qscale = b.get(5);
    if (!qscale) fail(kCorrupt);
    int fcode = 1;
    if (p_vop) {
      fcode = b.get(3);
      if (!fcode) fail(kCorrupt);
    }
    if (have_ref) std::swap(cur, ref);
    cur.resize(mbw, mbh);
    dc_y.assign(size_t(2 * mbw + 1) * (2 * mbh + 1), 1024);
    dc_u.assign(size_t(mbw + 1) * (mbh + 1), 1024);
    dc_v.assign(dc_u.size(), 1024);
    mv.assign(size_t(mbw + 2) * (mbh + 1) * 2, 0);
    alignas(16) int16_t blk[6][64];
    for (int mby = 0; mby < mbh; ++mby)
      for (int mbx = 0; mbx < mbw; ++mbx) {
        bool intra = true, dquant;
        int cbpc;
        if (p_vop) {
          if (b.bit()) {  // not coded: the reference's macroblock, vector 0
            motion_compensate(mbx, mby, 0, 0, rounding);
            reset_dc(mbx, mby);
            continue;
          }
          int idx;
          do idx = t.inter_mcbpc.read(b);
          while (idx == 20);
          int mb_type = idx >> 2;
          if (mb_type == 4 || mb_type == 6) fail(kFourMv);
          if (mb_type == 5) fail(kCorrupt);
          intra = mb_type == 1 || mb_type == 3;
          dquant = mb_type == 2 || mb_type == 3;
          cbpc = idx & 3;
        } else {
          int idx;
          do idx = t.intra_mcbpc.read(b);
          while (idx == 8);
          dquant = idx >> 2;
          cbpc = idx & 3;
        }
        if (intra && b.bit()) fail(kAcPred);
        int cbpy = t.cbpy.read(b);
        if (!intra) cbpy ^= 15;
        const bool dc_vlc = qscale < thr;
        if (dquant) qscale = std::clamp(qscale + kDquant[b.get(2)], 1, 31);
        const int cbp = cbpy << 2 | cbpc;  // bit 5 - n for block n
        if (intra) {
          for (int n = 0; n < 6; ++n) decode_intra_block(b, blk[n], n, mbx, mby, cbp >> (5 - n) & 1, dc_vlc);
          for (int n = 0; n < 6; ++n) {
            int stride;
            uint8_t* dst = block_dst(n, mbx, mby, &stride);
            idct_block(blk[n], dst, stride, false);
          }
          continue;
        }
        int* m = mv_at(mbx, mby);
        int px, py;
        if (mby == 0) {
          px = mbx ? m[-2] : 0;
          py = mbx ? m[-1] : 0;
        } else {
          const int* above = mv_at(mbx, mby - 1);
          px = median(m[-2], above[0], above[2]);
          py = median(m[-1], above[1], above[3]);
        }
        m[0] = read_mv(b, px, fcode);
        m[1] = read_mv(b, py, fcode);
        reset_dc(mbx, mby);
        for (int n = 0; n < 6; ++n) {
          if (cbp >> (5 - n) & 1) {
            std::memset(blk[n], 0, sizeof(blk[n]));
            read_coefs(b, blk[n], 0, false, qscale);
          }
        }
        motion_compensate(mbx, mby, m[0], m[1], rounding);
        for (int n = 0; n < 6; ++n)
          if (cbp >> (5 - n) & 1) {
            int stride;
            uint8_t* dst = block_dst(n, mbx, mby, &stride);
            idct_block(blk[n], dst, stride, true);
          }
      }
    have_ref = true;
    return true;
  }
};

// ---------------------------------------------------------------- MP4

uint32_t be32(const uint8_t* p) { return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3]; }
uint64_t be64(const uint8_t* p) { return uint64_t(be32(p)) << 32 | be32(p + 4); }

struct Box {
  uint32_t type;
  const uint8_t* body;
  size_t size;
};
constexpr uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) << 24 | uint32_t(uint8_t(s[1])) << 16 | uint32_t(uint8_t(s[2])) << 8 | uint8_t(s[3]);
}

// The child boxes of [p, p + n); a box that runs past the end is corrupt.
std::vector<Box> children(const uint8_t* p, size_t n) {
  std::vector<Box> out;
  size_t i = 0;
  while (i + 8 <= n) {
    uint64_t size = be32(p + i);
    uint32_t type = be32(p + i + 4);
    size_t head = 8;
    if (size == 1) {
      if (i + 16 > n) fail(kCorrupt);
      size = be64(p + i + 8);
      head = 16;
    } else if (size == 0) {
      size = n - i;
    }
    if (size < head || size > n - i) fail(kCorrupt);
    out.push_back({type, p + i + head, size_t(size - head)});
    i += size;
  }
  return out;
}
const Box* child(const std::vector<Box>& boxes, const char* type) {
  for (const Box& b : boxes)
    if (b.type == fourcc(type)) return &b;
  return nullptr;
}

// An MPEG-4 expandable descriptor length: up to four bytes of 7 bits.
size_t descriptor_length(const uint8_t*& p, const uint8_t* end) {
  size_t len = 0;
  for (int i = 0; i < 4; ++i) {
    if (p >= end) fail(kCorrupt);
    uint8_t c = *p++;
    len = len << 7 | (c & 0x7F);
    if (!(c & 0x80)) break;
  }
  return len;
}

// The DecoderSpecificInfo of an esds box (the VOL headers), or empty.
std::vector<uint8_t> esds_config(const Box& esds) {
  const uint8_t* p = esds.body + 4;  // version, flags
  const uint8_t* end = esds.body + esds.size;
  if (p >= end || *p++ != 0x03) return {};
  size_t len = descriptor_length(p, end);
  end = std::min(end, p + len);
  if (p + 3 > end) fail(kCorrupt);
  uint8_t flags = p[2];
  p += 3;
  if (flags & 0x80) p += 2;
  if (flags & 0x40) {
    if (p >= end) fail(kCorrupt);
    p += 1 + *p;
  }
  if (flags & 0x20) p += 2;
  if (p >= end || *p++ != 0x04) return {};
  len = descriptor_length(p, end);
  const uint8_t* dcd_end = std::min(end, p + len);
  p += 13;  // objectTypeIndication, streamType, bufferSizeDB, max and average bitrates
  if (p >= dcd_end || *p++ != 0x05) return {};
  len = descriptor_length(p, dcd_end);
  if (p + len > dcd_end) fail(kCorrupt);
  return std::vector<uint8_t>(p, p + len);
}

#include "h264.h"

struct Track {
  std::vector<uint8_t> file;
  std::vector<uint8_t> config;  // the VOL headers of mp4v, or the avcC record of avc1 / avc3
  uint32_t format = 0;
  std::vector<std::pair<uint64_t, uint32_t>> samples;  // offset, size
  uint32_t timescale = 0;
  uint64_t duration = 0;   // in timescale units, over the samples
  uint32_t first_delta = 0;
  size_t stts_entries = 0;
};

// An edit list as FFmpeg's mov demuxer reads it: empty edits only shift the
// timeline, and one edit that starts no later than the first presented
// sample (what FFmpeg's muxer writes for B-frames: the first composition
// offset) hands every sample to the decoder and every frame out. Any other
// edit list drops or repeats frames, which is refused.
void check_edits(const Track& t, const std::vector<Box>& trak, const std::vector<Box>& stbl) {
  const Box* edts = child(trak, "edts");
  if (!edts) return;
  auto eb = children(edts->body, edts->size);
  const Box* elst = child(eb, "elst");
  if (!elst || elst->size < 8) return;
  const int version = elst->body[0];
  const uint32_t entries = be32(elst->body + 4);
  const size_t entry = version == 1 ? 20 : 12;
  if (elst->size < 8 + entry * entries) fail(kCorrupt);
  // the earliest composition time: decode times plus ctts offsets
  int64_t first_cts = 0;
  if (const Box* ctts = child(stbl, "ctts")) {
    if (ctts->size < 8) fail(kCorrupt);
    const bool signed_offsets = ctts->body[0] == 1;
    const uint32_t n = be32(ctts->body + 4);
    if (ctts->size < 8 + 8 * size_t(n)) fail(kCorrupt);
    const Box* stts = child(stbl, "stts");
    std::vector<int64_t> dts;
    int64_t clock = 0;
    if (stts && stts->size >= 8)
      for (uint32_t i = 0, m = be32(stts->body + 4); i < m && 8 + 8 * size_t(i + 1) <= stts->size; ++i)
        for (uint32_t k = 0, c = be32(stts->body + 8 + 8 * i); k < c && dts.size() < t.samples.size(); ++k) {
          dts.push_back(clock);
          clock += be32(stts->body + 12 + 8 * i);
        }
    size_t s = 0;
    first_cts = INT64_MAX;
    for (uint32_t i = 0; i < n; ++i) {
      const uint32_t count = be32(ctts->body + 8 + 8 * i), raw = be32(ctts->body + 12 + 8 * i);
      const int64_t off = signed_offsets ? int64_t(int32_t(raw)) : int64_t(raw);
      for (uint32_t k = 0; k < count && s < dts.size(); ++k, ++s) first_cts = std::min(first_cts, dts[s] + off);
    }
    if (first_cts == INT64_MAX) first_cts = 0;
  }
  int used = 0;
  for (uint32_t i = 0; i < entries; ++i) {
    const uint8_t* e = elst->body + 8 + entry * i;
    const int64_t media_time = version == 1 ? int64_t(be64(e + 8)) : int64_t(int32_t(be32(e + 4)));
    if (media_time == -1) continue;  // an empty edit
    if (++used > 1 || media_time > first_cts) fail(kEditList);
  }
}

Track open_mp4(const char* path) {
  Track t;
  FILE* f = std::fopen(path, "rb");
  if (!f) fail(kUnreadable);
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) {
    std::fclose(f);
    fail(kUnreadable);
  }
  t.file.resize(size_t(n));
  size_t got = n ? std::fread(t.file.data(), 1, size_t(n), f) : 0;
  std::fclose(f);
  if (got != size_t(n)) fail(kUnreadable);
  const uint8_t* d = t.file.data();
  if (n < 8 || (be32(d + 4) != fourcc("ftyp") && be32(d + 4) != fourcc("moov") && be32(d + 4) != fourcc("mdat") &&
                be32(d + 4) != fourcc("free") && be32(d + 4) != fourcc("wide")))
    fail(kNotMp4);
  std::vector<Box> top;
  try {
    top = children(d, t.file.size());
  } catch (const Fail&) {
    // A cut file: the boxes before the cut still name the format.
    top.clear();
  }
  const Box* moov = child(top, "moov");
  if (!moov) {
    bool any_moov = false;  // a moov after a cut mdat
    for (size_t i = 4; i + 4 <= t.file.size() && !any_moov; ++i) any_moov = be32(d + i) == fourcc("moov");
    fail(any_moov || child(top, "mdat") || top.empty() ? kCorrupt : kNotMp4);
  }
  Box stbl{}, mdhd{};
  std::vector<Box> trak_boxes;
  bool found = false;
  for (const Box& trak : children(moov->body, moov->size)) {
    if (trak.type != fourcc("trak")) continue;
    auto tk = children(trak.body, trak.size);
    const Box* mdia = child(tk, "mdia");
    if (!mdia) continue;
    auto md = children(mdia->body, mdia->size);
    const Box* hdlr = child(md, "hdlr");
    const Box* minf = child(md, "minf");
    if (!hdlr || hdlr->size < 12 || be32(hdlr->body + 8) != fourcc("vide") || !minf) continue;
    auto mi = children(minf->body, minf->size);
    const Box* s = child(mi, "stbl");
    const Box* h = child(md, "mdhd");
    if (s && h) {
      stbl = *s, mdhd = *h, found = true;
      trak_boxes = tk;
      break;
    }
  }
  if (!found) fail(kNoVideo);
  auto st = children(stbl.body, stbl.size);
  const Box* stsd = child(st, "stsd");
  if (!stsd || stsd->size < 16) fail(kCorrupt);
  uint32_t format = be32(stsd->body + 12);
  const bool avc = format == fourcc("avc1") || format == fourcc("avc3");
  if (format == fourcc("hvc1") || format == fourcc("hev1")) fail(kAvc);
  if (format == fourcc("vp09") || format == fourcc("vp08")) fail(kVp9);
  if (format == fourcc("av01")) fail(kAv1);
  if (format != fourcc("mp4v") && !avc) fail(kOtherCodec);
  t.format = format;
  size_t entry_size = be32(stsd->body + 8);
  if (entry_size < 8 + 78 || entry_size > stsd->size - 8) fail(kCorrupt);
  auto entry = children(stsd->body + 8 + 8 + 78, entry_size - 8 - 78);
  if (const Box* colr = child(entry, "colr"); colr && colr->size >= 10) {
    const uint32_t kind = be32(colr->body);
    const uint8_t* c = colr->body + 4;
    if (kind == fourcc("nclx") && colr->size < 11) fail(kCorrupt);
    if ((kind == fourcc("nclx") || kind == fourcc("nclc")) &&
        !converts_as_bt601(c[0] << 8 | c[1], c[2] << 8 | c[3], c[4] << 8 | c[5], kind == fourcc("nclx") && (c[6] & 0x80)))
      fail(kColour);  // FFmpeg's demuxer hands the box's description to the frames OpenCV converts
  }
  if (avc) {
    const Box* avcc = child(entry, "avcC");
    if (!avcc && format == fourcc("avc1")) fail(kAvc);  // avc1 keeps its parameter sets in avcC
    if (!avcc) fail(kCorrupt);
    t.config.assign(avcc->body, avcc->body + avcc->size);
  } else if (const Box* esds = child(entry, "esds")) {
    t.config = esds_config(*esds);
  }

  const uint8_t* mh = mdhd.body;
  if (mdhd.size < 24) fail(kCorrupt);
  t.timescale = mh[0] == 1 ? be32(mh + 20) : be32(mh + 12);

  const Box* stsz = child(st, "stsz");
  const Box* stsc = child(st, "stsc");
  const Box* stco = child(st, "stco");
  const Box* co64 = child(st, "co64");
  const Box* stts = child(st, "stts");
  if (!stsz || !stsc || !(stco || co64) || stsz->size < 12 || stsc->size < 8) fail(kCorrupt);
  uint32_t uniform = be32(stsz->body + 4), count = be32(stsz->body + 8);
  if (!uniform && stsz->size < 12 + 4 * size_t(count)) fail(kCorrupt);
  const Box* co = stco ? stco : co64;
  if (co->size < 8) fail(kCorrupt);
  uint32_t chunks = be32(co->body + 4);
  if (co->size < 8 + size_t(chunks) * (stco ? 4 : 8)) fail(kCorrupt);
  uint32_t runs = be32(stsc->body + 4);
  if (stsc->size < 8 + 12 * size_t(runs)) fail(kCorrupt);
  uint32_t sample = 0;
  for (uint32_t r = 0; r < runs && sample < count; ++r) {
    const uint8_t* e = stsc->body + 8 + 12 * r;
    uint32_t first = be32(e), per = be32(e + 4);
    uint32_t next = r + 1 < runs ? be32(e + 12) : chunks + 1;
    if (first < 1 || next < first) fail(kCorrupt);
    for (uint32_t c = first; c < next && c <= chunks && sample < count; ++c) {
      uint64_t off = stco ? be32(co->body + 8 + 4 * (c - 1)) : be64(co->body + 8 + 8 * (c - 1));
      for (uint32_t k = 0; k < per && sample < count; ++k, ++sample) {
        uint32_t size = uniform ? uniform : be32(stsz->body + 12 + 4 * size_t(sample));
        if (off + size > t.file.size()) fail(kCorrupt);  // a sample past the end: a cut file
        t.samples.push_back({off, size});
        off += size;
      }
    }
  }
  if (sample != count) fail(kCorrupt);
  if (stts && stts->size >= 8) {
    uint32_t entries = be32(stts->body + 4);
    if (stts->size < 8 + 8 * size_t(entries)) fail(kCorrupt);
    t.stts_entries = entries;
    for (uint32_t i = 0; i < entries; ++i) {
      uint32_t c = be32(stts->body + 8 + 8 * i), delta = be32(stts->body + 12 + 8 * i);
      if (!i) t.first_delta = delta;
      t.duration += uint64_t(c) * delta;
    }
  }
  check_edits(t, trak_boxes, st);
  return t;
}

// Frames a second as FFmpeg's demuxer guesses it: the one delta of a
// constant-rate track, else samples over duration.
double track_fps(const Track& t) {
  if (!t.timescale) return 0.0;
  if (t.stts_entries == 1 && t.first_delta) return double(t.timescale) / t.first_delta;
  return t.duration ? double(t.samples.size()) * t.timescale / double(t.duration) : 0.0;
}

// The stream's VOL: from esds, else from the first sample that holds one.
Vol find_vol(const Track& t) {
  auto scan = [](const uint8_t* d, size_t n) -> Vol {
    for (size_t i = 0; i + 4 <= n; ++i)
      if (!d[i] && !d[i + 1] && d[i + 2] == 1 && d[i + 3] >= 0x20 && d[i + 3] <= 0x2F) {
        BitReader b(d + i + 4, n - i - 4);
        return parse_vol(b);
      } else if (!d[i] && !d[i + 1] && d[i + 2] == 1 && d[i + 3] == 0xB6) {
        break;
      }
    return Vol{};
  };
  Vol v = scan(t.config.data(), t.config.size());
  for (size_t s = 0; !v.have && s < t.samples.size(); ++s)
    v = scan(t.file.data() + t.samples[s].first, t.samples[s].second);
  if (!v.have) fail(kCorrupt);
  return v;
}

// ---------------------------------------------------------------- H.264 tracks

bool is_avc(const Track& t) { return t.format == fourcc("avc1") || t.format == fourcc("avc3"); }

// The cropped size of an H.264 track: from its first SPS, in avcC or, for
// avc3, in band.
void avc_size(const Track& t, int* height, int* width) {
  h264::Decoder d;
  h264::read_avcc(d, t.config);
  for (size_t s = 0; d.first_sps < 0 && s < t.samples.size(); ++s)
    h264::for_each_nal(t.file.data() + t.samples[s].first, t.samples[s].second, d.length_size,
                 [&](const uint8_t* p, size_t n) {
                   if ((p[0] & 31) == 7 && d.first_sps < 0) d.nal(p, n);
                 });
  if (d.first_sps < 0) fail(kCorrupt);
  *height = d.sps_table[d.first_sps].height();
  *width = d.sps_table[d.first_sps].width();
}

// Decodes an H.264 track into the buffers of evt_read_mp4, frames in the
// order FFmpeg outputs them, each cropped to the SPS's window.
void read_avc(const Track& t, uint8_t* rgb, uint8_t* y, uint8_t* u, uint8_t* v, int max_frames, int H, int W,
              int* produced) {
  h264::Decoder d;
  h264::read_avcc(d, t.config);
  const int cw = (W + 1) / 2, ch = (H + 1) / 2;
  Frame crop;
  crop.y.resize(W, H);
  crop.u.resize(cw, ch);
  crop.v.resize(cw, ch);
  d.sink = [&](const h264::Picture& p) {
    if (*produced >= max_frames) fail(kCorrupt);
    const h264::Sps& q = *d.sps;
    if (q.width() != W || q.height() != H) fail(kCorrupt);  // not the size mp4_info read
    for (int r = 0; r < H; ++r) std::memcpy(crop.y.at(0, r), p.f.y.at(q.crop_left, q.crop_top + r), size_t(W));
    for (int r = 0; r < ch; ++r) {
      std::memcpy(crop.u.at(0, r), p.f.u.at(q.crop_left / 2, q.crop_top / 2 + r), size_t(cw));
      std::memcpy(crop.v.at(0, r), p.f.v.at(q.crop_left / 2, q.crop_top / 2 + r), size_t(cw));
    }
    const size_t k = size_t(*produced);
    if (rgb) frame_to_rgb(crop, W, H, rgb + k * W * H * 3);
    if (y) std::memcpy(y + k * W * H, crop.y.px.data(), size_t(W) * H);
    if (u && v) {
      std::memcpy(u + k * cw * ch, crop.u.px.data(), size_t(cw) * ch);
      std::memcpy(v + k * cw * ch, crop.v.px.data(), size_t(cw) * ch);
    }
    ++*produced;
  };
  for (const auto& s : t.samples) d.sample(t.file.data() + s.first, s.second);
  d.flush();
}

// ---------------------------------------------------------------- encoder

// Forward DCT of 8x8 samples (orthonormal, as the IDCT above inverts).
struct Fdct {
  double m[8][8];
  Fdct() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        m[u][x] = 0.5 * (u ? 1.0 : std::sqrt(0.5)) * std::cos((2 * x + 1) * u * M_PI / 16);
  }
  void operator()(const uint8_t* src, int stride, double out[64]) const {
    double tmp[64];
    for (int y = 0; y < 8; ++y)
      for (int u = 0; u < 8; ++u) {
        double s = 0;
        for (int x = 0; x < 8; ++x) s += m[u][x] * src[y * stride + x];
        tmp[y * 8 + u] = s;
      }
    for (int v = 0; v < 8; ++v)
      for (int u = 0; u < 8; ++u) {
        double s = 0;
        for (int y = 0; y < 8; ++y) s += m[v][y] * tmp[y * 8 + u];
        out[v * 8 + u] = s;
      }
  }
};

// The RGB the encoder aims at, above the frame's own: the conversion back
// (`frame_to_rgb`, swscale's, as OpenCV reads the file) floors each of a
// channel's terms, two for red and blue and three for green, which costs
// half a level a term on average.
constexpr double kAim[3] = {1.0, 1.5, 1.0};

// One RGB frame to planes of whole macroblocks (4:2:0 limited-range BT.601,
// chroma the mean of each 2x2 block's; edges replicated past the frame).
void rgb_to_frame(const uint8_t* rgb, int width, int height, Frame& f) {
  const int W = f.y.w, H = f.y.h;
  for (int y = 0; y < H; ++y) {
    const uint8_t* row = rgb + size_t(std::min(y, height - 1)) * width * 3;
    for (int x = 0; x < W; ++x) {
      const uint8_t* p = row + 3 * std::min(x, width - 1);
      double l = 0.299 * (p[0] + kAim[0]) + 0.587 * (p[1] + kAim[1]) + 0.114 * (p[2] + kAim[2]);
      *f.y.at(x, y) = clip8(static_cast<int>(std::lrint(16 + l * 219 / 255)));
    }
  }
  for (int y = 0; y < H / 2; ++y)
    for (int x = 0; x < W / 2; ++x) {
      double cb = 0, cr = 0;
      for (int j = 0; j < 2; ++j)
        for (int i = 0; i < 2; ++i) {
          const uint8_t* p =
              rgb + (size_t(std::min(2 * y + j, height - 1)) * width + std::min(2 * x + i, width - 1)) * 3;
          const double r = p[0] + kAim[0], g = p[1] + kAim[1], b = p[2] + kAim[2];
          cb += -0.168736 * r - 0.331264 * g + 0.5 * b;
          cr += 0.5 * r - 0.418688 * g - 0.081312 * b;
        }
      *f.u.at(x, y) = clip8(static_cast<int>(std::lrint(128 + cb / 4 * 224 / 255)));
      *f.v.at(x, y) = clip8(static_cast<int>(std::lrint(128 + cr / 4 * 224 / 255)));
    }
}

void put_dc(BitWriter& w, int diff, bool luma) {
  int mag = std::abs(diff), size = 0;
  while ((1 << size) <= mag) ++size;
  const uint16_t* code = luma ? kDcLum[size] : kDcChrom[size];
  w.put(code[0], code[1]);
  if (size) {
    w.put(diff > 0 ? diff : diff + (1 << size) - 1, size);
    if (size > 8) w.put(1, 1);
  }
}

// Intra TCOEF events of a quantised block from zig-zag position 1, each by
// its VLC where the table holds it, else by the fixed-length escape (the
// two escapes that extend the table's level or run save under 2% of a
// file).
void put_coefs(BitWriter& w, const int* q) {
  const Tcoef& t = tables().intra;
  int last_pos = 0;
  for (int i = 63; i > 0; --i)
    if (q[kZigzag[i]]) {
      last_pos = i;
      break;
    }
  int run = 0;
  for (int i = 1; i <= last_pos; ++i) {
    int level = q[kZigzag[i]];
    if (!level) {
      ++run;
      continue;
    }
    const int last = i == last_pos, mag = std::abs(level), sign = level < 0;
    int e = t.find(last, run, mag);
    if (e >= 0) {
      w.put(kIntraCodes[e][0], kIntraCodes[e][1]);
      w.put(sign, 1);
    } else {
      w.put(kIntraCodes[kEscape][0], kIntraCodes[kEscape][1]);
      w.put(3, 2);
      w.put(last, 1);
      w.put(run, 6);
      w.put(1, 1);
      w.put(static_cast<uint32_t>(level) & 0xFFF, 12);
      w.put(1, 1);
    }
    run = 0;
  }
}

// One I-VOP (after its start code is written by the caller).
std::vector<uint8_t> encode_ivop(const uint8_t* rgb, int width, int height, int time_bits, int seconds,
                                 int increment) {
  static const Fdct fdct;
  const int mbw = (width + 15) / 16, mbh = (height + 15) / 16, q = kEncodeQuant;
  Frame f;
  f.resize(mbw, mbh);
  rgb_to_frame(rgb, width, height, f);
  BitWriter w;
  w.start_code(0xB6);
  w.put(0, 2);  // I-VOP
  for (int s = 0; s < seconds; ++s) w.put(1, 1);
  w.put(0, 1);
  w.put(1, 1);
  w.put(increment, time_bits);
  w.put(1, 1);
  w.put(1, 1);  // vop_coded
  w.put(0, 3);  // intra_dc_vlc_thr: DC VLCs throughout
  w.put(q, 5);
  std::vector<int> dc_y(size_t(2 * mbw + 1) * (2 * mbh + 1), 1024), dc_c[2];
  dc_c[0].assign(size_t(mbw + 1) * (mbh + 1), 1024);
  dc_c[1] = dc_c[0];
  const int qadd = (q - 1) | 1;
  for (int mby = 0; mby < mbh; ++mby)
    for (int mbx = 0; mbx < mbw; ++mbx) {
      int levels[6][64], dc_diff[6], cbp = 0;
      for (int n = 0; n < 6; ++n) {
        const uint8_t* src;
        int stride;
        if (n < 4) {
          src = f.y.at(mbx * 16 + (n & 1) * 8, mby * 16 + (n >> 1) * 8);
          stride = f.y.w;
        } else {
          const Plane& p = n == 4 ? f.u : f.v;
          src = p.at(mbx * 8, mby * 8);
          stride = p.w;
        }
        double c[64];
        fdct(src, stride, c);
        const int scale = dc_scaler(q, n < 4);
        int dc = std::clamp(static_cast<int>(std::lrint(c[0] / scale)), 1, 2047 / scale);
        int* x;
        int dstride;
        if (n < 4) {
          dstride = 2 * mbw + 1;
          x = &dc_y[size_t(2 * mby + (n >> 1) + 1) * dstride + 2 * mbx + (n & 1) + 1];
        } else {
          dstride = mbw + 1;
          x = &dc_c[n - 4][size_t(mby + 1) * dstride + mbx + 1];
        }
        int a = x[-1], b = x[-1 - dstride], cc = x[-dstride];
        int pred = ((std::abs(a - b) < std::abs(b - cc) ? cc : a) + (scale >> 1)) / scale;
        dc_diff[n] = dc - pred;
        *x = dc * scale;
        levels[n][0] = 0;
        bool any = false;
        for (int i = 1; i < 64; ++i) {
          // The level whose reconstruction (0, or 2q|L| + qadd) lies nearest.
          double mag = std::fabs(c[i]);
          int l = mag < (2 * q + qadd) / 2.0 ? 0 : std::min(2047, std::max(1, static_cast<int>((mag - qadd + q) / (2 * q))));
          levels[n][i] = c[i] < 0 ? -l : l;
          any |= l != 0;
        }
        if (any) cbp |= 1 << (5 - n);
      }
      const int cbpc = cbp & 3, cbpy = cbp >> 2;
      w.put(kIntraMcbpc[cbpc][0], kIntraMcbpc[cbpc][1]);
      w.put(0, 1);  // ac_pred_flag
      w.put(kCbpy[cbpy][0], kCbpy[cbpy][1]);
      for (int n = 0; n < 6; ++n) {
        put_dc(w, dc_diff[n], n < 4);
        if (cbp >> (5 - n) & 1) put_coefs(w, levels[n]);
      }
    }
  w.stuff();
  return std::move(w.out);
}

// The smallest Simple profile level whose macroblock count fits (L6 above).
int simple_profile_level(int mbs) {
  if (mbs <= 99) return 0x01;
  if (mbs <= 396) return 0x03;
  if (mbs <= 1200) return 0x04;
  if (mbs <= 1620) return 0x05;
  return 0x06;
}

// VOS, visual object, video object and VOL headers of an intra-only
// rectangular 8-bit stream at `resolution` ticks a second, `increment` a frame.
std::vector<uint8_t> stream_headers(int width, int height, int resolution, int increment, int time_bits) {
  BitWriter w;
  w.start_code(0xB0);
  w.put(simple_profile_level(((width + 15) / 16) * ((height + 15) / 16)), 8);
  w.start_code(0xB5);
  w.put(0, 1);  // is_visual_object_identifier
  w.put(1, 4);  // video ID
  w.put(0, 1);  // video_signal_type
  w.stuff();
  w.start_code(0x00);
  w.start_code(0x20);
  w.put(0, 1);  // random_accessible_vol
  w.put(1, 8);  // Simple object type
  w.put(1, 1);  // is_object_layer_identifier
  w.put(1, 4);  // verid 1
  w.put(1, 3);  // priority
  w.put(1, 4);  // square pixels
  w.put(1, 1);  // vol_control_parameters
  w.put(1, 2);  // 4:2:0
  w.put(1, 1);  // low_delay
  w.put(0, 1);  // no VBV parameters
  w.put(0, 2);  // rectangular
  w.put(1, 1);
  w.put(resolution, 16);
  w.put(1, 1);
  w.put(1, 1);  // fixed_vop_rate
  w.put(increment, time_bits);
  w.put(1, 1);
  w.put(width, 13);
  w.put(1, 1);
  w.put(height, 13);
  w.put(1, 1);
  w.put(0, 1);  // interlaced
  w.put(1, 1);  // obmc_disable
  w.put(0, 1);  // sprite_enable
  w.put(0, 1);  // not_8_bit
  w.put(0, 1);  // quant_type: H.263
  w.put(1, 1);  // complexity_estimation_disable
  w.put(1, 1);  // resync_marker_disable
  w.put(0, 1);  // data_partitioned
  w.put(0, 1);  // scalability
  w.stuff();
  return std::move(w.out);
}

struct BoxWriter {
  std::vector<uint8_t> b;
  std::vector<size_t> open;
  void u8(uint32_t v) { b.push_back(static_cast<uint8_t>(v)); }
  void u16(uint32_t v) { u8(v >> 8), u8(v); }
  void u32(uint32_t v) { u16(v >> 16), u16(v); }
  void tag(const char* s) { b.insert(b.end(), s, s + 4); }
  void zeros(size_t n) { b.insert(b.end(), n, 0); }
  void begin(const char* type) {
    open.push_back(b.size());
    u32(0);
    tag(type);
  }
  void full(const char* type, uint8_t version, uint32_t flags) {
    begin(type);
    u8(version);
    u8(flags >> 16), u16(flags);
  }
  void end() {
    size_t at = open.back(), size = b.size() - at;
    open.pop_back();
    for (int i = 0; i < 4; ++i) b[at + i] = static_cast<uint8_t>(size >> (24 - 8 * i));
  }
  void matrix() {
    const uint32_t m[9] = {0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000};
    for (uint32_t v : m) u32(v);
  }
  // An MPEG-4 descriptor: tag, length in four bytes, body.
  void descriptor(uint8_t t, const std::vector<uint8_t>& body) {
    u8(t);
    size_t n = body.size();
    u8(0x80 | (n >> 21 & 0x7F)), u8(0x80 | (n >> 14 & 0x7F)), u8(0x80 | (n >> 7 & 0x7F)), u8(n & 0x7F);
    b.insert(b.end(), body.begin(), body.end());
  }
};

// `resolution` and `increment` for a frame rate: the rate itself with an
// increment of 1 when it is whole, else the smallest increment up to 1001
// that makes it whole within 1e-6, else thousandths of a second.
void frame_timing(double fps, int* resolution, int* increment) {
  for (int inc = 1; inc <= 1001; ++inc) {
    double r = fps * inc;
    if (std::fabs(r - std::lrint(r)) < 1e-6 * r && std::lrint(r) < 65536) {
      *resolution = static_cast<int>(std::lrint(r));
      *increment = inc;
      return;
    }
  }
  *increment = 1000;
  *resolution = static_cast<int>(std::lrint(std::min(fps * 1000, 65535.0)));
}

int write_mp4(const char* path, const std::vector<std::vector<uint8_t>>& samples, const std::vector<uint8_t>& config,
              int width, int height, int resolution, int increment) {
  const uint32_t n = static_cast<uint32_t>(samples.size());
  uint64_t payload = 0;
  for (const auto& s : samples) payload += s.size();
  if (payload + 1024 > 0xFFFFFFF0ull) return kUnwritable;  // one 32-bit mdat and stco
  BoxWriter w;
  w.begin("ftyp");
  w.tag("isom");
  w.u32(0x200);
  w.tag("isom"), w.tag("iso2"), w.tag("mp41");
  w.end();
  w.u32(static_cast<uint32_t>(8 + payload));
  w.tag("mdat");
  const uint32_t first = static_cast<uint32_t>(w.b.size());
  for (const auto& s : samples) w.b.insert(w.b.end(), s.begin(), s.end());
  const uint64_t media_duration = uint64_t(n) * increment;
  const uint32_t movie_duration = static_cast<uint32_t>(media_duration * 1000 / resolution);
  w.begin("moov");
  w.full("mvhd", 0, 0);
  w.u32(0), w.u32(0), w.u32(1000), w.u32(movie_duration);
  w.u32(0x10000), w.u16(0x100), w.zeros(10);
  w.matrix();
  w.zeros(24);
  w.u32(2);
  w.end();
  w.begin("trak");
  w.full("tkhd", 0, 3);
  w.u32(0), w.u32(0), w.u32(1), w.u32(0), w.u32(movie_duration);
  w.zeros(8);
  w.u16(0), w.u16(0), w.u16(0), w.u16(0);
  w.matrix();
  w.u32(uint32_t(width) << 16), w.u32(uint32_t(height) << 16);
  w.end();
  w.begin("mdia");
  w.full("mdhd", 0, 0);
  w.u32(0), w.u32(0), w.u32(resolution), w.u32(static_cast<uint32_t>(media_duration));
  w.u16(0x55C4), w.u16(0);  // "und"
  w.end();
  w.full("hdlr", 0, 0);
  w.u32(0);
  w.tag("vide");
  w.zeros(12);
  const char name[] = "VideoHandler";
  w.b.insert(w.b.end(), name, name + sizeof(name));
  w.end();
  w.begin("minf");
  w.full("vmhd", 0, 1);
  w.zeros(8);
  w.end();
  w.begin("dinf");
  w.full("dref", 0, 0);
  w.u32(1);
  w.full("url ", 0, 1);
  w.end();
  w.end();
  w.end();
  w.begin("stbl");
  w.full("stsd", 0, 0);
  w.u32(1);
  w.begin("mp4v");
  w.zeros(6), w.u16(1);
  w.zeros(16);
  w.u16(width), w.u16(height);
  w.u32(0x480000), w.u32(0x480000), w.u32(0), w.u16(1);
  w.zeros(32);
  w.u16(0x18), w.u16(0xFFFF);
  w.full("esds", 0, 0);
  {
    BoxWriter d;
    d.descriptor(0x05, config);
    BoxWriter dcd;
    dcd.u8(0x20);  // MPEG-4 Visual
    dcd.u8(0x11);  // visual stream
    dcd.u8(0), dcd.u16(0);
    dcd.u32(0), dcd.u32(0);
    dcd.b.insert(dcd.b.end(), d.b.begin(), d.b.end());
    BoxWriter es;
    es.u16(1), es.u8(0);
    es.descriptor(0x04, dcd.b);
    es.descriptor(0x06, {0x02});
    w.descriptor(0x03, es.b);
  }
  w.end();  // esds
  w.end();  // mp4v
  w.end();  // stsd
  w.full("stts", 0, 0);
  w.u32(1), w.u32(n), w.u32(increment);
  w.end();
  w.full("stss", 0, 0);
  w.u32(n);
  for (uint32_t i = 1; i <= n; ++i) w.u32(i);
  w.end();
  w.full("stsc", 0, 0);
  w.u32(1), w.u32(1), w.u32(n), w.u32(1);
  w.end();
  w.full("stsz", 0, 0);
  w.u32(0), w.u32(n);
  for (const auto& s : samples) w.u32(static_cast<uint32_t>(s.size()));
  w.end();
  w.full("stco", 0, 0);
  w.u32(1), w.u32(first);
  w.end();
  w.end();  // stbl
  w.end();  // minf
  w.end();  // mdia
  w.end();  // trak
  w.end();  // moov
  FILE* f = std::fopen(path, "wb");
  if (!f) return kUnwritable;
  bool ok = std::fwrite(w.b.data(), 1, w.b.size(), f) == w.b.size();
  ok = (std::fclose(f) == 0) && ok;
  return ok ? kOk : kUnwritable;
}

}  // namespace

extern "C" {

// Frames (samples), size (from the VOL, or the H.264 SPS's cropping window)
// and frames a second of the video track of an MP4; a status (0 = ok).
int evt_mp4_info(const char* path, int* frames, int* height, int* width, double* fps) {
  try {
    Track t = open_mp4(path);
    if (is_avc(t)) {
      avc_size(t, height, width);
    } else {
      Vol v = find_vol(t);
      *height = v.height;
      *width = v.width;
    }
    *frames = static_cast<int>(t.samples.size());
    *fps = track_fps(t);
    return kOk;
  } catch (const Fail& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kCorrupt;
  }
}

// Decodes up to `max_frames` frames of the MP4, whose VOL or SPS must give
// height x width (the buffers' size), into rgb (frames x H x W x 3), and,
// where given, their planes into y (frames x H x W) and u, v (frames x
// ceil(H / 2) x ceil(W / 2)); *produced gets the frame count.
int evt_read_mp4(const char* path, uint8_t* rgb, uint8_t* y, uint8_t* u, uint8_t* v, int max_frames, int height,
                 int width, int* produced) {
  *produced = 0;
  try {
    Track t = open_mp4(path);
    if (is_avc(t)) {
      read_avc(t, rgb, y, u, v, max_frames, height, width, produced);
      return kOk;
    }
    Decoder dec;
    if (!t.config.empty()) dec.decode_sample(t.config.data(), t.config.size());
    if (!dec.vol.have) dec.set_vol(find_vol(t));
    const int W = dec.vol.width, H = dec.vol.height, cw = (W + 1) / 2, ch = (H + 1) / 2;
    if (W != width || H != height) fail(kCorrupt);  // not the file mp4_info read
    for (const auto& s : t.samples) {
      if (*produced >= max_frames) break;
      if (!dec.decode_sample(t.file.data() + s.first, s.second)) continue;
      const size_t k = size_t(*produced);
      if (dec.vol.width != W || dec.vol.height != H) fail(kCorrupt);
      if (rgb) frame_to_rgb(dec.cur, W, H, rgb + k * W * H * 3);
      if (y)
        for (int r = 0; r < H; ++r) std::memcpy(y + (k * H + r) * W, dec.cur.y.at(0, r), W);
      if (u && v)
        for (int r = 0; r < ch; ++r) {
          std::memcpy(u + (k * ch + r) * cw, dec.cur.u.at(0, r), cw);
          std::memcpy(v + (k * ch + r) * cw, dec.cur.v.at(0, r), cw);
        }
      ++*produced;
    }
    return kOk;
  } catch (const Fail& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kCorrupt;
  }
}

// Encodes n RGB frames (n x H x W x 3) as I-VOPs on n_threads threads and
// writes them to an MP4 at `fps` frames a second; a status.
int evt_save_mp4(const char* path, const uint8_t* rgb, int n, int height, int width, double fps, int n_threads) {
  if (n < 1 || height < 1 || width < 1 || height > 8191 || width > 8191 || !(fps > 0)) return kUnwritable;
  try {
    int resolution, increment;
    frame_timing(fps, &resolution, &increment);
    int time_bits = 1;
    while ((1 << time_bits) < resolution) ++time_bits;
    std::vector<std::vector<uint8_t>> samples(n);
    std::atomic<int> next{0};
    auto work = [&] {
      for (int i; (i = next++) < n;) {
        const int64_t ticks = int64_t(i) * increment, prev = i ? int64_t(i - 1) * increment : 0;
        samples[i] = encode_ivop(rgb + size_t(i) * height * width * 3, width, height, time_bits,
                                 static_cast<int>(ticks / resolution - prev / resolution),
                                 static_cast<int>(ticks % resolution));
      }
    };
    std::vector<std::thread> pool;
    for (int i = 1; i < std::min(n_threads, n); ++i) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
    return write_mp4(path, samples, stream_headers(width, height, resolution, increment, time_bits), width, height,
                     resolution, increment);
  } catch (const Fail& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kUnwritable;
  }
}

}  // extern "C"
