// Image IO of the episode data path: PNG and JPEG decode, bilinear resize to
// float, PNG encode, each over a batch on a pool of threads. A plain C
// interface, loaded with ctypes by evoworld_tpu_torch/data/native_io.py and
// built at first use with g++ (-lz) by ops/_build.py.
//
// The port's own copy of what it needs from native/imageio.cpp (the JAX
// package's loader, built on libpng and libjpeg): the half-pixel bilinear
// resize without antialiasing (`resize_to_float`, the same arithmetic), the
// PNG writer at compression level 1 with no row filter, and libjpeg's default
// JPEG decode. The H100 machine the port runs on has zlib (zlib.h, libz) but
// neither libpng nor libjpeg, so both formats are decoded here: PNG on zlib
// (the chunks are parsed, the IDAT stream inflated and the five row filters
// undone; the writer deflates unfiltered rows into one IDAT chunk), JPEG with
// no library at all, in libjpeg's own integer arithmetic (namespace jpg,
// below). A file is a PNG by its signature and a JPEG by its SOI marker,
// whatever its name; anything else fails with status kNotImage, and the
// Python wrapper raises an error naming the file and the status.
//
// PNG variants read: colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey +
// alpha), 6 (RGBA) at 8 or 16 bits, palette and grey also at 1, 2, 4 bits;
// plain or Adam7-interlaced (each of the seven passes un-filtered as an
// image of its own, then scattered into place, as libpng de-interlaces). As
// libpng with the JAX loader's transforms: 16-bit samples keep their high
// byte (png_set_strip_16), grey is replicated to RGB and alpha dropped
// without compositing (png_set_strip_alpha).

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// The JPEG decoder's own refusals follow these (jpg::JpegStatus, 5..10).
enum Status { kOk = 0, kOpenFailed = 1, kNotImage = 2, kBadPng = 3, kWriteFailed = 4 };

struct Image {
  std::vector<uint8_t> rgb;  // H*W*3
  int h = 0, w = 0;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(uint8_t(v >> 24));
  out.push_back(uint8_t(v >> 16));
  out.push_back(uint8_t(v >> 8));
  out.push_back(uint8_t(v));
}

const uint8_t kSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};

bool read_file(const char* path, std::vector<uint8_t>& bytes) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), fp)) > 0) bytes.insert(bytes.end(), buf, buf + n);
  const bool ok = !ferror(fp);
  fclose(fp);
  return ok;
}

uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return pb <= pc ? uint8_t(b) : uint8_t(c);
}

// Undo the row filters in place: `raw` holds h rows of 1 filter byte +
// `stride` bytes; `bpp` is the filter's byte distance (at least 1).
bool unfilter(uint8_t* raw, int h, size_t stride, int bpp) {
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw + size_t(y) * (stride + 1);
    const uint8_t type = row[0];
    uint8_t* cur = row + 1;
    const uint8_t* prev = y > 0 ? raw + size_t(y - 1) * (stride + 1) + 1 : nullptr;
    for (size_t i = 0; i < stride; ++i) {
      const int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = prev && i >= size_t(bpp) ? prev[i - bpp] : 0;
      switch (type) {
        case 0: break;
        case 1: cur[i] = uint8_t(cur[i] + a); break;
        case 2: cur[i] = uint8_t(cur[i] + b); break;
        case 3: cur[i] = uint8_t(cur[i] + ((a + b) >> 1)); break;
        case 4: cur[i] = uint8_t(cur[i] + paeth(a, b, c)); break;
        default: return false;
      }
    }
  }
  return true;
}

// `bytes` begin with the PNG signature.
int decode_png(const std::vector<uint8_t>& bytes, Image& out) {
  int depth = 0, color = -1, interlace = 0;
  std::vector<uint8_t> idat, palette;
  size_t at = 8;
  bool ended = false;
  while (!ended && at + 12 <= bytes.size()) {
    const uint32_t len = be32(&bytes[at]);
    if (at + 12 + size_t(len) > bytes.size()) return kBadPng;
    const uint8_t* type = &bytes[at + 4];
    const uint8_t* data = &bytes[at + 8];
    if (memcmp(type, "IHDR", 4) == 0 && len >= 13) {
      out.w = int(be32(data));
      out.h = int(be32(data + 4));
      depth = data[8];
      color = data[9];
      interlace = data[12];
    } else if (memcmp(type, "PLTE", 4) == 0) {
      palette.assign(data, data + len);
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      ended = true;
    }
    at += 12 + size_t(len);
  }
  // A header from outside the program: sizes past 2^16 a side are refused before any allocation.
  if (out.w <= 0 || out.h <= 0 || out.w > (1 << 16) || out.h > (1 << 16) || interlace > 1 || idat.empty()) {
    return kBadPng;
  }
  int channels;
  switch (color) {
    case 0: case 3: channels = 1; break;
    case 2: channels = 3; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: return kBadPng;
  }
  const bool low = depth == 1 || depth == 2 || depth == 4;
  if (!(depth == 8 || depth == 16 || (low && (color == 0 || color == 3)))) return kBadPng;
  if (color == 3 && (depth == 16 || palette.size() < 3)) return kBadPng;

  // The passes of the scan, each (x0, y0, dx, dy): the whole image, or
  // Adam7's seven. Each pass is a sub-image of its own rows (filter byte +
  // stride bytes, a sub-byte row rounded up to whole bytes) and filters;
  // an empty pass has no bytes at all.
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  const int (*passes)[4] = interlace ? kAdam7 : kWhole;
  const int n_passes = interlace ? 7 : 1;
  int pass_w[7], pass_h[7];
  size_t pass_stride[7], total = 0;
  for (int p = 0; p < n_passes; ++p) {
    pass_w[p] = (out.w - passes[p][0] + passes[p][2] - 1) / passes[p][2];
    pass_h[p] = (out.h - passes[p][1] + passes[p][3] - 1) / passes[p][3];
    if (pass_w[p] <= 0 || pass_h[p] <= 0) pass_w[p] = pass_h[p] = 0;
    pass_stride[p] = (size_t(pass_w[p]) * channels * depth + 7) / 8;
    total += size_t(pass_h[p]) * (pass_stride[p] + (pass_w[p] > 0));
  }
  const int bpp = depth < 8 ? 1 : channels * depth / 8;
  std::vector<uint8_t> raw(total);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK || raw_len != raw.size()) return kBadPng;

  out.rgb.resize(size_t(out.h) * out.w * 3);
  const int step = depth == 16 ? 2 : 1;  // a 16-bit sample keeps its high byte
  uint8_t* pass_raw = raw.data();
  for (int p = 0; p < n_passes; ++p) {
    if (!pass_w[p]) continue;
    const size_t stride = pass_stride[p];
    uint8_t* rows = pass_raw;
    pass_raw += size_t(pass_h[p]) * (stride + 1);
    if (!unfilter(rows, pass_h[p], stride, bpp)) return kBadPng;
    for (int y = 0; y < pass_h[p]; ++y) {
      const uint8_t* row = rows + size_t(y) * (stride + 1) + 1;
      uint8_t* dst = out.rgb.data() + (size_t(passes[p][1] + y * passes[p][3]) * out.w + passes[p][0]) * 3;
      const size_t dst_step = size_t(passes[p][2]) * 3;
      for (int x = 0; x < pass_w[p]; ++x, dst += dst_step) {
        uint8_t r, g, b;
        if (low) {
          const int per_byte = 8 / depth;
          const int v = (row[x / per_byte] >> ((per_byte - 1 - x % per_byte) * depth)) & ((1 << depth) - 1);
          if (color == 3) {
            if (size_t(v) * 3 + 2 >= palette.size()) return kBadPng;
            r = palette[v * 3], g = palette[v * 3 + 1], b = palette[v * 3 + 2];
          } else {
            r = g = b = uint8_t(v * 255 / ((1 << depth) - 1));
          }
        } else {
          const uint8_t* px = row + size_t(x) * channels * step;
          if (color == 3) {
            if (size_t(px[0]) * 3 + 2 >= palette.size()) return kBadPng;
            r = palette[px[0] * 3], g = palette[px[0] * 3 + 1], b = palette[px[0] * 3 + 2];
          } else if (channels >= 3) {
            r = px[0], g = px[step], b = px[2 * step];
          } else {
            r = g = b = px[0];
          }
        }
        dst[0] = r, dst[1] = g, dst[2] = b;
      }
    }
  }
  return kOk;
}

// ---------------------------------------------------------------------------
// JPEG: libjpeg's default decode to RGB (jpeg_read_header, out_color_space =
// JCS_RGB, jpeg_start_decompress), as native/imageio.cpp and PIL call it, in
// the same integer arithmetic, so that both give the same bytes:
//   - Huffman-coded 8-bit frames, sequential (SOF0, SOF1) or progressive
//     (SOF2: spectral selection and successive approximation, jdphuff.c), with
//     restart intervals; every coefficient is kept until the end of the file
//     and each block is transformed once;
//   - the "islow" inverse DCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2) and
//     its range limit (jdmaster.c's table: the result wraps in 10 bits, then
//     clamps), after dequantizing with the table each component held at its
//     first scan;
//   - jdsample.c's fancy upsampling of chroma at 2:1 across (h2v1) or 2:1
//     both ways (h2v2): the triangle filter with biases 1, 2 (h2v1) and 8, 7
//     (h2v2), rows above the first and below the last repeating those rows
//     and columns past either edge repeating the edge; components no wider
//     than 2 samples are replicated instead, as jdsample.c does;
//   - jdcolor.c's YCbCr -> RGB in 16-bit fixed point (SCALEBITS 16, tables
//     rounded as there); grey is replicated; three components are YCbCr
//     unless an Adobe marker (transform 0) or component ids 'R', 'G', 'B'
//     without a JFIF marker say RGB (jdapimin.c's rule).
// Refused, each with its own status: arithmetic coding (SOF9-15, DAC),
// lossless, hierarchical and 12-bit frames (SOF3, SOF5-7, precision other than
// 8), component counts other than 1 and 3 (CMYK and YCCK have 4: decode_jpeg
// with JCS_RGB cannot convert them either), sampling other than 4:4:4, 4:2:2
// and 4:2:0, and progressive files whose scans leave any of coefficients 0-9
// unrefined (libjpeg then smooths the blocks, by rules that differ between
// its versions). Corrupt or truncated data (a bad Huffman code, a scan that
// needs bits past its end, a missing EOI) fails as well; libjpeg would fill
// in zeros and warn. So does a Huffman table that libjpeg refuses too.

namespace jpg {

// Zigzag position -> natural (row-major) index, with 16 entries of 63 past
// the end so that a corrupt run stays inside the block (jpeg_natural_order).
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLook = 9;  // bits of the Huffman lookahead table

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int maxcode[17];  // the largest code of each length, -1 where there is none
  int valoff[17];   // vals index of a code of that length, minus the code
  uint16_t look[1 << kLook];  // (length << 8) | value of each code of at most kLook bits, 0 where longer
};

// jdhuff.c's canonical code assignment and its checks (jpeg_make_d_derived_tbl):
// no code may outgrow its length or be all ones, and a DC table's symbols are
// magnitude categories of at most 15 bits. Each code is checked before it is
// placed, so an oversubscribed table never writes past `look`.
bool build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* vals, int n_vals, bool is_dc) {
  if (is_dc) {
    for (int k = 0; k < n_vals; ++k) {
      if (vals[k] > 15) return false;
    }
  }
  memcpy(t.vals, vals, n_vals);
  memset(t.look, 0, sizeof(t.look));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    t.valoff[len] = k - code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      if (code >= (1 << len)) return false;
      if (len <= kLook) {
        const int shift = kLook - len;
        for (int j = 0; j < (1 << shift); ++j) t.look[(code << shift) | j] = uint16_t((len << 8) | vals[k]);
      }
    }
    t.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    if (code >= (1 << len)) return false;
    code <<= 1;
  }
  t.defined = true;
  return true;
}

// Entropy-coded bits: 0xFF 0x00 is a data byte 0xFF, and at a marker (0xFF
// followed by anything else) the reader stops and supplies zero bits, counting
// whether a decode consumed any of them (`overrun`).
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // n bits, left-aligned
  int n = 0;
  int pad = 0;  // bits at the tail of acc that are not data
  bool at_marker = false;
  bool overrun = false;

  void fill() {
    while (n <= 56) {
      uint32_t byte = 0;
      bool data = false;
      if (!at_marker && p < end) {
        byte = *p;
        if (byte != 0xFF) {
          ++p;
          data = true;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes
          if (q < end && *q == 0x00) {
            p = q + 1;
            data = true;
          } else {
            at_marker = true;  // p stays on the 0xFF before the marker's code
            p = q - 1;
            byte = 0;
          }
        }
      }
      if (!data) pad += 8;
      acc |= uint64_t(byte) << (56 - n);
      n += 8;
    }
  }
  void skip(int k) {
    acc <<= k;
    n -= k;
    if (n < pad) {
      overrun = true;
      pad = n;
    }
  }
  int get(int k) {  // k in 0..16
    if (k == 0) return 0;
    if (n < k) fill();
    const int v = int(acc >> (64 - k));
    skip(k);
    return v;
  }
  int bit() { return get(1); }
  int decode(const Huffman& t) {
    if (n < 16) fill();
    const uint32_t peek = uint32_t(acc >> 48);
    const int e = t.look[peek >> (16 - kLook)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int len = kLook + 1; len <= 16; ++len) {
      const int code = int(peek >> (16 - len));
      if (code <= t.maxcode[len]) {
        skip(len);
        return t.vals[t.valoff[len] + code];
      }
    }
    overrun = true;  // no code matches: corrupt data
    return 0;
  }
  // Drops the buffered bits and moves p to the next marker's 0xFF; false at the end of the data.
  bool to_marker() {
    acc = 0;
    n = pad = 0;
    if (!at_marker) {
      for (; p + 1 < end; ++p) {
        if (p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF) break;
      }
      if (p + 1 >= end) return false;
    }
    at_marker = false;
    return true;
  }
};

// HUFF_EXTEND: the signed value of an s-bit magnitude category.
inline int extend(int r, int s) { return s == 0 ? 0 : (r < (1 << (s - 1)) ? r - (1 << s) + 1 : r); }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_table = 0, ac_table = 0;
  int blocks_w = 0, blocks_h = 0;  // allocated (whole MCUs of an interleaved scan)
  int width_in_blocks = 0, height_in_blocks = 0;  // a non-interleaved scan's extent
  int down_w = 0, down_h = 0;  // samples (jdinput.c's downsampled_width / height)
  std::vector<int16_t> coef;   // blocks_h x blocks_w blocks of 64, natural order
  int dc_pred = 0;
  bool latched = false;
  uint16_t q[64];             // the quantization table at the component's first scan, natural order
  int coef_bits[64];          // progressive: the last successive-approximation bit, -1 before any scan
  std::vector<uint8_t> plane;  // samples, (blocks_h * 8) x (blocks_w * 8)

  int16_t* block(int by, int bx) { return coef.data() + (size_t(by) * blocks_w + bx) * 64; }
};

enum JpegStatus { kJpegBad = 5, kJpegArithmetic = 6, kJpegNotDct8 = 7, kJpegComponents = 8, kJpegSampling = 9,
                  kJpegUnrefined = 10 };

struct Decoder {
  const uint8_t* data;
  size_t size;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool progressive = false, have_frame = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcus_w = 0, mcus_h = 0;
  std::vector<Component> comps;
  int scans = 0;
};

int parse_sof(Decoder& d, const uint8_t* s, int len) {
  if (d.have_frame || len < 6) return kJpegBad;
  if (s[0] != 8) return kJpegNotDct8;
  d.height = (s[1] << 8) | s[2];
  d.width = (s[3] << 8) | s[4];
  const int nc = s[5];
  if (d.width == 0 || d.height == 0 || nc == 0 || len < 6 + 3 * nc) return kJpegBad;  // no DNL
  d.comps.resize(nc);
  for (int i = 0; i < nc; ++i) {
    Component& c = d.comps[i];
    c.id = s[6 + 3 * i];
    c.h = s[7 + 3 * i] >> 4;
    c.v = s[7 + 3 * i] & 15;
    c.tq = s[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return kJpegBad;
    d.hmax = std::max(d.hmax, c.h);
    d.vmax = std::max(d.vmax, c.v);
  }
  if (nc != 1 && nc != 3) return kJpegComponents;
  if (nc == 3) {
    for (const Component& c : d.comps) {
      const int rh = d.hmax / c.h, rv = d.vmax / c.v;
      const bool ok = d.hmax % c.h == 0 && d.vmax % c.v == 0 && ((rh == 1 && rv == 1) || (rh == 2 && rv <= 2));
      if (!ok) return kJpegSampling;
    }
  }
  d.mcus_w = (d.width + 8 * d.hmax - 1) / (8 * d.hmax);
  d.mcus_h = (d.height + 8 * d.vmax - 1) / (8 * d.vmax);
  for (Component& c : d.comps) {
    c.down_w = int((int64_t(d.width) * c.h + d.hmax - 1) / d.hmax);
    c.down_h = int((int64_t(d.height) * c.v + d.vmax - 1) / d.vmax);
    c.width_in_blocks = (c.down_w + 7) / 8;
    c.height_in_blocks = (c.down_h + 7) / 8;
    c.blocks_w = d.mcus_w * c.h;
    c.blocks_h = d.mcus_h * c.v;
    c.coef.assign(size_t(c.blocks_w) * c.blocks_h * 64, 0);
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
  }
  d.have_frame = true;
  return kOk;
}

// Adds a DC difference to the component's predictor. A sum past int's range
// (only corrupt data reaches it) marks the scan corrupt, as libjpeg-turbo's
// JERR_BAD_DCT_COEF does, instead of overflowing.
void add_dc(Bits& br, Component& c, int diff) {
  const int64_t sum = int64_t(c.dc_pred) + diff;
  if (sum > INT32_MAX || sum < INT32_MIN) {
    br.overrun = true;
    return;
  }
  c.dc_pred = int(sum);
}

// One block of a sequential scan (jdhuff.c decode_mcu).
void decode_sequential_block(Bits& br, Component& c, int16_t* blk, const Huffman& dct, const Huffman& act) {
  const int s = br.decode(dct);
  add_dc(br, c, extend(br.get(s), s));
  blk[0] = int16_t(c.dc_pred);
  for (int k = 1; k < 64; ++k) {
    const int rs = br.decode(act);
    const int r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      blk[kNatural[k]] = int16_t(extend(br.get(sz), sz));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// The blocks of one scan of a progressive frame (jdphuff.c's four decoders).
struct Progressive {
  int ss, se, ah, al;
  int eobrun = 0;

  void dc_block(Bits& br, Component& c, int16_t* blk, const Huffman& dct) {
    if (ah == 0) {
      const int s = br.decode(dct);
      add_dc(br, c, extend(br.get(s), s));
      blk[0] = int16_t(int64_t(c.dc_pred) * (1 << al));
    } else if (br.bit()) {
      blk[0] = int16_t(blk[0] | (1 << al));
    }
  }

  void ac_first(Bits& br, int16_t* blk, const Huffman& act) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = br.decode(act);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.get(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  // Returns false on a coefficient of a size other than 1 (corrupt data).
  bool ac_refine(Bits& br, int16_t* blk, const Huffman& act) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (br.bit() && (coef & p1) == 0) coef = int16_t(coef >= 0 ? coef + p1 : coef + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) return false;
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
    return true;
  }
};

// One scan: its header at s (len bytes), its entropy-coded data from `pos`.
// Returns a status and leaves `pos` at the marker after the data.
int decode_scan(Decoder& d, const uint8_t* s, int len, size_t& pos) {
  if (!d.have_frame || len < 1) return kJpegBad;
  const int ns = s[0];
  if (ns < 1 || ns > 4 || len < 4 + 2 * ns) return kJpegBad;
  Component* sc[4];
  for (int i = 0; i < ns; ++i) {
    sc[i] = nullptr;
    for (Component& c : d.comps) {
      if (c.id == s[1 + 2 * i]) sc[i] = &c;
    }
    if (sc[i] == nullptr) return kJpegBad;
    sc[i]->dc_table = s[2 + 2 * i] >> 4;
    sc[i]->ac_table = s[2 + 2 * i] & 15;
    if (sc[i]->dc_table > 3 || sc[i]->ac_table > 3) return kJpegBad;
  }
  Progressive pg{s[1 + 2 * ns], s[2 + 2 * ns], s[3 + 2 * ns] >> 4, s[3 + 2 * ns] & 15};
  bool needs_dc = true, needs_ac = true;
  if (d.progressive) {
    const bool dc_band = pg.ss == 0;
    bool bad = dc_band ? pg.se != 0 : (pg.ss > pg.se || pg.se > 63 || ns != 1);
    if (pg.ah != 0 && pg.al != pg.ah - 1) bad = true;
    if (pg.al > 13) bad = true;
    if (bad) return kJpegBad;
    needs_dc = dc_band && pg.ah == 0;
    needs_ac = !dc_band;
    // jdphuff.c's progression check (a warning there): each coefficient's
    // first scan has Ah = 0, each refinement continues the last scan's Al.
    for (int i = 0; i < ns; ++i) {
      if (!dc_band && sc[i]->coef_bits[0] < 0) return kJpegBad;
      for (int k = pg.ss; k <= pg.se; ++k) {
        const int expected = sc[i]->coef_bits[k] < 0 ? 0 : sc[i]->coef_bits[k];
        if (pg.ah != expected) return kJpegBad;
        sc[i]->coef_bits[k] = pg.al;
      }
    }
  }
  for (int i = 0; i < ns; ++i) {
    Component& c = *sc[i];
    if ((needs_dc && !d.dc[c.dc_table].defined) || (needs_ac && !d.ac[c.ac_table].defined)) return kJpegBad;
    if (!c.latched) {  // jdinput.c latch_quant_tables: the table in force at the first scan
      if (!d.qt_defined[c.tq]) return kJpegBad;
      memcpy(c.q, d.qt[c.tq], sizeof(c.q));
      c.latched = true;
    }
    c.dc_pred = 0;
  }

  Bits br{d.data + pos, d.data + d.size};
  const bool interleaved = ns > 1;
  const int mcus_w = interleaved ? d.mcus_w : sc[0]->width_in_blocks;
  const int mcus_h = interleaved ? d.mcus_h : sc[0]->height_in_blocks;
  const int64_t n_mcus = int64_t(mcus_w) * mcus_h;
  int next_rst = 0;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (d.restart_interval && m > 0 && m % d.restart_interval == 0) {
      // jdhuff.c process_restart: the interval's leftover bits go, RSTn follows.
      if (!br.to_marker() || br.p[1] != 0xD0 + next_rst) return kJpegBad;
      br.p += 2;
      next_rst = (next_rst + 1) & 7;
      for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
      pg.eobrun = 0;
    }
    const int my = int(m / mcus_w), mx = int(m % mcus_w);
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      const int bv = interleaved ? c.v : 1, bh = interleaved ? c.h : 1;
      for (int v = 0; v < bv; ++v) {
        for (int u = 0; u < bh; ++u) {
          int16_t* blk = c.block(my * bv + v, mx * bh + u);
          if (!d.progressive) {
            decode_sequential_block(br, c, blk, d.dc[c.dc_table], d.ac[c.ac_table]);
          } else if (pg.ss == 0) {
            pg.dc_block(br, c, blk, d.dc[c.dc_table]);
          } else if (pg.ah == 0) {
            pg.ac_first(br, blk, d.ac[c.ac_table]);
          } else if (!pg.ac_refine(br, blk, d.ac[c.ac_table])) {
            return kJpegBad;
          }
        }
      }
    }
    if (br.overrun) return kJpegBad;
  }
  if (!br.to_marker()) return kJpegBad;
  pos = size_t(br.p - d.data);
  ++d.scans;
  return kOk;
}

// jdmaster.c's post-IDCT range limit: the descaled value wraps in 10 bits, then clamps to 0..255.
inline uint8_t idct_limit(int64_t x) {
  const int v = int(x & 1023);
  return v < 128 ? uint8_t(v + 128) : v < 512 ? 255 : v < 896 ? 0 : uint8_t(v - 896);
}

// jidctint.c jpeg_idct_islow: dequantize, columns then rows, descale, range limit.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  constexpr int kConst = 13, kPass1 = 2;
  auto descale = [](int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; };
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* col = in + c;
    const uint16_t* qc = q + c;
    int64_t* w = ws + c;
    if (col[8] == 0 && col[16] == 0 && col[24] == 0 && col[32] == 0 && col[40] == 0 && col[48] == 0 && col[56] == 0) {
      const int64_t dc = int64_t(col[0] * qc[0]) * (1 << kPass1);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = col[16] * qc[16], z3 = col[48] * qc[48];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137, tmp3 = z1 + z2 * 6270;
    z2 = col[0] * qc[0];
    z3 = col[32] * qc[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConst), tmp1 = (z2 - z3) * (1 << kConst);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = col[56] * qc[56];
    tmp1 = col[40] * qc[40];
    tmp2 = col[24] * qc[24];
    tmp3 = col[8] * qc[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 = z3 * -16069 + z5;
    z4 = z4 * -3196 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = descale(tmp10 + tmp3, kConst - kPass1);
    w[56] = descale(tmp10 - tmp3, kConst - kPass1);
    w[8] = descale(tmp11 + tmp2, kConst - kPass1);
    w[48] = descale(tmp11 - tmp2, kConst - kPass1);
    w[16] = descale(tmp12 + tmp1, kConst - kPass1);
    w[40] = descale(tmp12 - tmp1, kConst - kPass1);
    w[24] = descale(tmp13 + tmp0, kConst - kPass1);
    w[32] = descale(tmp13 - tmp0, kConst - kPass1);
  }
  for (int r = 0; r < 8; ++r) {
    const int64_t* w = ws + 8 * r;
    uint8_t* o = out + size_t(r) * stride;
    constexpr int kOut = kConst + kPass1 + 3;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137, tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = (w[0] + w[4]) * (1 << kConst), tmp1 = (w[0] - w[4]) * (1 << kConst);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 = z3 * -16069 + z5;
    z4 = z4 * -3196 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_limit(descale(tmp10 + tmp3, kOut));
    o[7] = idct_limit(descale(tmp10 - tmp3, kOut));
    o[1] = idct_limit(descale(tmp11 + tmp2, kOut));
    o[6] = idct_limit(descale(tmp11 - tmp2, kOut));
    o[2] = idct_limit(descale(tmp12 + tmp1, kOut));
    o[5] = idct_limit(descale(tmp12 - tmp1, kOut));
    o[3] = idct_limit(descale(tmp13 + tmp0, kOut));
    o[4] = idct_limit(descale(tmp13 - tmp0, kOut));
  }
}

// jdcolor.c's tables: R = Y + Cr_r[Cr], G = Y + ((Cb_g[Cb] + Cr_g[Cr]) >> 16), B = Y + Cb_b[Cb].
struct ColorTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  ColorTables() {
    constexpr int kScale = 16;
    auto fix = [](double x) { return int(x * (1 << kScale) + 0.5); };
    const int one_half = 1 << (kScale - 1);
    for (int i = 0; i < 256; ++i) {
      const int x = i - 128;
      cr_r[i] = (fix(1.40200) * x + one_half) >> kScale;
      cb_b[i] = (fix(1.77200) * x + one_half) >> kScale;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

inline uint8_t clamp255(int x) { return uint8_t(x < 0 ? 0 : x > 255 ? 255 : x); }

// Row y of component c at the output's full width, upsampled as jdsample.c
// does (into `row`, at least 2 * c.down_w + 1 bytes).
void upsampled_row(const Decoder& d, const Component& c, int y, uint8_t* row) {
  const int pw = c.blocks_w * 8;
  const int rh = d.hmax / c.h, rv = d.vmax / c.v;
  if (rh == 1 && rv == 1) {
    memcpy(row, &c.plane[size_t(y) * pw], size_t(d.width));
    return;
  }
  const int in_y = y / rv;
  const uint8_t* near = &c.plane[size_t(in_y) * pw];
  const int dw = c.down_w;
  if (dw <= 2) {  // h2v1_upsample / h2v2_upsample: replication
    for (int x = 0; x < 2 * dw; ++x) row[x] = near[x / 2];
    return;
  }
  if (rv == 1) {  // h2v1_fancy_upsample
    for (int i = 0; i < dw; ++i) {
      const int cur = near[i] * 3;
      const int left = near[i > 0 ? i - 1 : 0], right = near[i + 1 < dw ? i + 1 : dw - 1];
      row[2 * i] = uint8_t((cur + left + 1) >> 2);
      row[2 * i + 1] = uint8_t((cur + right + 2) >> 2);
    }
    return;
  }
  // h2v2_fancy_upsample: the other row is above for an even output row,
  // below for an odd one, clamped to the component's rows.
  const int other_y = y % 2 == 0 ? std::max(in_y - 1, 0) : std::min(in_y + 1, c.down_h - 1);
  const uint8_t* far = &c.plane[size_t(other_y) * pw];
  auto colsum = [&](int i) { return near[i] * 3 + far[i]; };
  for (int i = 0; i < dw; ++i) {
    const int cur = colsum(i) * 3;
    row[2 * i] = uint8_t((cur + colsum(i > 0 ? i - 1 : 0) + 8) >> 4);
    row[2 * i + 1] = uint8_t((cur + colsum(i + 1 < dw ? i + 1 : dw - 1) + 7) >> 4);
  }
}

int finish(Decoder& d, Image& out) {
  if (!d.have_frame || d.scans == 0) return kJpegBad;
  for (Component& c : d.comps) {
    if (!c.latched) return kJpegBad;  // a component no scan covered
    if (d.progressive) {
      for (int k = 0; k < 10; ++k) {
        if (c.coef_bits[k] != 0) return kJpegUnrefined;
      }
    }
    const int pw = c.blocks_w * 8;
    c.plane.resize(size_t(pw) * c.blocks_h * 8);
    for (int by = 0; by < c.blocks_h; ++by) {
      for (int bx = 0; bx < c.blocks_w; ++bx) {
        idct_islow(c.block(by, bx), c.q, &c.plane[size_t(by) * 8 * pw + bx * 8], pw);
      }
    }
    std::vector<int16_t>().swap(c.coef);
  }
  out.w = d.width;
  out.h = d.height;
  out.rgb.resize(size_t(out.h) * out.w * 3);
  if (d.comps.size() == 1) {
    std::vector<uint8_t> row(size_t(2 * d.width + 16));
    for (int y = 0; y < d.height; ++y) {
      upsampled_row(d, d.comps[0], y, row.data());
      uint8_t* dst = &out.rgb[size_t(y) * out.w * 3];
      for (int x = 0; x < d.width; ++x) dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = row[x];
    }
    return kOk;
  }
  bool rgb;  // jdapimin.c default_decompress_parms
  if (d.saw_jfif) {
    rgb = false;
  } else if (d.saw_adobe) {
    rgb = d.adobe_transform == 0;
  } else {
    rgb = d.comps[0].id == 'R' && d.comps[1].id == 'G' && d.comps[2].id == 'B';
  }
  static const ColorTables tab;
  std::vector<uint8_t> rows[3];
  for (auto& r : rows) r.resize(size_t(2 * d.width + 16));
  for (int y = 0; y < d.height; ++y) {
    for (int i = 0; i < 3; ++i) upsampled_row(d, d.comps[i], y, rows[i].data());
    uint8_t* dst = &out.rgb[size_t(y) * out.w * 3];
    for (int x = 0; x < d.width; ++x) {
      const int yy = rows[0][x], cb = rows[1][x], cr = rows[2][x];
      if (rgb) {
        dst[3 * x] = uint8_t(yy), dst[3 * x + 1] = uint8_t(cb), dst[3 * x + 2] = uint8_t(cr);
      } else {
        dst[3 * x] = clamp255(yy + tab.cr_r[cr]);
        dst[3 * x + 1] = clamp255(yy + ((tab.cb_g[cb] + tab.cr_g[cr]) >> 16));
        dst[3 * x + 2] = clamp255(yy + tab.cb_b[cb]);
      }
    }
  }
  return kOk;
}

// The marker segments of a JPEG file (jdmarker.c read_markers).
int decode(const std::vector<uint8_t>& bytes, Image& out) {
  Decoder d;
  d.data = bytes.data();
  d.size = bytes.size();
  size_t pos = 2;  // past SOI
  while (true) {
    // next_marker: skip anything up to a 0xFF, then fill bytes.
    while (pos < d.size && d.data[pos] != 0xFF) ++pos;
    while (pos < d.size && d.data[pos] == 0xFF) ++pos;
    if (pos >= d.size) return kJpegBad;  // no EOI
    const int m = d.data[pos++];
    if (m == 0xD9) return finish(d, out);                // EOI
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // RSTn, TEM: no length
    if (pos + 2 > d.size) return kJpegBad;
    const int len = ((d.data[pos] << 8) | d.data[pos + 1]) - 2;
    if (len < 0 || pos + 2 + size_t(len) > d.size) return kJpegBad;
    const uint8_t* s = d.data + pos + 2;
    pos += 2 + size_t(len);
    int st = kOk;
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:  // baseline, extended sequential, progressive Huffman
        d.progressive = m == 0xC2;
        st = parse_sof(d, s, len);
        break;
      case 0xC3: case 0xC5: case 0xC6: case 0xC7:  // lossless, hierarchical
        return kJpegNotDct8;
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF: case 0xCC:  // arithmetic, DAC
        return kJpegArithmetic;
      case 0xC4:  // DHT
        for (int at = 0; at < len;) {
          if (at + 17 > len) return kJpegBad;
          const int tc = s[at] >> 4, th = s[at] & 15;
          int n = 0;
          for (int i = 0; i < 16; ++i) n += s[at + 1 + i];
          if (tc > 1 || th > 3 || n > 256 || at + 17 + n > len) return kJpegBad;
          if (!build_huffman(tc ? d.ac[th] : d.dc[th], s + at + 1, s + at + 17, n, tc == 0)) return kJpegBad;
          at += 17 + n;
        }
        break;
      case 0xDB:  // DQT
        for (int at = 0; at < len;) {
          const int pq = s[at] >> 4, tq = s[at] & 15;
          if (pq > 1 || tq > 3 || at + 1 + 64 * (pq + 1) > len) return kJpegBad;
          for (int i = 0; i < 64; ++i) {
            d.qt[tq][kNatural[i]] = pq ? uint16_t((s[at + 1 + 2 * i] << 8) | s[at + 2 + 2 * i]) : s[at + 1 + i];
          }
          d.qt_defined[tq] = true;
          at += 1 + 64 * (pq + 1);
        }
        break;
      case 0xDD:  // DRI
        if (len < 2) return kJpegBad;
        d.restart_interval = (s[0] << 8) | s[1];
        break;
      case 0xDA:  // SOS, then its entropy-coded data
        st = decode_scan(d, s, len, pos);
        break;
      case 0xE0:  // APP0: JFIF
        if (len >= 14 && memcmp(s, "JFIF\0", 5) == 0) d.saw_jfif = true;
        break;
      case 0xEE:  // APP14: Adobe, with its colour transform
        if (len >= 12 && memcmp(s, "Adobe", 5) == 0) {
          d.saw_adobe = true;
          d.adobe_transform = s[11];
        }
        break;
      default:
        if (m == 0xDC || (m >= 0xC0 && m <= 0xCF) || m == 0xD8) return kJpegBad;  // DNL, JPG, a second SOI
        if (!((m >= 0xE0 && m <= 0xEF) || m == 0xFE)) return kJpegBad;  // not APPn or COM: unknown
        break;
    }
    if (st != kOk) return st;
  }
}

}  // namespace jpg

// A PNG by its signature, a JPEG by its SOI marker.
int decode_image(const char* path, Image& out) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, bytes)) return kOpenFailed;
  if (bytes.size() >= 8 && memcmp(bytes.data(), kSignature, 8) == 0) return decode_png(bytes, out);
  if (bytes.size() >= 2 && bytes[0] == 0xFF && bytes[1] == 0xD8) return jpg::decode(bytes, out);
  return kNotImage;
}

// Bilinear resize uint8 HWC -> float HWC with optional [-1, 1] rescale: the
// arithmetic of native/imageio.cpp's resize_to_float (half-pixel centres, no
// antialiasing). At the source's own size no resize runs and each sample is
// (v / 255) * 2 - 1 (or v / 255), in the order the JAX package's PIL route
// computes it, so that both give the same floats.
void to_float(const Image& src, float* dst, int th, int tw, int minus1_1) {
  if (src.h == th && src.w == tw) {
    const size_t n = size_t(th) * tw * 3;
    for (size_t i = 0; i < n; ++i) {
      const float v = float(src.rgb[i]) / 255.0f;
      dst[i] = minus1_1 ? v * 2.0f - 1.0f : v;
    }
    return;
  }
  const float sy = float(src.h) / th;
  const float sx = float(src.w) / tw;
  const float scale = minus1_1 ? 2.0f / 255.0f : 1.0f / 255.0f;
  const float bias = minus1_1 ? -1.0f : 0.0f;
  for (int y = 0; y < th; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : int(fy);
    if (y0 > src.h - 1) y0 = src.h - 1;
    int y1 = y0 + 1 > src.h - 1 ? src.h - 1 : y0 + 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < tw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : int(fx);
      if (x0 > src.w - 1) x0 = src.w - 1;
      int x1 = x0 + 1 > src.w - 1 ? src.w - 1 : x0 + 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      const uint8_t* p00 = &src.rgb[(size_t(y0) * src.w + x0) * 3];
      const uint8_t* p01 = &src.rgb[(size_t(y0) * src.w + x1) * 3];
      const uint8_t* p10 = &src.rgb[(size_t(y1) * src.w + x0) * 3];
      const uint8_t* p11 = &src.rgb[(size_t(y1) * src.w + x1) * 3];
      float* o = dst + (size_t(y) * tw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1 - wx) + p01[c] * wx;
        float bot = p10[c] * (1 - wx) + p11[c] * wx;
        o[c] = (top * (1 - wy) + bot * wy) * scale + bias;
      }
    }
  }
}

void put_chunk(std::vector<uint8_t>& out, const char* type, const uint8_t* data, size_t len) {
  put_be32(out, uint32_t(len));
  const size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  out.insert(out.end(), data, data + len);
  put_be32(out, uint32_t(crc32(0, out.data() + start, uInt(len + 4))));
}

// uint8 HWC RGB -> a PNG file: 8-bit RGB, no row filter, deflate level 1
// (native/imageio.cpp's choice: level 1 halves the write time of the default
// 6, and filtering every row five ways doubles it again for no smaller file
// on these panoramas).
int encode_png(const char* path, const uint8_t* rgb, int h, int w) {
  const size_t stride = size_t(w) * 3;
  std::vector<uint8_t> raw(size_t(h) * (stride + 1));
  for (int y = 0; y < h; ++y) {
    raw[size_t(y) * (stride + 1)] = 0;
    memcpy(&raw[size_t(y) * (stride + 1) + 1], rgb + size_t(y) * stride, stride);
  }
  uLongf packed_len = compressBound(raw.size());
  std::vector<uint8_t> packed(packed_len);
  if (compress2(packed.data(), &packed_len, raw.data(), raw.size(), 1) != Z_OK) return kWriteFailed;
  std::vector<uint8_t> out(kSignature, kSignature + 8);
  uint8_t ihdr[13];
  const uint32_t dims[2] = {uint32_t(w), uint32_t(h)};
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 4; ++j) ihdr[4 * i + j] = uint8_t(dims[i] >> (24 - 8 * j));
  }
  ihdr[8] = 8, ihdr[9] = 2, ihdr[10] = 0, ihdr[11] = 0, ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "IDAT", packed.data(), packed_len);
  put_chunk(out, "IEND", nullptr, 0);
  FILE* fp = fopen(path, "wb");
  if (!fp) return kWriteFailed;
  const bool ok = fwrite(out.data(), 1, out.size(), fp) == out.size();
  return (fclose(fp) == 0 && ok) ? kOk : kWriteFailed;
}

// Runs job(i) for i in [0, n) on min(n_threads, n) threads.
template <typename Job>
void parallel_for(int n, int n_threads, Job job) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i; (i = next.fetch_add(1)) < n;) job(i);
  };
  std::vector<std::thread> threads;
  const int nt = n_threads < 1 ? 1 : (n_threads < n ? n_threads : n);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// ---------------------------------------------------------------------------
// GIF: an animated GIF89a of uint8 RGB frames (the validation side-by-sides),
// where the JAX package calls PIL. Each frame gets its own 256-colour
// palette: a histogram of the frame at 6 bits a channel, a median cut over
// its occupied cells (the box of largest count-weighted variance is split at
// the weighted median of its widest axis, 256 boxes), then kLloydPasses
// k-means passes over the cells weighted by their pixel counts; every pixel
// takes the entry nearest its cell's mean colour. No dithering, no frame
// differencing (each frame is whole), so the bytes are not PIL's; the
// encoder is held by decoding (tests/test_torch_port_train_cli.py).
namespace gif {

constexpr int kCellBits = 6;
constexpr int kCells = 1 << (3 * kCellBits);
constexpr int kLloydPasses = 4;

inline int cell_of(const uint8_t* p) {
  constexpr int s = 8 - kCellBits;
  return ((p[0] >> s) << (2 * kCellBits)) | ((p[1] >> s) << kCellBits) | (p[2] >> s);
}

struct Cell {
  float rgb[3];  // mean colour of the cell's pixels
  uint32_t n;    // pixel count
};

inline int nearest(const float* c, const float* palette, int k) {
  int best = 0;
  float best_d = 3e38f;
  for (int j = 0; j < k; ++j) {
    const float* q = palette + 3 * j;
    const float d = (c[0] - q[0]) * (c[0] - q[0]) + (c[1] - q[1]) * (c[1] - q[1]) + (c[2] - q[2]) * (c[2] - q[2]);
    if (d < best_d) best_d = d, best = j;
  }
  return best;
}

// Median cut over cells[begin, end): count-weighted mean colours of up to 256 boxes.
std::vector<float> median_cut(std::vector<Cell>& cells) {
  struct Box { size_t begin, end; double score; int axis; };
  auto measure = [&](Box& b) {
    double n = 0, s[3] = {0, 0, 0}, ss[3] = {0, 0, 0};
    for (size_t i = b.begin; i < b.end; ++i) {
      for (int a = 0; a < 3; ++a) {
        s[a] += double(cells[i].n) * cells[i].rgb[a];
        ss[a] += double(cells[i].n) * cells[i].rgb[a] * cells[i].rgb[a];
      }
      n += cells[i].n;
    }
    b.score = 0, b.axis = 0;
    double widest = -1;
    for (int a = 0; a < 3; ++a) {
      const double var = ss[a] - s[a] * s[a] / n;  // n times the variance
      b.score += var;
      if (var > widest) widest = var, b.axis = a;
    }
    if (b.end - b.begin < 2) b.score = -1;  // one cell: nothing to split
  };
  std::vector<Box> boxes(1, Box{0, cells.size(), 0, 0});
  measure(boxes[0]);
  while (boxes.size() < 256) {
    size_t pick = 0;
    for (size_t i = 1; i < boxes.size(); ++i) {
      if (boxes[i].score > boxes[pick].score) pick = i;
    }
    Box b = boxes[pick];
    if (b.score <= 0) break;
    const int a = b.axis;
    std::sort(cells.begin() + b.begin, cells.begin() + b.end,
              [a](const Cell& x, const Cell& y) { return x.rgb[a] < y.rgb[a]; });
    double total = 0, run = 0;
    for (size_t i = b.begin; i < b.end; ++i) total += cells[i].n;
    size_t cut = b.begin + 1;
    for (size_t i = b.begin; i < b.end - 1; ++i) {
      run += cells[i].n;
      cut = i + 1;
      if (run >= total / 2) break;
    }
    Box lo{b.begin, cut, 0, 0}, hi{cut, b.end, 0, 0};
    measure(lo);
    measure(hi);
    boxes[pick] = lo;
    boxes.push_back(hi);
  }
  std::vector<float> palette;
  for (const Box& b : boxes) {
    double n = 0, s[3] = {0, 0, 0};
    for (size_t i = b.begin; i < b.end; ++i) {
      n += cells[i].n;
      for (int a = 0; a < 3; ++a) s[a] += double(cells[i].n) * cells[i].rgb[a];
    }
    for (int a = 0; a < 3; ++a) palette.push_back(float(s[a] / n));
  }
  return palette;
}

// One frame's palette (768 bytes, `k` entries used) and the index of every pixel.
void quantize(const uint8_t* rgb, size_t n_px, uint8_t* palette_out, std::vector<uint8_t>& index) {
  std::vector<uint32_t> count(kCells, 0);
  std::vector<uint64_t> sum(3 * size_t(kCells), 0);
  for (size_t i = 0; i < n_px; ++i) {
    const uint8_t* p = rgb + 3 * i;
    const int c = cell_of(p);
    ++count[c];
    for (int a = 0; a < 3; ++a) sum[3 * size_t(c) + a] += p[a];
  }
  std::vector<Cell> cells;
  std::vector<int> id;  // cell number of cells[i] before the median cut reorders them
  for (int c = 0; c < kCells; ++c) {
    if (!count[c]) continue;
    Cell cell;
    for (int a = 0; a < 3; ++a) cell.rgb[a] = float(double(sum[3 * size_t(c) + a]) / count[c]);
    cell.n = count[c];
    cells.push_back(cell);
    id.push_back(c);
  }
  std::vector<Cell> work = cells;
  std::vector<float> palette = median_cut(work);
  const int k = int(palette.size() / 3);
  for (int pass = 0; pass < kLloydPasses; ++pass) {
    std::vector<double> acc(4 * size_t(k), 0.0);
    for (const Cell& cell : cells) {
      double* a = &acc[4 * size_t(nearest(cell.rgb, palette.data(), k))];
      for (int j = 0; j < 3; ++j) a[j] += double(cell.n) * cell.rgb[j];
      a[3] += cell.n;
    }
    for (int j = 0; j < k; ++j) {
      if (acc[4 * j + 3] > 0) {
        for (int a = 0; a < 3; ++a) palette[3 * j + a] = float(acc[4 * j + a] / acc[4 * j + 3]);
      }
    }
  }
  memset(palette_out, 0, 768);
  for (int j = 0; j < 3 * k; ++j) {
    const float v = palette[j] + 0.5f;
    palette_out[j] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
    palette[j] = palette_out[j];  // pixels map to the colours the file holds
  }
  std::vector<uint8_t> of_cell(kCells, 0);
  for (size_t i = 0; i < cells.size(); ++i) of_cell[id[i]] = uint8_t(nearest(cells[i].rgb, palette.data(), k));
  index.resize(n_px);
  for (size_t i = 0; i < n_px; ++i) index[i] = of_cell[cell_of(rgb + 3 * i)];
}

// GIF's variable-length LZW (minimum code size 8, as giflib's EGifCompressLine:
// a code widens once the next code to assign needs another bit, and the table
// is cleared when it reaches 4095 codes), packed into sub-blocks of at most
// 255 bytes and a zero-length terminator.
void lzw(const std::vector<uint8_t>& index, std::vector<uint8_t>& out) {
  constexpr int kClear = 256, kEnd = 257, kMaxCode = 4095;
  std::vector<uint16_t> table(size_t(kMaxCode + 1) << 8, 0);  // (prefix << 8 | byte) -> code, 0: absent
  std::vector<uint32_t> used;
  std::vector<uint8_t> bytes;
  uint32_t acc = 0;
  int nbits = 0, size = 9, next = kEnd + 1;
  auto put = [&](int code) {
    acc |= uint32_t(code) << nbits;
    nbits += size;
    while (nbits >= 8) {
      bytes.push_back(uint8_t(acc));
      acc >>= 8;
      nbits -= 8;
    }
    if (next >= (1 << size) && size < 12) ++size;
  };
  put(kClear);
  int prefix = index.empty() ? 0 : index[0];
  for (size_t i = 1; i < index.size(); ++i) {
    const uint32_t key = (uint32_t(prefix) << 8) | index[i];
    if (table[key]) {
      prefix = table[key];
      continue;
    }
    put(prefix);
    if (next >= kMaxCode) {
      put(kClear);
      for (uint32_t u : used) table[u] = 0;
      used.clear();
      size = 9, next = kEnd + 1;
    } else {
      table[key] = uint16_t(next++);
      used.push_back(key);
    }
    prefix = index[i];
  }
  put(prefix);
  put(kEnd);
  if (nbits > 0) bytes.push_back(uint8_t(acc));
  out.push_back(8);  // minimum code size
  for (size_t i = 0; i < bytes.size(); i += 255) {
    const size_t len = std::min<size_t>(255, bytes.size() - i);
    out.push_back(uint8_t(len));
    out.insert(out.end(), bytes.begin() + i, bytes.begin() + i + len);
  }
  out.push_back(0);
}

void put_le16(std::vector<uint8_t>& out, int v) {
  out.push_back(uint8_t(v & 0xff));
  out.push_back(uint8_t((v >> 8) & 0xff));
}

// One frame: graphic control extension (no disposal, `delay_cs` hundredths
// of a second), image descriptor with a 256-entry local colour table, data.
void encode_frame(const uint8_t* rgb, int h, int w, int delay_cs, std::vector<uint8_t>& out) {
  uint8_t palette[768];
  std::vector<uint8_t> index;
  quantize(rgb, size_t(h) * w, palette, index);
  const uint8_t gce[4] = {0x21, 0xF9, 0x04, 0x04};
  out.insert(out.end(), gce, gce + 4);
  put_le16(out, delay_cs);
  out.push_back(0);  // transparent index (unused)
  out.push_back(0);
  out.push_back(0x2C);
  put_le16(out, 0);
  put_le16(out, 0);
  put_le16(out, w);
  put_le16(out, h);
  out.push_back(0x87);  // local colour table of 2^(7+1) entries, not interlaced
  out.insert(out.end(), palette, palette + 768);
  lzw(index, out);
}

}  // namespace gif

}  // namespace

extern "C" {

// Load n images (paths[i]) into dst, n x th x tw x 3 floats, resized as above
// and in [-1, 1] with minus1_1 (else [0, 1]). status[i] gets the image's
// Status. Returns the number of failed images.
int evt_load_images(const char** paths, int n, float* dst, int th, int tw, int minus1_1, int n_threads,
                    int* status) {
  std::atomic<int> failed(0);
  parallel_for(n, n_threads, [&](int i) {
    Image img;
    status[i] = decode_image(paths[i], img);
    if (status[i] == kOk) {
      to_float(img, dst + size_t(i) * th * tw * 3, th, tw, minus1_1);
    } else {
      failed.fetch_add(1);
    }
  });
  return failed.load();
}

// Write n uint8 HWC RGB images (data + i*h*w*3) to paths[i] as PNG.
// status[i] gets the write's Status. Returns the number of failed writes.
int evt_save_pngs(const char** paths, const uint8_t* data, int n, int h, int w, int n_threads, int* status) {
  std::atomic<int> failed(0);
  parallel_for(n, n_threads, [&](int i) {
    status[i] = encode_png(paths[i], data + size_t(i) * h * w * 3, h, w);
    if (status[i] != kOk) failed.fetch_add(1);
  });
  return failed.load();
}

// Write n uint8 HWC RGB frames (data + i*h*w*3) to `path` as an animated GIF
// that loops forever (NETSCAPE2.0, loop count 0), each frame shown for
// delay_cs hundredths of a second; frames are quantized and compressed on
// n_threads threads. Returns a Status.
int evt_save_gif(const char* path, const uint8_t* data, int n, int h, int w, int delay_cs, int n_threads) {
  std::vector<std::vector<uint8_t>> frames(n);
  parallel_for(n, n_threads, [&](int i) { gif::encode_frame(data + size_t(i) * h * w * 3, h, w, delay_cs, frames[i]); });
  std::vector<uint8_t> out = {'G', 'I', 'F', '8', '9', 'a'};
  gif::put_le16(out, w);
  gif::put_le16(out, h);
  out.push_back(0x70);  // no global colour table, 8 bits of colour resolution
  out.push_back(0);     // background colour index
  out.push_back(0);     // pixel aspect ratio
  const uint8_t loop[19] = {0x21, 0xFF, 0x0B, 'N', 'E', 'T', 'S', 'C', 'A', 'P', 'E', '2', '.', '0', 0x03, 0x01, 0, 0, 0};
  out.insert(out.end(), loop, loop + 19);
  FILE* fp = fopen(path, "wb");
  if (!fp) return kWriteFailed;
  bool ok = fwrite(out.data(), 1, out.size(), fp) == out.size();
  for (const auto& f : frames) ok = ok && fwrite(f.data(), 1, f.size(), fp) == f.size();
  ok = ok && fputc(0x3B, fp) != EOF;  // trailer
  return (fclose(fp) == 0 && ok) ? kOk : kWriteFailed;
}

}  // extern "C"
