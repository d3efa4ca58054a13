// Image IO of the episode data path: PNG decode, bilinear resize to float,
// PNG encode, each over a batch on a pool of threads. A plain C interface,
// loaded with ctypes by evoworld_tpu_torch/data/native_io.py and built at
// first use with g++ (-lz) by ops/_build.py.
//
// The port's own copy of what it needs from native/imageio.cpp (the JAX
// package's loader, built on libpng and libjpeg): the half-pixel bilinear
// resize without antialiasing (`resize_to_float`, the same arithmetic) and
// the PNG writer at compression level 1 with no row filter. The H100
// machine the port runs on has zlib (zlib.h, libz) but neither libpng nor
// libjpeg, so PNG is read and written here on zlib alone: the chunks are
// parsed, the IDAT stream inflated and the five row filters undone in this
// file; the writer deflates unfiltered rows into one IDAT chunk. JPEG has no
// decoder here: a file that is not a PNG fails with status kNotPng, and the
// Python wrapper raises an error naming the file (ROADMAP.md §3).
//
// PNG variants read: colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey +
// alpha), 6 (RGBA) at 8 or 16 bits, palette and grey also at 1, 2, 4 bits;
// no interlacing. As libpng with the JAX loader's transforms: 16-bit samples
// keep their high byte (png_set_strip_16), grey is replicated to RGB and
// alpha dropped without compositing (png_set_strip_alpha).

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

enum Status { kOk = 0, kOpenFailed = 1, kNotPng = 2, kBadPng = 3, kWriteFailed = 4 };

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
bool unfilter(std::vector<uint8_t>& raw, int h, size_t stride, int bpp) {
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw.data() + size_t(y) * (stride + 1);
    const uint8_t type = row[0];
    uint8_t* cur = row + 1;
    const uint8_t* prev = y > 0 ? raw.data() + size_t(y - 1) * (stride + 1) + 1 : nullptr;
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

int decode_png(const char* path, Image& out) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, bytes)) return kOpenFailed;
  if (bytes.size() < 8 || memcmp(bytes.data(), kSignature, 8) != 0) return kNotPng;
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
  if (out.w <= 0 || out.h <= 0 || out.w > (1 << 16) || out.h > (1 << 16) || interlace != 0 || idat.empty()) {
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
  const size_t stride = (size_t(out.w) * channels * depth + 7) / 8;
  const int bpp = depth < 8 ? 1 : channels * depth / 8;
  std::vector<uint8_t> raw(size_t(out.h) * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK || raw_len != raw.size()) return kBadPng;
  if (!unfilter(raw, out.h, stride, bpp)) return kBadPng;

  out.rgb.resize(size_t(out.h) * out.w * 3);
  const int step = depth == 16 ? 2 : 1;  // a 16-bit sample keeps its high byte
  for (int y = 0; y < out.h; ++y) {
    const uint8_t* row = raw.data() + size_t(y) * (stride + 1) + 1;
    uint8_t* dst = out.rgb.data() + size_t(y) * out.w * 3;
    for (int x = 0; x < out.w; ++x) {
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
      dst[3 * x] = r, dst[3 * x + 1] = g, dst[3 * x + 2] = b;
    }
  }
  return kOk;
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
    status[i] = decode_png(paths[i], img);
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

}  // extern "C"
