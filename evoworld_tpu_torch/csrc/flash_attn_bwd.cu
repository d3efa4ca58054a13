// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV of exact
// non-causal O = softmax(Q K^T * scale) V over (B, S, H, D) bf16 tensors read
// through their strides, with keys at or past `kv_len` masked, from the
// forward's output O and per-row log-sum-exp L (flash_attn_fwd.cu, fp32
// (B, H, Sq)) and the output's gradient dO. dQ, dK, dV are written bf16
// through their strides (the wrapper makes them contiguous).
//
// Replaces the two backward Pallas TPU kernels of K1
// (evoworld_tpu/ops/attention.py::_builtin_flash, JAX's shipped flash
// attention, whose custom_vjp is jax/experimental/pallas/ops/tpu/
// flash_attention.py::_flash_attention_bwd): `_flash_attention_bwd_dkv` and
// `_flash_attention_bwd_dq`. The TPU kernels walk a sequential grid axis and
// carry dK/dV (or dQ) in VMEM scratch, recomputing S and dP in each. Blocks on
// this card run in no order, so each sweep is a loop inside one block.
//
// Bound: 10*B*H*Sq*kv_len*D flops of bf16 tensor-core work (five products of
// 2*Sq*kv_len*D each: S, dP, dV, dK, dQ) against about (4*Sq + 4*Skv)*B*H*D*2
// bytes; at the training shape's 9216 tokens the operations bound it by three
// orders of magnitude. Beside the tensor cores, one exp2 per score runs on the
// special-function units (16 a clock per SM), and at D = 64 a product with
// both operands in shared memory reads as many bytes as shared memory
// delivers in the tensor cores' time.
//
// D = 64 (every attention with a gradient on the port's paths: the UNet's
// heads of 64) and D = 128 (head dims 65-128 at 4096 tokens or more; no path
// runs it today): one fused pass, `flash_bwd_fused<D>`, that does the five
// products once and exp2 once, between two small passes. At D = 64:
//   flash_bwd_delta   delta_i = rowsum(dO_i * O_i) and L_i * log2(e), fp32
//                     (B, H, Sq rounded up to 64); the padding holds delta = 0
//                     and a huge L, so a padded query gets P = 0 and no mask.
//   flash_bwd_fused   3 warpgroups, 384 threads, one block per SM and per
//                     (128-key tile, head, batch), key tiles fastest in the
//                     grid. Warpgroup 0 is the producer: one thread starts
//                     every TMA load and the group gives its registers up.
//                     K and V of the tile are loaded once (the maps' key
//                     extent is `kv_len`, so padded keys read as zeros) and
//                     each consumer keeps its 64 keys of both in registers as
//                     wgmma A fragments. Q and dO tiles of 64 queries, with
//                     their L and delta rows, stream through a ring of
//                     kStages buffers with full / empty mbarrier pairs.
//                     Warpgroups 1 and 2 are consumers, 64 keys each. Per
//                     query tile a consumer computes
//                       S^T  = K Q^T,  dP^T = V dO^T   (wgmma m64n64k16, A from
//                                                       registers, Q and dO K-major)
//                       P^T  = exp2(S^T * scale * log2(e) - L * log2(e))
//                       dS^T = P^T * (dP^T - delta)
//                     in the accumulators' registers, whose layout is the A
//                     operand's, so
//                       dV += P^T dO,  dK += dS^T Q    (A from registers, dO
//                                                       and Q read MN-major)
//                     and writes dS^T as bf16 into a 128-key x 64-query
//                     shared tile in the 128-byte swizzle (two buffers, with
//                     mbarriers between the consumers). The consumers take
//                     turns at a tile's
//                       dQ_part = dS K                 (A = dS^T and B = K of all
//                                                       128 keys, both MN-major)
//                     one tile late, so that neither waits for the other's
//                     half; the 64 x 64 fp32 result goes through a staging
//                     tile in shared memory into an fp32 (B, H, Sq', 64)
//                     buffer as one cp.reduce.async.bulk (the sum over key
//                     tiles crosses blocks). Each block starts its sweep at
//                     another query tile, so the blocks in flight add into
//                     different rows of dQ. dK and dV need no sum across
//                     blocks; keys at or past `kv_len` get P = 0 (masked in
//                     the block's last key tile only) and their rows are
//                     written as zeros.
//   flash_bwd_store_dq  dQ = bf16(scale * buffer).
// At D = 128 the same block, grid and schedule hold twice the columns, and
// registers are what runs short: a consumer's dK and dV for 64 keys x 128
// columns take 128 fp32 registers a thread, beside 64 of S^T and dP^T and 32
// of dQ, under setmaxnreg's 240 (the producer keeps 24). So:
//   - K and V stay in shared memory (two 64-column boxes each, as
//     flash_fwd_wgmma lays out D = 128) and S^T and dP^T read both operands
//     from there (wgmma m64n64k16, 8 k-steps across the two boxes); the
//     first k-step only writes its accumulator, so S^T, dP^T and dQ hold no
//     registers between their uses;
//   - dV += P^T dO and dK += dS^T Q are wgmma m64n128k16 with P and dS from
//     registers, dO and Q MN-major over both boxes (the descriptor's leading
//     offset is the box distance); P and dS become bf16 column pair by
//     column pair as dS is formed;
//   - each consumer computes its own 64 columns of every tile's dQ over all
//     128 keys (B = K's box cw), one tile late as at D = 64, and adds the
//     64 x 64 fp32 part into a (B, H, Sq', 128) buffer with one bulk
//     reduction; both consumers read each dS^T buffer;
//   - the query ring has 3 stages (227 KB of shared memory in all).
// The order of the fp32 sums into dQ changes from run to run, so dQ may
// differ in its last bf16 bit between two calls; dK and dV are repeatable.
//
// D = 512 (the VAE's mid-block attention, one head of 512; no path of the
// port or of the JAX package forms this gradient, the VAE being frozen) runs
// the mma.sync kernels of the first port, `flash_bwd_dkdv` (one block per 64
// keys) and `flash_bwd_dq` (one block per 64 queries), cp.async double
// buffering, S and dP recomputed in both, no atomics, with their output
// columns split: a block owns one
// 256-column half of dK and dV for 64 keys (or of dQ for 64 queries), the
// two halves side by side on grid.x. A 64 x 512 fp32 gradient tile would
// take 256 registers a thread for each of dK and dV. The block has 8 warps:
// warps w and w + 4 own the same 16 rows, each contracts S and dP over 256
// of the 512 columns and accumulates 128 of the block's 256 output columns,
// and the pair swaps its fp32 partial scores through shared memory
// (`swap_partials`), so both hold S and dP bit for bit. Each block still
// recomputes S and dP for its half, so the pair does 11 products' worth of
// work where the function needs 5 (2.2x), and K, V and the query tiles of 16
// rows fill ~211 KB of shared memory (one block, eight warps, per SM). Its
// bound is the function's: 10*B*H*Sq*kv_len*512 flops, e.g. 3.52 ms at (8,
// 9216, 1, 512) on an H100's 989 TFLOP/s; this simple design is far from it
// (PERF.md §6). `flash_bwd_delta` reads a 512-wide row with one warp, two
// chunks a thread.

#include "flash_attn_hopper.cuh"

namespace {

using namespace flash;

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // (B, H, Sq), natural log
  float* delta;      // (B, H, sq_pad)
  float* lse2;       // (B, H, sq_pad): lse * log2(e); null at D = 512
  float* dq_acc;     // (B, H, sq_pad, D) fp32 sums of dQ / scale; null at D = 512
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int sq, sq_pad, skv, kv_len, heads;
  float scale;       // softmax scale
  float scale_log2;  // scale * log2(e)
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
};

constexpr float kPadLse = 1e30f;  // exp2(s - kPadLse) = 0 for any finite score

// Threads a row of flash_bwd_delta: D / 8 (16 bytes each) up to one warp;
// at D = 512 each of a warp's 32 threads reads two 16-byte chunks of the row.
template <int D>
constexpr int kDeltaTPR = D / 8 < 32 ? D / 8 : 32;

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d] over rows (b, s, h) with
// s < sq_pad: kDeltaTPR<D> threads a row, 16 bytes a chunk,
// summed with shuffles inside their group of lanes (a group never spans two
// warps). With `lse2` it also writes lse * log2(e); rows in [sq, sq_pad) get
// delta = 0 and lse2 = kPadLse.
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_delta(BwdParams p, int64_t n_rows) {
  constexpr int TPR = kDeltaTPR<D>;
  constexpr int RPB = 128 / TPR;
  const int64_t row = (int64_t)blockIdx.x * RPB + threadIdx.x / TPR;  // (b, s, h), h fastest
  const int c = threadIdx.x % TPR;
  const int h = (int)(row % p.heads);
  const int s = (int)((row / p.heads) % p.sq_pad);
  const int64_t b = row / ((int64_t)p.heads * p.sq_pad);
  const bool real = row < n_rows && s < p.sq;
  float acc = 0.f;
  if (real) {
#pragma unroll
    for (int chunk = c; chunk < D / 8; chunk += TPR) {
      const uint4 ov = *reinterpret_cast<const uint4*>(p.o + b * p.o_sb + s * p.o_ss + h * p.o_sh + chunk * 8);
      const uint4 dv =
          *reinterpret_cast<const uint4*>(p.dout + b * p.do_sb + s * p.do_ss + h * p.do_sh + chunk * 8);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(o2[i]), y = __bfloat1622float2(d2[i]);
        acc += x.x * y.x + x.y * y.y;
      }
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < n_rows && c == 0) {
    const int64_t at = (b * p.heads + h) * p.sq_pad + s;
    p.delta[at] = acc;
    if (p.lse2 != nullptr) p.lse2[at] = real ? p.lse[(b * p.heads + h) * p.sq + s] * kLog2e : kPadLse;
  }
}

// ---------------------------------------------------------------------------
// The fused pass, D = 64 and 128.
// ---------------------------------------------------------------------------
constexpr int kKeys = 128;          // keys per block, 64 per consumer warpgroup
constexpr int kQ = 64;              // queries per tile
constexpr int kFusedThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;   // arrivals that free a ring buffer or fill a dS^T buffer
constexpr int kDsBufs = 2;          // dS^T buffers
constexpr uint32_t kDsBytes = kKeys * 128;  // one 128-key x 64-query bf16 dS^T tile
constexpr uint32_t kBoxBytes = kQ * 128;    // one 64-row x 64-column bf16 box (a query tile's, or a consumer's keys)
constexpr uint32_t kRowBytes = kQ * 4;      // one tile's L or delta
constexpr uint32_t kDqBytes = kQ * 64 * 4;  // one consumer's 64 x 64 fp32 part of a tile's dQ

template <int D>
struct Fused {
  static constexpr int kBoxes = D / 64;                     // 64-column (128-byte) boxes per row
  // Buffers of the query ring. At D = 128 three fill shared memory to 232,024
  // of its 232,448 bytes; they ran faster than two on an H100.
  static constexpr int kStages = D == 64 ? 4 : 3;
  // Registers of a producer / consumer thread: 128 (P + 2 C) <= 65536. At D =
  // 128 a consumer holds 128 accumulators of dK and dV, 64 of S^T and dP^T
  // and 32 of dQ.
  static constexpr int kProducerRegs = D == 64 ? 40 : 24;
  static constexpr int kConsumerRegs = D == 64 ? 232 : 240;
  static constexpr uint32_t kKVBox = kKeys * 128;           // one 128-key x 64-column box
  static constexpr uint32_t kKVBytes = kBoxes * kKVBox;     // K or V of the block
  static constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;  // one Q or dO tile
  // 1024 bytes of slack to align the tiles, then K, V, the dS^T buffers, a dQ
  // staging tile per consumer, the Q ring, the dO ring, the L and delta rings,
  // and the mbarriers.
  static constexpr size_t kSmem = 1024 + 2 * kKVBytes + kDsBufs * kDsBytes + 2 * kDqBytes + 2 * kStages * kTileBytes +
                                  2 * kStages * kRowBytes + (1 + 2 * kDsBufs + 2 * kStages) * 8;
};

struct FusedArgs {
  const float* lse2;   // (B, H, sq_pad)
  const float* delta;  // (B, H, sq_pad)
  float* dq_acc;       // (B, H, sq_pad / 64, 64 * D) in staging order, zeroed by the caller
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  int sq_pad, skv, kv_len, heads;
  float scale, scale_log2;
};

// Adds `bytes` contiguous bytes of fp32 in shared memory into global memory
// (one asynchronous bulk reduction), as part of this thread's bulk group.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Waits until this thread's bulk groups have read their shared-memory sources.
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

// Offset (in floats) of the 8 columns 8 j .. 8 j + 7 of query row q inside a
// 64 x 64 tile in staging order: the order of the wgmma accumulator, in which
// each store of a warp (fixed j and r) covers 256 contiguous bytes.
__device__ __forceinline__ int staging_offset(int q, int j) {
  return (((q / 16) * 8 + j) * 2 + (q % 16) / 8) * 64 + (q % 8) * 8;
}

// A 64 x 64 fp32 accumulator as bf16 A fragments: two adjacent 8-column blocks
// make one 16-deep k-step.
__device__ __forceinline__ void to_bf16(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
  }
}

// The A fragments (16 rows of this warp, four 16-column k-steps) of a 64-row x
// 64-column bf16 tile in the 128-byte swizzle: the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8). `rows` points at the warp's row g.
__device__ __forceinline__ void load_a_sw128(uint32_t (&f)[4][4], const unsigned char* rows, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int chunk = 2 * kk + (i >> 1), r = i & 1;
      f[kk][i] = *reinterpret_cast<const uint32_t*>(rows + r * 1024 + ((chunk ^ g) << 4) + 4 * t4);
    }
  }
}

// acc (64 keys x 64 queries) = A (this consumer's 64 keys x 128 columns, `a`)
// B^T (64 queries x 128 columns, `b`), both K-major in two 64-column boxes
// (`a_box`, `b_box` descriptor units apart): S^T or dP^T at D = 128.
__device__ __forceinline__ void scores_d128(float (&acc)[32], uint64_t a, uint32_t a_box, uint64_t b,
                                            uint32_t b_box) {
  wgmma_ss_n64_first<0, 0>(acc, a, b);
#pragma unroll
  for (int kk = 1; kk < 8; ++kk) {
    wgmma_ss_n64<0, 0>(acc, a + (kk / 4) * a_box + (kk % 4) * 2, b + (kk / 4) * b_box + (kk % 4) * 2, 1);
  }
}

template <int D>
__global__ void __launch_bounds__(kFusedThreads, 1)
    flash_bwd_fused(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const FusedArgs a) {
  using C = Fused<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* vs = ks + C::kKVBytes;
  unsigned char* dss = vs + C::kKVBytes;  // dS^T of tile t at dss + (t % kDsBufs) * kDsBytes, 128 keys x 64 queries
  unsigned char* dqs = dss + kDsBufs * kDsBytes;  // consumer cw's dQ staging tile at dqs + cw * kDqBytes
  unsigned char* qs = dqs + 2 * kDqBytes;         // stage st at qs + st * kTileBytes
  unsigned char* dos = qs + C::kStages * C::kTileBytes;
  float* lse_s = reinterpret_cast<float*>(dos + C::kStages * C::kTileBytes);  // [kStages][kQ]
  float* dlt_s = lse_s + C::kStages * kQ;                                     // [kStages][kQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dlt_s + C::kStages * kQ);
  uint64_t* ds_full = kv_full + 1;         // [kDsBufs]: both consumers have written their half of dS^T
  uint64_t* ds_empty = ds_full + kDsBufs;  // [kDsBufs]: the dQ products have read it
  uint64_t* full = ds_empty + kDsBufs;     // [kStages]
  uint64_t* empty = full + C::kStages;     // [kStages]

  const int k0 = blockIdx.x * kKeys, h = blockIdx.y, b = blockIdx.z;
  __nv_bfloat16* dkb = a.dk + b * a.dk_sb + h * a.dk_sh;
  __nv_bfloat16* dvb = a.dv + b * a.dv_sb + h * a.dv_sh;

  if (k0 >= a.kv_len) {  // every key of the tile is masked: zero rows
    const int rows = min(kKeys, a.skv - k0);
    for (int i = threadIdx.x; i < rows * (D / 8); i += kFusedThreads) {
      const int r = i / (D / 8), c = i % (D / 8);
      *reinterpret_cast<uint4*>(dkb + (int64_t)(k0 + r) * a.dk_ss + c * 8) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dvb + (int64_t)(k0 + r) * a.dv_ss + c * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const int n_tiles = a.sq_pad / kQ;
  // Each key tile of a head starts its sweep at another query tile, so the
  // blocks in flight add into different rows of dQ.
  const int t0 = (int)((int64_t)blockIdx.x * n_tiles / gridDim.x);
  const int64_t row_base = ((int64_t)b * a.heads + h) * a.sq_pad;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < kDsBufs; ++i) {
      mbar_init(ds_full + i, kConsumerWarps);
      // D = 64: one consumer reads a tile's dS^T; D = 128: both do.
      mbar_init(ds_empty + i, D == 64 ? kConsumerWarps / 2 : kConsumerWarps);
    }
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread loads K and V, then keeps the query ring full.
    reg_dealloc<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * C::kKVBytes);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_load(ks + x * C::kKVBox, &tk, kv_full, x * 64, k0, h, b);
        tma_load(vs + x * C::kKVBox, &tv, kv_full, x * 64, k0, h, b);
      }
#pragma unroll 1
      for (int t = 0; t < n_tiles; ++t) {  // rolled: the group keeps kProducerRegs registers
        const int st = t % C::kStages;
        const int qt = t + t0 < n_tiles ? t + t0 : t + t0 - n_tiles;
        mbar_wait(empty + st, ((t / C::kStages) & 1) ^ 1);  // the first round finds the ring free
        mbar_expect_tx(full + st, 2 * C::kTileBytes + 2 * kRowBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(qs + st * C::kTileBytes + x * kBoxBytes, &tq, full + st, x * 64, qt * kQ, h, b);
          tma_load(dos + st * C::kTileBytes + x * kBoxBytes, &tdo, full + st, x * 64, qt * kQ, h, b);
        }
        bulk_load(lse_s + st * kQ, a.lse2 + row_base + qt * kQ, kRowBytes, full + st);
        bulk_load(dlt_s + st * kQ, a.delta + row_base + qt * kQ, kRowBytes, full + st);
      }
    }
  } else {
    // Consumers: warpgroup cw owns keys k0 + 64 cw .. + 63.
    reg_alloc<C::kConsumerRegs>();
    const int cw = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const bool leader = threadIdx.x % 128 == 0;  // starts this consumer's bulk reductions
    // K-major operands step 32 bytes along a 128-byte row per 16-deep k-step
    // (2 descriptor units), and a whole box (kBoxes > 1) every 4 steps;
    // MN-major ones 16 rows of 128 bytes (128 units), their 64-column boxes
    // the leading offset apart (unused where the product is 64 columns wide).
    constexpr uint32_t kTileStep = C::kTileBytes / 16;  // descriptor units between ring stages
    constexpr uint32_t kDsStep = kDsBytes / 16;         // and between the dS^T buffers
    constexpr uint32_t kLead = D == 64 ? 16 : kBoxBytes;
    const uint64_t q_desc = sw128_desc(qs, kLead, 1024);
    const uint64_t do_desc = sw128_desc(dos, kLead, 1024);
    const uint64_t ds_desc = sw128_desc(dss, 16, 1024);
    // dQ_part = dS K: at D = 64 over K's only box; at D = 128 consumer cw
    // computes columns 64 cw .. + 63 of every tile, over K's box cw.
    const uint64_t k_dq_desc = sw128_desc(ks + (D == 64 ? 0 : cw * C::kKVBox), 16, 1024);
    // This thread's dS^T elements: key rows 64 cw + 16 warp + g + 8 r, query
    // pairs 8 j + 2 t4; the 16-byte chunk j of row `row` sits at chunk j ^ (row % 8).
    unsigned char* ds_thread = dss + cw * kBoxBytes + warp * 2048 + g * 128 + 4 * t4;
    const int g16 = g * 16;
    const int key0 = k0 + cw * 64 + warp * 16 + g;  // this thread's key rows: key0 and key0 + 8
    const bool edge = k0 + kKeys > a.kv_len;
    float* dq_stage = reinterpret_cast<float*>(dqs + cw * kDqBytes);
    float* dq_thread = dq_stage + warp * 1024 + lane * 2;  // staging order, see staging_offset
    // Tile qt's 64 x D part of dQ sits at dq_tiles + qt * 64 D, its 64-column
    // slices 4096 floats apart, each in staging order.
    float* dq_tiles = a.dq_acc + row_base * D + (D == 64 ? 0 : cw * kQ * 64);

    float dk[D / 2], dv[D / 2], s[32], dp[32], dq[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    if constexpr (D == 64) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = dq[i] = 0.f;
    }
    uint32_t pa[4][4], dsa[4][4];

    // D = 64: K and V of this consumer's keys stay in registers as A
    // fragments for the block's whole sweep: with them in shared memory, S^T
    // and dP^T would read as many bytes per product as shared memory delivers
    // in its time. D = 128 has no registers for them (64 more a thread): S^T
    // and dP^T read both operands from shared memory.
    uint32_t kf[D == 64 ? 4 : 1][4], vf[D == 64 ? 4 : 1][4];
    mbar_wait(kv_full, 0);
    if constexpr (D == 64) {
      load_a_sw128(kf, ks + cw * kBoxBytes + warp * 2048 + g * 128, g, t4);
      load_a_sw128(vf, vs + cw * kBoxBytes + warp * 2048 + g * 128, g, t4);
    }
    const uint64_t k_own = sw128_desc(ks + cw * kBoxBytes, 16, 1024);  // D = 128: this consumer's keys, K-major
    const uint64_t v_own = sw128_desc(vs + cw * kBoxBytes, 16, 1024);

    // dQ_part = dS K of tile `tile`: A = dS^T and B = K over all 128 keys, both MN-major.
    auto start_dq = [&](int tile) {
      const int at = tile % kDsBufs;
      mbar_wait(ds_full + at, (tile / kDsBufs) & 1);  // both halves of dS^T are there
      if constexpr (D == 64) {
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_ss_n64<1, 1>(dq, ds_desc + at * kDsStep + kk * 128, k_dq_desc + kk * 128, kk > 0);
        }
      } else {  // the first k-step only writes dq, which stays dead from the last drain until here
        wgmma_fence();
        wgmma_ss_n64_first<1, 1>(dq, ds_desc + at * kDsStep, k_dq_desc);
#pragma unroll
        for (int kk = 1; kk < 8; ++kk) {
          wgmma_ss_n64<1, 1>(dq, ds_desc + at * kDsStep + kk * 128, k_dq_desc + kk * 128, 1);
        }
      }
      wgmma_commit();
    };
    // This consumer's 64 x 64 part of dQ goes through its staging tile into
    // the fp32 buffer as one asynchronous bulk reduction.
    auto drain_dq = [&](int tile) {
      fence_regs(dq);
      if (leader) bulk_wait_read();  // the staging tile's last reduction has read it
      named_barrier_sync(1 + cw, 128);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(dq_thread + j * 128) = make_float2(dq[4 * j + 0], dq[4 * j + 1]);
        *reinterpret_cast<float2*>(dq_thread + j * 128 + 64) = make_float2(dq[4 * j + 2], dq[4 * j + 3]);
      }
      fence_proxy_async();  // the bulk reduction reads shared memory through the async proxy
      named_barrier_sync(1 + cw, 128);
      if (leader) {
        bulk_reduce_add_f32(dq_tiles + (int64_t)tile * (kQ * D), dq_stage, kDqBytes);
        bulk_commit();
      }
    };

    int qt_prev = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % C::kStages, buf = t % kDsBufs;
      // D = 64: the consumers take turns at a tile's dQ, one product over all
      // 128 keys and one reduction into global memory, not two. D = 128:
      // each consumer computes its 64 columns of every tile's dQ. It is
      // started one tile late, behind the next tile's dV and dK, when the
      // other consumer's half of dS^T has long arrived.
      const bool has_dq = t > 0 && (D != 64 || ((t - 1) & 1) == cw);
      const int qt = t + t0 < n_tiles ? t + t0 : t + t0 - n_tiles;
      const float* lt = lse_s + st * kQ + 2 * t4;
      const float* dt = dlt_s + st * kQ + 2 * t4;
      const uint64_t q_tile = q_desc + st * kTileStep, do_tile = do_desc + st * kTileStep;

      // S^T = K Q^T and dP^T = V dO^T, one group each; Q and dO are K-major here.
      mbar_wait(full + st, (t / C::kStages) & 1);
      if constexpr (D == 64) {
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_n64_acc<0>(s, kf[kk], q_tile + kk * 2, kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_n64_acc<0>(dp, vf[kk], do_tile + kk * 2, kk > 0);
        }
        wgmma_commit();
      } else {
        wgmma_fence();
        scores_d128(s, k_own, C::kKVBox / 16, q_tile, kBoxBytes / 16);
        wgmma_commit();
        scores_d128(dp, v_own, C::kKVBox / 16, do_tile, kBoxBytes / 16);
        wgmma_commit();
      }

      wgmma_wait<1>();  // S^T done; dP^T may still run
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * j);
        s[4 * j + 0] = fast_exp2(fmaf(s[4 * j + 0], a.scale_log2, -l2.x));
        s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], a.scale_log2, -l2.y));
        s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], a.scale_log2, -l2.x));
        s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], a.scale_log2, -l2.y));
      }
      if (edge) {  // zero-filled keys would get P = exp2(-L): mask them
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (key0 >= a.kv_len) s[4 * j + 0] = s[4 * j + 1] = 0.f;
          if (key0 + 8 >= a.kv_len) s[4 * j + 2] = s[4 * j + 3] = 0.f;
        }
      }
      if constexpr (D == 64) to_bf16(s, pa);

      wgmma_wait<0>();  // dP^T done
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dt + 8 * j);
        dp[4 * j + 0] = s[4 * j + 0] * (dp[4 * j + 0] - d2.x);
        dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - d2.y);
        dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - d2.x);
        dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - d2.y);
        if constexpr (D == 128) {
          // P and dS to bf16 column pair by column pair, so that each pair's
          // fp32 registers die at once: dK and dV's 128 leave no room for all
          // of P, dS and their bf16 copies together.
          pa[j / 2][2 * (j % 2)] = pack_bf16(s[4 * j + 0], s[4 * j + 1]);
          pa[j / 2][2 * (j % 2) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
          dsa[j / 2][2 * (j % 2)] = pack_bf16(dp[4 * j + 0], dp[4 * j + 1]);
          dsa[j / 2][2 * (j % 2) + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
        }
      }
      if constexpr (D == 64) to_bf16(dp, dsa);
      // dS^T into shared memory for the dQ product, once tile t - kDsBufs's product has read the buffer.
      mbar_wait(ds_empty + buf, ((t / kDsBufs) & 1) ^ 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * kk + (i >> 1), r = i & 1;
          *reinterpret_cast<uint32_t*>(ds_thread + buf * kDsBytes + r * 1024 + ((j * 16) ^ g16)) = dsa[kk][i];
        }
      }
      fence_proxy_async();  // wgmma reads shared memory through the async proxy
      __syncwarp();
      if (lane == 0) mbar_arrive(ds_full + buf);

      // dV += P^T dO and dK += dS^T Q; dO and Q are MN-major here.
      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (D == 64) {
          wgmma_rs_n64(dv, pa[kk], do_tile + kk * 128);
        } else {
          wgmma_rs_n128(dv, pa[kk], do_tile + kk * 128);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (D == 64) {
          wgmma_rs_n64(dk, dsa[kk], q_tile + kk * 128);
        } else {
          wgmma_rs_n128(dk, dsa[kk], q_tile + kk * 128);
        }
      }
      wgmma_commit();
      if (has_dq) start_dq(t - 1);
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + st);
      if (has_dq) {
        if (lane == 0) mbar_arrive(ds_empty + (t - 1) % kDsBufs);
        drain_dq(qt_prev);
      }
      qt_prev = qt;
    }
    if (D != 64 || ((n_tiles - 1) & 1) == cw) {  // the last tile's dQ
      start_dq(n_tiles - 1);
      wgmma_wait<0>();
      drain_dq(qt_prev);
    }
    fence_regs(dk);
    fence_regs(dv);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = key0 + 8 * r;
      if (row < a.skv) {
        __nv_bfloat16* dkr = dkb + (int64_t)row * a.dk_ss;
        __nv_bfloat16* dvr = dvb + (int64_t)row * a.dv_ss;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dkr + 8 * j + 2 * t4) =
              pack_bf16(dk[4 * j + 2 * r] * a.scale, dk[4 * j + 2 * r + 1] * a.scale);
          *reinterpret_cast<uint32_t*>(dvr + 8 * j + 2 * t4) = pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
      }
    }
    if (leader) bulk_wait_read();  // shared memory stays until the last reduction has read it
  }
}

// dQ[b, s, h, :] = bf16(scale * dq_acc[b, h, s, :]), with dq_acc's tiles in
// staging order, their 64-column slices 4096 floats apart: D / 8 threads a
// row, 8 columns each.
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_store_dq(BwdParams p, int64_t n_rows) {
  constexpr int TPR = D / 8, RPB = 128 / TPR;
  const int64_t row = (int64_t)blockIdx.x * RPB + threadIdx.x / TPR;  // (b, s, h), h fastest
  if (row >= n_rows) return;
  const int c = threadIdx.x % TPR;
  const int h = (int)(row % p.heads);
  const int s = (int)((row / p.heads) % p.sq);
  const int64_t b = row / ((int64_t)p.heads * p.sq);
  const float* tile = p.dq_acc + ((b * p.heads + h) * p.sq_pad + s / kQ * kQ) * D + (c / 8) * (kQ * 64);
  const float4* src = reinterpret_cast<const float4*>(tile + staging_offset(s % kQ, c % 8));
  const float4 x = src[0], y = src[1];
  uint4 out;
  out.x = pack_bf16(x.x * p.scale, x.y * p.scale);
  out.y = pack_bf16(x.z * p.scale, x.w * p.scale);
  out.z = pack_bf16(y.x * p.scale, y.y * p.scale);
  out.w = pack_bf16(y.z * p.scale, y.w * p.scale);
  *reinterpret_cast<uint4*>(p.dq + b * p.dq_sb + s * p.dq_ss + h * p.dq_sh + c * 8) = out;
}

// delta and L, the fused pass, then dQ to bf16. Returns a cudaError_t, or
// kEncodeError + the CUresult when a tensor map cannot be encoded.
template <int D>
int run_fused(const BwdParams& p, int batch, cudaStream_t stream) {
  using C = Fused<D>;
  CUtensorMap tq, tk, tv, tdo;
  CUresult r = make_map(&tq, p.q, D, p.sq, p.heads, batch, p.q_ss, p.q_sh, p.q_sb, kQ);
  if (r == CUDA_SUCCESS) r = make_map(&tdo, p.dout, D, p.sq, p.heads, batch, p.do_ss, p.do_sh, p.do_sb, kQ);
  if (r == CUDA_SUCCESS) r = make_map(&tk, p.k, D, p.kv_len, p.heads, batch, p.k_ss, p.k_sh, p.k_sb, kKeys);
  if (r == CUDA_SUCCESS) r = make_map(&tv, p.v, D, p.kv_len, p.heads, batch, p.v_ss, p.v_sh, p.v_sb, kKeys);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;

  const int64_t pad_rows = (int64_t)batch * p.sq_pad * p.heads;
  constexpr int delta_rows = 128 / kDeltaTPR<D>;  // rows a block of flash_bwd_delta
  flash_bwd_delta<D><<<(unsigned)((pad_rows + delta_rows - 1) / delta_rows), 128, 0, stream>>>(p, pad_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  FusedArgs a;
  a.lse2 = p.lse2;
  a.delta = p.delta;
  a.dq_acc = p.dq_acc;
  a.dk = p.dk;
  a.dv = p.dv;
  a.dk_sb = p.dk_sb; a.dk_ss = p.dk_ss; a.dk_sh = p.dk_sh;
  a.dv_sb = p.dv_sb; a.dv_ss = p.dv_ss; a.dv_sh = p.dv_sh;
  a.sq_pad = p.sq_pad;
  a.skv = p.skv;
  a.kv_len = p.kv_len;
  a.heads = p.heads;
  a.scale = p.scale;
  a.scale_log2 = p.scale_log2;
  err = cudaFuncSetAttribute(flash_bwd_fused<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_fused<D><<<dim3((p.skv + kKeys - 1) / kKeys, p.heads, batch), kFusedThreads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t n_rows = (int64_t)batch * p.sq * p.heads;
  constexpr int store_rows = 128 / (D / 8);  // rows a block of flash_bwd_store_dq
  flash_bwd_store_dq<D><<<(unsigned)((n_rows + store_rows - 1) / store_rows), 128, 0, stream>>>(p, n_rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// D = 512: the mma.sync kernels. A block owns DC output columns of dK
// and dV (or of dQ), the D / DC column slices side by side on grid.x, and
// recomputes S and dP over the whole D-deep contraction. The block has 8
// warps: warps w and w + 4 own the same 16 rows, each takes half of the
// contraction of S and dP and half of the block's DC columns, and the pair
// swaps its fp32 partial scores through shared memory, so that both hold the
// same S and dP bit for bit (fp32 addition commutes).
// dK/dV: one block per 64 keys and DC columns; warp w owns keys 16 (w % 4) .. + 15 of the tile.
// ---------------------------------------------------------------------------
// The pair's one configuration: head dim D, DC output columns a block, KSPLIT
// warps sharing 16 rows, and tiles of TILE queries (the dK/dV sweep) or keys
// (the dQ sweep): two 64-row x 512-column tiles already fill 130 KB of
// shared memory.
namespace pair {

constexpr int D = 512, DC = 256, KSPLIT = 2, TILE = 16;
constexpr int NT = 128 * KSPLIT, LD = D + 8, kSlices = D / DC;
constexpr int CW = DC / KSPLIT;          // output columns of one warp
constexpr int KSTEPS = D / KSPLIT / 16;  // its 16-deep steps of the S and dP contraction

// This warp's partial S and dP (F floats each a thread) go to shared memory;
// once its partner's are there, each adds the other's to its own. The
// caller's next __syncthreads keeps the buffer until both have read it.
template <int F>
__device__ __forceinline__ void swap_partials(float (&s)[F / 4][4], float (&dp)[F / 4][4], float* xs, int warp,
                                              int lane) {
  float4* mine = reinterpret_cast<float4*>(xs + (warp * 32 + lane) * 2 * F);
  const float4* theirs = reinterpret_cast<const float4*>(xs + (((warp + 4) % 8) * 32 + lane) * 2 * F);
#pragma unroll
  for (int i = 0; i < F / 4; ++i) {
    mine[i] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    mine[F / 4 + i] = make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
  }
  named_barrier_sync(1 + warp % 4, 64);
#pragma unroll
  for (int i = 0; i < F / 4; ++i) {
    const float4 a = theirs[i], c = theirs[F / 4 + i];
    s[i][0] += a.x, s[i][1] += a.y, s[i][2] += a.z, s[i][3] += a.w;
    dp[i][0] += c.x, dp[i][1] += c.y, dp[i][2] += c.z, dp[i][3] += c.w;
  }
}

__global__ void __launch_bounds__(NT) flash_bwd_dkdv(BwdParams p) {
  constexpr int BN = 64, BQ = TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + BN * LD;
  __nv_bfloat16* qs = vs + BN * LD;      // [2][BQ * LD]
  __nv_bfloat16* dos = qs + 2 * BQ * LD;  // [2][BQ * LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ], L * log2(e)
  float* dlt_s = lse_s + 2 * BQ;                                // [2][BQ]
  float* xs = dlt_s + 2 * BQ;  // [8 warps][32 lanes][BQ / 2] partial S and dP

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4, rg = warp % 4, half = warp / 4;
  const int k0 = (int)(blockIdx.x / kSlices) * BN, c0 = (int)(blockIdx.x % kSlices) * DC;
  const int h = blockIdx.y, b = blockIdx.z;
  __nv_bfloat16* dkb = p.dk + b * p.dk_sb + h * p.dk_sh + c0;
  __nv_bfloat16* dvb = p.dv + b * p.dv_sb + h * p.dv_sh + c0;

  if (k0 >= p.kv_len) {  // every key of the tile is masked: zero rows
    const int rows = min(BN, p.skv - k0);
    for (int i = threadIdx.x; i < rows * (DC / 8); i += NT) {
      const int r = i / (DC / 8), c = i % (DC / 8);
      *reinterpret_cast<uint4*>(dkb + (int64_t)(k0 + r) * p.dk_ss + c * 8) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dvb + (int64_t)(k0 + r) * p.dv_ss + c * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lseb = p.lse + ((int64_t)b * p.heads + h) * p.sq;
  const float* dltb = p.delta + ((int64_t)b * p.heads + h) * p.sq;

  auto load_queries = [&](int t, int buf) {
    load_tile<D, LD, NT>(qs + buf * BQ * LD, qb, p.q_ss, t * BQ, BQ, p.sq);
    load_tile<D, LD, NT>(dos + buf * BQ * LD, dob, p.do_ss, t * BQ, BQ, p.sq);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const int qi = t * BQ + i;
      const bool ok = qi < p.sq;
      lse_s[buf * BQ + i] = ok ? lseb[qi] * kLog2e : 0.f;
      dlt_s[buf * BQ + i] = ok ? dltb[qi] : 0.f;
    }
  };

  load_tile<D, LD, NT>(ks, kb, p.k_ss, k0, BN, p.kv_len);
  load_tile<D, LD, NT>(vs, vb, p.v_ss, k0, BN, p.kv_len);
  cp_async_commit();
  load_queries(0, 0);
  cp_async_commit();

  float dk[CW / 8][4], dv[CW / 8][4];
#pragma unroll
  for (int i = 0; i < CW / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const int key0 = k0 + rg * 16 + g;  // this thread's key rows: key0 and key0 + 8
  const bool key_ok[2] = {key0 < p.kv_len, key0 + 8 < p.kv_len};
  const __nv_bfloat16* kw = ks + rg * 16 * LD + half * (D / KSPLIT);
  const __nv_bfloat16* vw = vs + rg * 16 * LD + half * (D / KSPLIT);
  const int cw = c0 + half * CW;  // this warp's first output column
  const int n_tiles = (p.sq + BQ - 1) / BQ;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_queries(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and query tile t have landed
    __syncthreads();
    const __nv_bfloat16* qt = qs + buf * BQ * LD;
    const __nv_bfloat16* dot = dos + buf * BQ * LD;
    const float* lt = lse_s + buf * BQ;
    const float* dt = dlt_s + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ queries, over its share of D.
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    const __nv_bfloat16* qh = qt + half * (D / KSPLIT);
    const __nv_bfloat16* doh = dot + half * (D / KSPLIT);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, kw, kk, g, t4);
      load_a<LD>(va, vw, kk, g, t4);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const __nv_bfloat16* qr = qh + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        const __nv_bfloat16* dr = doh + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        mma_bf16(s[nt], ka, ld32(qr), ld32(qr + 8));
        mma_bf16(dp[nt], va, ld32(dr), ld32(dr + 8));
      }
    }
    swap_partials<BQ / 2>(s, dp, xs, warp, lane);

    // P^T and dS^T as bf16 A fragments (16 keys x 16 queries each).
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      float pv[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t4 + (e & 1);
        const bool ok = key_ok[e >> 1] && t * BQ + qc < p.sq;
        pv[e] = ok ? exp2f(s[nt][e] * p.scale_log2 - lt[qc]) : 0.f;
        ds[e] = pv[e] * (dp[nt][e] - dt[qc]);
      }
      pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(pv[0], pv[1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      dsa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO and dK += dS^T Q over this warp's CW columns.
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
#pragma unroll
      for (int dn = 0; dn < CW / 8; dn += 2) {
        uint32_t bo[4], bq[4];
        ldmatrix_x4_trans(bo, trans_addr<LD>(dot, j * 16, cw + dn * 8, lane));
        ldmatrix_x4_trans(bq, trans_addr<LD>(qt, j * 16, cw + dn * 8, lane));
        mma_bf16(dv[dn], pa[j], bo[0], bo[1]);
        mma_bf16(dv[dn + 1], pa[j], bo[2], bo[3]);
        mma_bf16(dk[dn], dsa[j], bq[0], bq[1]);
        mma_bf16(dk[dn + 1], dsa[j], bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `buf` (and its partner with xs) before they are refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key0 + 8 * r;
    if (row < p.skv) {
      __nv_bfloat16* dkr = dkb + (int64_t)row * p.dk_ss + half * CW;
      __nv_bfloat16* dvr = dvb + (int64_t)row * p.dv_ss + half * CW;
#pragma unroll
      for (int dn = 0; dn < CW / 8; ++dn) {
        *reinterpret_cast<uint32_t*>(dkr + dn * 8 + 2 * t4) =
            pack_bf16(dk[dn][2 * r] * p.scale, dk[dn][2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvr + dn * 8 + 2 * t4) = pack_bf16(dv[dn][2 * r], dv[dn][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per 64 queries and DC columns, key tiles of BN; warp w owns
// queries 16 (w % 4) .. + 15 and half of the contraction and of the columns.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) flash_bwd_dq(BwdParams p) {
  constexpr int BM = 64, BN = TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + BM * LD;
  __nv_bfloat16* ks = dos + BM * LD;     // [2][BN * LD]
  __nv_bfloat16* vs = ks + 2 * BN * LD;  // [2][BN * LD]
  float* xs = reinterpret_cast<float*>(vs + 2 * BN * LD);  // [8 warps][32 lanes][BN / 2]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4, rg = warp % 4, half = warp / 4;
  const int q0 = (int)(blockIdx.x / kSlices) * BM, c0 = (int)(blockIdx.x % kSlices) * DC;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lseb = p.lse + ((int64_t)b * p.heads + h) * p.sq;
  const float* dltb = p.delta + ((int64_t)b * p.heads + h) * p.sq;

  load_tile<D, LD, NT>(qs, qb, p.q_ss, q0, BM, p.sq);
  load_tile<D, LD, NT>(dos, dob, p.do_ss, q0, BM, p.sq);
  load_tile<D, LD, NT>(ks, kb, p.k_ss, 0, BN, p.kv_len);
  load_tile<D, LD, NT>(vs, vb, p.v_ss, 0, BN, p.kv_len);
  cp_async_commit();

  const int row0 = q0 + rg * 16 + g;  // this thread's query rows: row0 and row0 + 8
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < p.sq ? lseb[row] * kLog2e : 0.f;
    dlt_r[r] = row < p.sq ? dltb[row] : 0.f;
  }
  float dq[CW / 8][4];
#pragma unroll
  for (int i = 0; i < CW / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const __nv_bfloat16* qw = qs + rg * 16 * LD + half * (D / KSPLIT);
  const __nv_bfloat16* dw = dos + rg * 16 * LD + half * (D / KSPLIT);
  const int cw = c0 + half * CW;
  const int n_tiles = (p.kv_len + BN - 1) / BN;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<D, LD, NT>(ks + (buf ^ 1) * BN * LD, kb, p.k_ss, (t + 1) * BN, BN, p.kv_len);
      load_tile<D, LD, NT>(vs + (buf ^ 1) * BN * LD, vb, p.v_ss, (t + 1) * BN, BN, p.kv_len);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and key tile t have landed
    __syncthreads();
    const __nv_bfloat16* kt = ks + buf * BN * LD;
    const __nv_bfloat16* vt = vs + buf * BN * LD;

    // S = Q K^T and dP = dO V^T for this warp's 16 queries x BN keys, over its share of D.
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    const __nv_bfloat16* kh = kt + half * (D / KSPLIT);
    const __nv_bfloat16* vh = vt + half * (D / KSPLIT);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, qw, kk, g, t4);
      load_a<LD>(da, dw, kk, g, t4);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const __nv_bfloat16* kr = kh + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        const __nv_bfloat16* vr = vh + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        mma_bf16(s[nt], qa, ld32(kr), ld32(kr + 8));
        mma_bf16(dp[nt], da, ld32(vr), ld32(vr + 8));
      }
    }
    swap_partials<BN / 2>(s, dp, xs, warp, lane);

    uint32_t dsa[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * BN + nt * 8 + 2 * t4 + (e & 1);
        const float pv = col < p.kv_len ? exp2f(s[nt][e] * p.scale_log2 - lse_r[e >> 1]) : 0.f;
        ds[e] = pv * (dp[nt][e] - dlt_r[e >> 1]);
      }
      dsa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K over this warp's CW columns.
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
#pragma unroll
      for (int dn = 0; dn < CW / 8; dn += 2) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, trans_addr<LD>(kt, j * 16, cw + dn * 8, lane));
        mma_bf16(dq[dn], dsa[j], bk[0], bk[1]);
        mma_bf16(dq[dn + 1], dsa[j], bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `buf` (and its partner with xs) before they are refilled
  }

  __nv_bfloat16* dqb = p.dq + b * p.dq_sb + h * p.dq_sh + cw;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < p.sq) {
      __nv_bfloat16* dqr = dqb + (int64_t)row * p.dq_ss;
#pragma unroll
      for (int dn = 0; dn < CW / 8; ++dn) {
        *reinterpret_cast<uint32_t*>(dqr + dn * 8 + 2 * t4) =
            pack_bf16(dq[dn][2 * r] * p.scale, dq[dn][2 * r + 1] * p.scale);
      }
    }
  }
}

// delta, then dK/dV, then dQ.
cudaError_t run(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t kSwap = 8 * 32 * sizeof(float);  // partial scores, times the tile's rows
  const int64_t n_rows = (int64_t)batch * p.sq * p.heads;
  constexpr int rows_per_block = 128 / kDeltaTPR<D>;
  flash_bwd_delta<D><<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block), 128, 0, stream>>>(p, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t dkdv_smem =
      (size_t)(2 * 64 + 4 * TILE) * LD * sizeof(__nv_bfloat16) + 4 * TILE * sizeof(float) + kSwap * TILE;
  err = launch(flash_bwd_dkdv, dim3((p.skv + 63) / 64 * kSlices, p.heads, batch), dkdv_smem, p, stream, NT);
  if (err != cudaSuccess) return err;
  const size_t dq_smem = (size_t)(2 * 64 + 4 * TILE) * LD * sizeof(__nv_bfloat16) + kSwap * TILE;
  return launch(flash_bwd_dq, dim3((p.sq + 63) / 64 * kSlices, p.heads, batch), dq_smem, p,
                stream, NT);
}

}  // namespace pair

}  // namespace

// C entry point, every kernel on `stream`. Strides are in elements; the last
// (D) stride must be 1 and every other stride a multiple of 8, with 16-byte
// aligned base pointers (the Python wrapper checks this). `sq_pad` is the row
// pitch of the fp32 scratch: at D = 64 and 128, Sq rounded up to 64, with
// `delta` and `lse2` (B, H, sq_pad) and `dq_acc` (B, H, sq_pad * D), the last
// zeroed by the caller; at D = 512, Sq, with `delta` (B, H, Sq) and the other
// two null. Returns the
// first failing launch's cudaError_t, kEncodeError + the CUresult when a
// tensor map cannot be encoded, or 0.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                              const float* lse, float* delta, float* lse2, float* dq_acc, void* dq, void* dk,
                              void* dv, int batch, int sq, int sq_pad, int skv, int heads, int head_dim, int kv_len,
                              float scale, const long long* strides, void* stream) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.lse2 = lse2;
  p.dq_acc = dq_acc;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.sq = sq;
  p.sq_pad = sq_pad;
  p.skv = skv;
  p.kv_len = kv_len;
  p.heads = heads;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  // strides: (batch, seq, head) of q, k, v, o, dout, dq, dk, dv, in that order
  int64_t* dst[24] = {&p.q_sb,  &p.q_ss,  &p.q_sh,  &p.k_sb,  &p.k_ss,  &p.k_sh,  &p.v_sb,  &p.v_ss,
                      &p.v_sh,  &p.o_sb,  &p.o_ss,  &p.o_sh,  &p.do_sb, &p.do_ss, &p.do_sh, &p.dq_sb,
                      &p.dq_ss, &p.dq_sh, &p.dk_sb, &p.dk_ss, &p.dk_sh, &p.dv_sb, &p.dv_ss, &p.dv_sh};
  for (int i = 0; i < 24; ++i) *dst[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
    case 128:
      if (lse2 == nullptr || dq_acc == nullptr || sq_pad % kQ != 0 || sq_pad < sq) return (int)cudaErrorInvalidValue;
      return head_dim == 64 ? run_fused<64>(p, batch, s) : run_fused<128>(p, batch, s);
    case 512:
      if (sq_pad != sq) return (int)cudaErrorInvalidValue;
      return (int)pair::run(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
