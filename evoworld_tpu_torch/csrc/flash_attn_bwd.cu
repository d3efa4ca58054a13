// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV of exact
// non-causal O = softmax(Q K^T * scale) V over (B, S, H, D) bf16 or fp16
// tensors read through their strides, with keys at or past `kv_len` masked,
// from the forward's output O and per-row log-sum-exp L (flash_attn_fwd.cu,
// fp32 (B, H, Sq)) and the output's gradient dO. dQ, dK, dV are written in
// the inputs' type through their strides (the wrapper makes them
// contiguous). Every kernel is a template over the element type T, as in
// flash_attn_fwd.cu: one design for both types, P and dS rounded to T as
// wgmma operands.
//
// Replaces the two backward Pallas TPU kernels of K1
// (evoworld_tpu/ops/attention.py::_builtin_flash, JAX's shipped flash
// attention, whose custom_vjp is jax/experimental/pallas/ops/tpu/
// flash_attention.py::_flash_attention_bwd): `_flash_attention_bwd_dkv` and
// `_flash_attention_bwd_dq`. The TPU kernels walk a sequential grid axis and
// carry dK/dV (or dQ) in VMEM scratch, recomputing S and dP in each. Blocks on
// this card run in no order, so each sweep is a loop inside one block.
//
// Bound: 10*B*H*Sq*kv_len*D flops of bf16 / fp16 tensor-core work (five
// products of 2*Sq*kv_len*D each: S, dP, dV, dK, dQ) against about
// (4*Sq + 4*Skv)*B*H*D*2 bytes; at the training shape's 9216 tokens the
// operations bound it by three orders of magnitude. Beside the tensor cores, one exp2 per score runs on the
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
//                     and writes dS^T as T into a 128-key x 64-query
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
//   flash_bwd_store_dq  dQ = T(scale * buffer).
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
//     offset is the box distance); P and dS become T column pair by
//     column pair as dS is formed;
//   - each consumer computes its own 64 columns of every tile's dQ over all
//     128 keys (B = K's box cw), one tile late as at D = 64 but only once
//     the next tile's dK and dV products have drained (with all three in
//     flight ptxas runs short of registers and serializes every wgmma of
//     the pass), and adds the 64 x 64 fp32 part into a (B, H, Sq', 128)
//     buffer with one bulk reduction; both consumers read each dS^T buffer;
//   - the query ring has 3 stages (227 KB of shared memory in all).
// The order of the fp32 sums into dQ changes from run to run, so dQ may
// differ in its last bit between two calls; dK and dV are repeatable.
//
// D = 512 (the VAE's mid-block attention, one head of 512; no path of the
// port or of the JAX package forms this gradient, the VAE being frozen). A
// 64 x 512 fp32 gradient tile takes 256 registers a thread, and dK and dV of
// 64 keys together would fill the register file, so no block holds both and
// one fused pass cannot exist here. After flash_bwd_delta (its scratch padded
// as at D = 64) three wgmma + TMA sweeps run, each block shaped like
// flash_fwd_wide's: a producer warpgroup (one thread starts every TMA load
// into 64-column boxes in the 128-byte swizzle) and two consumers, consumer
// c owning columns 256 c .. 256 c + 255 of the sweep's gradient (128 fp32
// registers) and the same half of every 512-deep score contraction. The two
// swap their fp32 partial scores through shared memory under named barriers
// and each adds the other's to its own: fp32 addition commutes, so both hold
// the same scores bit for bit.
//   flash_bwd_wide_dv  one block per 64 keys, K resident; Q and dO in tiles
//                      of 64 queries. S^T = K Q^T (m64n64k16), the exchange,
//                      P^T = exp2(S^T * scale * log2(e) - L * log2(e)), dV +=
//                      P^T dO (m64n256k16, P^T from registers, dO through
//                      the transpose bit): flash_fwd_wide with Q and K
//                      swapped, dO in V's place and no online softmax; tile
//                      t's S^T and tile t - 1's dV product run together.
//   flash_bwd_wide_dk  one block per 64 keys, K and V resident; Q and dO in
//                      tiles of 32 queries. S^T and dP^T = V dO^T (m64n32k16),
//                      one exchange for both, dS^T = P^T (dP^T - delta), dK +=
//                      dS^T Q (m64n256k16, dS^T from registers, 2 k-steps).
//   flash_bwd_wide_dq  one block per 64 queries, Q and dO resident; K and V
//                      in tiles of 32 keys: S, dP, dS as in the dK sweep,
//                      dQ += dS K.
// That is 2 + 3 + 3 = 8 products where the function needs 5 (1.6x). A
// streamed tile sits in one group of boxes per consumer and operand, each
// with its own full and empty mbarrier. Shared memory (of the 232,448 bytes
// a block may use):
//   - dV sweep, 230,472 bytes: K (64 KB), one Q and one dO tile (64 KB
//     each), and 32 KB of partials;
//   - dK and dQ sweeps, 230,504 bytes: 128 KB resident, Q (K) in a
//     two-stage ring of 32-row tiles (64 KB), so that the next tile's Q
//     arrives during this one, and dO (V) in one stage (32 KB). Once a
//     consumer's dP product has read its dO (V) boxes, they carry its
//     partials to the other consumer: no separate partials buffer.
// Keys at or past `kv_len` get P = 0 (masked in the last key tile only) and
// zero rows of dK and dV. No sweep sums across blocks, so dQ, dK and dV
// repeat bit for bit. The bound is the function's, 10*B*H*Sq*kv_len*512
// flops: 3.52 ms at (8, 9216, 1, 512) on an H100's 989 TFLOP/s (PERF.md §6).

#include "flash_attn_hopper.cuh"

namespace {

using namespace flash;

template <typename T>
struct BwdParams {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  const float* lse;  // (B, H, Sq), natural log
  float* delta;      // (B, H, sq_pad)
  float* lse2;       // (B, H, sq_pad): lse * log2(e)
  float* dq_acc;     // (B, H, sq_pad, D) fp32 sums of dQ / scale; null at D = 512
  T* dq;
  T* dk;
  T* dv;
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
template <int D, typename T>
__global__ void __launch_bounds__(128) flash_bwd_delta(BwdParams<T> p, int64_t n_rows) {
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
      const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&ov);
      const uint32_t* d2 = reinterpret_cast<const uint32_t*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = unpack2<T>(o2[i]), y = unpack2<T>(d2[i]);
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

// flash_bwd_delta over every row of the padded scratch.
template <int D, typename T>
cudaError_t launch_delta(const BwdParams<T>& p, int batch, cudaStream_t stream) {
  const int64_t pad_rows = (int64_t)batch * p.sq_pad * p.heads;
  constexpr int rows = 128 / kDeltaTPR<D>;  // rows a block
  flash_bwd_delta<D, T><<<(unsigned)((pad_rows + rows - 1) / rows), 128, 0, stream>>>(p, pad_rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fused pass, D = 64 and 128.
// ---------------------------------------------------------------------------
constexpr int kKeys = 128;          // keys per block, 64 per consumer warpgroup
constexpr int kQ = 64;              // queries per tile
constexpr int kFusedThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;   // arrivals that free a ring buffer or fill a dS^T buffer
constexpr int kDsBufs = 2;          // dS^T buffers
// Tiles of 2-byte elements (bf16 or fp16):
constexpr uint32_t kDsBytes = kKeys * 128;  // one 128-key x 64-query dS^T tile
constexpr uint32_t kBoxBytes = kQ * 128;    // one 64-row x 64-column box (a query tile's, or a consumer's keys)
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

template <typename T>
struct FusedArgs {
  const float* lse2;   // (B, H, sq_pad)
  const float* delta;  // (B, H, sq_pad)
  float* dq_acc;       // (B, H, sq_pad / 64, 64 * D) in staging order, zeroed by the caller
  T* dk;
  T* dv;
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

// A 64 x 64 fp32 accumulator as A fragments of T: two adjacent 8-column blocks
// make one 16-deep k-step.
template <typename T>
__device__ __forceinline__ void to_frags(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack2<T>(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
  }
}

// The A fragments (16 rows of this warp, four 16-column k-steps) of a 64-row x
// 64-column tile of 2-byte elements in the 128-byte swizzle: the 16-byte chunk c of row r
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
template <typename T>
__device__ __forceinline__ void scores_d128(float (&acc)[32], uint64_t a, uint32_t a_box, uint64_t b,
                                            uint32_t b_box) {
  wgmma_ss_n64_first<T, 0, 0>(acc, a, b);
#pragma unroll
  for (int kk = 1; kk < 8; ++kk) {
    wgmma_ss_n64<T, 0, 0>(acc, a + (kk / 4) * a_box + (kk % 4) * 2, b + (kk / 4) * b_box + (kk % 4) * 2, 1);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kFusedThreads, 1)
    flash_bwd_fused(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const FusedArgs<T> a) {
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
  T* dkb = a.dk + b * a.dk_sb + h * a.dk_sh;
  T* dvb = a.dv + b * a.dv_sb + h * a.dv_sh;

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
          wgmma_ss_n64<T, 1, 1>(dq, ds_desc + at * kDsStep + kk * 128, k_dq_desc + kk * 128, kk > 0);
        }
      } else {  // the first k-step only writes dq, which stays dead from the last drain until here
        wgmma_fence();
        wgmma_ss_n64_first<T, 1, 1>(dq, ds_desc + at * kDsStep, k_dq_desc);
#pragma unroll
        for (int kk = 1; kk < 8; ++kk) {
          wgmma_ss_n64<T, 1, 1>(dq, ds_desc + at * kDsStep + kk * 128, k_dq_desc + kk * 128, 1);
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
      // started one tile late, when the other consumer's half of dS^T has
      // long arrived: at D = 64 behind the next tile's dV and dK, at D = 128
      // once they are done (dK, dV and dQ in flight together leave ptxas
      // short of registers, and it then serializes every wgmma of the pass).
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
          wgmma_rs_n64_acc<T, 0>(s, kf[kk], q_tile + kk * 2, kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_n64_acc<T, 0>(dp, vf[kk], do_tile + kk * 2, kk > 0);
        }
        wgmma_commit();
      } else {
        wgmma_fence();
        scores_d128<T>(s, k_own, C::kKVBox / 16, q_tile, kBoxBytes / 16);
        wgmma_commit();
        scores_d128<T>(dp, v_own, C::kKVBox / 16, do_tile, kBoxBytes / 16);
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
      if constexpr (D == 64) to_frags<T>(s, pa);

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
          // P and dS to T column pair by column pair, so that each pair's
          // fp32 registers die at once: dK and dV's 128 leave no room for all
          // of P, dS and their packed copies together.
          pa[j / 2][2 * (j % 2)] = pack2<T>(s[4 * j + 0], s[4 * j + 1]);
          pa[j / 2][2 * (j % 2) + 1] = pack2<T>(s[4 * j + 2], s[4 * j + 3]);
          dsa[j / 2][2 * (j % 2)] = pack2<T>(dp[4 * j + 0], dp[4 * j + 1]);
          dsa[j / 2][2 * (j % 2) + 1] = pack2<T>(dp[4 * j + 2], dp[4 * j + 3]);
        }
      }
      if constexpr (D == 64) to_frags<T>(dp, dsa);
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
          wgmma_rs_n64<T>(dv, pa[kk], do_tile + kk * 128);
        } else {
          wgmma_rs_n128<T>(dv, pa[kk], do_tile + kk * 128);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (D == 64) {
          wgmma_rs_n64<T>(dk, dsa[kk], q_tile + kk * 128);
        } else {
          wgmma_rs_n128<T>(dk, dsa[kk], q_tile + kk * 128);
        }
      }
      wgmma_commit();
      if (D == 64 && has_dq) start_dq(t - 1);
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + st);
      if (has_dq) {
        if (D == 128) {
          start_dq(t - 1);
          wgmma_wait<0>();
        }
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
        T* dkr = dkb + (int64_t)row * a.dk_ss;
        T* dvr = dvb + (int64_t)row * a.dv_ss;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          // dK's scale is applied in fp32, before the rounding to T, as the plain version does
          *reinterpret_cast<uint32_t*>(dkr + 8 * j + 2 * t4) =
              pack2<T>(dk[4 * j + 2 * r] * a.scale, dk[4 * j + 2 * r + 1] * a.scale);
          *reinterpret_cast<uint32_t*>(dvr + 8 * j + 2 * t4) = pack2<T>(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
      }
    }
    if (leader) bulk_wait_read();  // shared memory stays until the last reduction has read it
  }
}

// dQ[b, s, h, :] = T(scale * dq_acc[b, h, s, :]), with dq_acc's tiles in
// staging order, their 64-column slices 4096 floats apart: D / 8 threads a
// row, 8 columns each.
template <int D, typename T>
__global__ void __launch_bounds__(128) flash_bwd_store_dq(BwdParams<T> p, int64_t n_rows) {
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
  out.x = pack2<T>(x.x * p.scale, x.y * p.scale);
  out.y = pack2<T>(x.z * p.scale, x.w * p.scale);
  out.z = pack2<T>(y.x * p.scale, y.y * p.scale);
  out.w = pack2<T>(y.z * p.scale, y.w * p.scale);
  *reinterpret_cast<uint4*>(p.dq + b * p.dq_sb + s * p.dq_ss + h * p.dq_sh + c * 8) = out;
}

// delta and L, the fused pass, then dQ to T. Returns a cudaError_t, or
// kEncodeError + the CUresult when a tensor map cannot be encoded.
template <int D, typename T>
int run_fused(const BwdParams<T>& p, int batch, cudaStream_t stream) {
  using C = Fused<D>;
  CUtensorMap tq, tk, tv, tdo;
  CUresult r = make_map<T>(&tq, p.q, D, p.sq, p.heads, batch, p.q_ss, p.q_sh, p.q_sb, kQ);
  if (r == CUDA_SUCCESS) r = make_map<T>(&tdo, p.dout, D, p.sq, p.heads, batch, p.do_ss, p.do_sh, p.do_sb, kQ);
  if (r == CUDA_SUCCESS) r = make_map<T>(&tk, p.k, D, p.kv_len, p.heads, batch, p.k_ss, p.k_sh, p.k_sb, kKeys);
  if (r == CUDA_SUCCESS) r = make_map<T>(&tv, p.v, D, p.kv_len, p.heads, batch, p.v_ss, p.v_sh, p.v_sb, kKeys);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;

  cudaError_t err = launch_delta<D, T>(p, batch, stream);
  if (err != cudaSuccess) return (int)err;

  FusedArgs<T> a;
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
  err = cudaFuncSetAttribute(flash_bwd_fused<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_fused<D, T><<<dim3((p.skv + kKeys - 1) / kKeys, p.heads, batch), kFusedThreads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t n_rows = (int64_t)batch * p.sq * p.heads;
  constexpr int store_rows = 128 / (D / 8);  // rows a block of flash_bwd_store_dq
  flash_bwd_store_dq<D, T><<<(unsigned)((n_rows + store_rows - 1) / store_rows), 128, 0, stream>>>(p, n_rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// D = 512: three wgmma + TMA sweeps with flash_fwd_wide's block. Consumer c
// owns columns 256 c .. 256 c + 255 of the sweep's gradient and the same
// half of every 512-deep score contraction; the consumers swap their fp32
// partial scores through shared memory (see the file's header).
// ---------------------------------------------------------------------------
namespace wide {

constexpr int kD = 512;
constexpr int kHalfBoxes = kD / 128;  // 64-column boxes of one consumer's 256 columns
constexpr int kRows = 64;             // rows of a resident tile: a block's keys (dV, dK) or queries (dQ)
constexpr int kThreads = 384;         // producer warpgroup + two consumer warpgroups
// Registers of a producer / consumer thread, as flash_bwd_fused<128>: a
// consumer holds 128 fp32 of its gradient beside 32 of scores.
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr uint32_t kResBox = kRows * 128;                 // one 64-row x 64-column box
constexpr uint32_t kResBytes = 2 * kHalfBoxes * kResBox;  // one resident 64 x 512 tile
constexpr int kXsFloats = 64 * 64;  // the dV sweep's partials of one consumer: 64 x 64 of S^T
// Named barriers of the exchange (0 is __syncthreads): both consumers'
// partials written; (dV sweep) consumer c's partials read by the other consumer.
constexpr int kBarScores = 1, kBarRead = 2;

// A sweep whose streamed tiles have kTile rows. Its shared memory: 1024
// bytes of slack to align the tiles, kRes resident tiles, kGroups groups of
// streamed boxes, each holding one consumer's 256 columns of one streamed
// operand, with a full and an empty mbarrier each, and in the dV sweep the
// consumers' partials:
//   dV sweep  group c: Q of consumer c, group 2 + c: dO; 230,472 bytes;
//   dK / dQ   group 2 s + c: x0 (Q or K) of consumer c in stage s of a
//             two-stage ring, group 4 + c: x1 (dO or V), which also carries
//             consumer c's partials once its dP product has read it;
//             230,504 of the 232,448 bytes.
template <int kTile>
struct Sweep {
  static constexpr bool kDv = kTile == 64;
  static constexpr int kRes = kDv ? 1 : 2;      // K (dV sweep); K and V, or Q and dO
  static constexpr int kGroups = kDv ? 4 : 6;
  static constexpr uint32_t kBox = kTile * 128;  // one streamed 64-column box
  static constexpr uint32_t kGroup = kHalfBoxes * kBox;
  static constexpr uint32_t kXsBytes = kDv ? 2 * kXsFloats * 4 : 0;
  static constexpr size_t kSmem = 1024 + kRes * kResBytes + kGroups * kGroup + kXsBytes + (1 + 2 * kGroups) * 8;
};

struct Smem {
  unsigned char* res;   // resident tile i at res + i * kResBytes
  unsigned char* ring;  // group gi at ring + gi * kGroup
  float* xs;            // dV sweep: consumer c's partials at xs + c * kXsFloats
  uint64_t* res_full;
  uint64_t* full;   // [kGroups], one per group
  uint64_t* empty;  // [kGroups]
};

template <int kTile>
__device__ __forceinline__ Smem smem_layout(unsigned char* raw) {
  using S = Sweep<kTile>;
  Smem m;
  m.res = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  m.ring = m.res + S::kRes * kResBytes;
  m.xs = reinterpret_cast<float*>(m.ring + S::kGroups * S::kGroup);
  m.res_full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(m.xs) + S::kXsBytes);
  m.full = m.res_full + 1;
  m.empty = m.full + S::kGroups;
  if (threadIdx.x == 0) {
    mbar_init(m.res_full, 1);
    for (int gi = 0; gi < S::kGroups; ++gi) {
      mbar_init(m.full + gi, 1);
      // The owning consumer's 4 warps; both consumers' 8 for the dK and dQ
      // sweeps' x1 groups, which the other consumer reads partials from.
      mbar_init(m.empty + gi, S::kDv || gi < 4 ? 4 : 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return m;
}

template <typename T>
struct WideArgs {
  const float* lse2;   // (B, H, sq_pad): L * log2(e), kPadLse on padded rows
  const float* delta;  // (B, H, sq_pad), 0 on padded rows
  T* out;              // dV, dK or dQ
  int64_t out_sb, out_ss, out_sh;
  int sq, sq_pad, skv, kv_len, heads;
  float out_scale;   // 1 for dV, the softmax scale for dK and dQ
  float scale_log2;  // scale * log2(e)
};

// Rows row0 .. row0 + rows - 1 of a 512-wide gradient as zeros (keys at or past kv_len).
template <typename T>
__device__ __forceinline__ void zero_rows(T* base, int64_t ss, int row0, int rows) {
  for (int i = threadIdx.x; i < rows * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = i % (kD / 8);
    *reinterpret_cast<uint4*>(base + (int64_t)(row0 + r) * ss + c * 8) = make_uint4(0, 0, 0, 0);
  }
}

// The producer's thread: rows row0 .. row0 + 63 of `r0` (and of `r1` where
// the sweep keeps two resident tiles), all 512 columns.
template <int kTile>
__device__ __forceinline__ void load_resident(const Smem& m, const CUtensorMap* r0, const CUtensorMap* r1, int row0,
                                              int h, int b) {
  constexpr int kRes = Sweep<kTile>::kRes;
  mbar_expect_tx(m.res_full, kRes * kResBytes);
#pragma unroll 1
  for (int x = 0; x < 2 * kHalfBoxes; ++x) {
    tma_load(m.res + x * kResBox, r0, m.res_full, x * 64, row0, h, b);
    if (kRes == 2) tma_load(m.res + kResBytes + x * kResBox, r1, m.res_full, x * 64, row0, h, b);
  }
}

// The producer's thread: rows t * kTile .. of a streamed operand into
// groups g0 (consumer 0's 256 columns) and g0 + 1 (consumer 1's), each once
// freed for the `round`-th time (the first round finds them free). Rolled
// loops: the producer keeps kProducerRegs registers.
template <int kTile>
__device__ __forceinline__ void load_streamed(const Smem& m, const CUtensorMap* map, int g0, int round, int t, int h,
                                              int b) {
  using S = Sweep<kTile>;
  const uint32_t free_parity = (round & 1) ^ 1;
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    const int gi = g0 + c;
    mbar_wait(m.empty + gi, free_parity);
    mbar_expect_tx(m.full + gi, S::kGroup);
#pragma unroll 1
    for (int j = 0; j < kHalfBoxes; ++j) {
      tma_load(m.ring + gi * S::kGroup + j * S::kBox, map, m.full + gi, (c * kHalfBoxes + j) * 64, t * kTile, h, b);
    }
  }
}

// This thread's float4 slots of a consumer's partials (128 float4 apart)
// from v, and the other consumer's added to v. fp32 addition commutes, so
// both consumers then hold the same sums bit for bit.
template <int N>
__device__ __forceinline__ void put_partials(float4* dst, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) dst[i * 128] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
template <int N>
__device__ __forceinline__ void add_partials(float (&v)[N], const float4* src) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 x = src[i * 128];
    v[4 * i] += x.x;
    v[4 * i + 1] += x.y;
    v[4 * i + 2] += x.z;
    v[4 * i + 3] += x.w;
  }
}

// A consumer's 64 x 256 fp32 gradient times `mult` as T: this thread's
// rows row0 and row0 + 8 where under `limit`, at `base` (its first column).
template <typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[128], T* base, int64_t ss, int row0,
                                           int limit, float mult, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < limit) {
      T* dst = base + (int64_t)row * ss + 2 * t4;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack2<T>(acc[4 * j + 2 * r] * mult, acc[4 * j + 2 * r + 1] * mult);
      }
    }
  }
}

// dV: one block per 64 keys (K resident), Q and dO in tiles of 64 queries.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_wide_dv(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo, const WideArgs<T> a) {
  using S = Sweep<64>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  T* outb = a.out + b * a.out_sb + h * a.out_sh;
  if (k0 >= a.kv_len) {  // every key of the tile is masked: zero rows
    zero_rows(outb, a.out_ss, k0, min(kRows, a.skv - k0));
    return;
  }
  const Smem m = smem_layout<64>(smem_raw);
  const int n_tiles = a.sq_pad / 64;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // Producer: Q of tile t goes out before dO of tile t - 1, whose groups free later.
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      load_resident<64>(m, &tk, &tk, k0, h, b);
#pragma unroll 1
      for (int t = 0; t < n_tiles; ++t) {
        load_streamed<64>(m, &tq, 0, t, t, h, b);
        if (t > 0) load_streamed<64>(m, &tdo, 2, t - 1, t - 1, h, b);
      }
      load_streamed<64>(m, &tdo, 2, n_tiles - 1, n_tiles - 1, h, b);
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int c = wg - 1, ctid = threadIdx.x % 128, warp = ctid / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    uint64_t* q_full = m.full + c;
    uint64_t* q_empty = m.empty + c;
    uint64_t* do_full = m.full + 2 + c;
    uint64_t* do_empty = m.empty + 2 + c;
    const uint64_t k_desc = sw128_desc(m.res + c * kHalfBoxes * kResBox, 16, 1024);      // K-major
    const uint64_t q_desc = sw128_desc(m.ring + c * S::kGroup, 16, 1024);               // K-major
    const uint64_t do_desc = sw128_desc(m.ring + (2 + c) * S::kGroup, S::kBox, 1024);  // MN-major
    float4* mine = reinterpret_cast<float4*>(m.xs + c * kXsFloats) + ctid;
    const float4* theirs = reinterpret_cast<const float4*>(m.xs + (1 - c) * kXsFloats) + ctid;
    const float* lse_cols = a.lse2 + ((int64_t)b * a.heads + h) * a.sq_pad + 2 * t4;
    const int key0 = k0 + warp * 16 + g;  // this thread's key rows: key0 and key0 + 8
    const bool edge = k0 + kRows > a.kv_len;
    auto release = [&](uint64_t* bar) {  // one arrival per warp
      if (lane == 0) mbar_arrive(bar);
    };

    float s[32], dv[128];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 128; ++i) dv[i] = 0.f;
    uint32_t p[4][4];
    float2 l2[8];  // L * log2(e) of this thread's query columns 8 j + 2 t4 + (0, 1) of the tile

    // This consumer's half of S^T = K Q^T: 16 k-steps over its 4 boxes.
    auto scores = [&]() {
      // Formed anew for each tile: held across the loop, the 32 descriptors
      // would not fit in the registers beside dV.
      uint64_t kd = k_desc, qd = q_desc;
      asm volatile("" : "+l"(kd), "+l"(qd));
#pragma unroll
      for (int kk = 0; kk < 4 * kHalfBoxes; ++kk) {
        const uint32_t off = ((kk / 4) * kResBox + (kk % 4) * 32) / 16;  // both operands in 64-row boxes
        wgmma_ss_n64<T, 0, 0>(s, kd + off, qd + off, kk > 0);
      }
    };
    auto exchange = [&](int t) {
      if (t > 0) named_barrier_sync(kBarRead + c, 256);  // the other consumer has read tile t - 1's
      put_partials(mine, s);
      named_barrier_sync(kBarScores, 256);
      add_partials(s, theirs);
      if (t + 1 < n_tiles) named_barrier_arrive(kBarRead + 1 - c, 256);
    };
    auto load_lse = [&](int t) {
#pragma unroll
      for (int j = 0; j < 8; ++j) l2[j] = *reinterpret_cast<const float2*>(lse_cols + t * 64 + 8 * j);
    };
    // P^T = exp2(S^T * scale * log2(e) - L * log2(e)) in place; a padded
    // query has a huge L and gets 0, a key at or past kv_len is masked.
    auto probs = [&]() {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j + 0] = fast_exp2(fmaf(s[4 * j + 0], a.scale_log2, -l2[j].x));
        s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], a.scale_log2, -l2[j].y));
        s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], a.scale_log2, -l2[j].x));
        s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], a.scale_log2, -l2[j].y));
      }
      if (edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (key0 >= a.kv_len) s[4 * j + 0] = s[4 * j + 1] = 0.f;
          if (key0 + 8 >= a.kv_len) s[4 * j + 2] = s[4 * j + 3] = 0.f;
        }
      }
    };
    // dV (64 keys x this half's 256 columns) += P^T (registers) dO.
    auto dv_product = [&]() {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n256<T>(dv, p[kk], do_desc + kk * 16 * 128 / 16);
    };

    // Tile 0: S^T alone.
    mbar_wait(m.res_full, 0);
    load_lse(0);
    mbar_wait(q_full, 0);
    fence_regs(s);
    wgmma_fence();
    scores();
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release(q_empty);
    exchange(0);
    probs();
    to_frags<T>(s, p);

    for (int t = 1; t < n_tiles; ++t) {
      // Tile t's S^T and tile t - 1's dV product go to the tensor cores together.
      load_lse(t);
      mbar_wait(q_full, t & 1);
      mbar_wait(do_full, (t - 1) & 1);
      fence_regs(s);
      fence_regs(dv);
      wgmma_fence();
      scores();
      wgmma_commit();
      dv_product();
      wgmma_commit();
      wgmma_wait<1>();  // S^T done; the dV product may still run
      fence_regs(s);
      release(q_empty);
      exchange(t);
      probs();
      wgmma_wait<0>();  // the dV product done: p and the dO group are free
      fence_regs(dv);
      release(do_empty);
      to_frags<T>(s, p);
    }
    mbar_wait(do_full, (n_tiles - 1) & 1);
    fence_regs(dv);
    wgmma_fence();
    dv_product();
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    store_rows(dv, outb + c * kHalfBoxes * 64, a.out_ss, key0, a.skv, a.out_scale, t4);
  }
}

// dK (kKeys: K and V resident, Q and dO streamed in tiles of 32 queries) or
// dQ (Q and dO resident, K and V streamed in tiles of 32 keys). r0 / x0 are
// the operands of the scores (K / Q or Q / K), r1 / x1 those of dP (V / dO
// or dO / V); the gradient product reads x0 again. x0 goes through a
// two-stage ring, so tile t + 1's arrives while tile t is worked on; x1 has
// one stage, and once both consumers' dP products have read tile t's x1 its
// groups carry the consumers' partial scores of the exchange.
template <typename T, bool kKeys>
__device__ __forceinline__ void ds_sweep(const CUtensorMap* r0, const CUtensorMap* r1, const CUtensorMap* x0,
                                         const CUtensorMap* x1, const WideArgs<T>& a) {
  using S = Sweep<32>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  T* outb = a.out + b * a.out_sb + h * a.out_sh;
  if (kKeys && row0 >= a.kv_len) {  // every key of the tile is masked: zero rows
    zero_rows(outb, a.out_ss, row0, min(kRows, a.skv - row0));
    return;
  }
  const Smem m = smem_layout<32>(smem_raw);
  const int n_tiles = ((kKeys ? a.sq : a.kv_len) + 31) / 32;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // Producer: tile t's x1 frees after tile t - 1's exchange, the stage of
    // tile t + 1's x0 after tile t - 1's gradient product, in that order.
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      load_resident<32>(m, r0, r1, row0, h, b);
      load_streamed<32>(m, x0, 0, 0, 0, h, b);
#pragma unroll 1
      for (int t = 0; t < n_tiles; ++t) {
        load_streamed<32>(m, x1, 4, t, t, h, b);
        if (t + 1 < n_tiles) load_streamed<32>(m, x0, 2 * ((t + 1) & 1), (t + 1) >> 1, t + 1, h, b);
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int c = wg - 1, ctid = threadIdx.x % 128, warp = ctid / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    constexpr uint32_t kStageStep = 2 * S::kGroup / 16;  // descriptor units between x0's stages
    const uint64_t r0_desc = sw128_desc(m.res + c * kHalfBoxes * kResBox, 16, 1024);              // K-major
    const uint64_t r1_desc = sw128_desc(m.res + kResBytes + c * kHalfBoxes * kResBox, 16, 1024);  // K-major
    const uint64_t x0_desc = sw128_desc(m.ring + c * S::kGroup, 16, 1024);                        // K-major
    const uint64_t x0_mn = sw128_desc(m.ring + c * S::kGroup, S::kBox, 1024);                    // MN-major
    const uint64_t x1_desc = sw128_desc(m.ring + (4 + c) * S::kGroup, 16, 1024);                  // K-major
    // Each consumer's partials go into its own x1 group (16 KB: 64 x 32 fp32 of S and of dP).
    float4* mine = reinterpret_cast<float4*>(m.ring + (4 + c) * S::kGroup) + ctid;
    const float4* theirs = reinterpret_cast<const float4*>(m.ring + (5 - c) * S::kGroup) + ctid;
    const int64_t bh = ((int64_t)b * a.heads + h) * a.sq_pad;
    const int rows0 = row0 + warp * 16 + g;  // this thread's rows: rows0 and rows0 + 8
    const bool edge = kKeys && row0 + kRows > a.kv_len;
    auto release = [&](uint64_t* bar) {  // one arrival per warp
      if (lane == 0) mbar_arrive(bar);
    };
    // dQ: L * log2(e) and delta of this thread's two query rows.
    float l2r[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
    if constexpr (!kKeys) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l2r[r] = a.lse2[bh + rows0 + 8 * r];
        dr[r] = a.delta[bh + rows0 + 8 * r];
      }
    }

    float s[16], dp[16], acc[128];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t dsa[2][4];

    // This consumer's half of a 64 x 32 product over 512 columns: 16 k-steps
    // over its 4 boxes of the resident tile and of the streamed one.
    auto partial = [&](float (&d)[16], uint64_t rd, uint64_t xd) {
      asm volatile("" : "+l"(rd), "+l"(xd));  // descriptors formed anew for each tile, as in dv's scores
#pragma unroll
      for (int kk = 0; kk < 4 * kHalfBoxes; ++kk) {
        wgmma_ss_n32<T>(d, rd + ((kk / 4) * kResBox + (kk % 4) * 32) / 16, xd + ((kk / 4) * S::kBox + (kk % 4) * 32) / 16,
                     kk > 0);
      }
    };

    mbar_wait(m.res_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t & 1;
      // dK: L * log2(e) and delta of this thread's query columns 8 j + 2 t4 + (0, 1) of the tile.
      float2 l2c[4], dc[4];
      if constexpr (kKeys) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          l2c[j] = *reinterpret_cast<const float2*>(a.lse2 + bh + t * 32 + 8 * j + 2 * t4);
          dc[j] = *reinterpret_cast<const float2*>(a.delta + bh + t * 32 + 8 * j + 2 * t4);
        }
      }
      // S first: its x0 arrived during the previous tile; x1 was reloaded
      // after the previous tile's exchange.
      mbar_wait(m.full + 2 * st + c, (t >> 1) & 1);
      fence_regs(s);
      wgmma_fence();
      partial(s, r0_desc, x0_desc + st * kStageStep);
      wgmma_commit();
      mbar_wait(m.full + 4 + c, t & 1);
      fence_regs(dp);
      wgmma_fence();
      partial(dp, r1_desc, x1_desc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // One exchange for both partials, through the x1 groups; then both
      // groups may take the next tile's x1 (8 arrivals each).
      put_partials(mine, s);
      put_partials(mine + 4 * 128, dp);
      named_barrier_sync(kBarScores, 256);
      add_partials(s, theirs);
      add_partials(dp, theirs + 4 * 128);
      fence_proxy_async();  // ordinary accesses before the TMA's next writes there
      release(m.empty + 4);
      release(m.empty + 5);

      // P = exp2(S * scale * log2(e) - L * log2(e)) and dS = P (dP - delta),
      // as A fragments of T: two 8-column blocks make one 16-deep k-step.
      // A padded query has a huge L and gets P = 0; keys at or past kv_len
      // are masked in the last key tile (dK: the block's rows, dQ: columns).
      const bool last = !kKeys && t == n_tiles - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l2 = kKeys ? ((e & 1) ? l2c[j].y : l2c[j].x) : l2r[e >> 1];
          pv[e] = fast_exp2(fmaf(s[4 * j + e], a.scale_log2, -l2));
          if (edge && rows0 + 8 * (e >> 1) >= a.kv_len) pv[e] = 0.f;
          if (last && t * 32 + 8 * j + 2 * t4 + (e & 1) >= a.kv_len) pv[e] = 0.f;
          const float d = kKeys ? ((e & 1) ? dc[j].y : dc[j].x) : dr[e >> 1];
          pv[e] *= dp[4 * j + e] - d;
        }
        dsa[j / 2][2 * (j % 2)] = pack2<T>(pv[0], pv[1]);
        dsa[j / 2][2 * (j % 2) + 1] = pack2<T>(pv[2], pv[3]);
      }

      // The gradient (64 rows x this half's 256 columns) += dS x0, x0 read
      // MN-major: 2 k-steps of 16 streamed rows. Drained inside the tile: a
      // product left in flight across the loop's back edge makes ptxas
      // serialize every wgmma of the loop.
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) wgmma_rs_n256<T>(acc, dsa[kk], x0_mn + st * kStageStep + kk * 16 * 128 / 16);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(m.empty + 2 * st + c);
    }
    store_rows(acc, outb + c * kHalfBoxes * 64, a.out_ss, rows0, kKeys ? a.skv : a.sq, a.out_scale, t4);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_wide_dk(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                      const WideArgs<T> a) {
  ds_sweep<T, true>(&tk, &tv, &tq, &tdo, a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_wide_dq(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                      const WideArgs<T> a) {
  ds_sweep<T, false>(&tq, &tdo, &tk, &tv, a);
}

// Points `a` at one gradient.
template <typename T>
void set_out(WideArgs<T>& a, T* out, int64_t sb, int64_t ss, int64_t sh, float scale) {
  a.out = out;
  a.out_sb = sb;
  a.out_ss = ss;
  a.out_sh = sh;
  a.out_scale = scale;
}

// delta and L, then the dV, dK and dQ sweeps. Returns a cudaError_t, or
// kEncodeError + the CUresult when a tensor map cannot be encoded.
template <typename T>
int run(const BwdParams<T>& p, int batch, cudaStream_t stream) {
  // 64-row boxes for the resident tiles and the dV sweep's query tiles,
  // 32-row boxes for the dK and dQ sweeps' streamed tiles.
  CUtensorMap q64, do64, k64, v64, q32, do32, k32, v32;
  CUresult r = make_map<T>(&q64, p.q, kD, p.sq, p.heads, batch, p.q_ss, p.q_sh, p.q_sb, 64);
  if (r == CUDA_SUCCESS) r = make_map<T>(&q32, p.q, kD, p.sq, p.heads, batch, p.q_ss, p.q_sh, p.q_sb, 32);
  if (r == CUDA_SUCCESS) r = make_map<T>(&do64, p.dout, kD, p.sq, p.heads, batch, p.do_ss, p.do_sh, p.do_sb, 64);
  if (r == CUDA_SUCCESS) r = make_map<T>(&do32, p.dout, kD, p.sq, p.heads, batch, p.do_ss, p.do_sh, p.do_sb, 32);
  if (r == CUDA_SUCCESS) r = make_map<T>(&k64, p.k, kD, p.kv_len, p.heads, batch, p.k_ss, p.k_sh, p.k_sb, 64);
  if (r == CUDA_SUCCESS) r = make_map<T>(&k32, p.k, kD, p.kv_len, p.heads, batch, p.k_ss, p.k_sh, p.k_sb, 32);
  if (r == CUDA_SUCCESS) r = make_map<T>(&v64, p.v, kD, p.kv_len, p.heads, batch, p.v_ss, p.v_sh, p.v_sb, 64);
  if (r == CUDA_SUCCESS) r = make_map<T>(&v32, p.v, kD, p.kv_len, p.heads, batch, p.v_ss, p.v_sh, p.v_sb, 32);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;

  cudaError_t err = launch_delta<kD, T>(p, batch, stream);
  if (err != cudaSuccess) return (int)err;
  WideArgs<T> a;
  a.lse2 = p.lse2;
  a.delta = p.delta;
  a.sq = p.sq;
  a.sq_pad = p.sq_pad;
  a.skv = p.skv;
  a.kv_len = p.kv_len;
  a.heads = p.heads;
  a.scale_log2 = p.scale_log2;
  const dim3 keys((p.skv + kRows - 1) / kRows, p.heads, batch), queries(p.sq_pad / kRows, p.heads, batch);

  set_out(a, p.dv, p.dv_sb, p.dv_ss, p.dv_sh, 1.f);
  err = cudaFuncSetAttribute(flash_bwd_wide_dv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sweep<64>::kSmem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_wide_dv<T><<<keys, kThreads, Sweep<64>::kSmem, stream>>>(k64, q64, do64, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  set_out(a, p.dk, p.dk_sb, p.dk_ss, p.dk_sh, p.scale);
  err = cudaFuncSetAttribute(flash_bwd_wide_dk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sweep<32>::kSmem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_wide_dk<T><<<keys, kThreads, Sweep<32>::kSmem, stream>>>(k64, v64, q32, do32, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  set_out(a, p.dq, p.dq_sb, p.dq_ss, p.dq_sh, p.scale);
  err = cudaFuncSetAttribute(flash_bwd_wide_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sweep<32>::kSmem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_wide_dq<T><<<queries, kThreads, Sweep<32>::kSmem, stream>>>(q64, do64, k32, v32, a);
  return (int)cudaGetLastError();
}

}  // namespace wide

// The backward for element type T: every kernel on `stream` (see the entry
// point below).
template <typename T>
int run_typed(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              float* delta, float* lse2, float* dq_acc, void* dq, void* dk, void* dv, int batch, int sq, int sq_pad,
              int skv, int heads, int head_dim, int kv_len, float scale, const long long* strides,
              cudaStream_t stream) {
  BwdParams<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<const T*>(o);
  p.dout = static_cast<const T*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.lse2 = lse2;
  p.dq_acc = dq_acc;
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
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
  switch (head_dim) {
    case 64:
    case 128:
      if (dq_acc == nullptr) return (int)cudaErrorInvalidValue;
      return head_dim == 64 ? run_fused<64, T>(p, batch, stream) : run_fused<128, T>(p, batch, stream);
    case 512: return wide::run<T>(p, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, every kernel on `stream`. Strides are in elements; the last
// (D) stride must be 1 and every other stride a multiple of 8, with 16-byte
// aligned base pointers (the Python wrapper checks this). `dtype` is the
// element type of q, k, v, o, dout and the gradients (ElemCode: 0 bf16, 1
// fp16). `sq_pad` is Sq rounded up to 64, the row pitch of the fp32 scratch
// `delta` and `lse2` (B, H, sq_pad); at D = 64 and 128 `dq_acc` (B, H, sq_pad
// * D), zeroed by the caller, takes the sums of dQ; D = 512 sums nothing
// across blocks and reads no `dq_acc`. Returns the first failing launch's
// cudaError_t, cudaErrorInvalidValue for a head dim or element type without a
// kernel, kEncodeError + the CUresult when a tensor map cannot be encoded, or 0.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                              const float* lse, float* delta, float* lse2, float* dq_acc, void* dq, void* dk,
                              void* dv, int batch, int sq, int sq_pad, int skv, int heads, int head_dim, int kv_len,
                              int dtype, float scale, const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse2 == nullptr || sq_pad % kQ != 0 || sq_pad < sq) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kElemBf16:
      return run_typed<__nv_bfloat16>(q, k, v, o, dout, lse, delta, lse2, dq_acc, dq, dk, dv, batch, sq, sq_pad, skv,
                                      heads, head_dim, kv_len, scale, strides, s);
    case kElemF16:
      return run_typed<__half>(q, k, v, o, dout, lse, delta, lse2, dq_acc, dq, dk, dv, batch, sq, sq_pad, skv, heads,
                               head_dim, kv_len, scale, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
