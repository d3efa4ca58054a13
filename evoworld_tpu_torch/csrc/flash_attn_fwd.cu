// Flash-attention forward for Hopper (sm_90a): exact non-causal
// softmax(Q K^T * scale) V over (B, S, H, D) bf16 tensors read through their
// strides, written to a (B, Sq, H, D) bf16 output.
//
// Replaces two TPU kernels that compute this same function:
//   K1  evoworld_tpu/ops/attention.py::_builtin_flash (JAX's shipped Pallas TPU
//       flash kernel; ragged lengths padded and masked with segment ids by
//       _pad_with_segment_mask). Here key columns at or past `kv_len` are masked
//       in the kernel instead, with no padded copies.
//   K2  evoworld_tpu/ops/flash_attention.py::flash_attention / _flash_kernel
//       (the package's own streaming kernel, `kv_len` mask and `use_exp2`).
// K2 carries the running max, normaliser and accumulator in scratch across a
// sequential grid axis. Blocks on this card run in no order, so here the KV
// sweep is a loop inside one block and nothing is carried between blocks.
//
// Bound: 4*B*H*Sq*Skv*D flops of bf16 tensor-core work (the two products)
// against (2*Sq + 2*Skv)*B*H*D*2 bytes moved (Q, K, V read once, O written
// once). At the main path's 9216 tokens the operations bound it: Sq/2 = 4,608
// flops per byte, against the card's ~295. At D = 64 the softmax's exp2 (16
// a clock per SM) needs as many cycles per key tile as the two products at
// the tensor cores' peak, so the design's aim is to overlap the two.
//
// wgmma kernel (D = 64, 128), built for the tensor cores' full rate:
//   - 3 warpgroups, 384 threads, one block per SM. Warpgroup 0 is the
//     producer: one thread issues every TMA load (cp.async.bulk.tensor) and the
//     group gives its registers up (setmaxnreg.dec). Warpgroups 1 and 2 are
//     consumers (setmaxnreg.inc), 64 query rows each: 128 rows a block.
//   - Q is loaded once; K and V tiles of 128 keys go through a ring of
//     kStages buffers with full/empty mbarrier pairs. The tensor maps view the
//     strided tensors as (D, S, H, B) with 64-column boxes in the 128-byte
//     swizzle that wgmma reads; the key extent is `kv_len`, so TMA zero-fills
//     keys past it and a ragged query tile past Sq.
//   - S = Q K^T is wgmma m64n128k16 with both operands in shared memory;
//     O += P V is wgmma with P in registers (the S accumulator's layout is the
//     A operand's, so P is the accumulator converted to bf16) and V read
//     through the descriptor's transpose bit. fp32 accumulation throughout.
//   - Each consumer overlaps its own work: tile t's Q K^T and tile t-1's P V
//     are issued together, and the softmax of tile t runs on the CUDA cores
//     while P V still runs on the tensor cores.
//   - Online softmax in registers with exp2 of scores pre-scaled by
//     scale*log2(e) whatever `use_exp2` says (both modes are the same
//     function); the key-length mask runs on the last key tile only.
//   - With a non-null `lse` each row's natural-log log-sum-exp is written, fp32
//     (B, H, Sq): the residual the backward kernels (flash_attn_bwd.cu)
//     recompute P from. The serving path passes null and writes nothing more.
//
// split kernel (D = 512, the VAE's one head of 512): mma.sync m16n8k16, 4
// warps, 16 query rows and 32-key tiles; a 16-row x 512 fp32 accumulator does
// not fit one warp's registers, so the warps split D (128 columns each) for
// P V and the key tile (8 keys each) for Q K^T, and row maxima and sums meet
// in shared memory. It re-reads K and V from L2 once per 16 query rows and
// takes no `lse` (the VAE has no backward).

#include <math.h>

#include "flash_attn_hopper.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------------
// wgmma kernel: D = 64 or 128.
// ---------------------------------------------------------------------------
constexpr int kBM = 128;           // query rows per block, 64 per consumer warpgroup
constexpr int kBN = 128;           // keys per tile
constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;  // arrivals that free a K or V buffer
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int D>
struct Fwd {
  static constexpr int kBoxes = D / 64;  // 64-column (128-byte) boxes per row
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr uint32_t kBoxQ = kBM * 128, kBoxKV = kBN * 128;  // bytes of one box
  static constexpr uint32_t kQBytes = kBoxes * kBoxQ, kKVBytes = kBoxes * kBoxKV;
  // 1024 bytes of slack to align the tiles, then Q, the K ring, the V ring,
  // and 1 + 4 * kStages mbarriers.
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + (1 + 4 * kStages) * 8;
};

struct FwdArgs {
  __nv_bfloat16* o;
  float* lse;  // (B, H, Sq) or null
  int64_t o_sb, o_ss, o_sh;
  int sq, kv_len, heads;
  float scale_log2;  // scale * log2(e)
};

// S (64 x 128) = Q (64 x D) K^T for one key tile. Each 16-column step is 32
// bytes further into a 128-byte swizzled row; D = 128 spans two boxes.
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[64], uint64_t q_desc, uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss_n128(s, q_desc + ((kk / 4) * Fwd<D>::kBoxQ + (kk % 4) * 32) / 16,
                  k_desc + ((kk / 4) * Fwd<D>::kBoxKV + (kk % 4) * 32) / 16, kk > 0);
  }
}

// O (64 x D) += P (64 x 128, registers) V (128 x D); each 16-key step is 16
// rows of 128 bytes further.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2], const uint32_t (&p)[kBN / 16][4], uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    if constexpr (D == 64) {
      wgmma_rs_n64(o, p[kk], v_desc + kk * 16 * 128 / 16);
    } else {
      wgmma_rs_n128(o, p[kk], v_desc + kk * 16 * 128 / 16);
    }
  }
}

// Scores of keys at or past `limit` (relative to the tile) leave the softmax.
__device__ __forceinline__ void mask_tile(float (&s)[64], int limit, int t4) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (8 * j + 2 * t4 + (e & 1) >= limit) s[4 * j + e] = kNegInf;
    }
  }
}

// Online softmax over one tile in the exp2 domain: s becomes
// exp2(s * scale_log2 - m_new) in place, m and the thread's partial row sums
// l move on, and alpha is the factor for the output accumulated so far.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], scale_log2, neg_m[e >> 1]));
      sum[e >> 1] += s[4 * j + e];
    }
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// Probabilities as bf16 A fragments: two adjacent 8-column accumulator blocks
// make one 16-key k-step.
__device__ __forceinline__ void to_bf16(const float (&s)[64], uint32_t (&p)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  using C = Fwd<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ks = qs + C::kQBytes;                 // stage st at ks + st * kKVBytes
  unsigned char* vs = ks + C::kStages * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + C::kStages * C::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + C::kStages;
  uint64_t* v_full = k_empty + C::kStages;
  uint64_t* v_empty = v_full + C::kStages;

  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (a.kv_len + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(k_empty + st, kConsumerWarps);
      mbar_init(v_empty + st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) tma_load(qs + x * C::kBoxQ, &tq, q_full, x * 64, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % C::kStages;
        const uint32_t free_parity = ((t / C::kStages) & 1) ^ 1;  // the first round finds the ring free
        mbar_wait(k_empty + st, free_parity);
        mbar_expect_tx(k_full + st, C::kKVBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(ks + st * C::kKVBytes + x * C::kBoxKV, &tk, k_full + st, x * 64, t * kBN, h, b);
        }
        mbar_wait(v_empty + st, free_parity);
        mbar_expect_tx(v_full + st, C::kKVBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(vs + st * C::kKVBytes + x * C::kBoxKV, &tv, v_full + st, x * 64, t * kBN, h, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63.
    reg_alloc<kConsumerRegs>();
    const int cw = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint64_t q_desc = sw128_desc(qs + cw * 64 * 128, 16, 1024);
    const uint64_t k_desc = sw128_desc(ks, 16, 1024);          // K-major, 8-row groups 1024 bytes apart
    const uint64_t v_desc = sw128_desc(vs, C::kBoxKV, 1024);   // MN-major, boxes kBoxKV bytes apart
    constexpr uint32_t kStageStep = C::kKVBytes / 16;           // descriptor units between stages

    float s[64], o[D / 2];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    uint32_t p[kBN / 16][4];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];

    // Tile 0: Q K^T alone.
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    fence_regs(s);
    wgmma_fence();
    qk_tile<D>(s, q_desc, k_desc);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(k_empty);
    if (n_tiles == 1) mask_tile(s, a.kv_len, t4);
    softmax_tile(s, m, l, alpha, a.scale_log2);
    to_bf16(s, p);

    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % C::kStages, prev = (t - 1) % C::kStages;
      // Tile t's Q K^T and tile t-1's P V go to the tensor cores together.
      mbar_wait(v_full + prev, ((t - 1) / C::kStages) & 1);
      mbar_wait(k_full + st, (t / C::kStages) & 1);
      fence_regs(s);
      fence_regs(o);
      wgmma_fence();
      qk_tile<D>(s, q_desc, k_desc + st * kStageStep);
      wgmma_commit();
      pv_tile<D>(o, p, v_desc + prev * kStageStep);
      wgmma_commit();
      wgmma_wait<1>();  // Q K^T done; P V may still run
      fence_regs(s);
      if (lane == 0) mbar_arrive(k_empty + st);
      if (t == n_tiles - 1) mask_tile(s, a.kv_len - t * kBN, t4);
      softmax_tile(s, m, l, alpha, a.scale_log2);
      wgmma_wait<0>();  // P V done: o and p are free
      fence_regs(o);
      if (lane == 0) mbar_arrive(v_empty + prev);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      to_bf16(s, p);
    }
    const int last = (n_tiles - 1) % C::kStages;
    mbar_wait(v_full + last, ((n_tiles - 1) / C::kStages) & 1);
    fence_regs(o);
    wgmma_fence();
    pv_tile<D>(o, p, v_desc + last * kStageStep);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    __nv_bfloat16* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(l[r]);
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      const int row = q0 + cw * 64 + warp * 16 + g + 8 * r;
      if (row < a.sq) {
        __nv_bfloat16* orow = ob + (int64_t)row * a.o_ss;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
              pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        }
        if (a.lse != nullptr && t4 == 0) {
          a.lse[((int64_t)b * a.heads + h) * a.sq + row] = (m[r] + log2f(sum)) * kLn2;
        }
      }
    }
  }
}

template <int D>
int launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const FwdArgs& a, int batch,
                 cudaStream_t stream) {
  const size_t smem = Fwd<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_wgmma<D><<<dim3((a.sq + kBM - 1) / kBM, a.heads, batch), kThreads, smem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

// Parameters of the split kernel (D = 512).
struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int sq, kv_len, heads;
  float scale;  // already multiplied by log2(e) when use_exp2
  bool use_exp2;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
};

__device__ __forceinline__ float softmax_exp(float x, bool use_exp2) {
  return use_exp2 ? exp2f(x) : expf(x);
}

// ---------------------------------------------------------------------------
// split kernel: D = 512 (VAE mid-block attention, one head of 512).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(128) flash_fwd_split(Params p) {
  constexpr int BM = 16, BN = 32, NT = 128, NW = 4, LD = D + 8, LDP = BN + 8;
  constexpr int DW = D / NW;  // output columns owned by each warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BM * LD;
  __nv_bfloat16* vs = ks + BN * LD;
  __nv_bfloat16* ps = vs + BN * LD;
  float* red = reinterpret_cast<float*>(ps + BM * LDP);  // [NW][BM]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int n_tiles = (p.kv_len + BN - 1) / BN;

  load_tile<D, LD, NT>(qs, qb, p.q_ss, q0, BM, p.sq);
  load_tile<D, LD, NT>(ks, kb, p.k_ss, 0, BN, p.kv_len);
  cp_async_commit();
  load_tile<D, LD, NT>(vs, vb, p.v_ss, 0, BN, p.kv_len);
  cp_async_commit();

  float o[DW / 8][4];
#pragma unroll
  for (int i = 0; i < DW / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<1>();  // Q and K tile t have landed
    __syncthreads();

    // This warp's 8 key columns of the 16 x 32 score tile, over all of D.
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      a[0] = ld32(qs + g * LD + kk * 16 + 2 * t4);
      a[1] = ld32(qs + (g + 8) * LD + kk * 16 + 2 * t4);
      a[2] = ld32(qs + g * LD + kk * 16 + 8 + 2 * t4);
      a[3] = ld32(qs + (g + 8) * LD + kk * 16 + 8 + 2 * t4);
      const __nv_bfloat16* kr = ks + (warp * 8 + g) * LD + kk * 16 + 2 * t4;
      mma_bf16(s, a, ld32(kr), ld32(kr + 8));
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = t * BN + warp * 8 + 2 * t4 + (e & 1);
      s[e] = col < p.kv_len ? s[e] * p.scale : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[e]);
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    if (t4 == 0) {
      red[warp * BM + g] = mx[0];
      red[warp * BM + g + 8] = mx[1];
    }
    __syncthreads();  // partial maxima visible; every warp is done with K tile t
    const bool more = t + 1 < n_tiles;
    if (more) load_tile<D, LD, NT>(ks, kb, p.k_ss, (t + 1) * BN, BN, p.kv_len);
    cp_async_commit();

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tile_max = red[g + 8 * r];
#pragma unroll
      for (int w = 1; w < NW; ++w) tile_max = fmaxf(tile_max, red[w * BM + g + 8 * r]);
      const float m_new = fmaxf(m[r], tile_max);
      alpha[r] = softmax_exp(m[r] - m_new, p.use_exp2);
      m[r] = m_new;
    }
    const float p0 = softmax_exp(s[0] - m[0], p.use_exp2);
    const float p1 = softmax_exp(s[1] - m[0], p.use_exp2);
    const float p2 = softmax_exp(s[2] - m[1], p.use_exp2);
    const float p3 = softmax_exp(s[3] - m[1], p.use_exp2);
    l[0] = l[0] * alpha[0] + p0 + p1;  // this warp's columns only; summed at the end
    l[1] = l[1] * alpha[1] + p2 + p3;
    *reinterpret_cast<uint32_t*>(ps + g * LDP + warp * 8 + 2 * t4) = pack_bf16(p0, p1);
    *reinterpret_cast<uint32_t*>(ps + (g + 8) * LDP + warp * 8 + 2 * t4) = pack_bf16(p2, p3);
#pragma unroll
    for (int i = 0; i < DW / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    if (more) cp_async_wait<1>(); else cp_async_wait<0>();  // V tile t has landed
    __syncthreads();  // P tile visible
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      uint32_t a[4];
      a[0] = ld32(ps + g * LDP + j * 16 + 2 * t4);
      a[1] = ld32(ps + (g + 8) * LDP + j * 16 + 2 * t4);
      a[2] = ld32(ps + g * LDP + j * 16 + 8 + 2 * t4);
      a[3] = ld32(ps + (g + 8) * LDP + j * 16 + 8 + 2 * t4);
#pragma unroll
      for (int dn = 0; dn < DW / 8; dn += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (j * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + warp * DW + dn * 8 +
                                  (lane / 16) * 8);
        mma_bf16(o[dn], a, bv[0], bv[1]);
        mma_bf16(o[dn + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with V tile t, P and the maxima
    if (more) load_tile<D, LD, NT>(vs, vb, p.v_ss, (t + 1) * BN, BN, p.kv_len);
    cp_async_commit();
  }

  // Row sums: each warp holds the sum over its own columns.
  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  if (t4 == 0) {
    red[warp * BM + g] = l0;
    red[warp * BM + g + 8] = l1;
  }
  __syncthreads();
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) sum += red[w * BM + g + 8 * r];
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = q0 + g + r * 8;
    if (row < p.sq) {
      __nv_bfloat16* orow = ob + (int64_t)row * p.o_ss + warp * DW;
#pragma unroll
      for (int dn = 0; dn < DW / 8; ++dn) {
        *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t4) =
            pack_bf16(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
      }
    }
  }
}

template <int D>
size_t split_smem() {
  return (size_t)(16 + 32 + 32) * (D + 8) * sizeof(__nv_bfloat16) + 16 * (32 + 8) * sizeof(__nv_bfloat16) +
         4 * 16 * sizeof(float);
}

}  // namespace

// C entry point. Strides are in elements; the last (D) stride must be 1 and
// every other stride a multiple of 8, with 16-byte aligned base pointers (the
// Python wrapper checks this). `use_exp2` selects nothing at D = 64/128,
// where both modes are the same function. Returns the launch's cudaError_t,
// or kEncodeError + the CUresult when a tensor map cannot be encoded.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int sq,
                              int heads, int head_dim, int kv_len, float scale, int use_exp2, long long q_sb,
                              long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh, long long o_sb, long long o_ss,
                              long long o_sh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64 || head_dim == 128) {
    CUtensorMap tq, tk, tv;
    CUresult r = make_map(&tq, q, head_dim, sq, heads, batch, q_ss, q_sh, q_sb, kBM);
    if (r == CUDA_SUCCESS) r = make_map(&tk, k, head_dim, kv_len, heads, batch, k_ss, k_sh, k_sb, kBN);
    if (r == CUDA_SUCCESS) r = make_map(&tv, v, head_dim, kv_len, heads, batch, v_ss, v_sh, v_sb, kBN);
    if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
    FwdArgs a;
    a.o = static_cast<__nv_bfloat16*>(o);
    a.lse = lse;
    a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
    a.sq = sq;
    a.kv_len = kv_len;
    a.heads = heads;
    a.scale_log2 = scale * kLog2e;
    return head_dim == 64 ? launch_wgmma<64>(tq, tk, tv, a, batch, s) : launch_wgmma<128>(tq, tk, tv, a, batch, s);
  }
  if (head_dim != 512 || lse != nullptr) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.sq = sq;
  p.kv_len = kv_len;
  p.heads = heads;
  p.use_exp2 = use_exp2 != 0;
  p.scale = p.use_exp2 ? scale * kLog2e : scale;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  return (int)launch(flash_fwd_split<512>, dim3((sq + 15) / 16, heads, batch), split_smem<512>(), p, s);
}
