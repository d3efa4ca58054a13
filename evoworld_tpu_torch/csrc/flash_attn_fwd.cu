// Flash-attention forward for Hopper (sm_90a): exact non-causal
// softmax(Q K^T * scale) V over (B, S, H, D) bf16 or fp16 tensors read
// through their strides, written to a (B, Sq, H, D) output of the same type.
// Every kernel is a template over the element type T (flash_attn_common.cuh):
// the two types are both 2 bytes, so tiles, swizzle, descriptors and the
// schedule are one design; only the wgmma operand type (.bf16 or .f16), the
// tensor maps' data type and the rounding of P and O to T differ.
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
// Bound: 4*B*H*Sq*Skv*D flops of bf16 / fp16 tensor-core work (the same
// dense rate on this card) (the two products)
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
//     A operand's, so P is the accumulator converted to T) and V read
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
// wide kernel (D = 512, the VAE's one head of 512), `flash_fwd_wide`:
//   - The same three warpgroups and register split, 64 query rows a block
//     (ptxas holds a 384-thread kernel to 168 registers a thread except
//     after setmaxnreg.inc). A 64 x 512 fp32 accumulator would take
//     256 registers a thread, so the consumers split D: consumer c owns output columns 256 c .. 256 c + 255 of all 64 rows
//     (128 registers) and O += P V is wgmma m64n256k16 with P in registers
//     and V through the transpose bit, four 64-column boxes in one product.
//   - S = Q K^T contracts over all 512 columns: each consumer takes the
//     partial sum over its own 256 (wgmma m64n64k16, tiles of 64 keys) and
//     the two swap their 64 x 64 fp32 partials through shared memory under
//     named barriers. Each adds the other's to its own; fp32 addition is
//     commutative, so both hold the same S bit for bit, run the same online
//     softmax and keep the same m and l with no further exchange, and each
//     rescales only its half of O.
//   - Q stays resident (64 KB). K and V come in 64-key x 64-column boxes
//     (8 KB) through 16 ring slots, one K and one V tile: each consumer
//     waits on and frees only its own half of D, a group of 4 K boxes and
//     one of 4 V boxes with a full and an empty barrier each. The producer
//     sends tile t's K before tile t - 1's V, whose slots free later.
//   - K and V are read from L2 once per 64 query rows (21.7 GB at the
//     training chunk's (8, 9216, 1, 512)). Pairing neighbouring query tiles
//     in 2-block clusters that multicast each box to both halved that
//     traffic and measured about 5% slower on an H100 (PERF.md §6): L2
//     does not bound this kernel, so it has no cluster.
//   - With a non-null `lse` consumer 0 writes each row's log-sum-exp, as the
//     wgmma kernel does: both consumers hold the same m and l bit for bit, so
//     either one's is the row's. The VAE's forward passes null; a gradient
//     through it reads it: flash_attn_bwd.cu's D = 512 sweeps
//     (flash_bwd_wide_dv, _dk, _dq), which keep this block's shape.

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

template <typename T>
struct FwdArgs {
  T* o;
  float* lse;  // (B, H, Sq) or null
  int64_t o_sb, o_ss, o_sh;
  int sq, kv_len, heads;
  float scale_log2;  // scale * log2(e)
};

// S (64 x 128) = Q (64 x D) K^T for one key tile. Each 16-column step is 32
// bytes further into a 128-byte swizzled row; D = 128 spans two boxes.
template <int D, typename T>
__device__ __forceinline__ void qk_tile(float (&s)[64], uint64_t q_desc, uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss_n128<T>(s, q_desc + ((kk / 4) * Fwd<D>::kBoxQ + (kk % 4) * 32) / 16,
                  k_desc + ((kk / 4) * Fwd<D>::kBoxKV + (kk % 4) * 32) / 16, kk > 0);
  }
}

// O (64 x D) += P (64 x 128, registers) V (128 x D); each 16-key step is 16
// rows of 128 bytes further.
template <int D, typename T>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2], const uint32_t (&p)[kBN / 16][4], uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    if constexpr (D == 64) {
      wgmma_rs_n64<T>(o, p[kk], v_desc + kk * 16 * 128 / 16);
    } else {
      wgmma_rs_n128<T>(o, p[kk], v_desc + kk * 16 * 128 / 16);
    }
  }
}

// Scores of keys at or past `limit` (relative to the tile) leave the softmax.
// F is the number of score registers of one thread: a tile of 2 F keys.
template <int F>
__device__ __forceinline__ void mask_tile(float (&s)[F], int limit, int t4) {
#pragma unroll
  for (int j = 0; j < F / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (8 * j + 2 * t4 + (e & 1) >= limit) s[4 * j + e] = kNegInf;
    }
  }
}

// Online softmax over one tile in the exp2 domain: s becomes
// exp2(s * scale_log2 - m_new) in place, m and the thread's partial row sums
// l move on, and alpha is the factor for the output accumulated so far.
template <int F>
__device__ __forceinline__ void softmax_tile(float (&s)[F], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < F / 4; ++j) {
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
  for (int j = 0; j < F / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], scale_log2, neg_m[e >> 1]));
      sum[e >> 1] += s[4 * j + e];
    }
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// Probabilities as A fragments of T: two adjacent 8-column accumulator blocks
// make one 16-key k-step.
template <typename T, int F>
__device__ __forceinline__ void to_frags(const float (&s)[F], uint32_t (&p)[F / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < F / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack2<T>(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const FwdArgs<T> a) {
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
    qk_tile<D, T>(s, q_desc, k_desc);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(k_empty);
    if (n_tiles == 1) mask_tile(s, a.kv_len, t4);
    softmax_tile(s, m, l, alpha, a.scale_log2);
    to_frags<T>(s, p);

    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % C::kStages, prev = (t - 1) % C::kStages;
      // Tile t's Q K^T and tile t-1's P V go to the tensor cores together.
      mbar_wait(v_full + prev, ((t - 1) / C::kStages) & 1);
      mbar_wait(k_full + st, (t / C::kStages) & 1);
      fence_regs(s);
      fence_regs(o);
      wgmma_fence();
      qk_tile<D, T>(s, q_desc, k_desc + st * kStageStep);
      wgmma_commit();
      pv_tile<D, T>(o, p, v_desc + prev * kStageStep);
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
      to_frags<T>(s, p);
    }
    const int last = (n_tiles - 1) % C::kStages;
    mbar_wait(v_full + last, ((n_tiles - 1) / C::kStages) & 1);
    fence_regs(o);
    wgmma_fence();
    pv_tile<D, T>(o, p, v_desc + last * kStageStep);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    T* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(l[r]);
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      const int row = q0 + cw * 64 + warp * 16 + g + 8 * r;
      if (row < a.sq) {
        T* orow = ob + (int64_t)row * a.o_ss;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
              pack2<T>(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        }
        if (a.lse != nullptr && t4 == 0) {
          a.lse[((int64_t)b * a.heads + h) * a.sq + row] = (m[r] + log2f(sum)) * kLn2;
        }
      }
    }
  }
}

template <int D, typename T>
int launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const FwdArgs<T>& a, int batch,
                 cudaStream_t stream) {
  const size_t smem = Fwd<D>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_wgmma<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_wgmma<D, T><<<dim3((a.sq + kBM - 1) / kBM, a.heads, batch), kThreads, smem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wide kernel: D = 512 (the VAE's mid-block attention, one head of 512).
// ---------------------------------------------------------------------------
constexpr int kWM = 64;                 // query rows per block
constexpr int kWN = 64;                 // keys per tile
constexpr int kWD = 512;                // head dim
constexpr int kWBoxes = kWD / 64;       // 64-column boxes per row
constexpr int kWHalfBoxes = kWBoxes / 2;  // boxes of one consumer's half of D
constexpr uint32_t kWBox = 64 * 128;    // bytes of one box: 64 rows (queries or keys) x 128 bytes
constexpr int kWSlots = 2 * kWBoxes;    // ring slots: a K and a V tile, 8 + 8 boxes
// The slots in 4 groups of kWHalfBoxes, each with a full and an empty
// barrier: group 2 c holds consumer c's K boxes, group 2 c + 1 its V boxes.
constexpr int kWGroups = kWSlots / kWHalfBoxes;
constexpr uint32_t kWGroupBytes = kWHalfBoxes * kWBox;
// 1024 bytes of slack to align the tiles, then Q, the ring, the two
// consumers' 64 x 64 fp32 partial scores, and 1 + 2 * kWGroups mbarriers.
constexpr size_t kWSmem = 1024 + kWBoxes * kWBox + kWSlots * kWBox + 2 * kWM * kWN * 4 + (1 + 2 * kWGroups) * 8;
// Named barriers of the score exchange (0 is __syncthreads): both partials
// written; consumer c's partial read by the other consumer.
constexpr int kBarScores = 1, kBarRead = 2;

template <typename T>
struct WideArgs {
  T* o;
  float* lse;  // (B, H, Sq) or null
  int64_t o_sb, o_ss, o_sh;
  int sq, kv_len, heads;
  float scale_log2;  // scale * log2(e)
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wide(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const WideArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = qs + kWBoxes * kWBox;
  float* xs = reinterpret_cast<float*>(ring + kWSlots * kWBox);  // [consumer][8][128 threads][4]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(xs + 2 * kWM * kWN);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kWGroups;

  const int q0 = blockIdx.x * kWM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (a.kv_len + kWN - 1) / kWN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int gi = 0; gi < kWGroups; ++gi) {
      mbar_init(full + gi, 1);
      mbar_init(empty + gi, 4);  // the owning consumer's 4 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread. A group is refilled once its consumer has freed
    // it; K of tile t goes out before V of tile t - 1, whose slots free later.
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kWBoxes * kWBox);
#pragma unroll
      for (int x = 0; x < kWBoxes; ++x) tma_load(qs + x * kWBox, &tq, q_full, x * 64, q0, h, b);
      // Rolled loops: the producer keeps to kProducerRegs registers.
      auto load_boxes = [&](const CUtensorMap* map, int kv, int t) {
        const uint32_t free_parity = (t & 1) ^ 1;  // the first round finds the ring free
#pragma unroll 1
        for (int c = 0; c < 2; ++c) {
          const int gi = 2 * c + kv;
          mbar_wait(empty + gi, free_parity);
          mbar_expect_tx(full + gi, kWGroupBytes);
#pragma unroll 1
          for (int j = 0; j < kWHalfBoxes; ++j) {
            tma_load(ring + gi * kWGroupBytes + j * kWBox, map, full + gi, (c * kWHalfBoxes + j) * 64, t * kWN, h, b);
          }
        }
      };
      for (int t = 0; t < n_tiles; ++t) {
        load_boxes(&tk, 0, t);
        if (t > 0) load_boxes(&tv, 1, t - 1);
      }
      load_boxes(&tv, 1, n_tiles - 1);
    }
  } else {
    // Consumers: warpgroup c owns output columns 256 c .. 256 c + 255 of all
    // 64 rows, and the matching half of the contraction of S = Q K^T.
    reg_alloc<kConsumerRegs>();  // a consumer holds ~200 live registers: O alone is 128
    const int c = wg - 1, ctid = threadIdx.x % 128, warp = ctid / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    uint64_t* k_full = full + 2 * c;
    uint64_t* k_empty = empty + 2 * c;
    uint64_t* v_full = k_full + 1;
    uint64_t* v_empty = k_empty + 1;
    const uint64_t q_desc = sw128_desc(qs + c * kWGroupBytes, 16, 1024);
    const uint64_t k_desc = sw128_desc(ring + 2 * c * kWGroupBytes, 16, 1024);              // K-major
    const uint64_t v_desc = sw128_desc(ring + (2 * c + 1) * kWGroupBytes, kWBox, 1024);     // MN-major
    float4* mine = reinterpret_cast<float4*>(xs + c * kWM * kWN) + ctid;
    const float4* theirs = reinterpret_cast<const float4*>(xs + (1 - c) * kWM * kWN) + ctid;

    auto release = [&](uint64_t* bar) {  // one arrival per warp
      if (lane == 0) mbar_arrive(bar);
    };

    float s[32], o[128];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    uint32_t p[kWN / 16][4];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];

    // This consumer's half of S = Q K^T: 16 k-steps over its 4 boxes.
    auto qk = [&]() {
      // The 32 descriptors are formed anew for each tile: held across the
      // loop, they would not fit in the registers beside O.
      uint64_t qd = q_desc, kd = k_desc;
      asm volatile("" : "+l"(qd), "+l"(kd));
#pragma unroll
      for (int kk = 0; kk < 4 * kWHalfBoxes; ++kk) {
        const uint32_t off = ((kk / 4) * kWBox + (kk % 4) * 32) / 16;
        wgmma_ss_n64<T, 0, 0>(s, qd + off, kd + off, kk > 0);
      }
    };
    // Both halves meet in shared memory; each consumer adds the other's to
    // its own. fp32 addition is commutative, so both hold the same S bit for
    // bit, run the same softmax and agree on m and l with no more exchange.
    auto exchange = [&](int t) {
      if (t > 0) named_barrier_sync(kBarRead + c, 256);  // the other consumer has read tile t - 1's
#pragma unroll
      for (int i = 0; i < 8; ++i) mine[i * 128] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      named_barrier_sync(kBarScores, 256);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 x = theirs[i * 128];
        s[4 * i] += x.x;
        s[4 * i + 1] += x.y;
        s[4 * i + 2] += x.z;
        s[4 * i + 3] += x.w;
      }
      if (t + 1 < n_tiles) named_barrier_arrive(kBarRead + 1 - c, 256);
    };
    // O (64 x 256) += P (64 x 64, registers) V (64 keys x this half's 256 columns).
    auto pv = [&]() {
#pragma unroll
      for (int kk = 0; kk < kWN / 16; ++kk) wgmma_rs_n256<T>(o, p[kk], v_desc + kk * 16 * 128 / 16);
    };

    // Tile 0: Q K^T alone.
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    fence_regs(s);
    wgmma_fence();
    qk();
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release(k_empty);
    exchange(0);
    if (n_tiles == 1) mask_tile(s, a.kv_len, t4);
    softmax_tile(s, m, l, alpha, a.scale_log2);
    to_frags<T>(s, p);

    for (int t = 1; t < n_tiles; ++t) {
      // Tile t's Q K^T and tile t-1's P V go to the tensor cores together.
      mbar_wait(k_full, t & 1);
      mbar_wait(v_full, (t - 1) & 1);
      fence_regs(s);
      fence_regs(o);
      wgmma_fence();
      qk();
      wgmma_commit();
      pv();
      wgmma_commit();
      wgmma_wait<1>();  // Q K^T done; P V may still run
      fence_regs(s);
      release(k_empty);
      exchange(t);
      if (t == n_tiles - 1) mask_tile(s, a.kv_len - t * kWN, t4);
      softmax_tile(s, m, l, alpha, a.scale_log2);
      wgmma_wait<0>();  // P V done: o and p are free
      fence_regs(o);
      release(v_empty);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      to_frags<T>(s, p);
    }
    mbar_wait(v_full, (n_tiles - 1) & 1);
    fence_regs(o);
    wgmma_fence();
    pv();
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    T* ob = a.o + b * a.o_sb + h * a.o_sh + c * kWHalfBoxes * 64;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(l[r]);
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < a.sq) {
        T* orow = ob + (int64_t)row * a.o_ss;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
              pack2<T>(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        }
        if (a.lse != nullptr && c == 0 && t4 == 0) {
          a.lse[((int64_t)b * a.heads + h) * a.sq + row] = (m[r] + log2f(sum)) * kLn2;
        }
      }
    }
  }
}

template <typename T>
int launch_wide(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const WideArgs<T>& a, int heads,
                int batch, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWSmem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_wide<T><<<dim3((a.sq + kWM - 1) / kWM, heads, batch), kThreads, kWSmem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

// Both kernels for element type T: the tensor maps, the arguments, the
// launch at head dim 64 / 128 (flash_fwd_wgmma) or 512 (flash_fwd_wide).
// Returns the launch's cudaError_t, cudaErrorInvalidValue for a head dim
// without a kernel, or kEncodeError + the CUresult when a tensor map cannot
// be encoded.
template <typename T>
int run(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int sq, int heads, int head_dim,
        int kv_len, float scale, const long long* st, cudaStream_t s) {
  const bool wide = head_dim == 512;
  if (!wide && head_dim != 64 && head_dim != 128) return (int)cudaErrorInvalidValue;
  const int box_q = wide ? kWM : kBM, box_kv = wide ? kWN : kBN;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map<T>(&tq, q, head_dim, sq, heads, batch, st[1], st[2], st[0], box_q);
  if (r == CUDA_SUCCESS) r = make_map<T>(&tk, k, head_dim, kv_len, heads, batch, st[4], st[5], st[3], box_kv);
  if (r == CUDA_SUCCESS) r = make_map<T>(&tv, v, head_dim, kv_len, heads, batch, st[7], st[8], st[6], box_kv);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  if (wide) {
    WideArgs<T> a;
    a.o = static_cast<T*>(o);
    a.lse = lse;
    a.o_sb = st[9]; a.o_ss = st[10]; a.o_sh = st[11];
    a.sq = sq;
    a.kv_len = kv_len;
    a.heads = heads;
    a.scale_log2 = scale * kLog2e;
    return launch_wide<T>(tq, tk, tv, a, heads, batch, s);
  }
  FwdArgs<T> a;
  a.o = static_cast<T*>(o);
  a.lse = lse;
  a.o_sb = st[9]; a.o_ss = st[10]; a.o_sh = st[11];
  a.sq = sq;
  a.kv_len = kv_len;
  a.heads = heads;
  a.scale_log2 = scale * kLog2e;
  return head_dim == 64 ? launch_wgmma<64, T>(tq, tk, tv, a, batch, s) : launch_wgmma<128, T>(tq, tk, tv, a, batch, s);
}

}  // namespace

// C entry point. Strides are in elements; the last (D) stride must be 1 and
// every other stride a multiple of 8, with 16-byte aligned base pointers (the
// Python wrapper checks this). `dtype` is the element type of q, k, v and o
// (ElemCode: 0 bf16, 1 fp16). `use_exp2` selects nothing: both modes are the
// same function, computed in the exp2 domain. Returns the launch's
// cudaError_t, cudaErrorInvalidValue for a head dim or element type without a
// kernel, or kEncodeError + the CUresult when a tensor map cannot be encoded.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int sq,
                              int heads, int head_dim, int kv_len, float scale, int use_exp2, int dtype,
                              long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                              long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                              long long o_ss, long long o_sh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  switch (dtype) {
    case kElemBf16: return run<__nv_bfloat16>(q, k, v, o, lse, batch, sq, heads, head_dim, kv_len, scale, st, s);
    case kElemF16: return run<__half>(q, k, v, o, lse, batch, sq, heads, head_dim, kv_len, scale, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
