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
// Bound: 4*B*H*Sq*Skv*D flops of bf16 tensor-core work (the two products),
// against (2*Sq + 2*Skv)*B*H*D*2 bytes moved (Q, K, V read once, O written
// once); at the main path's 9216 tokens the flops bound it (Sq/2 = 4,608 flops
// per byte, against the card's ~295). The simple design leaves on the
// table: mma.sync m16n8k16 instead of wgmma (the only path to the full rate),
// cp.async with one K and one V buffer instead of a TMA ring fed by a producer
// warp, no persistent blocks, and a 16-row query tile at D = 512 that re-reads
// K and V from L2 once per 16 query rows.
//
// Two block layouts:
//   rows kernel  (D = 64, 128): 4 warps, 64 query rows (16 per warp), 64-key
//                tiles; scores, probabilities and the output accumulator stay
//                in registers.
//   split kernel (D = 512): a 16-row x 512 fp32 accumulator does not fit one
//                warp's registers, so 4 warps split D (128 columns each) for
//                P V, and split the 32-key tile (8 keys each) for Q K^T; row
//                maxima and sums meet in shared memory.
// Both use dynamic shared memory (above 48 KB for D >= 128).
//
// With a non-null `lse` the rows kernel also writes each row's natural-log
// log-sum-exp of the scaled scores, fp32 (B, H, Sq), once per row at the end:
// the residual the backward kernels (flash_attn_bwd.cu) recompute P from.
// The serving path passes null and writes nothing more. The split kernel has
// no backward, so it takes no `lse`.

#include <math.h>

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

__device__ __forceinline__ float softmax_exp(float x, bool use_exp2) {
  return use_exp2 ? exp2f(x) : expf(x);
}

// Natural-log log-sum-exp of a row from its running max (in the exp or exp2
// domain of the scores) and its sum of exponentials.
__device__ __forceinline__ float row_lse(float m, float sum, bool use_exp2) {
  return use_exp2 ? (m + log2f(sum)) * kLn2 : m + logf(sum);
}

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // (B, H, Sq) or null; rows kernel only
  int sq, kv_len, heads;
  float scale;  // already multiplied by log2(e) when use_exp2
  bool use_exp2;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
};

// ---------------------------------------------------------------------------
// rows kernel: D = 64 or 128.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(128) flash_fwd_rows(Params p) {
  constexpr int BM = 64, BN = 64, NT = 128, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BM * LD;
  __nv_bfloat16* vs = ks + BN * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int n_tiles = (p.kv_len + BN - 1) / BN;

  load_tile<D, LD, NT>(qs, qb, p.q_ss, q0, BM, p.sq);
  cp_async_commit();
  load_tile<D, LD, NT>(ks, kb, p.k_ss, 0, BN, p.kv_len);
  cp_async_commit();
  load_tile<D, LD, NT>(vs, vb, p.v_ss, 0, BN, p.kv_len);
  cp_async_commit();

  cp_async_wait<2>();
  __syncthreads();
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* qw = qs + (warp * 16) * LD;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = ld32(qw + g * LD + kk * 16 + 2 * t4);
      qa[kk][1] = ld32(qw + (g + 8) * LD + kk * 16 + 2 * t4);
      qa[kk][2] = ld32(qw + g * LD + kk * 16 + 8 + 2 * t4);
      qa[kk][3] = ld32(qw + (g + 8) * LD + kk * 16 + 8 + 2 * t4);
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<1>();  // K tile t has landed; V tile t may be in flight
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        mma_bf16(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }
    __syncthreads();  // every warp is done with K tile t
    const bool more = t + 1 < n_tiles;
    if (more) load_tile<D, LD, NT>(ks, kb, p.k_ss, (t + 1) * BN, BN, p.kv_len);
    cp_async_commit();

    // Online softmax over this tile; rows g and g + 8 of the warp's 16.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * BN + nt * 8 + 2 * t4 + (e & 1);
        const float x = col < p.kv_len ? s[nt][e] * p.scale : kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = softmax_exp(m[r] - m_new, p.use_exp2);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const float p0 = softmax_exp(s[nt][0] - m[0], p.use_exp2);
      const float p1 = softmax_exp(s[nt][1] - m[0], p.use_exp2);
      const float p2 = softmax_exp(s[nt][2] - m[1], p.use_exp2);
      const float p3 = softmax_exp(s[nt][3] - m[1], p.use_exp2);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      // Two adjacent 16x8 accumulator tiles form one 16x16 A fragment.
      pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    if (more) cp_async_wait<1>(); else cp_async_wait<0>();  // V tile t has landed
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (j * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + dn * 8 + (lane / 16) * 8);
        mma_bf16(o[dn], pa[j], bv[0], bv[1]);
        mma_bf16(o[dn + 1], pa[j], bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with V tile t
    if (more) load_tile<D, LD, NT>(vs, vb, p.v_ss, (t + 1) * BN, BN, p.kv_len);
    cp_async_commit();
  }

  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = q0 + warp * 16 + g + r * 8;
    if (p.lse != nullptr && row < p.sq && t4 == 0) {
      p.lse[((int64_t)b * p.heads + h) * p.sq + row] = row_lse(m[r], sum, p.use_exp2);
    }
    if (row < p.sq) {
      __nv_bfloat16* orow = ob + (int64_t)row * p.o_ss;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t4) =
            pack_bf16(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
      }
    }
  }
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
size_t rows_smem() { return (size_t)(64 + 64 + 64) * (D + 8) * sizeof(__nv_bfloat16); }

template <int D>
size_t split_smem() {
  return (size_t)(16 + 32 + 32) * (D + 8) * sizeof(__nv_bfloat16) + 16 * (32 + 8) * sizeof(__nv_bfloat16) +
         4 * 16 * sizeof(float);
}

}  // namespace

// C entry point. Strides are in elements; the last (D) stride must be 1 and
// every other stride a multiple of 8, with 16-byte aligned base pointers (the
// Python wrapper checks this). Returns the launch's cudaError_t.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int sq,
                              int heads, int head_dim, int kv_len, float scale, int use_exp2, long long q_sb,
                              long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh, long long o_sb, long long o_ss,
                              long long o_sh, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.sq = sq;
  p.kv_len = kv_len;
  p.heads = heads;
  p.use_exp2 = use_exp2 != 0;
  p.scale = p.use_exp2 ? scale * kLog2e : scale;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto grid = [&](int bm) { return dim3((sq + bm - 1) / bm, heads, batch); };
  switch (head_dim) {
    case 64: return (int)launch(flash_fwd_rows<64>, grid(64), rows_smem<64>(), p, s);
    case 128: return (int)launch(flash_fwd_rows<128>, grid(64), rows_smem<128>(), p, s);
    case 512:
      if (lse != nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch(flash_fwd_split<512>, grid(16), split_smem<512>(), p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
