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
// `_flash_attention_bwd_dq`, with the same split into two kernels so that no
// sum crosses blocks and no atomics are needed:
//   delta   D_i = rowsum(dO_i * O_i), fp32 (JAX computes it in jnp, `di`);
//   dK/dV   one block per (64-key tile, head, batch), looping over query
//           tiles: S^T = K Q^T, P^T = exp(S^T * scale - L), dV += P^T dO,
//           dP^T = V dO^T, dS^T = P^T * (dP^T - D), dK += dS^T Q * scale;
//   dQ      one block per (64-query tile, head, batch), looping over key
//           tiles: the same S, P, dP, dS, then dQ += dS K * scale.
// The TPU kernels walk a sequential grid axis and carry dK/dV (or dQ) in VMEM
// scratch; blocks on this card run in no order, so each sweep is a loop
// inside one block with the accumulator in registers.
//
// Arithmetic: bf16 operands (P and dS rounded to bf16 before their
// products), fp32 accumulation with mma.sync m16n8k16, exp2 with the scale
// and L premultiplied by log2(e). Keys at or past `kv_len` get P = 0, so
// their dK and dV rows are written as zeros; query rows past Sq are loaded
// as zeros and masked.
//
// Bound: 10*B*H*Sq*kv_len*D flops (five products of 2*Sq*kv_len*D each:
// S is recomputed in both kernels, dP in both, then dV, dK and dQ) against
// about (4*Sq + 4*Skv)*B*H*D*2 bytes; at the training shape's 9216 tokens
// the flops bound it. The simple design leaves on the table: mma.sync
// instead of wgmma, cp.async double buffering instead of a TMA ring, and the
// recomputation of S and dP in both kernels (a fused kernel with atomic dQ
// does the four products once).
//
// Head dims 64 and 128. At D = 128 the dK/dV kernel takes 32-query tiles so
// that two 16 x 128 fp32 accumulators, scores and their gradients fit the
// registers of one thread.

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // (B, H, Sq), natural log
  float* delta;      // (B, H, Sq)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int sq, skv, kv_len, heads;
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

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]: D / 8 threads a row,
// 16 bytes each, summed with shuffles inside their group of lanes.
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_delta(BwdParams p, int64_t n_rows) {
  constexpr int TPR = D / 8;
  constexpr int RPB = 128 / TPR;
  const int64_t row = (int64_t)blockIdx.x * RPB + threadIdx.x / TPR;  // (b, s, h), h fastest
  const int c = threadIdx.x % TPR;
  const int h = (int)(row % p.heads);
  const int s = (int)((row / p.heads) % p.sq);
  const int64_t b = row / ((int64_t)p.heads * p.sq);
  float acc = 0.f;
  if (row < n_rows) {
    const uint4 ov = *reinterpret_cast<const uint4*>(p.o + b * p.o_sb + s * p.o_ss + h * p.o_sh + c * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(p.dout + b * p.do_sb + s * p.do_ss + h * p.do_sh + c * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(o2[i]), y = __bfloat1622float2(d2[i]);
      acc += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < n_rows && c == 0) p.delta[(b * p.heads + h) * p.sq + s] = acc;
}

// ---------------------------------------------------------------------------
// dK/dV: one block per 64 keys; warp w owns keys 16w .. 16w + 15 of the tile.
// ---------------------------------------------------------------------------
template <int D, int BQ>
__global__ void __launch_bounds__(128) flash_bwd_dkdv(BwdParams p) {
  constexpr int BN = 64, NT = 128, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + BN * LD;
  __nv_bfloat16* qs = vs + BN * LD;      // [2][BQ * LD]
  __nv_bfloat16* dos = qs + 2 * BQ * LD;  // [2][BQ * LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ], L * log2(e)
  float* dlt_s = lse_s + 2 * BQ;                                // [2][BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int k0 = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  __nv_bfloat16* dkb = p.dk + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* dvb = p.dv + b * p.dv_sb + h * p.dv_sh;

  if (k0 >= p.kv_len) {  // every key of the tile is masked: zero rows
    const int rows = min(BN, p.skv - k0);
    for (int i = threadIdx.x; i < rows * (D / 8); i += NT) {
      const int r = i / (D / 8), c = i % (D / 8);
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

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const int key0 = k0 + warp * 16 + g;  // this thread's key rows: key0 and key0 + 8
  const bool key_ok[2] = {key0 < p.kv_len, key0 + 8 < p.kv_len};
  const __nv_bfloat16* kw = ks + warp * 16 * LD;
  const __nv_bfloat16* vw = vs + warp * 16 * LD;
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

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ queries.
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, kw, kk, g, t4);
      load_a<LD>(va, vw, kk, g, t4);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const __nv_bfloat16* qr = qt + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        const __nv_bfloat16* dr = dot + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        mma_bf16(s[nt], ka, ld32(qr), ld32(qr + 8));
        mma_bf16(dp[nt], va, ld32(dr), ld32(dr + 8));
      }
    }

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

    // dV += P^T dO and dK += dS^T Q.
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        uint32_t bo[4], bq[4];
        ldmatrix_x4_trans(bo, trans_addr<LD>(dot, j * 16, dn * 8, lane));
        ldmatrix_x4_trans(bq, trans_addr<LD>(qt, j * 16, dn * 8, lane));
        mma_bf16(dv[dn], pa[j], bo[0], bo[1]);
        mma_bf16(dv[dn + 1], pa[j], bo[2], bo[3]);
        mma_bf16(dk[dn], dsa[j], bq[0], bq[1]);
        mma_bf16(dk[dn + 1], dsa[j], bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `buf` before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key0 + 8 * r;
    if (row < p.skv) {
      __nv_bfloat16* dkr = dkb + (int64_t)row * p.dk_ss;
      __nv_bfloat16* dvr = dvb + (int64_t)row * p.dv_ss;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        *reinterpret_cast<uint32_t*>(dkr + dn * 8 + 2 * t4) =
            pack_bf16(dk[dn][2 * r] * p.scale, dk[dn][2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvr + dn * 8 + 2 * t4) = pack_bf16(dv[dn][2 * r], dv[dn][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per 64 queries; warp w owns queries 16w .. 16w + 15.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq(BwdParams p) {
  constexpr int BM = 64, BN = 64, NT = 128, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + BM * LD;
  __nv_bfloat16* ks = dos + BM * LD;     // [2][BN * LD]
  __nv_bfloat16* vs = ks + 2 * BN * LD;  // [2][BN * LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
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

  const int row0 = q0 + warp * 16 + g;  // this thread's query rows: row0 and row0 + 8
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < p.sq ? lseb[row] * kLog2e : 0.f;
    dlt_r[r] = row < p.sq ? dltb[row] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const __nv_bfloat16* qw = qs + warp * 16 * LD;
  const __nv_bfloat16* dw = dos + warp * 16 * LD;
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

    // S = Q K^T and dP = dO V^T for this warp's 16 queries x 64 keys.
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, qw, kk, g, t4);
      load_a<LD>(da, dw, kk, g, t4);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const __nv_bfloat16* kr = kt + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        const __nv_bfloat16* vr = vt + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        mma_bf16(s[nt], qa, ld32(kr), ld32(kr + 8));
        mma_bf16(dp[nt], da, ld32(vr), ld32(vr + 8));
      }
    }

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

    // dQ += dS K.
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, trans_addr<LD>(kt, j * 16, dn * 8, lane));
        mma_bf16(dq[dn], dsa[j], bk[0], bk[1]);
        mma_bf16(dq[dn + 1], dsa[j], bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `buf` before it is refilled
  }

  __nv_bfloat16* dqb = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < p.sq) {
      __nv_bfloat16* dqr = dqb + (int64_t)row * p.dq_ss;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        *reinterpret_cast<uint32_t*>(dqr + dn * 8 + 2 * t4) =
            pack_bf16(dq[dn][2 * r] * p.scale, dq[dn][2 * r + 1] * p.scale);
      }
    }
  }
}

template <int D, int BQ>
cudaError_t run(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr int LD = D + 8;
  const int64_t n_rows = (int64_t)batch * p.sq * p.heads;
  const int rows_per_block = 128 / (D / 8);
  flash_bwd_delta<D><<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block), 128, 0, stream>>>(p, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t dkdv_smem = (size_t)(2 * 64 + 4 * BQ) * LD * sizeof(__nv_bfloat16) + 4 * BQ * sizeof(float);
  err = launch(flash_bwd_dkdv<D, BQ>, dim3((p.skv + 63) / 64, p.heads, batch), dkdv_smem, p, stream);
  if (err != cudaSuccess) return err;
  const size_t dq_smem = (size_t)(2 * 64 + 4 * 64) * LD * sizeof(__nv_bfloat16);
  return launch(flash_bwd_dq<D>, dim3((p.sq + 63) / 64, p.heads, batch), dq_smem, p, stream);
}

}  // namespace

// C entry point: delta, then dK/dV, then dQ, all on `stream`. Strides are in
// elements; the last (D) stride must be 1 and every other stride a multiple
// of 8, with 16-byte aligned base pointers (the Python wrapper checks this).
// `delta` is fp32 (B, H, Sq) scratch. Returns the first failing launch's
// cudaError_t, or 0.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                              const float* lse, float* delta, void* dq, void* dk, void* dv, int batch, int sq,
                              int skv, int heads, int head_dim, int kv_len, float scale, const long long* strides,
                              void* stream) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.sq = sq;
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
    case 64: return (int)run<64, 64>(p, batch, s);
    case 128: return (int)run<128, 32>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
