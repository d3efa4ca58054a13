// Flash attention in fp32 for Hopper (sm_90a), forward and backward: exact
// non-causal O = softmax(Q K^T * scale) V over (B, S, H, D) fp32 tensors read
// through their strides, keys at or past `kv_len` masked, at D = 64, 128 and
// 512; the backward's dQ, dK, dV from q, k, v, O, dO and the forward's
// per-row log-sum-exp. The fp32 counterpart of flash_attn_fwd.cu and
// flash_attn_bwd.cu (bf16 and fp16), with C entry points of its own.
//
// Replaces the same TPU kernels as those two sources, run at
// `runtime.compute_dtype float32`:
//   K1  evoworld_tpu/ops/attention.py::_builtin_flash (JAX's shipped Pallas TPU
//       flash kernel, jax/experimental/pallas/ops/tpu/flash_attention.py:
//       `_flash_attention_impl`, and its custom_vjp's backward kernels
//       `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`);
//   K2  evoworld_tpu/ops/flash_attention.py::flash_attention / _flash_kernel
//       (`kv_len` mask and `use_exp2`: both modes are the same function here,
//       computed with exp2 of scores pre-scaled by scale * log2(e)).
//
// Bound: the same products as the bf16 kernels (4*B*H*Sq*kv_len*D flops
// forward, 10* backward) at the card's TF32 tensor-core rate, 495 TFLOP/s
// dense, half the bf16 rate; at the main path's 9216 tokens the operations
// bound both directions by three orders of magnitude over the bytes.
//
// Why not the wgmma design of the bf16 kernels: wgmma takes fp32 data only as
// .tf32 with both shared-memory operands K-major (the transpose bits exist
// for 16-bit types only), while P V's B operand V, and dO, Q and K in the
// backward, are MN-major; and one TF32 pass rounds Q, K, V and P to 10
// mantissa bits, fp16's width, where the fp32 mode computes every other
// product in full fp32. So each product here is a split-TF32 mma.sync:
//   - every fp32 operand x becomes big = cvt.rna.tf32(x) and small =
//     cvt.rna.tf32(x - big) (x - big is exact in fp32), and a*b is summed as
//     small_a*big_b + big_a*small_b + big_a*big_b into an fp32 accumulator
//     (mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, three a k-step; the
//     small*small term, under 2^-22 of the product, is dropped). That keeps
//     about 21 bits of each operand: the products land within ~1e-6 of full
//     fp32, at 3x the tensor-core work of one pass;
//   - the softmax, running max and sum, the log-sum-exp and exp2 are fp32 on
//     the CUDA cores, as in the bf16 kernels.
// Fragments: a thread of an m16n8k8 TF32 accumulator holds rows g and g + 8
// (g = lane / 4) at columns 2t and 2t + 1 (t = lane % 4), while the A operand
// wants rows g and g + 8 at columns t and t + 4. Products that feed a score
// tile (P, dS, P^T, dS^T) into the next product as A take its k order
// permuted instead: k index t stands for column 2t of the 8-column block and
// t + 4 for 2t + 1, so accumulator registers (c0, c2, c1, c3) are the A
// fragment as they lie, and the B operand (V, dO, Q or K) is read from rows
// 2t and 2t + 1 to match. No shuffle, and no rounding of P or dS: both enter
// their product split like any other fp32 operand. Operands are 32-bit, so
// there is no ldmatrix: each thread loads its fragment from shared memory in
// the operand's own order, which reads V, dO, Q and K as B from the row-major
// tiles as they were copied (the transposes are free). Every shared tile has
// a row pitch of D + 4 words, so that a warp's 32 loads of any fragment (rows
// g at columns t, or rows 2t at columns g) fall in 32 different banks.
//
// Blocks (one warp computes 16 rows of a product; tiles stream through two
// cp.async stages of 16-byte copies, rows past the tensor's or `kv_len`'s end
// zero-filled; one __syncthreads a tile):
//   flash_fp32_fwd<D>       4 row groups x 16 queries a block at D = 64 and
//                           128 (64-key tiles at D = 64, 32-key tiles at 128,
//                           so that two blocks fit an SM); at D = 512 a warp
//                           cannot hold 16 x 512 fp32 sums (256 registers), so
//                           D is split across the warps as flash_fwd_wide
//                           splits it across its consumers: each of 4 warps
//                           owns 128 output columns of 16 query rows, adds the
//                           partial score over its 128 columns, and the four
//                           partials are swapped through shared memory and
//                           summed in one fixed order, so every warp holds the
//                           same scores bit for bit and runs the same softmax;
//                           2 row groups (32 queries, 8 warps) and 16-key
//                           tiles fit 227 KB. The log-sum-exp, when asked for,
//                           is natural-log fp32 (B, H, Sq), as the bf16
//                           kernels write it.
//   flash_fp32_bwd_delta<D> delta = rowsum(dO * O) and the log-sum-exp times
//                           log2(e), fp32 (B, H, Sq rounded up to 64); the
//                           padding holds delta = 0 and a huge L, so a padded
//                           query gets P = 0.
//   flash_fp32_bwd_dkdv<D>  one block per 64 keys (16 at D = 512), K and V
//                           resident, query tiles streamed (32 queries at
//                           D = 64, 16 at 128 and 512): S^T = K Q^T, dP^T =
//                           V dO^T, P^T = exp2(S^T scale log2(e) - L), dS^T =
//                           P^T (dP^T - delta), dV += P^T dO, dK += dS^T Q.
//                           dK and dV of 16 keys x 128 columns would take 128
//                           registers a thread, so every head dim is split into
//                           64-column chunks, one a warp (8 warps at D = 128
//                           and 512), the warps of a key group swapping partial
//                           S^T and dP^T as the forward swaps S.
//   flash_fp32_bwd_dq<D>    one block per 64 queries (16 at D = 512, D split
//                           across 4 warps as in the forward), Q and dO
//                           resident, key tiles streamed: S, dP, dS as above,
//                           dQ += dS K.
// The backward recomputes S and dP in both sweeps, 7 products where the
// function needs 5, sums nothing across blocks and uses no atomics, so dQ,
// dK and dV repeat bit for bit. Keys at or past `kv_len` get P = 0 and zero
// rows of dK and dV.
// Accumulation: the tensor cores add into their accumulator by truncation,
// so the products whose sums run over a whole sequence (O, dV, dK, dQ) start
// each tile from zeroed registers and are added into their sums on the CUDA
// cores, rounded to nearest (`product_pz`).

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

constexpr int kPad = 4;           // words of padding a shared row (see the fragments above)
constexpr float kPadLse = 1e30f;  // exp2(s - kPadLse) = 0 for any finite score
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

// ---------------------------------------------------------------------------
// Split-TF32 products on mma.sync m16n8k8.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x as big + small, each a TF32 value in a 32-bit register.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b with both split: the two cross terms first, the large term last.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2], const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

// The A fragment (16 x 8) of a row-major shared tile; `s` points at the
// fragment's element (row g, column t).
__device__ __forceinline__ void load_a(const float* s, int pitch, uint32_t (&big)[4], uint32_t (&small)[4]) {
  split(s[0], big[0], small[0]);              // (g, t)
  split(s[8 * pitch], big[1], small[1]);      // (g + 8, t)
  split(s[4], big[2], small[2]);              // (g, t + 4)
  split(s[8 * pitch + 4], big[3], small[3]);  // (g + 8, t + 4)
}

// An accumulator's 8-column n-tile as an A fragment in the permuted k order
// (k t -> column 2t, k t + 4 -> column 2t + 1).
__device__ __forceinline__ void acc_as_a(const float (&c)[4], uint32_t (&big)[4], uint32_t (&small)[4]) {
  split(c[0], big[0], small[0]);  // (g, 2t)
  split(c[2], big[1], small[1]);  // (g + 8, 2t)
  split(c[1], big[2], small[2]);  // (g, 2t + 1)
  split(c[3], big[3], small[3]);  // (g + 8, 2t + 1)
}

// S (16 x N, N / 8 accumulator n-tiles) = X Y^T over DW columns: X rows are
// the 16 rows of the product, Y rows its N columns, both row-major in shared
// memory with `pitch`. `xa` points at X's element (g, t), `yb` at Y's (g, t).
template <int DW, int N>
__device__ __forceinline__ void product_nt(float (&s)[N / 8][4], const float* xa, const float* yb, int pitch) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DW / 8; ++ks) {
    uint32_t ab[4], as[4];
    load_a(xa + ks * 8, pitch, ab, as);
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const float* y = yb + nt * 8 * pitch + ks * 8;
      uint32_t bb[2], bs[2];
      split(y[0], bb[0], bs[0]);  // (k t, n g)
      split(y[4], bb[1], bs[1]);  // (k t + 4, n g)
      mma3(s[nt], ab, as, bb, bs);
    }
  }
}

// O (16 x DW) += P (16 x K, accumulator n-tiles) Z (K x DW): Z row-major in
// shared memory, read in the permuted k order; `zb` points at Z's element
// (2t, g). The tensor cores add into an accumulator by truncation, so one
// accumulator carried across a whole sequence drifts toward zero by about a
// unit of its last place every few products (on an H100, 4e-4 of the
// output's RMS after 75,993 keys); each n-tile of the tile's product therefore starts from a
// zeroed accumulator (24 products at K = 64) and is added into O on the CUDA
// cores, rounded to nearest. P is split once for all n-tiles.
template <int DW, int K>
__device__ __forceinline__ void product_pz(float (&o)[DW / 8][4], const float (&p)[K / 8][4], const float* zb,
                                           int pitch) {
  uint32_t ab[K / 8][4], as[K / 8][4];
#pragma unroll
  for (int ks = 0; ks < K / 8; ++ks) acc_as_a(p[ks], ab[ks], as[ks]);
#pragma unroll
  for (int nt = 0; nt < DW / 8; ++nt) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < K / 8; ++ks) {
      const float* z = zb + ks * 8 * pitch + nt * 8;
      uint32_t bb[2], bs[2];
      split(z[0], bb[0], bs[0]);      // row 2t
      split(z[pitch], bb[1], bs[1]);  // row 2t + 1
      mma3(t, ab[ks], as[ks], bb, bs);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] += t[e];
  }
}

// Partial scores swapped between the NWD warps of a row group: each writes
// its n-tiles (one float4 a lane), and after a barrier each sums all NWD
// partials in the order of the warps, so every warp holds the same sums.
template <int NT>
__device__ __forceinline__ void exchange_put(float4* xch, int w, int lane, const float (&s)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) xch[(w * NT + nt) * 32 + lane] = make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
}
template <int NT, int NWD>
__device__ __forceinline__ void exchange_sum(const float4* xch, int lane, float (&s)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float4 a = xch[nt * 32 + lane];
#pragma unroll
    for (int w = 1; w < NWD; ++w) {
      const float4 b = xch[(w * NT + nt) * 32 + lane];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    s[nt][0] = a.x;
    s[nt][1] = a.y;
    s[nt][2] = a.z;
    s[nt][3] = a.w;
  }
}

// ---------------------------------------------------------------------------
// cp.async copies into shared tiles.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Rows row0 .. row0 + R - 1 of one (batch, head) of a (B, S, H, D) tensor
// (`base` at its row 0, rows `ss` elements apart) into a shared tile of R
// rows with pitch D + kPad; rows at or past `end` are zero-filled.
template <int R, int D, int THREADS>
__device__ __forceinline__ void load_rows(float* tile, const float* base, int64_t ss, int row0, int end) {
  constexpr int kChunks = D / 4;  // 16-byte copies a row
#pragma unroll 4
  for (int i = threadIdx.x; i < R * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < end;
    cp_async16(tile + r * (D + kPad) + c * 4, base + (in ? (int64_t)(row0 + r) * ss : 0) + c * 4, in);
  }
}

// N consecutive floats (N a multiple of 4, 16-byte aligned) into shared memory.
template <int N, int THREADS>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  for (int i = threadIdx.x; i < N / 4; i += THREADS) cp_async16(dst + 4 * i, src + 4 * i, true);
}

// ---------------------------------------------------------------------------
// Shapes of the blocks by head dim.
// ---------------------------------------------------------------------------

template <int D, int W>
struct Split {
  static constexpr int DW = W;           // columns of D a warp owns
  static constexpr int NWD = D / DW;     // warps that split D (and swap partial scores)
  static constexpr int P = D + kPad;     // row pitch of every shared tile, in words
};

template <int D>
struct FwdShape : Split<D, (D < 128 ? D : 128)> {
  using Base = Split<D, (D < 128 ? D : 128)>;
  static constexpr int RG = D <= 128 ? 4 : 2;  // row groups of 16 queries
  static constexpr int ROWS = 16 * RG;
  static constexpr int KT = D == 64 ? 64 : (D == 128 ? 32 : 16);  // keys a tile
  static constexpr int THREADS = 32 * RG * Base::NWD;
  static constexpr int Q_WORDS = ROWS * Base::P;
  static constexpr int KV_WORDS = KT * Base::P;  // one K or V tile
  static constexpr int XCH_WORDS = Base::NWD > 1 ? RG * Base::NWD * (KT / 8) * 128 : 0;
  static constexpr int SMEM = (Q_WORDS + 4 * KV_WORDS + XCH_WORDS) * 4;
  static_assert(SMEM <= kMaxSmem, "forward tiles exceed shared memory");
};

// dK and dV of 16 keys take 2 DW / 4 registers a thread, so here every head
// dim splits into 64-column chunks: 8 warps at D = 128 and 512.
template <int D>
struct DkdvShape : Split<D, 64> {
  using Base = Split<D, 64>;
  static constexpr int RG = D <= 128 ? 4 : 1;  // key groups of 16
  static constexpr int KEYS = 16 * RG;
  static constexpr int QT = D == 64 ? 32 : 16;  // queries a tile
  static constexpr int THREADS = 32 * RG * Base::NWD;
  static constexpr int KV_WORDS = KEYS * Base::P;
  static constexpr int QD_WORDS = QT * Base::P;  // one Q or dO tile
  static constexpr int XCH_WORDS = Base::NWD > 1 ? 2 * RG * Base::NWD * (QT / 8) * 128 : 0;
  static constexpr int SMEM = (2 * KV_WORDS + 4 * QD_WORDS + 4 * QT + XCH_WORDS) * 4;
  static_assert(SMEM <= kMaxSmem, "dK/dV tiles exceed shared memory");
};

template <int D>
struct DqShape : Split<D, (D < 128 ? D : 128)> {
  using Base = Split<D, (D < 128 ? D : 128)>;
  static constexpr int RG = D <= 128 ? 4 : 1;  // row groups of 16 queries
  static constexpr int ROWS = 16 * RG;
  static constexpr int KT = D == 64 ? 64 : (D == 128 ? 32 : 16);
  static constexpr int THREADS = 32 * RG * Base::NWD;
  static constexpr int QD_WORDS = ROWS * Base::P;
  static constexpr int KV_WORDS = KT * Base::P;
  static constexpr int XCH_WORDS = Base::NWD > 1 ? 2 * RG * Base::NWD * (KT / 8) * 128 : 0;
  static constexpr int SMEM = (2 * QD_WORDS + 4 * KV_WORDS + XCH_WORDS) * 4;
  static_assert(SMEM <= kMaxSmem, "dQ tiles exceed shared memory");
};

// ---------------------------------------------------------------------------
// Forward.
// ---------------------------------------------------------------------------

struct FwdParams {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // (B, H, Sq) natural log, or null
  int sq, kv_len, heads;
  float scale_log2;  // scale * log2(e)
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
};

template <int D>
__global__ void __launch_bounds__(FwdShape<D>::THREADS) flash_fp32_fwd(FwdParams p) {
  using S = FwdShape<D>;
  constexpr int DW = S::DW, NWD = S::NWD, P = S::P, KT = S::KT, NT = KT / 8;
  extern __shared__ __align__(16) float smem[];
  float* q_tile = smem;
  float* kv = smem + S::Q_WORDS;  // stage s: K at kv + 2 s KV_WORDS, V after it
  float4* xch = reinterpret_cast<float4*>(kv + 4 * S::KV_WORDS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp / NWD, w = warp % NWD;
  const int q0 = blockIdx.x * S::ROWS, h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;

  load_rows<S::ROWS, D, S::THREADS>(q_tile, qb, p.q_ss, q0, p.sq);
  load_rows<KT, D, S::THREADS>(kv, kb, p.k_ss, 0, p.kv_len);
  load_rows<KT, D, S::THREADS>(kv + S::KV_WORDS, vb, p.v_ss, 0, p.kv_len);
  cp_async_commit();

  float o[DW / 8][4];
#pragma unroll
  for (int nt = 0; nt < DW / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g and g + 8; l sums this thread's columns
  const float* xa = q_tile + (rg * 16 + g) * P + w * DW + t;
  const int n_tiles = (p.kv_len + KT - 1) / KT;
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it has landed, and every warp is done with the other stage
    if (it + 1 < n_tiles) {
      float* next = kv + ((it + 1) & 1) * 2 * S::KV_WORDS;
      load_rows<KT, D, S::THREADS>(next, kb, p.k_ss, (it + 1) * KT, p.kv_len);
      load_rows<KT, D, S::THREADS>(next + S::KV_WORDS, vb, p.v_ss, (it + 1) * KT, p.kv_len);
      cp_async_commit();
    }
    const float* k_tile = kv + (it & 1) * 2 * S::KV_WORDS;
    const float* v_tile = k_tile + S::KV_WORDS;
    float s[NT][4];
    product_nt<DW, KT>(s, xa, k_tile + g * P + w * DW + t, P);
    if constexpr (NWD > 1) {
      float4* mine = xch + rg * NWD * NT * 32;
      exchange_put<NT>(mine, w, lane, s);
      __syncthreads();
      exchange_sum<NT, NWD>(mine, lane, s);
    }
    const int k0 = it * KT;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = k0 + KT <= p.kv_len || k0 + nt * 8 + 2 * t + (e & 1) < p.kv_len;
        s[nt][e] = in ? s[nt][e] * p.scale_log2 : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e / 2]);
        l[e / 2] += s[nt][e];
      }
    }
#pragma unroll
    for (int nt = 0; nt < DW / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    product_pz<DW, KT>(o, s, v_tile + 2 * t * P + w * DW + g, P);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rg * 16 + g + 8 * r;
    const float sum = quad_sum(l[r]);
    if (row >= p.sq) continue;
    const float inv = 1.f / sum;
    float* out = p.o + b * p.o_sb + (int64_t)row * p.o_ss + h * p.o_sh + w * DW + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DW / 8; ++nt) {
      *reinterpret_cast<float2*>(out + nt * 8) = make_float2(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
    }
    if (p.lse != nullptr && w == 0 && t == 0) {
      p.lse[(b * p.heads + h) * p.sq + row] = (m[r] + log2f(sum)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward.
// ---------------------------------------------------------------------------

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;  // (B, H, Sq), natural log
  float* delta;      // (B, H, sq_pad)
  float* lse2;       // (B, H, sq_pad): lse * log2(e)
  float* dq;
  float* dk;
  float* dv;
  int sq, sq_pad, skv, kv_len, heads;
  float scale, scale_log2;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
};

// Threads a row of flash_fp32_bwd_delta: D / 4 (16 bytes each) up to one warp.
template <int D>
constexpr int kDeltaTPR = D / 4 < 32 ? D / 4 : 32;

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d] and lse2 = lse *
// log2(e) over rows (b, s, h) with s < sq_pad, h fastest; rows in [sq,
// sq_pad) get delta = 0 and lse2 = kPadLse.
template <int D>
__global__ void __launch_bounds__(128) flash_fp32_bwd_delta(BwdParams p, int64_t n_rows) {
  constexpr int TPR = kDeltaTPR<D>;
  constexpr int RPB = 128 / TPR;
  const int64_t row = (int64_t)blockIdx.x * RPB + threadIdx.x / TPR;
  const int c = threadIdx.x % TPR;
  const int h = (int)(row % p.heads);
  const int s = (int)((row / p.heads) % p.sq_pad);
  const int64_t b = row / ((int64_t)p.heads * p.sq_pad);
  const bool real = row < n_rows && s < p.sq;
  float acc = 0.f;
  if (real) {
#pragma unroll
    for (int chunk = c; chunk < D / 4; chunk += TPR) {
      const float4 ov = *reinterpret_cast<const float4*>(p.o + b * p.o_sb + s * p.o_ss + h * p.o_sh + chunk * 4);
      const float4 dv =
          *reinterpret_cast<const float4*>(p.dout + b * p.do_sb + s * p.do_ss + h * p.do_sh + chunk * 4);
      acc += ov.x * dv.x + ov.y * dv.y + ov.z * dv.z + ov.w * dv.w;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < n_rows && c == 0) {
    const int64_t at = (b * p.heads + h) * p.sq_pad + s;
    p.delta[at] = acc;
    p.lse2[at] = real ? p.lse[(b * p.heads + h) * p.sq + s] * kLog2e : kPadLse;
  }
}

template <int D>
__global__ void __launch_bounds__(DkdvShape<D>::THREADS) flash_fp32_bwd_dkdv(BwdParams p) {
  using S = DkdvShape<D>;
  constexpr int DW = S::DW, NWD = S::NWD, P = S::P, QT = S::QT, NT = QT / 8;
  extern __shared__ __align__(16) float smem[];
  float* k_tile = smem;
  float* v_tile = k_tile + S::KV_WORDS;
  float* qd = v_tile + S::KV_WORDS;  // stage s: Q at qd + 2 s QD_WORDS, dO after it
  float* vec = qd + 4 * S::QD_WORDS;  // stage s: lse2 at vec + 2 s QT, delta after it
  float4* xch = reinterpret_cast<float4*>(vec + 4 * QT);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp / NWD, w = warp % NWD;
  const int k0 = blockIdx.x * S::KEYS, h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t bh = b * p.heads + h;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* db = p.dout + b * p.do_sb + h * p.do_sh;

  float dk[DW / 8][4], dv[DW / 8][4];
#pragma unroll
  for (int nt = 0; nt < DW / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
  }
  const int key0 = k0 + rg * 16 + g;  // this thread's key rows: key0 and key0 + 8
  if (k0 < p.kv_len) {  // a block of keys all past kv_len writes zeros
    load_rows<S::KEYS, D, S::THREADS>(k_tile, p.k + b * p.k_sb + h * p.k_sh, p.k_ss, k0, p.kv_len);
    load_rows<S::KEYS, D, S::THREADS>(v_tile, p.v + b * p.v_sb + h * p.v_sh, p.v_ss, k0, p.kv_len);
    load_rows<QT, D, S::THREADS>(qd, qb, p.q_ss, 0, p.sq);
    load_rows<QT, D, S::THREADS>(qd + S::QD_WORDS, db, p.do_ss, 0, p.sq);
    load_vec<QT, S::THREADS>(vec, p.lse2 + bh * p.sq_pad);
    load_vec<QT, S::THREADS>(vec + QT, p.delta + bh * p.sq_pad);
    cp_async_commit();
    const float* ka = k_tile + (rg * 16 + g) * P + w * DW + t;
    const float* va = v_tile + (rg * 16 + g) * P + w * DW + t;
    const bool live[2] = {key0 < p.kv_len, key0 + 8 < p.kv_len};
    const int n_tiles = (p.sq + QT - 1) / QT;
    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait_all();
      __syncthreads();
      if (it + 1 < n_tiles) {
        const int s = (it + 1) & 1, row0 = (it + 1) * QT;
        load_rows<QT, D, S::THREADS>(qd + 2 * s * S::QD_WORDS, qb, p.q_ss, row0, p.sq);
        load_rows<QT, D, S::THREADS>(qd + (2 * s + 1) * S::QD_WORDS, db, p.do_ss, row0, p.sq);
        load_vec<QT, S::THREADS>(vec + 2 * s * QT, p.lse2 + bh * p.sq_pad + row0);
        load_vec<QT, S::THREADS>(vec + (2 * s + 1) * QT, p.delta + bh * p.sq_pad + row0);
        cp_async_commit();
      }
      const int s = it & 1;
      const float* q_t = qd + 2 * s * S::QD_WORDS;
      const float* do_t = q_t + S::QD_WORDS;
      const float* l_t = vec + 2 * s * QT;
      const float* d_t = l_t + QT;
      float st[NT][4], dpt[NT][4];  // S^T and dP^T: 16 keys x QT queries
      product_nt<DW, QT>(st, ka, q_t + g * P + w * DW + t, P);
      product_nt<DW, QT>(dpt, va, do_t + g * P + w * DW + t, P);
      if constexpr (NWD > 1) {
        float4* mine = xch + 2 * rg * NWD * NT * 32;
        exchange_put<NT>(mine, w, lane, st);
        exchange_put<NT>(mine + NWD * NT * 32, w, lane, dpt);
        __syncthreads();
        exchange_sum<NT, NWD>(mine, lane, st);
        exchange_sum<NT, NWD>(mine + NWD * NT * 32, lane, dpt);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 lq = *reinterpret_cast<const float2*>(l_t + nt * 8 + 2 * t);
        const float2 dq = *reinterpret_cast<const float2*>(d_t + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = live[e / 2] ? exp2f(st[nt][e] * p.scale_log2 - ((e & 1) ? lq.y : lq.x)) : 0.f;
          st[nt][e] = pr;
          dpt[nt][e] = pr * (dpt[nt][e] - ((e & 1) ? dq.y : dq.x));
        }
      }
      product_pz<DW, QT>(dv, st, do_t + 2 * t * P + w * DW + g, P);
      product_pz<DW, QT>(dk, dpt, q_t + 2 * t * P + w * DW + g, P);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.skv) continue;
    float* dk_row = p.dk + b * p.dk_sb + (int64_t)key * p.dk_ss + h * p.dk_sh + w * DW + 2 * t;
    float* dv_row = p.dv + b * p.dv_sb + (int64_t)key * p.dv_ss + h * p.dv_sh + w * DW + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DW / 8; ++nt) {
      *reinterpret_cast<float2*>(dk_row + nt * 8) =
          make_float2(dk[nt][2 * r] * p.scale, dk[nt][2 * r + 1] * p.scale);
      *reinterpret_cast<float2*>(dv_row + nt * 8) = make_float2(dv[nt][2 * r], dv[nt][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DqShape<D>::THREADS) flash_fp32_bwd_dq(BwdParams p) {
  using S = DqShape<D>;
  constexpr int DW = S::DW, NWD = S::NWD, P = S::P, KT = S::KT, NT = KT / 8;
  extern __shared__ __align__(16) float smem[];
  float* q_tile = smem;
  float* do_tile = q_tile + S::QD_WORDS;
  float* kv = do_tile + S::QD_WORDS;  // stage s: K at kv + 2 s KV_WORDS, V after it
  float4* xch = reinterpret_cast<float4*>(kv + 4 * S::KV_WORDS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp / NWD, w = warp % NWD;
  const int q0 = blockIdx.x * S::ROWS, h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t bh = b * p.heads + h;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;

  load_rows<S::ROWS, D, S::THREADS>(q_tile, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.sq);
  load_rows<S::ROWS, D, S::THREADS>(do_tile, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, p.sq);
  load_rows<KT, D, S::THREADS>(kv, kb, p.k_ss, 0, p.kv_len);
  load_rows<KT, D, S::THREADS>(kv + S::KV_WORDS, vb, p.v_ss, 0, p.kv_len);
  cp_async_commit();

  const int row0 = q0 + rg * 16 + g;  // this thread's query rows: row0 and row0 + 8 (< sq_pad)
  const float lrow[2] = {p.lse2[bh * p.sq_pad + row0], p.lse2[bh * p.sq_pad + row0 + 8]};
  const float drow[2] = {p.delta[bh * p.sq_pad + row0], p.delta[bh * p.sq_pad + row0 + 8]};
  float dq[DW / 8][4];
#pragma unroll
  for (int nt = 0; nt < DW / 8; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;
  const float* qa = q_tile + (rg * 16 + g) * P + w * DW + t;
  const float* da = do_tile + (rg * 16 + g) * P + w * DW + t;
  const int n_tiles = (p.kv_len + KT - 1) / KT;
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_tiles) {
      float* next = kv + ((it + 1) & 1) * 2 * S::KV_WORDS;
      load_rows<KT, D, S::THREADS>(next, kb, p.k_ss, (it + 1) * KT, p.kv_len);
      load_rows<KT, D, S::THREADS>(next + S::KV_WORDS, vb, p.v_ss, (it + 1) * KT, p.kv_len);
      cp_async_commit();
    }
    const float* k_t = kv + (it & 1) * 2 * S::KV_WORDS;
    const float* v_t = k_t + S::KV_WORDS;
    float s[NT][4], dp[NT][4];  // S and dP: 16 queries x KT keys
    product_nt<DW, KT>(s, qa, k_t + g * P + w * DW + t, P);
    product_nt<DW, KT>(dp, da, v_t + g * P + w * DW + t, P);
    if constexpr (NWD > 1) {
      float4* mine = xch + 2 * rg * NWD * NT * 32;
      exchange_put<NT>(mine, w, lane, s);
      exchange_put<NT>(mine + NWD * NT * 32, w, lane, dp);
      __syncthreads();
      exchange_sum<NT, NWD>(mine, lane, s);
      exchange_sum<NT, NWD>(mine + NWD * NT * 32, lane, dp);
    }
    const int kc = it * KT;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = kc + KT <= p.kv_len || kc + nt * 8 + 2 * t + (e & 1) < p.kv_len;
        const float pr = in ? exp2f(s[nt][e] * p.scale_log2 - lrow[e / 2]) : 0.f;
        s[nt][e] = pr * (dp[nt][e] - drow[e / 2]);  // dS
      }
    }
    product_pz<DW, KT>(dq, s, k_t + 2 * t * P + w * DW + g, P);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.sq) continue;
    float* out = p.dq + b * p.dq_sb + (int64_t)row * p.dq_ss + h * p.dq_sh + w * DW + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DW / 8; ++nt) {
      *reinterpret_cast<float2*>(out + nt * 8) = make_float2(dq[nt][2 * r] * p.scale, dq[nt][2 * r + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Launches.
// ---------------------------------------------------------------------------

template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t stream, const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_fwd(const FwdParams& p, int batch, cudaStream_t stream) {
  using S = FwdShape<D>;
  const dim3 grid((p.sq + S::ROWS - 1) / S::ROWS, p.heads, batch);
  return launch(flash_fp32_fwd<D>, grid, S::THREADS, S::SMEM, stream, p);
}

template <int D>
cudaError_t run_bwd(const BwdParams& p, int batch, cudaStream_t stream) {
  const int64_t pad_rows = (int64_t)batch * p.sq_pad * p.heads;
  constexpr int rows = 128 / kDeltaTPR<D>;  // rows a block of flash_fp32_bwd_delta
  flash_fp32_bwd_delta<D><<<(unsigned)((pad_rows + rows - 1) / rows), 128, 0, stream>>>(p, pad_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  using K = DkdvShape<D>;
  e = launch(flash_fp32_bwd_dkdv<D>, dim3((p.skv + K::KEYS - 1) / K::KEYS, p.heads, batch), K::THREADS, K::SMEM,
             stream, p);
  if (e != cudaSuccess) return e;
  using Q = DqShape<D>;
  return launch(flash_fp32_bwd_dq<D>, dim3((p.sq + Q::ROWS - 1) / Q::ROWS, p.heads, batch), Q::THREADS, Q::SMEM,
                stream, p);
}

}  // namespace

// C entry points, every kernel on `stream`. Strides are in elements; the last
// (D) stride must be 1 and every other stride a multiple of 4, with 16-byte
// aligned base pointers (the Python wrapper checks this). Each returns the
// first failing launch's cudaError_t, cudaErrorInvalidValue for a head dim
// without a kernel, or 0.

// The forward: o (B, Sq, H, D) and, with a non-null `lse`, the natural-log
// row log-sum-exp (B, H, Sq) contiguous. Keys at or past `kv_len` are never
// read. `use_exp2` selects nothing: both modes are the same function.
extern "C" int flash_attn_fp32_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int batch,
                                   int sq, int heads, int head_dim, int kv_len, float scale, int use_exp2,
                                   long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                                   long long o_ss, long long o_sh, void* stream) {
  (void)use_exp2;
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.sq = sq;
  p.kv_len = kv_len;
  p.heads = heads;
  p.scale_log2 = scale * kLog2e;
  p.q_sb = q_sb, p.q_ss = q_ss, p.q_sh = q_sh;
  p.k_sb = k_sb, p.k_ss = k_ss, p.k_sh = k_sh;
  p.v_sb = v_sb, p.v_ss = v_ss, p.v_sh = v_sh;
  p.o_sb = o_sb, p.o_ss = o_ss, p.o_sh = o_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return (int)run_fwd<64>(p, batch, s);
    case 128: return (int)run_fwd<128>(p, batch, s);
    case 512: return (int)run_fwd<512>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward: dq, dk, dv shaped like q, k and v. `sq_pad` is Sq rounded up
// to 64, the row pitch of the fp32 scratch `delta` and `lse2` (B, H, sq_pad).
// `strides` holds (batch, seq, head) of q, k, v, o, dout, dq, dk, dv in that
// order. Rows of dK and dV at or past `kv_len` (up to `skv`) are written as
// zeros.
extern "C" int flash_attn_fp32_bwd(const float* q, const float* k, const float* v, const float* o,
                                   const float* dout, const float* lse, float* delta, float* lse2, float* dq,
                                   float* dk, float* dv, int batch, int sq, int sq_pad, int skv, int heads,
                                   int head_dim, int kv_len, float scale, const long long* strides, void* stream) {
  if (sq_pad % 64 != 0 || sq_pad < sq) return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.lse2 = lse2;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sq = sq;
  p.sq_pad = sq_pad;
  p.skv = skv;
  p.kv_len = kv_len;
  p.heads = heads;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  int64_t* dst[24] = {&p.q_sb,  &p.q_ss,  &p.q_sh,  &p.k_sb,  &p.k_ss,  &p.k_sh,  &p.v_sb,  &p.v_ss,
                      &p.v_sh,  &p.o_sb,  &p.o_ss,  &p.o_sh,  &p.do_sb, &p.do_ss, &p.do_sh, &p.dq_sb,
                      &p.dq_ss, &p.dq_sh, &p.dk_sb, &p.dk_ss, &p.dk_sh, &p.dv_sb, &p.dv_ss, &p.dv_sh};
  for (int i = 0; i < 24; ++i) *dst[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return (int)run_bwd<64>(p, batch, s);
    case 128: return (int)run_bwd<128>(p, batch, s);
    case 512: return (int)run_bwd<512>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
