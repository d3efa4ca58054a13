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
// Every product is wgmma on a three-part bf16 split. wgmma takes fp32 data
// only as one .tf32 pass (10 mantissa bits, fp16's width) with both
// shared-memory operands K-major, while the products with a score (P V,
// P^T dO, dS^T Q, dS K) read V, dO, Q and K MN-major; bf16 wgmma has the
// transpose bit. So every fp32 operand x becomes
// three bf16 values, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid) (each subtraction exact in fp32, each rounding to nearest even), and
// a b is summed as six bf16 products, lo*hi, hi*lo, mid*mid, mid*hi, hi*mid,
// hi*hi, the small ones first, into an fp32 accumulator (the dropped mid*lo,
// lo*mid and lo*lo are under 2^-26 of |a||b|). That keeps about 24 bits of
// each operand; six bf16 products at 989 TFLOP/s take the tensor cores as
// long as three TF32 ones at 495. The softmax terms, delta, the log-sum-exp
// and exp2 are fp32 on the CUDA cores.
//
// Every kernel but flash_fp32_bwd_delta has one shape of block:
//   - three warpgroups, 384 threads, one block an SM. Warpgroup 0 is the
//     splitter: its 128 threads copy fp32 chunks of 64 rows x 64 columns
//     (cp.async, each thread reading back only what it copied, two chunks
//     ahead through three 16 KB staging buffers), split every element once
//     and write its hi, mid and lo planes (8 KB each) into a slot in the
//     128-byte swizzle that wgmma reads (a bf16 row of 64 is one 128-byte
//     swizzle row), then fence the writes to the async proxy and arrive on
//     the slot's full mbarrier. Slots are reused through full / empty
//     mbarrier pairs. Rows past the tensor's or `kv_len`'s end are zeros.
//     Warpgroups 1 and 2 are consumers (setmaxnreg moves registers to them).
//   - A score (S = Q K^T, and the backward's dP = dO V^T and their
//     transposes), per 64-column chunk of the contraction, is six wgmma
//     m64n64k16 products of four k-steps over the planes (both K-major) into
//     an accumulator that starts from zero; chunks are added on the CUDA cores.
//   - A product with a score (P V, P^T dO, dS^T Q, dS K): the consumer splits
//     P or dS in its registers into three A operands (the accumulator's
//     layout is the A fragment's) and the other operand's planes are read
//     MN-major through the transpose bit. The tensor cores add into their
//     accumulator by truncation: one accumulator carried across a whole
//     sequence drifted to 4e-4 of the output's RMS at 75,993 keys (on an
//     H100), so each tile's product starts from a zeroed accumulator and is
//     added into its sum (O, dV, dK, dQ) on the CUDA cores, rounded to nearest.
//   - D = 64 (forward also D = 128): the consumers own 64 rows each of the
//     block's own side (queries, or keys in the dK/dV sweep), whose chunks
//     are split once and stay resident; the other side's chunks pass through
//     one ring that both consumers read.
//   - Wide blocks, D = 512 (backward also D = 128): a block owns 64 rows, and
//     the consumers split D as flash_fwd_wide does: consumer c owns output
//     columns D/2 c .. and the same half of each score's contraction, and the
//     two swap their fp32 partial scores through shared memory and add the
//     other's to their own (fp32 addition commutes, so both hold the same
//     scores bit for bit). Three planes of 64 x 512 would take 192 KB, so no
//     chunk stays resident: each consumer has a ring of 3 slots through which
//     every chunk it reads passes, split again for every tile. In the D = 512
//     dK/dV blocks a consumer's 128-register gradient leaves no room for the
//     48 of P^T's or dS^T's split A operands, so the two consumers write
//     those planes into the exchange buffer once both have read it (each
//     half of the rows: both hold the same values) and the product reads
//     them from there.
//
//   flash_fp32_fwd<D>       O = softmax(Q K^T scale) V, online softmax in the
//                           exp2 domain over 64-key tiles; the log-sum-exp,
//                           when asked for, is natural-log fp32 (B, H, Sq), as
//                           the bf16 kernels write it. 128 queries a block at
//                           D = 64 and 128 (Q's chunks resident, K and V
//                           through a ring of 4 or 3 slots), 64 at D = 512.
//   flash_fp32_bwd_delta<D> delta = rowsum(dO * O) and the log-sum-exp times
//                           log2(e), fp32 (B, H, Sq rounded up to 64); the
//                           padding holds delta = 0 and a huge L, so a padded
//                           query gets P = 0.
//   flash_fp32_bwd_dkdv<D>  a block owns keys (128 at D = 64, 64 wide), query
//                           tiles of 64 stream: S^T = K Q^T, dP^T = V dO^T,
//                           P^T = exp2(S^T scale log2(e) - L), dS^T = P^T
//                           (dP^T - delta), dV += P^T dO, dK += dS^T Q. At
//                           D = 512 a consumer's dK and dV would take 256
//                           registers a thread, so each key block has two
//                           blocks, one for dV (S^T alone) and one for dK.
//   flash_fp32_bwd_dq<D>    a block owns queries (128 at D = 64, 64 wide), key
//                           tiles of 64 stream: S, dP, dS as above, dQ += dS K.
// The backward recomputes S and dP in both sweeps (and S^T again in the D =
// 512 dK blocks), sums nothing across blocks and uses no atomics, so dQ, dK
// and dV repeat bit for bit. Keys at or past `kv_len` get P = 0 and zero rows
// of dK and dV.

#include <utility>

#include "flash_attn_hopper.cuh"

namespace {

using namespace flash;

constexpr float kPadLse = 1e30f;  // exp2(s - kPadLse) = 0 for any finite score
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// ---------------------------------------------------------------------------
// The split, the splitter and the consumers' products (forward and backward).
// ---------------------------------------------------------------------------

constexpr int kThreads = 384;  // the splitter warpgroup and two consumer warpgroups
constexpr int kSplitterRegsAll = 40, kConsumerRegsAll = 232;  // setmaxnreg's split between the warpgroups
constexpr int kChunk = 64;                             // rows and columns of a chunk: a bf16 row of 64 fills
                                                       // one 128-byte swizzle row; also keys a tile
constexpr uint32_t kPlaneBytes = kChunk * 128;         // one bf16 plane of a chunk
constexpr uint32_t kSlotBytes = 3 * kPlaneBytes;       // a chunk's hi, mid and lo planes
constexpr uint32_t kPlaneUnits = kPlaneBytes >> 4;     // the same in wgmma descriptor units
constexpr uint32_t kSlotUnits = kSlotBytes >> 4;
constexpr uint32_t kStageBytes = kChunk * kChunk * 4;  // a chunk in fp32
constexpr int kStageBufs = 3;                          // staging buffers: two chunks copied ahead
constexpr int kBarScores = 1, kBarRead = 2;            // named barriers of the wide blocks' score exchange
constexpr uint32_t kXchHalf = 64 * 64 * 4;             // a consumer's buffer of the exchange: 64 x 64 fp32
constexpr int kBarPlanes = 4;                          // named barrier of the D = 512 dK/dV blocks' planes

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
struct FwdShape {
  static constexpr bool kWide = D == 512;              // the consumers split D and swap partial scores
  static constexpr int kRows = kWide ? 64 : 128;       // query rows a block
  static constexpr int kBoxes = D / kChunk;            // 64-column chunks of a row
  static constexpr int kQSlots = kWide ? 0 : 2 * kBoxes;  // Q's resident chunks, kBoxes a consumer
  static constexpr int kRings = kWide ? 2 : 1;         // wide: one ring a consumer
  static constexpr int kRing = D == 64 ? 4 : 3;        // slots a ring
  static constexpr int kJobsPerTile = kWide ? 24 : 2 * kBoxes;  // chunks split a key tile
  static constexpr int kReaders = kWide ? 4 : 8;       // warps that free a slot
  static constexpr int kSplitterRegs = kSplitterRegsAll, kConsumerRegs = kConsumerRegsAll;
  static constexpr uint32_t kXchBytes = kWide ? 2 * kXchHalf : 0;  // the two consumers' partial scores
  static constexpr int kBars = 1 + 2 * kRings * kRing;  // Q's full, then full and empty a slot
  // 1024 bytes of slack to align the slots, Q's slots, the rings, the
  // partial scores, the staging buffers, the mbarriers.
  static constexpr size_t kSmem =
      1024 + (size_t)(kQSlots + kRings * kRing) * kSlotBytes + kXchBytes + kStageBufs * kStageBytes + kBars * 8;
  static_assert(kSmem <= kMaxSmem, "forward slots exceed shared memory");
};

// The six products of a split pair a b, small first: lo*hi, hi*lo, mid*mid,
// mid*hi, hi*mid, hi*hi; the plane (0 hi, 1 mid, 2 lo) of a and of b in product i.
__host__ __device__ constexpr int part_a(int i) { return i == 0 ? 2 : (i == 2 || i == 3) ? 1 : 0; }
__host__ __device__ constexpr int part_b(int i) { return i == 1 ? 2 : (i == 2 || i == 4) ? 1 : 0; }

// Two floats as hi, mid and lo registers of two bf16 each, rounded to
// nearest even; x - hi and x - hi - mid are exact in fp32.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = pack2<__nv_bfloat16>(x0, x1);
  const float2 h = unpack2<__nv_bfloat16>(hi);
  const float r0 = x0 - h.x, r1 = x1 - h.y;
  mid = pack2<__nv_bfloat16>(r0, r1);
  const float2 m = unpack2<__nv_bfloat16>(mid);
  lo = pack2<__nv_bfloat16>(r0 - m.x, r1 - m.y);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(full ? 16 : 0));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n" : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// A chunk the splitter writes: 64 rows x 64 columns of one (batch, head) of
// a (B, S, H, D) fp32 tensor (`src` at row 0 and the chunk's first column,
// rows `ss` elements apart, rows at or past `end` zero) into the three planes
// at shared address `dst`. `full` completes when all 128 splitter threads
// have written theirs; the slot is written once `empty` (null for Q's
// resident chunks) has completed its phase of parity `parity`.
struct Job {
  const float* src;
  int64_t ss;
  int row0, end;
  uint32_t dst;
  uint64_t* full;
  uint64_t* empty;
  uint32_t parity;
};

// Splitter thread `tid`'s share of a chunk, rows tid / 8 + 16 i (i < 4) at
// columns 8 (tid % 8) .. + 7, copied into the staging buffer at `stage`. A
// thread reads back only what it copied, so no barrier guards the staging;
// 16-byte units of consecutive threads are consecutive, so the reads back
// meet no bank conflict.
__device__ __forceinline__ void stage_copy(const Job& j, uint32_t stage, int tid) {
  const int c8 = tid & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (tid >> 3) + 16 * i;
    const bool in = j.row0 + r < j.end;
    const float* src = j.src + (in ? (int64_t)(j.row0 + r) * j.ss : 0) + c8 * 8;
    cp_async16(stage + ((2 * i) * 128 + tid) * 16, src, in);
    cp_async16(stage + ((2 * i + 1) * 128 + tid) * 16, src + 4, in);
  }
}

// Splits what stage_copy brought into the slot's hi, mid and lo planes in the
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)); the 8
// threads of a row write its 128 bytes.
__device__ __forceinline__ void stage_split(const Job& j, uint32_t stage, int tid) {
  const int c8 = tid & 7;
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    const int r = (tid >> 3) + 16 * i;
    const float4 a = lds128(stage + ((2 * i) * 128 + tid) * 16);
    const float4 b = lds128(stage + ((2 * i + 1) * 128 + tid) * 16);
    uint32_t hi[4], mid[4], lo[4];
    split2(a.x, a.y, hi[0], mid[0], lo[0]);
    split2(a.z, a.w, hi[1], mid[1], lo[1]);
    split2(b.x, b.y, hi[2], mid[2], lo[2]);
    split2(b.z, b.w, hi[3], mid[3], lo[3]);
    const uint32_t at = j.dst + r * 128 + ((c8 ^ (r & 7)) << 4);
    sts128(at, hi[0], hi[1], hi[2], hi[3]);
    sts128(at + kPlaneBytes, mid[0], mid[1], mid[2], mid[3]);
    sts128(at + 2 * kPlaneBytes, lo[0], lo[1], lo[2], lo[3]);
  }
}

// The splitter warpgroup: every chunk of `n_jobs`, in order (job_of(n) says
// which), copied two ahead, split once, fenced for wgmma and announced.
template <typename JobOf>
__device__ __forceinline__ void split_jobs(const JobOf& job_of, int n_jobs, uint32_t staging, int tid) {
  stage_copy(job_of(0), staging, tid);
  cp_async_commit();
  if (n_jobs > 1) stage_copy(job_of(1), staging + kStageBytes, tid);
  cp_async_commit();
#pragma unroll 1
  for (int n = 0; n < n_jobs; ++n) {
    if (n + 2 < n_jobs) stage_copy(job_of(n + 2), staging + ((n + 2) % kStageBufs) * kStageBytes, tid);
    cp_async_commit();  // empty groups at the end keep the count
    cp_async_wait<2>();  // job n's copies have landed
    const Job j = job_of(n);
    if (j.empty != nullptr) mbar_wait(j.empty, j.parity);
    stage_split(j, staging + (n % kStageBufs) * kStageBytes, tid);
    fence_proxy_async();  // the planes, visible to wgmma
    mbar_arrive(j.full);
  }
}

// wgmma m64n64k16, bf16 inputs, fp32 accumulator d (the layout of
// flash_attn_hopper.cuh's wrappers), each operand's descriptor formed inside
// the asm as a base plus an immediate offset (16-byte units), so that no
// product's descriptor is held in a register ahead of it. A and B from
// shared memory, both K-major; with `First` d is written, not read.
template <int A_OFF, int B_OFF, bool First>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (First) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, 0, 0;\nadd.s64 da, %32, %34;\nadd.s64 db, %33, %35;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, da, db, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "l"(a), "l"(b), "n"(A_OFF), "n"(B_OFF));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, 1, 0;\nadd.s64 da, %32, %34;\nadd.s64 db, %33, %35;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, da, db, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "n"(A_OFF), "n"(B_OFF));
  }
}

// The same with A from registers (four bf16 pairs a thread, the A fragment)
// and B read MN-major through the transpose bit.
template <int B_OFF, bool First>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (First) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, 0, 0;\nadd.s64 db, %36, %37;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(B_OFF));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, 1, 0;\nadd.s64 db, %36, %37;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(B_OFF));
  }
}

template <int... Is>
__device__ __forceinline__ void qk_steps(float (&s)[32], uint64_t a, uint64_t b, std::integer_sequence<int, Is...>) {
  (wgmma_ss<(int)(part_a(Is / 4) * kPlaneUnits) + Is % 4 * 2, (int)(part_b(Is / 4) * kPlaneUnits) + Is % 4 * 2,
            Is == 0>(s, a, b),
   ...);
}

// S (64 x 64 fp32) = A B^T over one 64-column chunk: six products of 4
// k-steps (each 32 bytes further along the swizzled rows), small first, A and
// B K-major (`a`, `b`: descriptors of their hi planes); the first only writes S.
__device__ __forceinline__ void qk_chunk(float (&s)[32], uint64_t a, uint64_t b) {
  asm volatile("" : "+l"(a), "+l"(b));  // the bases are formed here, not held across tiles
  qk_steps(s, a, b, std::make_integer_sequence<int, 24>{});
}

template <int... Is>
__device__ __forceinline__ void pv_steps(float (&acc)[32], const uint32_t (&p)[3][4][4], uint64_t v,
                                         std::integer_sequence<int, Is...>) {
  (wgmma_rs<(int)(part_b(Is / 4) * kPlaneUnits) + Is % 4 * 128, Is == 0>(acc, p[part_a(Is / 4)][Is % 4], v), ...);
}

// acc (64 x 64 fp32) = P B: P (64 x 64, `p` its hi, mid and lo A
// fragments) and B (64 x 64 columns, `v` the descriptor of its hi plane,
// MN-major); six products of 4 k-steps of 16 rows of B (16 rows of 128
// bytes further), small first; the first only writes acc.
__device__ __forceinline__ void pv_chunk(float (&acc)[32], const uint32_t (&p)[3][4][4], uint64_t v) {
  asm volatile("" : "+l"(v));
  pv_steps(acc, p, v, std::make_integer_sequence<int, 24>{});
}

// wgmma_ss with B read MN-major through the transpose bit.
template <int A_OFF, int B_OFF, bool First>
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (First) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, 0, 0;\nadd.s64 da, %32, %34;\nadd.s64 db, %33, %35;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, da, db, p, 1, 1, 0, 1;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "l"(a), "l"(b), "n"(A_OFF), "n"(B_OFF));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, 1, 0;\nadd.s64 da, %32, %34;\nadd.s64 db, %33, %35;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, da, db, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "n"(A_OFF), "n"(B_OFF));
  }
}

template <int... Is>
__device__ __forceinline__ void pss_steps(float (&acc)[32], uint64_t a, uint64_t b, std::integer_sequence<int, Is...>) {
  (wgmma_ss_tb<(int)(part_a(Is / 4) * kPlaneUnits) + Is % 4 * 2, (int)(part_b(Is / 4) * kPlaneUnits) + Is % 4 * 128,
               Is == 0>(acc, a, b),
   ...);
}

// acc (64 x 64 fp32) = A B with A's three planes in shared memory, K-major
// (`a`), and B's read MN-major (`b`): pv_chunk with A from shared memory.
__device__ __forceinline__ void pss_chunk(float (&acc)[32], uint64_t a, uint64_t b) {
  asm volatile("" : "+l"(a), "+l"(b));
  pss_steps(acc, a, b, std::make_integer_sequence<int, 24>{});
}

// Online softmax over one 64-key tile of a thread's accumulator rows g and g + 8:
// s becomes exp2(s * scale_log2 - m_new), keys at or past `limit` (relative to the
// tile) 0; m and the thread's partial row sums l move on; alpha rescales O.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             float scale_log2, int limit, int t4) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = 8 * j + 2 * t4 + (e & 1) < limit;
      s[4 * j + e] = in ? s[4 * j + e] * scale_log2 : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
}

// P (64 x 64 keys, accumulator layout) as three A operands: two adjacent
// 8-column blocks make one 16-key k-step.
__device__ __forceinline__ void split_p(const float (&s)[32], uint32_t (&p)[3][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], p[0][kk][i], p[1][kk][i], p[2][kk][i]);
  }
}

__device__ __forceinline__ void scale_rows(float (&o)[32], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// A thread's rows (r = 0, 1: `out` and 8 rows further) of a 64 x 64 output
// chunk, row r times scale[r], where `live`.
__device__ __forceinline__ void store_chunk(float* out, int64_t ss, const float (&o)[32], const float (&scale)[2],
                                            const bool (&live)[2], int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live[r]) continue;
    float* row = out + r * 8 * ss + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(o[4 * j + 2 * r] * scale[r], o[4 * j + 2 * r + 1] * scale[r]);
    }
  }
}

// A consumer's view of a ring of R slots: use m is slot m % R, filled for
// the (m / R)-th time. `full` and `empty` are the shared addresses of slot
// 0's mbarriers (the others follow, 8 bytes apart), `kd` slot 0's K-major
// descriptor; the MN-major one differs in its leading byte offset, the
// distance between two planes. Held in 32-bit addresses and one descriptor,
// the view costs a consumer 4 registers.
template <int R>
struct RingView {
  uint32_t full, empty;
  uint64_t kd;
  __device__ __forceinline__ void wait(int m) const {
    asm volatile(
        "{\n.reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@!P1 bra LAB_WAIT;\n}\n" ::"r"(full + 8 * (m % R)),
        "r"((m / R) & 1)
        : "memory");
  }
  __device__ __forceinline__ void release(int m, int lane) const {  // one arrival a warp, after its wgmma read
    if (lane == 0) asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(empty + 8 * (m % R)) : "memory");
  }
  __device__ __forceinline__ uint64_t k(int m) const { return kd + (m % R) * kSlotUnits; }
  __device__ __forceinline__ uint64_t v(int m) const {
    return k(m) + ((uint64_t)(kPlaneUnits - 1) << 16);  // leading byte offset 16 -> kPlaneBytes
  }
};

// This consumer's part of a 64 x 64 score (A B^T over its NC chunks of the
// contraction, A of chunk x at ring use m + 2 x and B at m + 2 x + 1), each
// chunk's product from zero, summed chunk by chunk into its exchange buffer
// (`mine`: a shared address; a thread's 32 scores at mine + 2048 i, i < 8),
// one float4 at a time.
template <int NC, int R>
__device__ __forceinline__ void partial_scores(const RingView<R>& ring, int m, uint32_t mine, int lane) {
#pragma unroll
  for (int x = 0; x < NC; ++x) {
    const int ma = m + 2 * x, mb = ma + 1;
    ring.wait(ma);
    ring.wait(mb);
    float sx[32];
    wgmma_fence();
    qk_chunk(sx, ring.k(ma), ring.k(mb));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sx);
    ring.release(ma, lane);
    ring.release(mb, lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float4 y = make_float4(sx[4 * i], sx[4 * i + 1], sx[4 * i + 2], sx[4 * i + 3]);
      if (x > 0) {
        const float4 z = lds128(mine + 2048 * i);
        y = make_float4(z.x + y.x, z.y + y.y, z.z + y.z, z.w + y.w);
      }
      sts128(mine + 2048 * i, __float_as_uint(y.x), __float_as_uint(y.y), __float_as_uint(y.z), __float_as_uint(y.w));
    }
  }
}

// Exchange e of a block: it may write once the other consumer has read
// exchange e - 1 (`begin`); `end` waits for both partials, sums this
// consumer's (at `mine`) and the other's (the other buffer, kXchHalf bytes
// away) (fp32 addition commutes: both consumers hold the same sums bit for
// bit), one float4 at a time, and unless e is the last tells the other that
// its buffer is read.
__device__ __forceinline__ void xch_begin(int e, int c) {
  if (e > 0) named_barrier_sync(kBarRead + c, 256);
}
__device__ __forceinline__ void xch_end(float (&s)[32], uint32_t mine, int c, bool more) {
  named_barrier_sync(kBarScores, 256);
  const uint32_t theirs = c == 0 ? mine + kXchHalf : mine - kXchHalf;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 y = lds128(mine + 2048 * i), z = lds128(theirs + 2048 * i);
    s[4 * i] = y.x + z.x;
    s[4 * i + 1] = y.y + z.y;
    s[4 * i + 2] = y.z + z.z;
    s[4 * i + 3] = y.w + z.w;
    asm volatile("" ::"f"(s[4 * i]), "f"(s[4 * i + 1]), "f"(s[4 * i + 2]), "f"(s[4 * i + 3]));  // before the next loads
  }
  if (more) named_barrier_arrive(kBarRead + 1 - c, 256);
}

// g[x] += P B for x < NC: P in registers (three A operands), B's chunk x at
// ring use m + x read MN-major; each chunk's product from zero, added on the
// CUDA cores.
template <int NC, int R>
__device__ __forceinline__ void products(float (&g)[NC][32], const uint32_t (&pp)[3][4][4], const RingView<R>& ring,
                                         int m, int lane) {
#pragma unroll
  for (int x = 0; x < NC; ++x) {
    ring.wait(m + x);
    float acc[32];
    wgmma_fence();
    pv_chunk(acc, pp, ring.v(m + x));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release(m + x, lane);
#pragma unroll
    for (int i = 0; i < 32; ++i) g[x][i] += acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fp32_fwd(const FwdParams p) {
  using S = FwdShape<D>;
  constexpr int NB = S::kBoxes, R = S::kRing;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qslots = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = qslots + S::kQSlots * kSlotBytes;  // ring c's slot i at (c R + i) kSlotBytes
  float* xs = reinterpret_cast<float*>(ring + S::kRings * R * kSlotBytes);  // wide: [consumer][32][128 threads]
  unsigned char* staging = reinterpret_cast<unsigned char*>(xs) + S::kXchBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(staging + kStageBufs * kStageBytes);
  uint64_t* full = q_full + 1;  // ring c's slot i at c R + i
  uint64_t* empty = full + S::kRings * R;

  const int q0 = blockIdx.x * S::kRows, h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int n_tiles = (p.kv_len + kChunk - 1) / kChunk;
  const int wg = threadIdx.x / 128;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 128 * (S::kQSlots > 0 ? S::kQSlots : 1));
    for (int i = 0; i < S::kRings * R; ++i) {
      mbar_init(full + i, 128);
      mbar_init(empty + i, S::kReaders);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<S::kSplitterRegs>();
    const int tid = threadIdx.x;
    if constexpr (S::kWide) {
      // Per key tile t and consumer c, in ring c: Q chunk x, K chunk x (x <
      // 4, c's half of the contraction), then V chunks x (c's output
      // columns); the consumers' chunks alternate.
      auto job_of = [&](int n) {
        const int t = n / S::kJobsPerTile, r = n % S::kJobsPerTile, jj = r >> 1, c = r & 1;
        const int kind = jj < 8 ? (jj & 1) : 2, x = jj < 8 ? (jj >> 1) : jj - 8;
        const int m = 12 * t + jj, slot = c * R + m % R;
        Job j;
        j.src = (kind == 0 ? qb : kind == 1 ? kb : vb) + kChunk * (4 * c + x);
        j.ss = kind == 0 ? p.q_ss : kind == 1 ? p.k_ss : p.v_ss;
        j.row0 = kind == 0 ? q0 : t * kChunk;
        j.end = kind == 0 ? p.sq : p.kv_len;
        j.dst = smem_addr(ring) + slot * kSlotBytes;
        j.full = full + slot;
        j.empty = empty + slot;
        j.parity = ((m / R) & 1) ^ 1;  // the first round finds the ring free
        return j;
      };
      split_jobs(job_of, n_tiles * S::kJobsPerTile, smem_addr(staging), tid);
    } else {
      // Q's chunks (consumer c's box x at slot c NB + x), then per key tile
      // its K chunks and its V chunks through the one ring.
      auto job_of = [&](int n) {
        Job j;
        if (n < S::kQSlots) {
          j.src = qb + kChunk * (n % NB);
          j.ss = p.q_ss;
          j.row0 = q0 + kChunk * (n / NB);
          j.end = p.sq;
          j.dst = smem_addr(qslots) + n * kSlotBytes;
          j.full = q_full;
          j.empty = nullptr;
          j.parity = 0;
        } else {
          const int m = n - S::kQSlots, y = m % (2 * NB);
          const bool is_v = y >= NB;
          j.src = (is_v ? vb : kb) + kChunk * (y % NB);
          j.ss = is_v ? p.v_ss : p.k_ss;
          j.row0 = (m / (2 * NB)) * kChunk;
          j.end = p.kv_len;
          j.dst = smem_addr(ring) + (m % R) * kSlotBytes;
          j.full = full + m % R;
          j.empty = empty + m % R;
          j.parity = ((m / R) & 1) ^ 1;
        }
        return j;
      };
      split_jobs(job_of, S::kQSlots + n_tiles * S::kJobsPerTile, smem_addr(staging), tid);
    }
    return;
  }

  reg_alloc<S::kConsumerRegs>();
  const int c = wg - 1, ctid = threadIdx.x % 128, warp = ctid / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  constexpr int NO = S::kWide ? 4 : NB;  // 64-column chunks of the output a consumer owns
  float o[NO][32];
#pragma unroll
  for (int x = 0; x < NO; ++x) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[x][i] = 0.f;
  }
  int row;  // this thread's rows: row and row + 8
  if constexpr (!S::kWide) {
    // Consumer c: query rows q0 + 64 c .. + 63, all D columns; a tile's K
    // chunks at ring uses 2 NB t + x, its V chunks NB further.
    const uint64_t q_desc = sw128_desc(qslots + c * NB * kSlotBytes, 16, 1024);
    const RingView<R> rv{smem_addr(full), smem_addr(empty), sw128_desc(ring, 16, 1024)};
    row = q0 + kChunk * c + 16 * warp + g;
    mbar_wait(q_full, 0);
#pragma unroll 1
    for (int t = 0; t < n_tiles; ++t) {
      const int m0 = t * 2 * NB;
      float s[32];
      [[maybe_unused]] float s1[32];
#pragma unroll
      for (int x = 0; x < NB; ++x) rv.wait(m0 + x);
      wgmma_fence();
      qk_chunk(s, q_desc, rv.k(m0));
      if constexpr (NB == 2) qk_chunk(s1, q_desc + kSlotUnits, rv.k(m0 + 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if constexpr (NB == 2) {
        fence_regs(s1);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] += s1[i];
      }
#pragma unroll
      for (int x = 0; x < NB; ++x) rv.release(m0 + x, lane);
      softmax_tile(s, m, l, alpha, p.scale_log2, p.kv_len - t * kChunk, t4);
#pragma unroll
      for (int x = 0; x < NB; ++x) scale_rows(o[x], alpha);
      uint32_t pp[3][4][4];
      split_p(s, pp);
      products<NB>(o, pp, rv, m0 + NB, lane);
    }
  } else {
    // Consumer c: output columns 256 c .. 256 c + 255 of all 64 rows and the
    // same half of the contraction of S, its chunks through ring c; a tile's
    // Q and K chunks at uses 12 t + 2 x and + 1, its V chunks at 12 t + 8 + x.
    const RingView<R> rv{smem_addr(full + c * R), smem_addr(empty + c * R),
                         sw128_desc(ring + c * R * kSlotBytes, 16, 1024)};
    const uint32_t mine = smem_addr(xs) + c * kXchHalf + 16 * ctid;
    row = q0 + 16 * warp + g;
#pragma unroll 1
    for (int t = 0; t < n_tiles; ++t) {
      const int m0 = 12 * t;
      float s[32];
      xch_begin(t, c);
      partial_scores<4>(rv, m0, mine, lane);
      xch_end(s, mine, c, t + 1 < n_tiles);
      softmax_tile(s, m, l, alpha, p.scale_log2, p.kv_len - t * kChunk, t4);
#pragma unroll
      for (int x = 0; x < 4; ++x) scale_rows(o[x], alpha);
      uint32_t pp[3][4][4];
      split_p(s, pp);
      products<4>(o, pp, rv, m0 + 8, lane);
    }
  }
  float inv[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    inv[r] = 1.f / sum;
    live[r] = row + 8 * r < p.sq;
    if (live[r] && p.lse != nullptr && (c == 0 || !S::kWide) && t4 == 0) {
      p.lse[(b * p.heads + h) * p.sq + row + 8 * r] = (m[r] + log2f(sum)) * kLn2;
    }
  }
  float* out = p.o + b * p.o_sb + (int64_t)row * p.o_ss + h * p.o_sh + (S::kWide ? 256 * c : 0);
#pragma unroll
  for (int x = 0; x < NO; ++x) store_chunk(out + kChunk * x, p.o_ss, o[x], inv, live, t4);
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
struct BwdShape {
  static constexpr bool kWide = D >= 128;           // the consumers split D and swap partial scores
  static constexpr int kRows = kWide ? 64 : 128;    // a block's own rows: keys (dK/dV) or queries (dQ)
  static constexpr int NC = kWide ? D / 128 : 1;    // 64-column chunks of D a consumer owns
  static constexpr int kResident = kWide ? 0 : 4;   // D = 64: each consumer's two own-side chunks
  static constexpr int kRings = kWide ? 2 : 1;      // wide: one ring a consumer
  static constexpr int kRing = 3;
  static constexpr int kReaders = kWide ? 4 : 8;    // warps that free a slot
  // setmaxnreg's split. At D = 512 a consumer holds a 128-register gradient:
  // 240 a consumer thread, and the splitter gives up exactly the registers
  // they take, 128 x (168 - 24) = 256 x (240 - 168), since setmaxnreg.inc
  // waits until they are free (with the splitter at 32 the block hung). At
  // D = 128, where 232 suffice, the splitter keeps 40: at 24 it ran slower.
  static constexpr int kSplitterRegs = D == 512 ? 24 : kSplitterRegsAll;
  static constexpr int kConsumerRegs = D == 512 ? 240 : kConsumerRegsAll;
  static constexpr uint32_t kXchBytes = kWide ? 2 * kXchHalf : 0;
  static constexpr int kBars = 1 + 2 * kRings * kRing;
  static constexpr size_t kSmem = 1024 + (size_t)(kResident + kRings * kRing) * kSlotBytes + kXchBytes +
                                  kStageBufs * kStageBytes + kBars * 8;
  static_assert(kSmem <= kMaxSmem, "backward slots exceed shared memory");
};

// What a dK/dV block computes: dV (and S^T), dK (and S^T, dP^T), or both.
enum Grads : int { kDV = 1, kDK = 2, kBoth = 3 };

// The tensors a splitter job reads.
enum Src : int { kQ = 0, kK = 1, kV = 2, kDO = 3 };

// The j-th chunk of a wide backward block's key or query tile, for one
// consumer with NC chunks: (tensor, chunk x). dK/dV (`grads`): the S^T pairs
// (K_x, Q_x), the dP^T pairs (V_x, dO_x) where dK is asked for, then dV's
// dO_x and dK's Q_x. dQ (`grads` 0): the S pairs (Q_x, K_x), the dP pairs
// (dO_x, V_x), then dQ's K_x.
__device__ __forceinline__ void wide_job(int j, int nc, int grads, int& src, int& x) {
  if (grads == 0) {
    if (j < 4 * nc) {
      x = (j % (2 * nc)) >> 1;
      src = j < 2 * nc ? ((j & 1) ? kK : kQ) : ((j & 1) ? kV : kDO);
    } else {
      x = j - 4 * nc;
      src = kK;
    }
    return;
  }
  const int n_pairs = grads & kDK ? 2 * nc : nc;
  if (j < 2 * n_pairs) {
    x = (j % (2 * nc)) >> 1;
    src = j < 2 * nc ? ((j & 1) ? kQ : kK) : ((j & 1) ? kDO : kV);
  } else {
    const int i = j - 2 * n_pairs;
    x = i % nc;
    src = (grads & kDV) && i < nc ? kDO : kQ;
  }
}

// Chunks of a wide block's tile for one consumer.
__host__ __device__ constexpr int wide_jobs(int nc, int grads) {
  if (grads == 0) return 5 * nc;
  return (grads & kDK ? 4 * nc : 2 * nc) + (grads == kBoth ? 2 * nc : nc);
}

// A thread's rows of a 64 x 64 fp32 score tile (rows 16 w + g + 8 r,
// columns 8 j + 2 t4 + e, the accumulator layout), split into the three
// bf16 planes that the splitter writes (128-byte swizzle) at `planes`.
__device__ __forceinline__ void write_planes(uint32_t planes, const float (&d)[32], int warp, int g, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t hi, mid, lo;
      split2(d[4 * j + 2 * r], d[4 * j + 2 * r + 1], hi, mid, lo);
      const uint32_t at = planes + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t4;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(hi) : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + kPlaneBytes), "r"(mid) : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 2 * kPlaneBytes), "r"(lo) : "memory");
    }
  }
}

// `products` with P's planes in shared memory (`pd`, K-major) instead of
// registers: for the wide D = 512 dK/dV consumer, whose 128-register
// gradient leaves no room for P's 48.
template <int NC, int R>
__device__ __forceinline__ void products_ss(float (&g)[NC][32], uint64_t pd, const RingView<R>& ring, int m,
                                            int lane) {
#pragma unroll
  for (int x = 0; x < NC; ++x) {
    ring.wait(m + x);
    float acc[32];
    wgmma_fence();
    pss_chunk(acc, pd, ring.v(m + x));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release(m + x, lane);
#pragma unroll
    for (int i = 0; i < 32; ++i) g[x][i] += acc[i];
  }
}

// acc (64 x 64) = P B for one chunk, both in shared memory's reach: the
// product from zero, waited for.
__device__ __forceinline__ void product_now(float (&acc)[32], const uint32_t (&pp)[3][4][4], uint64_t b) {
  wgmma_fence();
  pv_chunk(acc, pp, b);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// A thread's 16 score columns (8 j + 2 t4 + e) of a 64-query tile at `q0`
// in `row`, one (batch, head) row of the padded scratch (L or delta).
__device__ __forceinline__ void col_vector(const float* row, int q0, int t4, float2 (&out)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = *reinterpret_cast<const float2*>(row + q0 + 8 * j + 2 * t4);
}

// P^T = exp2(S^T scale log2(e) - L) over a thread's rows (keys; `live`: key <
// kv_len, else 0) and columns (queries, `lc`), in place.
__device__ __forceinline__ void probs_t(float (&s)[32], const float2 (&lc)[8], const bool (&live)[2], float sl2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float2 l = lc[i >> 2];
    s[i] = live[(i >> 1) & 1] ? exp2f(s[i] * sl2 - ((i & 1) ? l.y : l.x)) : 0.f;
  }
}

// dS^T = P^T (dP^T - delta) over a thread's columns (queries, `dc`), into dp.
__device__ __forceinline__ void dscores_t(float (&dp)[32], const float (&pt)[32], const float2 (&dc)[8]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float2 d = dc[i >> 2];
    dp[i] = pt[i] * (dp[i] - ((i & 1) ? d.y : d.x));
  }
}

// dS = P (dP - delta) of a thread's rows (queries: `lr`, `dr`) and columns
// (keys at or past `limit`, relative to the tile, get 0), into s.
__device__ __forceinline__ void dscores(float (&s)[32], const float (&dp)[32], const float (&lr)[2],
                                        const float (&dr)[2], float sl2, int limit, int t4) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const bool in = 8 * (i >> 2) + 2 * t4 + (i & 1) < limit;
    s[i] = in ? exp2f(s[i] * sl2 - lr[r]) * (dp[i] - dr[r]) : 0.f;
  }
}

// The backward's blocks (the forward's three warpgroups, split and splitter).
//   dK/dV: a block owns keys. D = 64: 128 keys, 64 a consumer, whose K and V
//   chunks are split once and stay resident; Q and dO tiles of 64 queries
//   pass through one ring both consumers read. D = 128 and 512: 64 keys, the
//   consumers splitting D (consumer c: output columns D/2 c .., the same half
//   of each score's contraction, partial scores swapped), every chunk
//   through ring c. A tile: S^T = K Q^T and dP^T = V dO^T (six products each),
//   P^T = exp2(S^T scale log2(e) - L) (0 for keys at or past kv_len), dS^T =
//   P^T (dP^T - delta), dV += P^T dO and dK += dS^T Q (P^T and dS^T split in
//   registers, dO and Q read MN-major). At D = 512 a consumer's dK and dV
//   would take 256 registers a thread, so every key block has two blocks,
//   one for dV (S^T alone) and one for dK.
//   dQ: a block owns queries (128 at D = 64, 64 wide), K and V tiles of 64
//   keys stream: S = Q K^T, dP = dO V^T, dS = P (dP - delta), dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fp32_bwd_dkdv(const BwdParams p) {
  using S = BwdShape<D>;
  constexpr int NC = S::NC, R = S::kRing;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* resident = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = resident + S::kResident * kSlotBytes;
  float* xs = reinterpret_cast<float*>(ring + S::kRings * R * kSlotBytes);
  unsigned char* staging = reinterpret_cast<unsigned char*>(xs) + S::kXchBytes;
  uint64_t* res_full = reinterpret_cast<uint64_t*>(staging + kStageBufs * kStageBytes);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + S::kRings * R;

  // D = 512: blocks 2 i and 2 i + 1 share key block i, the first computing dV, the second dK.
  const int grads = D == 512 ? ((blockIdx.x & 1) ? kDK : kDV) : kBoth;
  const int k0 = (D == 512 ? blockIdx.x >> 1 : blockIdx.x) * S::kRows, h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int n_tiles = (p.sq + kChunk - 1) / kChunk;
  const int wg = threadIdx.x / 128;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* dob = p.dout + b * p.do_sb + h * p.do_sh;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 128 * (S::kResident > 0 ? S::kResident : 1));
    for (int i = 0; i < S::kRings * R; ++i) {
      mbar_init(full + i, 128);
      mbar_init(empty + i, S::kReaders);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<S::kSplitterRegs>();
    const int jobs = S::kWide ? wide_jobs(NC, grads) : 2;  // a tile's chunks (wide: a consumer's)
    auto job_of = [&](int n) {
      Job j;
      int src, x = 0, row0, slot, m;
      if (!S::kWide && n < S::kResident) {  // consumer n / 2's K (n even) or V chunk, split once
        src = (n & 1) ? kV : kK;
        row0 = k0 + kChunk * (n >> 1);
        j.dst = smem_addr(resident) + n * kSlotBytes;
        j.full = res_full;
        j.empty = nullptr;
        j.parity = 0;
      } else {
        int c = 0;
        if constexpr (S::kWide) {
          const int r = n % (2 * jobs);
          c = r & 1;
          m = (n / (2 * jobs)) * jobs + (r >> 1);
          wide_job(r >> 1, NC, grads, src, x);
          x += c * NC;
        } else {
          m = n - S::kResident;
          src = (m & 1) ? kDO : kQ;
        }
        const int t = m / jobs;
        row0 = src == kQ || src == kDO ? t * kChunk : k0;
        slot = c * R + m % R;
        j.dst = smem_addr(ring) + slot * kSlotBytes;
        j.full = full + slot;
        j.empty = empty + slot;
        j.parity = ((m / R) & 1) ^ 1;
      }
      j.src = (src == kQ ? qb : src == kK ? kb : src == kV ? vb : dob) + kChunk * x;
      j.ss = src == kQ ? p.q_ss : src == kK ? p.k_ss : src == kV ? p.v_ss : p.do_ss;
      j.row0 = row0;
      j.end = src == kQ || src == kDO ? p.sq : p.kv_len;
      return j;
    };
    split_jobs(job_of, S::kResident + n_tiles * jobs * S::kRings, smem_addr(staging), threadIdx.x);
    return;
  }

  reg_alloc<S::kConsumerRegs>();
  const int c = wg - 1, ctid = threadIdx.x % 128, warp = ctid / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // This thread's key rows: key and key + 8.
  const int key = k0 + (S::kWide ? 0 : kChunk * c) + 16 * warp + g;
  const bool live[2] = {key < p.kv_len, key + 8 < p.kv_len};
  const bool stored[2] = {key < p.skv, key + 8 < p.skv};
  // Formed where they are used (from the block's indices), not held through
  // the sweep: the wide consumers' registers are all but spent.
  auto out_of = [&](float* g, int64_t sb, int64_t ss, int64_t sh) {
    return g + (int64_t)blockIdx.z * sb + (int64_t)key * ss + (int64_t)blockIdx.y * sh;
  };
  auto lse2_row = [&]() { return p.lse2 + ((int64_t)blockIdx.z * p.heads + blockIdx.y) * p.sq_pad; };
  auto delta_row = [&]() { return p.delta + ((int64_t)blockIdx.z * p.heads + blockIdx.y) * p.sq_pad; };
  auto store = [&](float* g, int64_t sb, int64_t ss, int64_t sh, int col, const float (&v)[32], float sc) {
    const float scale[2] = {sc, sc};
    store_chunk(out_of(g, sb, ss, sh) + col, ss, v, scale, stored, t4);
  };
  float2 lc[8], dc[8];  // L and delta of a thread's score columns

  if constexpr (!S::kWide) {
    // D = 64: consumer c's keys, its K and V chunks resident.
    const uint64_t k_res = sw128_desc(resident + 2 * c * kSlotBytes, 16, 1024);
    const uint64_t v_res = k_res + kSlotUnits;
    const RingView<R> rv{smem_addr(full), smem_addr(empty), sw128_desc(ring, 16, 1024)};
    float gk[32], gv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) gk[i] = gv[i] = 0.f;
    mbar_wait(res_full, 0);
#pragma unroll 1
    for (int t = 0; t < n_tiles; ++t) {
      const int mq = 2 * t, md = mq + 1;  // ring uses of the tile's Q and dO chunks
      col_vector(lse2_row(), t * kChunk, t4, lc);
      col_vector(delta_row(), t * kChunk, t4, dc);
      rv.wait(mq);
      rv.wait(md);
      float st[32], dpt[32];
      wgmma_fence();
      qk_chunk(st, k_res, rv.k(mq));
      qk_chunk(dpt, v_res, rv.k(md));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      probs_t(st, lc, live, p.scale_log2);
      dscores_t(dpt, st, dc);
      uint32_t pp[3][4][4];
      float acc[32];
      split_p(st, pp);
      product_now(acc, pp, rv.v(md));  // dV += P^T dO
#pragma unroll
      for (int i = 0; i < 32; ++i) gv[i] += acc[i];
      split_p(dpt, pp);
      product_now(acc, pp, rv.v(mq));  // dK += dS^T Q
#pragma unroll
      for (int i = 0; i < 32; ++i) gk[i] += acc[i];
      rv.release(mq, lane);
      rv.release(md, lane);
    }
    store(p.dk, p.dk_sb, p.dk_ss, p.dk_sh, 0, gk, p.scale);
    store(p.dv, p.dv_sb, p.dv_ss, p.dv_sh, 0, gv, 1.f);
  } else {
    // D = 128, 512: consumer c's half of D (chunks c NC ..), all 64 keys.
    const RingView<R> rv{smem_addr(full + c * R), smem_addr(empty + c * R),
                         sw128_desc(ring + c * R * kSlotBytes, 16, 1024)};
    const uint32_t mine = smem_addr(xs) + c * kXchHalf + 16 * ctid;
    // The sweep for one choice of gradients, `G` of kDV, kDK, kBoth.
    auto sweep = [&](auto grads_c) {
      constexpr int G = decltype(grads_c)::value;
      constexpr int jobs = wide_jobs(NC, G);
      constexpr int kXch = G & kDK ? 2 : 1;  // exchanges a tile
      float gk[G & kDK ? NC : 1][32], gv[G & kDV ? NC : 1][32];
#pragma unroll
      for (int x = 0; x < NC; ++x) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if constexpr ((G & kDK) != 0) gk[x][i] = 0.f;
          if constexpr ((G & kDV) != 0) gv[x][i] = 0.f;
        }
      }
#pragma unroll 1
      for (int t = 0; t < n_tiles; ++t) {
        const int m = t * jobs;
        col_vector(lse2_row(), t * kChunk, t4, lc);
        float st[32];
        // At D = 512 the tile's product takes P^T or dS^T from planes that
        // the two consumers write into the exchange buffer once both have
        // read it; the other consumer is told its buffer is free only once
        // its products are done with the planes.
        constexpr bool kPlanes = NC == 4;
        xch_begin(kXch * t, c);
        partial_scores<NC>(rv, m, mine, lane);
        xch_end(st, mine, c, kXch == 2 || (!kPlanes && t + 1 < n_tiles));
        probs_t(st, lc, live, p.scale_log2);
        int mp = m + 2 * NC;  // the products' first ring use
        auto product = [&](float (&gx)[NC][32], const float (&ps)[32]) {
          if constexpr (kPlanes) {
            named_barrier_sync(kBarPlanes, 256);  // both consumers have read the exchange buffers
            if ((warp >> 1) == c) write_planes(smem_addr(xs), ps, warp, g, t4);
            fence_proxy_async();
            named_barrier_sync(kBarPlanes, 256);  // the planes are whole
            products_ss<NC>(gx, sw128_desc(xs, 16, 1024), rv, mp, lane);
            if (t + 1 < n_tiles) named_barrier_arrive(kBarRead + 1 - c, 256);
          } else {
            uint32_t pp[3][4][4];
            split_p(ps, pp);
            products<NC>(gx, pp, rv, mp, lane);
          }
        };
        if constexpr ((G & kDK) != 0) {
          float dpt[32];
          xch_begin(kXch * t + 1, c);
          partial_scores<NC>(rv, m + 2 * NC, mine, lane);
          xch_end(dpt, mine, c, !kPlanes && t + 1 < n_tiles);
          col_vector(delta_row(), t * kChunk, t4, dc);  // loaded late: no registers held through dP^T's products
          dscores_t(dpt, st, dc);
          mp += 2 * NC;
          if constexpr ((G & kDV) != 0) {
            product(gv, st);
            mp += NC;
          }
          product(gk, dpt);
        } else {
          product(gv, st);
        }
      }
#pragma unroll
      for (int x = 0; x < NC; ++x) {
        const int col = kChunk * (c * NC + x);
        if constexpr ((G & kDK) != 0) store(p.dk, p.dk_sb, p.dk_ss, p.dk_sh, col, gk[x], p.scale);
        if constexpr ((G & kDV) != 0) store(p.dv, p.dv_sb, p.dv_ss, p.dv_sh, col, gv[x], 1.f);
      }
    };
    if constexpr (D == 512) {
      if (grads == kDV) {
        sweep(std::integral_constant<int, kDV>{});
      } else {
        sweep(std::integral_constant<int, kDK>{});
      }
    } else {
      sweep(std::integral_constant<int, kBoth>{});
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fp32_bwd_dq(const BwdParams p) {
  using S = BwdShape<D>;
  constexpr int NC = S::NC, R = S::kRing;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* resident = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = resident + S::kResident * kSlotBytes;
  float* xs = reinterpret_cast<float*>(ring + S::kRings * R * kSlotBytes);
  unsigned char* staging = reinterpret_cast<unsigned char*>(xs) + S::kXchBytes;
  uint64_t* res_full = reinterpret_cast<uint64_t*>(staging + kStageBufs * kStageBytes);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + S::kRings * R;

  const int q0 = blockIdx.x * S::kRows, h = blockIdx.y;
  const int64_t b = blockIdx.z, bh = b * p.heads + h;
  const int n_tiles = (p.kv_len + kChunk - 1) / kChunk;
  const int wg = threadIdx.x / 128;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* dob = p.dout + b * p.do_sb + h * p.do_sh;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 128 * (S::kResident > 0 ? S::kResident : 1));
    for (int i = 0; i < S::kRings * R; ++i) {
      mbar_init(full + i, 128);
      mbar_init(empty + i, S::kReaders);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<S::kSplitterRegs>();
    const int jobs = S::kWide ? wide_jobs(NC, 0) : 2;
    auto job_of = [&](int n) {
      Job j;
      int src, x = 0, row0, slot, m;
      if (!S::kWide && n < S::kResident) {  // consumer n / 2's Q (n even) or dO chunk, split once
        src = (n & 1) ? kDO : kQ;
        row0 = q0 + kChunk * (n >> 1);
        j.dst = smem_addr(resident) + n * kSlotBytes;
        j.full = res_full;
        j.empty = nullptr;
        j.parity = 0;
      } else {
        int c = 0;
        if constexpr (S::kWide) {
          const int r = n % (2 * jobs);
          c = r & 1;
          m = (n / (2 * jobs)) * jobs + (r >> 1);
          wide_job(r >> 1, NC, 0, src, x);
          x += c * NC;
        } else {
          m = n - S::kResident;
          src = (m & 1) ? kV : kK;
        }
        const int t = m / jobs;
        row0 = src == kK || src == kV ? t * kChunk : q0;
        slot = c * R + m % R;
        j.dst = smem_addr(ring) + slot * kSlotBytes;
        j.full = full + slot;
        j.empty = empty + slot;
        j.parity = ((m / R) & 1) ^ 1;
      }
      j.src = (src == kQ ? qb : src == kK ? kb : src == kV ? vb : dob) + kChunk * x;
      j.ss = src == kQ ? p.q_ss : src == kK ? p.k_ss : src == kV ? p.v_ss : p.do_ss;
      j.row0 = row0;
      j.end = src == kK || src == kV ? p.kv_len : p.sq;
      return j;
    };
    split_jobs(job_of, S::kResident + n_tiles * jobs * S::kRings, smem_addr(staging), threadIdx.x);
    return;
  }

  reg_alloc<S::kConsumerRegs>();
  const int c = wg - 1, ctid = threadIdx.x % 128, warp = ctid / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // This thread's query rows, row and row + 8, with their L and delta (the
  // scratch is padded to sq_pad; rows past it count as padding).
  const int row = q0 + (S::kWide ? 0 : kChunk * c) + 16 * warp + g;
  float lr[2], dr[2];
  auto row_vectors = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row + 8 * r < p.sq_pad;
      lr[r] = in ? p.lse2[bh * p.sq_pad + row + 8 * r] : kPadLse;
      dr[r] = in ? p.delta[bh * p.sq_pad + row + 8 * r] : 0.f;
    }
  };
  const bool stored[2] = {row < p.sq, row + 8 < p.sq};
  float gq[NC][32];
#pragma unroll
  for (int x = 0; x < NC; ++x) {
#pragma unroll
    for (int i = 0; i < 32; ++i) gq[x][i] = 0.f;
  }

  if constexpr (!S::kWide) {
    // D = 64: consumer c's queries, its Q and dO chunks resident.
    const uint64_t q_res = sw128_desc(resident + 2 * c * kSlotBytes, 16, 1024);
    const uint64_t do_res = q_res + kSlotUnits;
    const RingView<R> rv{smem_addr(full), smem_addr(empty), sw128_desc(ring, 16, 1024)};
    row_vectors();
    mbar_wait(res_full, 0);
#pragma unroll 1
    for (int t = 0; t < n_tiles; ++t) {
      const int mk = 2 * t, mv = mk + 1;  // ring uses of the tile's K and V chunks
      rv.wait(mk);
      rv.wait(mv);
      float s[32], dp[32];
      wgmma_fence();
      qk_chunk(s, q_res, rv.k(mk));
      qk_chunk(dp, do_res, rv.k(mv));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      rv.release(mv, lane);
      dscores(s, dp, lr, dr, p.scale_log2, p.kv_len - t * kChunk, t4);
      uint32_t pp[3][4][4];
      float acc[32];
      split_p(s, pp);
      product_now(acc, pp, rv.v(mk));  // dQ += dS K
      rv.release(mk, lane);
#pragma unroll
      for (int i = 0; i < 32; ++i) gq[0][i] += acc[i];
    }
  } else {
    // D = 128, 512: consumer c's half of D, all 64 queries.
    const RingView<R> rv{smem_addr(full + c * R), smem_addr(empty + c * R),
                         sw128_desc(ring + c * R * kSlotBytes, 16, 1024)};
    const uint32_t mine = smem_addr(xs) + c * kXchHalf + 16 * ctid;
    constexpr int kJobs = 5 * NC;
#pragma unroll 1
    for (int t = 0; t < n_tiles; ++t) {
      const int m = t * kJobs;
      float s[32], dp[32];
      xch_begin(2 * t, c);
      partial_scores<NC>(rv, m, mine, lane);
      xch_end(s, mine, c, true);
      row_vectors();  // per tile: no registers held through the products
      xch_begin(2 * t + 1, c);
      partial_scores<NC>(rv, m + 2 * NC, mine, lane);
      xch_end(dp, mine, c, t + 1 < n_tiles);
      dscores(s, dp, lr, dr, p.scale_log2, p.kv_len - t * kChunk, t4);
      uint32_t pp[3][4][4];
      split_p(s, pp);
      products<NC>(gq, pp, rv, m + 4 * NC, lane);
    }
  }
  float* dq_out = p.dq + b * p.dq_sb + (int64_t)row * p.dq_ss + h * p.dq_sh;
  const float scale[2] = {p.scale, p.scale};
#pragma unroll
  for (int x = 0; x < NC; ++x) {
    store_chunk(dq_out + kChunk * ((S::kWide ? c * NC : 0) + x), p.dq_ss, gq[x], scale, stored, t4);
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
  const dim3 grid((p.sq + S::kRows - 1) / S::kRows, p.heads, batch);
  return launch(flash_fp32_fwd<D>, grid, kThreads, (int)S::kSmem, stream, p);
}

template <int D>
cudaError_t run_bwd(const BwdParams& p, int batch, cudaStream_t stream) {
  const int64_t pad_rows = (int64_t)batch * p.sq_pad * p.heads;
  constexpr int rows = 128 / kDeltaTPR<D>;  // rows a block of flash_fp32_bwd_delta
  flash_fp32_bwd_delta<D><<<(unsigned)((pad_rows + rows - 1) / rows), 128, 0, stream>>>(p, pad_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  using S = BwdShape<D>;
  const int key_blocks = (p.skv + S::kRows - 1) / S::kRows;
  e = launch(flash_fp32_bwd_dkdv<D>, dim3(key_blocks * (D == 512 ? 2 : 1), p.heads, batch), kThreads, (int)S::kSmem,
             stream, p);
  if (e != cudaSuccess) return e;
  return launch(flash_fp32_bwd_dq<D>, dim3((p.sq + S::kRows - 1) / S::kRows, p.heads, batch), kThreads,
                (int)S::kSmem, stream, p);
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
