// Device helpers shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): cp.async staging, mma.sync m16n8k16 bf16 with fp32
// accumulation, ldmatrix, bf16 packing and quad reductions.
//
// Fragment layouts of mma.sync m16n8k16 (g = lane / 4, t4 = lane % 4):
//   A (16 x 16, row): a0 (g, 2t4..), a1 (g + 8, 2t4..), a2 (g, 8 + 2t4..), a3 (g + 8, 8 + 2t4..);
//   B (16 x 8, col):  b0 (k 2t4.., n g), b1 (k 8 + 2t4.., n g);
//   C (16 x 8 fp32):  c0, c1 (g, 2t4 + 0/1), c2, c3 (g + 8, 2t4 + 0/1).
// Two adjacent C tiles of one 16 x 16 block therefore form one A fragment.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D(16x8 fp32) += A(16x16 bf16, row) * B(16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 b16 matrices: the B fragments of two adjacent 8-column
// blocks of a row-major (k x n) tile, e.g. V (keys x D) in P V.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Address for ldmatrix_x4_trans: rows k0..k0+15 and columns n0..n0+15 of a
// row-major shared tile with row pitch LD.
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* trans_addr(const __nv_bfloat16* tile, int k0, int n0, int lane) {
  return tile + (k0 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + n0 + (lane / 16) * 8;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows from `rows`, columns 16 kk ..) of a row-major shared tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* rows, int kk, int g, int t4) {
  a[0] = ld32(rows + g * LD + kk * 16 + 2 * t4);
  a[1] = ld32(rows + (g + 8) * LD + kk * 16 + 2 * t4);
  a[2] = ld32(rows + g * LD + kk * 16 + 8 + 2 * t4);
  a[3] = ld32(rows + (g + 8) * LD + kk * 16 + 8 + 2 * t4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage `rows` rows of D bf16 (row stride `ss` elements) into shared memory
// with row pitch LD; rows at or past `limit` are zero-filled.
template <int D, int LD, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base, int64_t ss,
                                          int row0, int rows, int limit) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < limit;
    const __nv_bfloat16* src = ok ? base + (int64_t)(row0 + r) * ss + c * 8 : base;
    cp_async16(dst + r * LD + c * 8, src, ok ? 16 : 0);
  }
}

template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Params& p, cudaStream_t stream, int threads = 128) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace flash
