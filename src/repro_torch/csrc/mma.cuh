// Tensor-core building blocks shared by the bf16 kernels (Hopper, sm_90a):
// swizzled bf16 tiles in shared memory, cp.async copies (with an L2
// eviction policy for data read once), ldmatrix fragments and mma.sync
// m16n8k16 (bf16 operands, f32 accumulators).
// Used by flash_attention.cu (B4) and paged_window.cu (B2's long-window
// route); paged_split.cuh takes its cp.async copies.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace repro_torch {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// element offset of 16-byte chunk c of row r in a (rows, D) bf16 tile:
// the chunk index XORed with the row, so the 8 rows an ldmatrix phase (or
// 8 consecutive cp.async chunks) touch land in 8 distinct bank groups
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CPR = D / 8;  // chunks per row
  int f;  // CPR < 8: rows of (8 / CPR) share a bank line, XOR by line
  if constexpr (CPR >= 8)
    f = r & 7;
  else
    f = (r / (8 / CPR)) & (CPR - 1);
  return (r * CPR + (c ^ f)) * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// The L2 cache policy of lines a kernel reads once: evicted first
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// cp_async16 under an L2 cache policy (l2_evict_first)
__device__ __forceinline__ void cp_async16_hint(void* dst, const void* src,
                                                bool valid, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(valid ? 16 : 0), "l"(policy));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[mt] (16 x N) = A[a0+16mt : a0+16mt+16] . B[b0 : b0+N]^T over the D
// columns of two swizzled (rows, D) tiles, for MT m16 tiles that share
// each B fragment; acc[mt][n / 8] is the C fragment of columns [8n, 8n+8):
// rows lane/4 (c0, c1) and lane/4 + 8 (c2, c3), columns 2 (lane % 4) +
// {0, 1}
template <int D, int N, int MT>
__device__ __forceinline__ void mma_abt(float (&acc)[MT][N / 8][4],
                                        const bf16* A, int a0, const bf16* B,
                                        int b0, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt],
              A + swz<D>(a0 + 16 * mt + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int nb = 0; nb < N / 16; ++nb) {
      uint32_t b[4];
      ldsm_x4(b, B + swz<D>(b0 + 16 * nb + (lane & 7) + ((lane >> 4) << 3),
                            2 * kk + ((lane >> 3) & 1)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(acc[mt][2 * nb], a[mt], b[0], b[1]);
        mma16816(acc[mt][2 * nb + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// acc[mt] (16 x D) += P[mt] (16 x KD, A fragments) . V[v0 : v0+KD] of a
// swizzled (rows, D) tile, V read transposed by ldmatrix.trans, each B
// fragment shared by the MT m16 tiles
template <int D, int KD, int MT>
__device__ __forceinline__ void mma_pv(float (&acc)[MT][D / 8][4],
                                       const uint32_t (&p)[MT][KD / 16][4],
                                       const bf16* V, int v0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < D / 16; ++nb) {
      uint32_t b[4];
      ldsm_x4_t(b, V + swz<D>(v0 + 16 * kk + (lane & 7) +
                                  (((lane >> 3) & 1) << 3),
                              2 * nb + (lane >> 4)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(acc[mt][2 * nb], p[mt][kk], b[0], b[1]);
        mma16816(acc[mt][2 * nb + 1], p[mt][kk], b[2], b[3]);
      }
    }
}

// a (16 x KD) C-fragment tile, rounded to bf16, as KD/16 A fragments
template <int KD>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[KD / 16][4],
                                       const float (&c)[KD / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace repro_torch
