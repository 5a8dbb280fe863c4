// Shared device helpers of the paged serving kernels: element-type
// conversions and rounding, the one "silent" comparison, warp sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {

// dtype codes shared with the Python wrappers
constexpr int DT_F32 = 0;
constexpr int DT_BF16 = 1;

// what a kernel reports as lse for a row that attended nothing
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// x rounded through type T and read back as float
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// core.events.silent_mask: |a-b| <= tol*max(|a|,|b|), NaN never silent,
// tol == 0 is exact equality
__device__ __forceinline__ int is_silent(float a, float b, float tol) {
  if (isnan(a) || isnan(b)) return 0;
  if (tol == 0.f) return a == b;
  return fabsf(a - b) <= tol * fmaxf(fabsf(a), fabsf(b));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One online-softmax step for n queries over a chunk of keys: p holds
// the chunk's scaled scores (-inf = masked), row stride ld. Turns them
// into probabilities against the running max, updates the running max
// m and denominator l, and leaves each query's rescale factor in alpha.
__device__ __forceinline__ void softmax_step(float* p, int ld, int nkeys,
                                             float* m, float* l,
                                             float* alpha, int nq) {
  for (int i = threadIdx.x; i < nq; i += blockDim.x) {
    float* row = p + i * ld;
    float mx = -INFINITY;
    for (int j = 0; j < nkeys; ++j) mx = fmaxf(mx, row[j]);
    const float m_new = fmaxf(m[i], mx);
    float a = 1.f, sum = 0.f;
    if (m_new == -INFINITY) {
      for (int j = 0; j < nkeys; ++j) row[j] = 0.f;
    } else {
      a = expf(m[i] - m_new);
      for (int j = 0; j < nkeys; ++j) {
        const float e = row[j] == -INFINITY ? 0.f : expf(row[j] - m_new);
        row[j] = e;
        sum += e;
      }
    }
    m[i] = m_new;
    l[i] = l[i] * a + sum;
    alpha[i] = a;
  }
}

// acc[i][d] = acc[i][d] * alpha[i] + sum_j p[i][j] * v[j][d]
__device__ __forceinline__ void accumulate(float* acc, const float* p,
                                           int ldp, const float* v,
                                           int nkeys, const float* alpha,
                                           int nq, int D) {
  for (int t = threadIdx.x; t < nq * D; t += blockDim.x) {
    const int i = t / D, d = t - i * D;
    float a = acc[t] * alpha[i];
    const float* pi = p + i * ldp;
    for (int j = 0; j < nkeys; ++j) a += pi[j] * v[j * D + d];
    acc[t] = a;
  }
}

}  // namespace repro_torch
