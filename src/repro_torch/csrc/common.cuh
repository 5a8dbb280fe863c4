// Shared device helpers of the hand-written kernels: element-type
// conversions and rounding, the one "silent" comparison, warp sums, the
// last-block election of a fixed-order combine.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace repro_torch {

// dtype codes shared with the Python wrappers
constexpr int DT_F32 = 0;
constexpr int DT_BF16 = 1;
constexpr int DT_F16 = 2;

// what a kernel reports as lse for a row that attended nothing
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
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

// Whether this block is the last of n to arrive at *ticket, after its
// partial was written: the fences order the partials' writes before the
// ticket, and the last block's reads after it.
__device__ __forceinline__ bool last_to_arrive(int* ticket, int n) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == n - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// N consecutive elements of type T at p (N * sizeof(T) bytes, aligned to
// that) as floats, in one vector load
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&x)[N]) {
  const Vec<T, N> u = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = to_f(u.v[i]);
}

// The paged store with its counters, shared by every route of the paged
// kernels: window rows [c0, c1) of kv head h of one slot (kw, vw: the
// slot's (S, Hkv, D) rows; ptb: its page-table row; cnt3: its [stored,
// silent, dropped]) land at positions i0 + c. A row is counted against
// the pool content it overwrites (is_silent, tol); rows on unmapped
// pages or past the table count as dropped; negative positions (the idle
// sentinel) attempt nothing. The block's threads take 4-element pieces
// of the rows, U pieces a thread with all their loads in flight before
// any store (D a multiple of 4, rows 16-byte aligned).
template <typename T, typename PT, int U>
__device__ __forceinline__ void store_window(
    const T* __restrict__ kw, const T* __restrict__ vw,
    PT* __restrict__ pool_k, PT* __restrict__ pool_v,
    const int* __restrict__ ptb, int* cnt3, int h, int i0, int c0, int c1,
    int Hkv, int D, int ps, int M, float tol) {
  constexpr int V = 4;
  const int vpr = D / V, n = (c1 - c0) * vpr;
  int stored = 0, silent = 0, dropped = 0;
  for (int base = threadIdx.x; base < n; base += U * blockDim.x) {
    float nk[U][V], nv[U][V], ok[U][V], ov[U][V];
    int64_t off[U];
    int state[U];  // 0: nothing attempted, 1: stored, 2: dropped
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * blockDim.x;
      const int c = c0 + t / vpr, d = (t % vpr) * V, pos = i0 + c;
      const int page_i = pos / ps;
      const int page = t < n && pos >= 0 && page_i < M ? ptb[page_i] : -1;
      state[u] = t >= n || pos < 0 ? 0 : page < 0 ? 2 : 1;
      off[u] = (((int64_t)page * ps + pos % ps) * Hkv + h) * D + d;
      if (state[u] == 1) {
        const int64_t src = ((int64_t)c * Hkv + h) * D + d;
        load_f<T, V>(kw + src, nk[u]);
        load_f<T, V>(vw + src, nv[u]);
        load_f<PT, V>(pool_k + off[u], ok[u]);
        load_f<PT, V>(pool_v + off[u], ov[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dropped += state[u] == 2 ? 2 * V : 0;
      if (state[u] != 1) continue;
      Vec<PT, V> a, b;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        a.v[e] = from_f<PT>(nk[u][e]);
        b.v[e] = from_f<PT>(nv[u][e]);
        silent += is_silent(ok[u][e], to_f(a.v[e]), tol) +
                  is_silent(ov[u][e], to_f(b.v[e]), tol);
      }
      *reinterpret_cast<Vec<PT, V>*>(pool_k + off[u]) = a;
      *reinterpret_cast<Vec<PT, V>*>(pool_v + off[u]) = b;
      stored += 2 * V;
    }
  }
  stored = warp_sum(stored);
  silent = warp_sum(silent);
  dropped = warp_sum(dropped);
  if ((threadIdx.x & 31) == 0) {
    if (stored) atomicAdd(&cnt3[0], stored);
    if (silent) atomicAdd(&cnt3[1], silent);
    if (dropped) atomicAdd(&cnt3[2], dropped);
  }
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
