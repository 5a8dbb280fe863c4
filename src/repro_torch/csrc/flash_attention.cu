// Cache-free flash attention, forward and backward (Hopper, sm_90a): the
// attention of every layer of the training forward (LM.backbone) and of
// its backward.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (the
// Pallas kernel _flash_kernel, forward only, no lse). The backward is the
// counterpart of the hand-written VJP the reference trains through,
// src/repro/kernels/flash_xla.py:_bwd_rule. Plain versions:
// repro_torch.kernels.ref.flash_attention_ref / flash_attention_bwd_ref.
//
// What it computes: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), read by stride
// in that layout (last dimension contiguous); query head h reads kv head
// h / G (G = Hq / Hkv). Scores s = (q . k) / sqrt(D) in f32; causal masks
// are top-left aligned (key kpos visible to query qpos when kpos <= qpos,
// both from 0, as the Pallas kernel's qpos >= kpos); keys >= Skv do not
// exist. out = softmax(s) v with an f32 accumulator, cast to the input
// type; lse (B, Hq, Sq) f32. A row that sees no key gives out 0 and lse
// NEG_INF (the reference's l == 0 -> 1).
// Backward, from (q, k, v, out, lse, dout): p = exp(s - lse),
// delta = rowsum(dout * out), dS = p (dP - delta) / sqrt(D) with
// dP = dout v^T; dq = dS k, dk = dS^T q, dv = p^T dout.
//
// Launches: forward, one block per (q tile of 64 rows, q head, batch)
// looping over the 64-key tiles at or below the diagonal. Backward, three
// launches and no atomics, so the gradients are deterministic:
//   (1) delta, one warp per (batch, row, q head);
//   (2) dK/dV, one block per (k tile, kv head, batch), looping over the G
//       query heads of the group and the q tiles at or below the diagonal;
//       dK and dV are written once, already summed over the group;
//   (3) dQ, one block per (q tile, q head, batch), looping over k tiles.
//
// What bounds it on the H100: operations. At the training shapes (S 1024,
// D 128) a forward does ~2 S^2 D flops per head against ~4 S D bytes per
// head: ~1000 flops per byte, above the ridge (~295 at bf16). This first
// version runs the products on the CUDA cores in f32 (the 67 TFLOP/s
// path, not the tensor cores), so it stays far from the bf16 bound. What
// the design does: every tile is staged once in shared memory (rows padded
// to D+1 floats against bank conflicts) and each thread keeps a 4 x 4
// score tile and a 4 x D/16 output tile in registers, so a shared-memory
// read feeds 2 to 4 FMAs. No tensor cores, TMA or load/compute overlap
// yet: that is later work.
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int NT = 256;        // threads per block: a 16 x 16 grid
constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int PP = BK + 1;     // padded row of a (BQ, BK) score tile

struct Strides {  // element strides of a (B, S, H, D) tensor, d stride 1
  int64_t b, s, h;
};

__device__ __forceinline__ int64_t at(const Strides& st, int b, int s, int h) {
  return (int64_t)b * st.b + (int64_t)s * st.s + (int64_t)h * st.h;
}

// rows [r0, r0+64) of head h of x into a (64, D+1) f32 tile, 0 past n
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ x,
                                          const Strides& st, int b, int h,
                                          int r0, int n) {
  constexpr int DP = D + 1;
  for (int t = threadIdx.x; t < 64 * D; t += NT) {
    const int r = t / D, d = t - r * D;
    dst[r * DP + d] = r0 + r < n ? to_f(x[at(st, b, r0 + r, h) + d]) : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] = sum_d a[(ty+16i)][d] * b[(tx+16j)][d] over (64, D+1) tiles
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Skv,
                                        int causal) {
  return qpos < Sq && kpos < Skv && (!causal || kpos <= qpos);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int Hq,
    int Hkv, Strides sq, Strides sk, Strides sv, Strides so, int causal,
    float scale) {
  constexpr int DP = D + 1, NC = D / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  extern __shared__ float smem[];
  float* Qs = smem;            // (BQ, D+1)
  float* Ks = Qs + BQ * DP;    // (BK, D+1)
  float* Vs = Ks + BK * DP;    // (BK, D+1)
  float* Ps = Vs + BK * DP;    // (BQ, BK+1)

  load_tile<T, D>(Qs, q, sq, b, h, q0, Sq);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
    load_tile<T, D>(Ks, k, sk, b, hk, k0, Skv);
    load_tile<T, D>(Vs, v, sv, b, hk, k0, Skv);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = visible(qpos, kpos, Sq, Skv, causal) ? s[i][j] * scale
                                                       : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);  // the row lives on the 16 lanes of one ty
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
          sum += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      sum = half_warp_sum(sum);
      m[i] = m_new;
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* o = out + at(so, b, qpos, h);
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = from_f<T>(acc[i][c] * inv);
    if (tx == 0)
      lse[((int64_t)b * Hq + h) * Sq + qpos] =
          l[i] > 0.f ? m[i] + logf(l[i]) : NEG_INF;
  }
}

// delta[b, h, s] = sum_d dout[b, s, h, d] * out[b, s, h, d], one warp a row
template <typename T>
__global__ void __launch_bounds__(NT) flash_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout,
    float* __restrict__ delta, int B, int Sq, int Hq, int D, Strides so,
    Strides sd) {
  const int64_t row = (int64_t)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (int64_t)B * Sq * Hq) return;
  const int h = row % Hq, s = (row / Hq) % Sq, b = row / ((int64_t)Hq * Sq);
  const T* o = out + at(so, b, s, h);
  const T* g = dout + at(sd, b, s, h);
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f(o[d]) * to_f(g[d]);
  acc = warp_sum(acc);
  if (lane == 0) delta[((int64_t)b * Hq + h) * Sq + s] = acc;
}

// p and dS of one (q tile, k tile) pair from staged Q, dO, K, V tiles:
// rows ty+16i, keys tx+16j
template <int D>
__device__ __forceinline__ void probs_and_dscores(
    float (&p)[4][4], float (&ds)[4][4], const float* Qs, const float* dOs,
    const float* Ks, const float* Vs, const float* lse_s, const float* dl_s,
    int q0, int k0, int Sq, int Skv, int causal, float scale, int ty, int tx) {
  float dp[4][4];
  tile_dot<D>(p, Qs, Ks, ty, tx);
  tile_dot<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      p[i][j] = visible(q0 + r, kpos, Sq, Skv, causal)
                    ? expf(p[i][j] * scale - lse_s[r])
                    : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - dl_s[r]) * scale;
    }
  }
}

// the per-row lse and delta of q tile [q0, q0+64) of head h (0 past Sq)
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int b, int h, int Hq, int q0,
                                          int Sq) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int64_t i = ((int64_t)b * Hq + h) * Sq + q0 + r;
    lse_s[r] = q0 + r < Sq ? lse[i] : 0.f;
    dl_s[r] = q0 + r < Sq ? delta[i] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Skv, int Hq, int Hkv, Strides sq, Strides sk, Strides sv,
    Strides sd, Strides sdk, int causal, float scale) {
  constexpr int DP = D + 1, NC = D / 16;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  extern __shared__ float smem[];
  float* Ks = smem;             // (BK, D+1)
  float* Vs = Ks + BK * DP;     // (BK, D+1)
  float* Qs = Vs + BK * DP;     // (BQ, D+1)
  float* dOs = Qs + BQ * DP;    // (BQ, D+1)
  float* Ps = dOs + BQ * DP;    // (BQ, BK+1)
  float* dSs = Ps + BQ * PP;    // (BQ, BK+1)
  float* lse_s = dSs + BQ * PP; // (BQ,)
  float* dl_s = lse_s + BQ;     // (BQ,)

  load_tile<T, D>(Ks, k, sk, b, hk, k0, Skv);
  load_tile<T, D>(Vs, v, sv, b, hk, k0, Skv);
  // this thread's dK/dV: keys ty+16a, dims tx+16c
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  // rows below k0 see none of this tile's keys
  const int qstart = causal ? (k0 / BQ) * BQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = qstart; q0 < Sq; q0 += BQ) {
      __syncthreads();  // the previous q tile is consumed
      load_tile<T, D>(Qs, q, sq, b, h, q0, Sq);
      load_tile<T, D>(dOs, dout, sd, b, h, q0, Sq);
      load_rows(lse_s, dl_s, lse, delta, b, h, Hq, q0, Sq);
      __syncthreads();
      float p[4][4], ds[4][4];
      probs_and_dscores<D>(p, ds, Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, Sq,
                           Skv, causal, scale, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty + 16 * i) * PP + tx + 16 * j] = p[i][j];
          dSs[(ty + 16 * i) * PP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pa[4], sa[4], oc[NC], qc[NC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = Ps[r * PP + ty + 16 * a];
          sa[a] = dSs[r * PP + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          oc[c] = dOs[r * DP + tx + 16 * c];
          qc[c] = Qs[r * DP + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[a][c] = fmaf(pa[a], oc[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(sa[a], qc[c], dk_acc[a][c]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kpos = k0 + ty + 16 * a;
    if (kpos >= Skv) continue;
    T* dkr = dk + at(sdk, b, kpos, hk);
    T* dvr = dv + at(sdk, b, kpos, hk);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkr[tx + 16 * c] = from_f<T>(dk_acc[a][c]);
      dvr[tx + 16 * c] = from_f<T>(dv_acc[a][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv,
    int Hq, int Hkv, Strides sq, Strides sk, Strides sv, Strides sd,
    Strides sdq, int causal, float scale) {
  constexpr int DP = D + 1, NC = D / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  extern __shared__ float smem[];
  float* Qs = smem;             // (BQ, D+1)
  float* dOs = Qs + BQ * DP;    // (BQ, D+1)
  float* Ks = dOs + BQ * DP;    // (BK, D+1)
  float* Vs = Ks + BK * DP;     // (BK, D+1)
  float* dSs = Vs + BK * DP;    // (BQ, BK+1)
  float* lse_s = dSs + BQ * PP; // (BQ,)
  float* dl_s = lse_s + BQ;     // (BQ,)

  load_tile<T, D>(Qs, q, sq, b, h, q0, Sq);
  load_tile<T, D>(dOs, dout, sd, b, h, q0, Sq);
  load_rows(lse_s, dl_s, lse, delta, b, h, Hq, q0, Sq);
  // this thread's dQ: rows ty+16i, dims tx+16c
  float dq_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;

  const int kend = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous k tile is consumed
    load_tile<T, D>(Ks, k, sk, b, hk, k0, Skv);
    load_tile<T, D>(Vs, v, sv, b, hk, k0, Skv);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs_and_dscores<D>(p, ds, Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, Sq, Skv,
                         causal, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty + 16 * i) * PP + tx + 16 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float si[4], kc[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) si[i] = dSs[(ty + 16 * i) * PP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kc[c] = Ks[j * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          dq_acc[i][c] = fmaf(si[i], kc[c], dq_acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    T* r = dq + at(sdq, b, qpos, h);
#pragma unroll
    for (int c = 0; c < NC; ++c) r[tx + 16 * c] = from_f<T>(dq_acc[i][c]);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse,
        int B, int Sq, int Skv, int Hq, int Hkv, Strides sq, Strides sk,
        Strides sv, Strides so, int causal, float scale, cudaStream_t st) {
  constexpr int DP = D + 1;
  const size_t smem = sizeof(float) * (BQ * DP + 2 * BK * DP + BQ * PP);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((Sq + BQ - 1) / BQ, Hq, B), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Skv, Hq, Hkv,
      sq, sk, sv, so, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const void* out,
        const void* dout, const float* lse, float* delta, void* dq, void* dk,
        void* dv, int B, int Sq, int Skv, int Hq, int Hkv, Strides sq,
        Strides sk, Strides sv, Strides so, Strides sd, Strides sdq,
        Strides sdk, int causal, float scale, cudaStream_t st) {
  constexpr int DP = D + 1;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const int64_t rows = (int64_t)B * Sq * Hq;
  flash_delta_kernel<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT,
                          0, st>>>(static_cast<const T*>(out), do_, delta, B,
                                   Sq, Hq, D, so, sd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_kv = sizeof(float) * (2 * BK * DP + 2 * BQ * DP +
                                          2 * BQ * PP + 2 * BQ);
  auto kv_kernel = flash_bwd_dkdv_kernel<T, D>;
  if ((e = set_smem(kv_kernel, smem_kv)) != cudaSuccess) return (int)e;
  kv_kernel<<<dim3((Skv + BK - 1) / BK, Hkv, B), NT, smem_kv, st>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Skv, Hq, Hkv, sq, sk, sv, sd, sdk, causal, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t smem_q = sizeof(float) * (2 * BQ * DP + 2 * BK * DP +
                                         BQ * PP + 2 * BQ);
  auto q_kernel = flash_bwd_dq_kernel<T, D>;
  if ((e = set_smem(q_kernel, smem_q)) != cudaSuccess) return (int)e;
  q_kernel<<<dim3((Sq + BQ - 1) / BQ, Hq, B), NT, smem_q, st>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), Sq, Skv, Hq, Hkv, sq,
      sk, sv, sd, sdq, causal, scale);
  return (int)cudaGetLastError();
}

Strides strides(const int64_t* s) { return Strides{s[0], s[1], s[2]}; }

// dtype x head_dim dispatch; F is a functor templated on <T, D>
template <template <typename, int> class F, typename... Args>
int dispatch(int dtype, int D, Args... args) {
#define REPRO_FLASH_CASE(T, DD) \
  if (D == DD) return F<T, DD>::run(args...);
  if (dtype == DT_F32) {
    REPRO_FLASH_CASE(float, 16) REPRO_FLASH_CASE(float, 32)
    REPRO_FLASH_CASE(float, 64) REPRO_FLASH_CASE(float, 128)
  } else if (dtype == DT_BF16) {
    REPRO_FLASH_CASE(__nv_bfloat16, 16) REPRO_FLASH_CASE(__nv_bfloat16, 32)
    REPRO_FLASH_CASE(__nv_bfloat16, 64) REPRO_FLASH_CASE(__nv_bfloat16, 128)
  }
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
struct Fwd {
  template <typename... Args>
  static int run(Args... args) { return fwd<T, D>(args...); }
};

template <typename T, int D>
struct Bwd {
  template <typename... Args>
  static int run(Args... args) { return bwd<T, D>(args...); }
};

}  // namespace
}  // namespace repro_torch

// C entry points. Return the cudaError_t of the launches (0 = success).
// Sq >= 1 and Skv >= 1 (the wrapper checks). dtype: 0 = float32,
// 1 = bfloat16; D in {16, 32, 64, 128}. Each *_st argument points to 3
// int64 element strides (batch, row, head) of a (B, S, H, D) tensor whose
// last dimension is contiguous. lse and delta are contiguous (B, Hq, Sq)
// f32.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int B, int Sq, int Skv, int Hq, int Hkv,
                                   int D, const int64_t* q_st,
                                   const int64_t* k_st, const int64_t* v_st,
                                   const int64_t* o_st, int causal,
                                   float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (B == 0) return 0;
  return dispatch<Fwd>(dtype, D, q, k, v, out, lse, B, Sq, Skv, Hq, Hkv,
                       strides(q_st), strides(k_st), strides(v_st),
                       strides(o_st), causal, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    const int64_t* q_st, const int64_t* k_st, const int64_t* v_st,
    const int64_t* o_st, const int64_t* do_st, const int64_t* dq_st,
    const int64_t* dk_st, int causal, float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (B == 0) return 0;
  return dispatch<Bwd>(dtype, D, q, k, v, out, dout, lse, delta, dq, dk, dv,
                       B, Sq, Skv, Hq, Hkv, strides(q_st), strides(k_st),
                       strides(v_st), strides(o_st), strides(do_st),
                       strides(dq_st), strides(dk_st), causal, scale,
                       static_cast<cudaStream_t>(stream));
}
