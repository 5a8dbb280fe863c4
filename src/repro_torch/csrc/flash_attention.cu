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
// What bounds it on the H100: operations. At the training shapes (S 1024,
// D 128, causal) a forward does ~2 S^2 D flops per head against ~4 S D
// bytes per head, about 1000 flops per byte, far above the bf16 ridge
// (~295). So the products belong on the tensor cores.
//
// Two routes, chosen by dtype in dispatch():
// * bfloat16 (the training path): every product runs on the tensor cores
//   as mma.sync m16n8k16 (bf16 operands, f32 accumulators), fragments
//   loaded by ldmatrix (.trans where an operand is needed transposed: V in
//   P.V, K in dS.K, Q and dO in the dK/dV products). Tiles live in shared
//   memory as bf16, rows unpadded, the 16-byte chunks of a row XOR-swizzled
//   with the row so ldmatrix and the cp.async stores are free of bank
//   conflicts. K/V (forward, dQ) or Q/dO (dK/dV) tiles stream through a
//   2-stage ring of cp.async.cg 16-byte copies: tile j+1 loads while tile j
//   computes. ~96 KB of shared memory per block at D 128.
//   Forward (FA2 order): 4 warps x 32 rows = a resident 128-row Q tile,
//   64-key tiles taken 32 keys per softmax step; each K and V fragment
//   feeds the warp's two m16 tiles, halving the ldmatrix traffic per mma
//   (shared-memory reads, not the tensor cores, bound mma.sync on this
//   card). S = Q K^T in registers, online softmax in registers
//   (quad shuffles, exp2f with 1/sqrt(D) folded into log2 e), P turned
//   from the accumulator layout into the A-operand layout in registers,
//   rounded to bf16, and fed to P.V without a trip through shared memory.
//   Only the diagonal tile and the ragged tails are masked; q tiles are
//   issued heaviest (last) first.
//   Backward, three launches and no atomics, so dq, dk and dv are
//   deterministic: (1) delta, one warp per (batch, row, q head);
//   (2) dK/dV, one block per (k tile of 64, kv head, batch), 4 warps x 16
//   keys, looping over the G query heads and the q tiles at or below the
//   diagonal: S^T = K Q^T and dP^T = V dO^T come out in the accumulator
//   layout, so P^T and dS^T become A operands in registers for
//   dV += P^T dO and dK += dS^T Q; (3) dQ, one block per (q tile of 64,
//   q head, batch), recomputing S and dP for dQ += dS K. P and dS are
//   rounded to bf16 as operands (the TPU's one bf16 pass of the reference
//   rounded the same operands); every sum is f32. The recompute in (3)
//   costs 14 D flops per visible pair against the bound's 10 D.
// * float32: the first, CUDA-core kernels (flash_fwd_kernel, flash_bwd_*),
//   f32 products at the 67 TFLOP/s rate. TF32 tensor cores keep ~3 digits,
//   which the f32 tolerances (1e-4 / 2e-4) and the f32 card-against-CPU
//   checks do not allow. Tiles staged as f32 in shared memory (rows padded
//   to D+1), each thread a 4 x 4 score tile; launches as the bf16 route
//   but with 64-row q tiles.
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

// ----------------------------------------------------------------------
// bfloat16: the tensor-core kernels
// ----------------------------------------------------------------------
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

// rows [r0, r0+R) of head h of x (0 past n) into a swizzled (R, D) tile,
// as cp.async copies of 16 bytes spread over NTH threads
template <int D, int R, int NTH>
__device__ __forceinline__ void load_async(bf16* dst,
                                           const bf16* __restrict__ x,
                                           const Strides& st, int b, int h,
                                           int r0, int n) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < R * CPR; i += NTH) {
    const int r = i / CPR, c = i - r * CPR;
    const bool ok = r0 + r < n;
    cp_async16(dst + swz<D>(r, c), ok ? x + at(st, b, r0 + r, h) + c * 8 : x,
               ok);
  }
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

// rows g, g+8 of a warp's 16-row C tile (g = lane / 4), each a bf16 pair
// per 8 columns, written to the row-strided output of head h
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ y,
                                           const Strides& st,
                                           const float (&acc)[D / 8][4],
                                           int b, int h, int r0, int n,
                                           float s0, float s1, int lane) {
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (lane >> 2) + 8 * r;
    if (row >= n) continue;
    const float s = r ? s1 : s0;
    bf16* p = y + at(st, b, row, h) + c2;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(p + 8 * nb) =
          pack_bf16(acc[nb][2 * r] * s, acc[nb][2 * r + 1] * s);
  }
}

constexpr int FW = 4;    // forward: warps per block
constexpr int FM = 2;    // forward: m16 tiles per warp (32 rows)
constexpr int FQ = FW * FM * 16;  // forward: query rows per block (128)
constexpr int FS = 32;   // forward: keys per online-softmax step
constexpr int TK = 64;   // keys per K/V tile (forward and dQ)
constexpr int TQ = 64;   // backward: q rows per Q/dO tile and per dQ block
constexpr int TW = 4;    // backward: warps per block (4 x 16 keys or rows)

// Each warp owns 32 rows (two m16 tiles), so every K and V fragment read
// from shared memory feeds two mma: ldmatrix traffic, not the tensor
// cores, is what bounds mma.sync on this card. Scores are taken 32 keys
// at a time to leave registers for the 32 x D accumulator.
template <int D>
__global__ void __launch_bounds__(FW * 32) flash_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, Strides sq,
    Strides sk, Strides sv, Strides so, int causal, float scale_log2) {
  // heaviest first: blockIdx.z runs over the q tiles from the last
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FQ;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qw = q0 + 16 * FM * warp;  // the warp's first row
  const int g = lane >> 2, c2 = 2 * (lane & 3);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // (FQ, D)
  bf16* Ks = Qs + FQ * D;                        // 2 x (TK, D)
  bf16* Vs = Ks + 2 * TK * D;                    // 2 x (TK, D)

  const int kend = causal ? min(Skv, q0 + FQ) : Skv;
  const int nk = (kend + TK - 1) / TK;
  load_async<D, FQ, FW * 32>(Qs, q, sq, b, h, q0, Sq);
  load_async<D, TK, FW * 32>(Ks, k, sk, b, hk, 0, Skv);
  load_async<D, TK, FW * 32>(Vs, v, sv, b, hk, 0, Skv);
  cp_async_commit();

  // per m16 tile: row g in e 0-1 / r 0, row g+8 in e 2-3 / r 1
  float o[FM][D / 8][4], m[FM][2], l[FM][2];
#pragma unroll
  for (int mt = 0; mt < FM; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  }

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * TK, st = j & 1;
    if (j + 1 < nk) {  // tile j+1 loads while tile j computes
      load_async<D, TK, FW * 32>(Ks + (st ^ 1) * TK * D, k, sk, b, hk,
                                 k0 + TK, Skv);
      load_async<D, TK, FW * 32>(Vs + (st ^ 1) * TK * D, v, sv, b, hk,
                                 k0 + TK, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * TK * D;
    const bf16* Vt = Vs + st * TK * D;
#pragma unroll 1  // unrolled, the two steps spill registers
    for (int ks = k0; ks < k0 + TK; ks += FS) {
      // past the keys, or (causal) past the warp's last row: nothing left
      if (ks >= Skv || (causal && ks > qw + 16 * FM - 1)) break;
      float s[FM][FS / 8][4];
      mma_abt<D, FS, FM>(s, Qs, qw - q0, Kt, ks - k0, lane);
      // only the diagonal steps and the ragged key tail are masked
      if (ks + FS > Skv || (causal && ks + FS - 1 > qw)) {
#pragma unroll
        for (int mt = 0; mt < FM; ++mt)
#pragma unroll
          for (int n = 0; n < FS / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = ks + 8 * n + c2 + (e & 1);
              const int qpos = qw + 16 * mt + g + 8 * (e >> 1);
              if (kpos >= Skv || (causal && kpos > qpos))
                s[mt][n][e] = -INFINITY;
            }
      }
      // online softmax in log2 units, the 1/sqrt(D) scale folded in
      uint32_t p[FM][FS / 16][4];
#pragma unroll
      for (int mt = 0; mt < FM; ++mt) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < FS / 8; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
        }
        float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[mt][r], quad_max(mx[r]) * scale_log2);
          mu[r] = mn == -INFINITY ? 0.f : mn;  // a row with no key yet
          alpha[r] = exp2f(m[mt][r] - mu[r]);
          m[mt][r] = mn;
        }
#pragma unroll
        for (int n = 0; n < FS / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][n][e] = exp2f(fmaf(s[mt][n][e], scale_log2, -mu[e >> 1]));
            sum[e >> 1] += s[mt][n][e];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * alpha[r] + sum[r];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[mt][n][0] *= alpha[0];
          o[mt][n][1] *= alpha[0];
          o[mt][n][2] *= alpha[1];
          o[mt][n][3] *= alpha[1];
        }
        c_to_a<FS>(p[mt], s[mt]);
      }
      mma_pv<D, FS, FM>(o, p, Vt, ks - k0, lane);
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }

#pragma unroll
  for (int mt = 0; mt < FM; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] = quad_sum(l[mt][r]);
      inv[r] = l[mt][r] > 0.f ? 1.f / l[mt][r] : 0.f;
      const int qpos = qw + 16 * mt + g + 8 * r;
      if ((lane & 3) == 0 && qpos < Sq)
        lse[((int64_t)b * Hq + h) * Sq + qpos] =
            l[mt][r] > 0.f ? (m[mt][r] + log2f(l[mt][r])) * LN2 : NEG_INF;
    }
    store_rows<D>(out, so, o[mt], b, h, qw + 16 * mt, Sq, inv[0], inv[1],
                  lane);
  }
}

// Q, dO (async) and lse * log2 e, delta (plain loads) of the q tile
// [q0, q0+TQ) of head h into one stage of the dK/dV kernel's ring
template <int D>
__device__ __forceinline__ void load_q_stage(
    bf16* Qs, bf16* dOs, float* Ls, float* Ds, const bf16* __restrict__ q,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const Strides& sq, const Strides& sd,
    int b, int h, int Hq, int q0, int Sq) {
  load_async<D, TQ, TW * 32>(Qs, q, sq, b, h, q0, Sq);
  load_async<D, TQ, TW * 32>(dOs, dout, sd, b, h, q0, Sq);
  for (int r = threadIdx.x; r < TQ; r += TW * 32) {
    const int64_t i = ((int64_t)b * Hq + h) * Sq + q0 + r;
    Ls[r] = q0 + r < Sq ? lse[i] * LOG2E : 0.f;
    Ds[r] = q0 + r < Sq ? delta[i] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(TW * 32) flash_bwd_dkdv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int Hq,
    int Hkv, Strides sq, Strides sk, Strides sv, Strides sd, Strides sdk,
    int causal, float scale, float scale_log2) {
  // heaviest first: blockIdx.z runs over the k tiles from the first
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * TK;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = k0 + 16 * warp;  // the warp's first key
  const int g = lane >> 2, c2 = 2 * (lane & 3);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // (TK, D)
  bf16* Vs = Ks + TK * D;                        // (TK, D)
  bf16* Qs = Vs + TK * D;                        // 2 x (TQ, D)
  bf16* dOs = Qs + 2 * TQ * D;                   // 2 x (TQ, D)
  float* Ls = reinterpret_cast<float*>(dOs + 2 * TQ * D);  // 2 x TQ
  float* Ds = Ls + 2 * TQ;                                 // 2 x TQ

  // the q tiles at or below the diagonal (rows below k0 see none of
  // these keys), for each of the G query heads: n steps in all
  const int qt0 = causal ? k0 / TQ : 0;
  const int per = max((Sq + TQ - 1) / TQ - qt0, 0);
  const int n = G * per;
  load_async<D, TK, TW * 32>(Ks, k, sk, b, hk, k0, Skv);
  load_async<D, TK, TW * 32>(Vs, v, sv, b, hk, k0, Skv);
  if (n > 0)
    load_q_stage<D>(Qs, dOs, Ls, Ds, q, dout, lse, delta, sq, sd, b,
                    hk * G, Hq, qt0 * TQ, Sq);
  cp_async_commit();

  float dk_acc[1][D / 8][4], dv_acc[1][D / 8][4];  // one m16 tile of keys
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[0][c][e] = dv_acc[0][c][e] = 0.f;

  for (int t = 0; t < n; ++t) {
    const int st = t & 1;
    const int q0 = (qt0 + t % per) * TQ;
    if (t + 1 < n) {  // the next (head, q tile) loads while this computes
      const int t1 = t + 1;
      load_q_stage<D>(Qs + (st ^ 1) * TQ * D, dOs + (st ^ 1) * TQ * D,
                      Ls + (st ^ 1) * TQ, Ds + (st ^ 1) * TQ, q, dout, lse,
                      delta, sq, sd, b, hk * G + t1 / per, Hq,
                      (qt0 + t1 % per) * TQ, Sq);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + st * TQ * D;
    const bf16* dOt = dOs + st * TQ * D;
    const float* Lt = Ls + st * TQ;
    const float* Dt = Ds + st * TQ;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int qh = q0 + 32 * half;
      if (causal && qh + 31 < kw) continue;  // these rows see none
      // S^T and dP^T (16 keys x 32 rows) land in the accumulator layout
      float sT[1][4][4], dpT[1][4][4];
      mma_abt<D, 32, 1>(sT, Ks, 16 * warp, Qt, 32 * half, lane);
      mma_abt<D, 32, 1>(dpT, Vs, 16 * warp, dOt, 32 * half, lane);
      const bool edge = qh + 32 > Sq || kw + 16 > Skv ||
                        (causal && kw + 15 > qh);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 32 * half + 8 * c + c2 + (e & 1);  // row of Qt
          float p = exp2f(fmaf(sT[0][c][e], scale_log2, -Lt[col]));
          if (edge) {
            const int qpos = q0 + col, kpos = kw + g + 8 * (e >> 1);
            if (qpos >= Sq || kpos >= Skv || (causal && kpos > qpos))
              p = 0.f;
          }
          sT[0][c][e] = p;
          dpT[0][c][e] = p * (dpT[0][c][e] - Dt[col]) * scale;
        }
      uint32_t pa[1][2][4], dsa[1][2][4];
      c_to_a<32>(pa[0], sT[0]);
      c_to_a<32>(dsa[0], dpT[0]);
      mma_pv<D, 32, 1>(dv_acc, pa, dOt, 32 * half, lane);
      mma_pv<D, 32, 1>(dk_acc, dsa, Qt, 32 * half, lane);
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }
  store_rows<D>(dk, sdk, dk_acc[0], b, hk, kw, Skv, 1.f, 1.f, lane);
  store_rows<D>(dv, sdk, dv_acc[0], b, hk, kw, Skv, 1.f, 1.f, lane);
}

template <int D>
__global__ void __launch_bounds__(TW * 32) flash_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, Strides sq,
    Strides sk, Strides sv, Strides sd, Strides sdq, int causal, float scale,
    float scale_log2) {
  // heaviest first: blockIdx.z runs over the q tiles from the last
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TQ;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qw = q0 + 16 * warp;
  const int g = lane >> 2, c2 = 2 * (lane & 3);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // (TQ, D)
  bf16* dOs = Qs + TQ * D;                       // (TQ, D)
  bf16* Ks = dOs + TQ * D;                       // 2 x (TK, D)
  bf16* Vs = Ks + 2 * TK * D;                    // 2 x (TK, D)

  const int kend = causal ? min(Skv, q0 + TQ) : Skv;
  const int nk = (kend + TK - 1) / TK;
  load_async<D, TQ, TW * 32>(Qs, q, sq, b, h, q0, Sq);
  load_async<D, TQ, TW * 32>(dOs, dout, sd, b, h, q0, Sq);
  load_async<D, TK, TW * 32>(Ks, k, sk, b, hk, 0, Skv);
  load_async<D, TK, TW * 32>(Vs, v, sv, b, hk, 0, Skv);
  cp_async_commit();
  // lse (log2 units) and delta of rows g and g+8
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw + g + 8 * r;
    const int64_t i = ((int64_t)b * Hq + h) * Sq + qpos;
    l2[r] = qpos < Sq ? lse[i] * LOG2E : 0.f;
    dl[r] = qpos < Sq ? delta[i] : 0.f;
  }

  float dq_acc[1][D / 8][4];  // one m16 tile of rows
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[0][c][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * TK, st = j & 1;
    if (j + 1 < nk) {
      load_async<D, TK, TW * 32>(Ks + (st ^ 1) * TK * D, k, sk, b, hk,
                                 k0 + TK, Skv);
      load_async<D, TK, TW * 32>(Vs + (st ^ 1) * TK * D, v, sv, b, hk,
                                 k0 + TK, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (!causal || k0 <= qw + 15) {
      const bf16* Kt = Ks + st * TK * D;
      const bf16* Vt = Vs + st * TK * D;
      float s[1][TK / 8][4], dp[1][TK / 8][4];
      mma_abt<D, TK, 1>(s, Qs, 16 * warp, Kt, 0, lane);
      mma_abt<D, TK, 1>(dp, dOs, 16 * warp, Vt, 0, lane);
      const bool edge = k0 + TK > Skv || (causal && k0 + TK - 1 > qw);
#pragma unroll
      for (int n = 0; n < TK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = exp2f(fmaf(s[0][n][e], scale_log2, -l2[r]));
          if (edge) {
            const int kpos = k0 + 8 * n + c2 + (e & 1);
            const int qpos = qw + g + 8 * r;
            if (kpos >= Skv || (causal && kpos > qpos)) p = 0.f;
          }
          dp[0][n][e] = p * (dp[0][n][e] - dl[r]) * scale;
        }
      uint32_t dsa[1][TK / 16][4];
      c_to_a<TK>(dsa[0], dp[0]);
      mma_pv<D, TK, 1>(dq_acc, dsa, Kt, 0, lane);
    }
    __syncthreads();
  }
  store_rows<D>(dq, sdq, dq_acc[0], b, h, qw, Sq, 1.f, 1.f, lane);
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

template <int D>
int fwd_tc(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Skv, int Hq, int Hkv, Strides sq,
           Strides sk, Strides sv, Strides so, int causal, float scale,
           cudaStream_t st) {
  const size_t smem = sizeof(bf16) * (FQ + 4 * TK) * D;
  auto kernel = flash_fwd_tc_kernel<D>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(Hq, B, (Sq + FQ - 1) / FQ), FW * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Sq, Skv,
      Hq, Hkv, sq, sk, sv, so, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_tc(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
           Strides sq, Strides sk, Strides sv, Strides so, Strides sd,
           Strides sdq, Strides sdk, int causal, float scale,
           cudaStream_t st) {
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const int64_t rows = (int64_t)B * Sq * Hq;
  flash_delta_kernel<bf16><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)),
                             NT, 0, st>>>(static_cast<const bf16*>(out), do_,
                                          delta, B, Sq, Hq, D, so, sd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_kv =
      sizeof(bf16) * (2 * TK + 4 * TQ) * D + sizeof(float) * 4 * TQ;
  auto kv_kernel = flash_bwd_dkdv_tc_kernel<D>;
  if ((e = set_smem(kv_kernel, smem_kv)) != cudaSuccess) return (int)e;
  kv_kernel<<<dim3(Hkv, B, (Skv + TK - 1) / TK), TW * 32, smem_kv, st>>>(
      q_, k_, v_, do_, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Skv, Hq, Hkv, sq, sk, sv, sd, sdk, causal,
      scale, scale * LOG2E);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t smem_q = sizeof(bf16) * (2 * TQ + 4 * TK) * D;
  auto q_kernel = flash_bwd_dq_tc_kernel<D>;
  if ((e = set_smem(q_kernel, smem_q)) != cudaSuccess) return (int)e;
  q_kernel<<<dim3(Hq, B, (Sq + TQ - 1) / TQ), TW * 32, smem_q, st>>>(
      q_, k_, v_, do_, lse, delta, static_cast<bf16*>(dq), Sq, Skv, Hq, Hkv,
      sq, sk, sv, sd, sdq, causal, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

Strides strides(const int64_t* s) { return Strides{s[0], s[1], s[2]}; }

// dtype x head_dim dispatch: float32 goes to the CUDA-core kernels
// (fwd / bwd), bfloat16 to the tensor-core kernels (fwd_tc / bwd_tc,
// through the specialisations of Fwd and Bwd); F is templated on <T, D>
template <template <typename, int> class F, typename... Args>
int dispatch(int dtype, int D, Args... args) {
#define REPRO_FLASH_CASE(T, DD) \
  if (D == DD) return F<T, DD>::run(args...);
  if (dtype == DT_F32) {
    REPRO_FLASH_CASE(float, 16) REPRO_FLASH_CASE(float, 32)
    REPRO_FLASH_CASE(float, 64) REPRO_FLASH_CASE(float, 128)
  } else if (dtype == DT_BF16) {
    REPRO_FLASH_CASE(bf16, 16) REPRO_FLASH_CASE(bf16, 32)
    REPRO_FLASH_CASE(bf16, 64) REPRO_FLASH_CASE(bf16, 128)
  }
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
struct Fwd {
  template <typename... Args>
  static int run(Args... args) { return fwd<T, D>(args...); }
};

template <int D>
struct Fwd<bf16, D> {
  template <typename... Args>
  static int run(Args... args) { return fwd_tc<D>(args...); }
};

template <typename T, int D>
struct Bwd {
  template <typename... Args>
  static int run(Args... args) { return bwd<T, D>(args...); }
};

template <int D>
struct Bwd<bf16, D> {
  template <typename... Args>
  static int run(Args... args) { return bwd_tc<D>(args...); }
};

}  // namespace
}  // namespace repro_torch

// C entry points. Return the cudaError_t of the launches (0 = success).
// Sq >= 1 and Skv >= 1 (the wrapper checks). dtype: 0 = float32,
// 1 = bfloat16; D in {16, 32, 64, 128}. Each *_st argument points to 3
// int64 element strides (batch, row, head) of a (B, S, H, D) tensor whose
// last dimension is contiguous; for bfloat16, q, k, v and dout are read
// by 16-byte cp.async copies, so their base pointers and strides must be
// 16-byte aligned (the wrapper copies what is not). lse and delta are
// contiguous (B, Hq, Sq) f32.
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
