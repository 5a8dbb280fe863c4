// The split-history attention of the paged kernels (Hopper, sm_90a): the
// one-token decode (paged_decode.cu, B1) and paged_window.cu's short
// windows of f32 activations (B2's bf16 windows take its tensor-core
// route, which splits a short window's history the same way and shares
// the combine below).
//
// What it computes is what the paged kernels' headers state: S window
// rows per slot at positions idx + r attend the committed history
// [0, idx) through the page table (unmapped pages masked) and the
// window rows c <= r whose position is valid (store mode: >= 0 and on a
// mapped page of the table; defer mode: in [0, M*page)), window K/V read
// through the pool dtype's round trip; store mode writes and counts the
// window rows (store_window). The decode is the window of one row in
// store mode.
//
// What bounds it: latency and bytes. The work is a few query rows (G*S
// of them for a kv group: 2 at decode, at most 16 here) against
// every history row: about one flop per byte at decode, far below the
// ridge. One block per (slot, kv head) walking its history serially
// leaves most of the card idle (64 blocks at the serving shapes) and
// exposes the load latency of every chunk.
//
// What the design does about it:
// * Grid (NS*QC, Hkv, B): the history is cut into NS = ceil(M / NP)
//   splits of NP = 2 pages by page index (a slot's result depends only on
//   its own inputs, never on another slot's length; the host knows M and
//   never reads idx), and the G*S query rows into QC chunks of NQ (4 at
//   decode, else 16). At the serving shapes (M 11): 6 splits, 384
//   blocks (2 pages timed fastest of 1, 2, 4 and 8 on the H100).
// * In a block: the split's history rows stream into shared memory by
//   16-byte cp.async copies, 16 rows a chunk, 2 chunks in flight (a
//   whole split of 32 rows at once; 32 KB, so that long histories keep
//   several blocks on an SM). One warp per history row: each
//   lane holds EPL = D/32 elements of the NQ query rows and of the K/V
//   row, scores are warp-shuffle sums interleaved over the query rows,
//   and each warp keeps its own online softmax in registers; no block
//   barrier per row. The warps' partials are merged once, in warp order.
// * The window's keys (and, in store mode, the store and its counters)
//   go to one split: the one whose range holds idx (the last one when idx
//   is past the table, the first when it is negative).
// * Combine: with NS > 1, each block writes its partial (m, l, acc) to a
//   workspace; the last block of a (slot, head, query chunk) to take an
//   integer ticket merges the NS partials in split order. Fixed-order
//   f32 sums and no float atomics: out and lse are bit-identical from
//   run to run (tier-4 silent counts need recomputed rows reproduced bit
//   for bit). A split with no live rows contributes l = 0.
// Workspace, from the wrapper (torch's allocator): ticket ints, zeroed,
// and the partials' floats, split_workspace() says how many.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace repro_torch {

constexpr int SPLIT_NW = 4;           // warps per block
constexpr int SPLIT_NT = SPLIT_NW * 32;
constexpr int SPLIT_PAGES = 2;        // NP: history pages per split
constexpr int SPLIT_NQ = 16;          // query rows (window row x head) a block
constexpr int SPLIT_CR = 16;          // history rows per staged chunk
constexpr int SPLIT_NST = 2;          // staged chunks in flight

struct SplitArgs {
  const void* q;      // (B, S, Hq, D)
  const void* k_win;  // (B, S, Hkv, D)
  const void* v_win;
  void* pool_k;       // (P, ps, Hkv, D)
  void* pool_v;
  const int* pt;      // (B, M)
  const int* idx;     // (B,)
  void* out;          // (B, S, Hq, D)
  float* lse;         // (B, Hq, S)
  int* cnt;           // (B, 3), zeroed
  float* part;        // partials, NS > 1 only
  int* ticket;        // (B, Hkv, QC), zeroed
  int S, Hq, Hkv, D, ps, M, NS, QC, store;
  float scale_log2, tol;
};

// elements of a row per lane: D = 32 * EPL, or D <= 32 with one each
inline int split_epl(int D) {
  if (D % 8) return 0;
  return D <= 32 ? 1 : D == 64 ? 2 : D == 128 ? 4 : 0;
}

inline int split_count(int M) {
  return (M + SPLIT_PAGES - 1) / SPLIT_PAGES;
}

inline int split_chunks(int S, int G) {
  return (S * G + SPLIT_NQ - 1) / SPLIT_NQ;
}

// sizes[0]: ticket ints, sizes[1]: partial floats
inline void split_workspace(int B, int S, int Hq, int Hkv, int D, int M,
                            int64_t* sizes) {
  const int NS = split_count(M), QC = split_chunks(S, Hq / Hkv);
  sizes[0] = (int64_t)B * Hkv * QC;
  sizes[1] = NS > 1 ? sizes[0] * NS * SPLIT_NQ * (D + 2) : 0;
}

// query rows a block holds: 4 while they fit (decode at G <= 4), else 16
inline int split_nq(int S, int G) { return S * G <= 4 ? 4 : SPLIT_NQ; }

inline size_t split_smem(int D, int NS, size_t pool_isz) {
  const size_t staging = 2 * SPLIT_NST * SPLIT_CR * D * pool_isz;
  const size_t merge = sizeof(float) * SPLIT_NW * SPLIT_NQ * (D + 2);
  const size_t combine = sizeof(float) * (2 * NS + 2) * SPLIT_NQ;  // sm
  return staging > merge ? (staging > combine ? staging : combine)
                         : (merge > combine ? merge : combine);
}

// one key row (kf, vf: this lane's elements) for the warp's online
// softmax (log2 units) of the NQ query rows; rows i < ifirst do not see
// it. Branch-free, so the NQ shuffle reductions interleave.
template <int EPL, int NQ>
__device__ __forceinline__ void attend_key(const float (&qr)[NQ][EPL],
                                           float (&m)[NQ], float (&l)[NQ],
                                           float (&acc)[NQ][EPL],
                                           const float (&kf)[EPL],
                                           const float (&vf)[EPL], int ifirst,
                                           float scale_log2) {
  float s[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) s[i] = fmaf(qr[i][e], kf[e], s[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const float si = i >= ifirst ? s[i] * scale_log2 : -INFINITY;
    const float mn = fmaxf(m[i], si);
    const float mu = mn == -INFINITY ? 0.f : mn;  // nothing seen yet
    const float al = exp2f(m[i] - mu), p = exp2f(si - mu);
    l[i] = fmaf(l[i], al, p);
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = fmaf(acc[i][e], al, p * vf[e]);
    m[i] = mn;
  }
}

// out and lse of window row r, query head hq, from the accumulator A (n
// consecutive elements from d), the denominator L and the max mx
template <typename T, int N>
__device__ __forceinline__ void write_result(T* out, float* lse, int b,
                                             int r, int hq, int d, int S,
                                             int Hq, int D, float mx, float L,
                                             const float (&A)[N]) {
  const float inv = L > 0.f ? 1.f / L : 0.f;
  Vec<T, N> o;
#pragma unroll
  for (int e = 0; e < N; ++e) o.v[e] = from_f<T>(A[e] * inv);
  *reinterpret_cast<Vec<T, N>*>(out + (((int64_t)b * S + r) * Hq + hq) * D +
                                d) = o;
  if (d == 0)
    lse[((int64_t)b * Hq + hq) * S + r] =
        L > 0.f ? (mx + log2f(L)) * LN2 : NEG_INF;
}

// The combine of a group's NS partials, in split order, into out and lse.
// Partial s at P0 + s * (rows * (D + 2)): m (rows, log2 units), l
// (rows), acc (rows, D), unnormalised. rowmap(i, r, hq) gives query row
// i's window row r and query head hq, false for a row not computed. sm:
// (2 NS + 2) rows floats of shared memory.
template <typename T, typename RowMap>
__device__ __forceinline__ void combine_partials(
    const float* P0, int rows, int NS, int D, float* sm, T* out, float* lse,
    int b, int S, int Hq, RowMap rowmap) {
  const int64_t pstride = (int64_t)rows * (D + 2);
  float* cm = sm;               // (NS, rows) m, then the weights
  float* cl = cm + NS * rows;   // (NS, rows)
  float* cmx = cl + NS * rows;  // (rows,) max
  float* cL = cmx + rows;       // (rows,) denominator
  int r, hq;
  for (int t = threadIdx.x; t < NS * rows; t += blockDim.x) {
    const int s = t / rows, i = t - s * rows;
    if (!rowmap(i, r, hq)) continue;
    cm[t] = __ldcg(P0 + s * pstride + i);
    cl[t] = __ldcg(P0 + s * pstride + rows + i);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    if (!rowmap(i, r, hq)) continue;
    float mx = -INFINITY, L = 0.f;
    for (int s = 0; s < NS; ++s) mx = fmaxf(mx, cm[s * rows + i]);
    for (int s = 0; s < NS; ++s) {  // in split order
      const float ls = cl[s * rows + i];
      const float w = ls > 0.f ? exp2f(cm[s * rows + i] - mx) : 0.f;
      L = fmaf(ls, w, L);
      cm[s * rows + i] = w;
    }
    cmx[i] = mx;
    cL[i] = L;
  }
  __syncthreads();
  const int D4 = D / 4;
  for (int t = threadIdx.x; t < rows * D4; t += blockDim.x) {
    const int i = t / D4, d = (t - i * D4) * 4;
    if (!rowmap(i, r, hq)) continue;
    float A[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = 0; s < NS; ++s) {  // in split order
      const float w = cm[s * rows + i];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          P0 + s * pstride + 2 * rows + (int64_t)i * D + d));
      A[0] = fmaf(x.x, w, A[0]);
      A[1] = fmaf(x.y, w, A[1]);
      A[2] = fmaf(x.z, w, A[2]);
      A[3] = fmaf(x.w, w, A[3]);
    }
    write_result<T, 4>(out, lse, b, r, hq, d, S, Hq, D, cmx[i], cL[i], A);
  }
}

// NQ: query rows a block holds (4 or SPLIT_NQ; the partials' layout keeps
// SPLIT_NQ rows)
template <typename T, typename PT, int EPL, int NQ>
__device__ __forceinline__ void split_attend(const SplitArgs& a) {
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ kw = static_cast<const T*>(a.k_win);
  const T* __restrict__ vw = static_cast<const T*>(a.v_win);
  PT* __restrict__ pool_k = static_cast<PT*>(a.pool_k);
  PT* __restrict__ pool_v = static_cast<PT*>(a.pool_v);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int NS = a.NS, S = a.S, Hq = a.Hq, Hkv = a.Hkv, D = a.D;
  const int ps = a.ps, M = a.M, G = Hq / Hkv;
  const int sp = blockIdx.x % NS, qc = blockIdx.x / NS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qi0 = qc * NQ, nq = min(NQ, S * G - qi0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e0 = lane * EPL;  // this lane's first element of a row
  const bool on = e0 < D;
  const int i0 = a.idx[b];
  const int* __restrict__ ptb = a.pt + (int64_t)b * M;
  const int SR = SPLIT_PAGES * ps;
  const int ws = min(max(i0, 0) / SR, NS - 1);  // the window's split
  const int h0 = sp * SR;
  const int h1 = min(min(h0 + SR, M * ps), i0);  // history rows [h0, h1)
  const T* kwb = kw + (int64_t)b * S * Hkv * D;
  const T* vwb = vw + (int64_t)b * S * Hkv * D;

  // the query rows (i = r * G + g: head h*G+g at window row r) in flight
  float qr[NQ][EPL];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[i][e] = 0.f;
    if (i < nq && on) {
      const int f = qi0 + i, r = f / G, g = f - r * G;
      load_f<T, EPL>(q + (((int64_t)b * S + r) * Hq + h * G + g) * D + e0,
                     qr[i]);
    }
  }

  extern __shared__ __align__(128) unsigned char smem_raw[];
  PT* ks = reinterpret_cast<PT*>(smem_raw);  // SPLIT_NST x (SPLIT_CR, D)
  PT* vs = ks + SPLIT_NST * SPLIT_CR * D;

  // the split's history chunks, SPLIT_NST in flight; rows that are not
  // live (unmapped, at or past idx) are zero-filled and skipped
  constexpr int VE = 16 / sizeof(PT);  // elements per 16-byte copy
  const int VPR = D / VE;
  const int nch = (max(h1 - h0, 0) + SPLIT_CR - 1) / SPLIT_CR;
  auto stage_chunk = [&](int c) {
    PT* kd = ks + (c % SPLIT_NST) * SPLIT_CR * D;
    PT* vd = vs + (c % SPLIT_NST) * SPLIT_CR * D;
    for (int t = threadIdx.x; t < SPLIT_CR * VPR; t += SPLIT_NT) {
      const int j = t / VPR, u = t - j * VPR;
      const int p = h0 + c * SPLIT_CR + j;
      const int page = p < h1 ? ptb[p / ps] : -1;
      const int64_t off =
          page >= 0 ? (((int64_t)page * ps + p % ps) * Hkv + h) * D + u * VE
                    : 0;
      cp_async16(kd + j * D + u * VE, pool_k + off, page >= 0);
      cp_async16(vd + j * D + u * VE, pool_v + off, page >= 0);
    }
  };
#pragma unroll
  for (int c = 0; c < SPLIT_NST - 1; ++c) {
    if (c < nch) stage_chunk(c);
    cp_async_commit();
  }

  if (a.store == WIN_STORE && sp == ws && qc == 0)  // rows >= idx
    store_window<T, PT, 2>(kwb, vwb, pool_k, pool_v, ptb, a.cnt + 3 * b, h,
                           i0, 0, S, Hkv, D, ps, M, a.tol);

  float acc[NQ][EPL], m[NQ], l[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  }

  for (int c = 0; c < nch; ++c) {
    if (c + SPLIT_NST - 1 < nch) stage_chunk(c + SPLIT_NST - 1);
    cp_async_commit();
    // the chunk's live rows, one page-table read a lane
    const int pl = h0 + c * SPLIT_CR + lane;
    const unsigned live = __ballot_sync(
        0xffffffffu, lane < SPLIT_CR && pl < h1 && ptb[pl / ps] >= 0);
    cp_async_wait<SPLIT_NST - 1>();
    __syncthreads();
    const PT* kc = ks + (c % SPLIT_NST) * SPLIT_CR * D;
    const PT* vc = vs + (c % SPLIT_NST) * SPLIT_CR * D;
    for (int j = warp; j < SPLIT_CR; j += SPLIT_NW) {
      if (!((live >> j) & 1)) continue;
      float kf[EPL] = {}, vf[EPL] = {};
      if (on) {
        load_f<PT, EPL>(kc + j * D + e0, kf);
        load_f<PT, EPL>(vc + j * D + e0, vf);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kf[e] = round_to<T>(kf[e]);
          vf[e] = round_to<T>(vf[e]);
        }
      }
      attend_key<EPL, NQ>(qr, m, l, acc, kf, vf, 0, a.scale_log2);
    }
    __syncthreads();  // chunk c's stage is refilled next
  }

  if (sp == ws) {  // the window, causal: key c is seen by rows r >= c
    const int rlast = (qi0 + nq - 1) / G;
    for (int c = warp; c <= rlast; c += SPLIT_NW) {
      const int pos = i0 + c;
      bool ok = pos >= 0 && pos < M * ps;
      if (ok && a.store) ok = window_key_ok(a.store, ptb[pos / ps]);
      if (!ok) continue;
      float kf[EPL] = {}, vf[EPL] = {};
      if (on) {
        load_f<T, EPL>(kwb + ((int64_t)c * Hkv + h) * D + e0, kf);
        load_f<T, EPL>(vwb + ((int64_t)c * Hkv + h) * D + e0, vf);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kf[e] = round_to<T>(round_to<PT>(kf[e]));
          vf[e] = round_to<T>(round_to<PT>(vf[e]));
        }
      }
      attend_key<EPL, NQ>(qr, m, l, acc, kf, vf, c * G - qi0, a.scale_log2);
    }
  }

  // the warps' partials, merged in warp order: 4 elements a thread
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem_raw);  // (NW, NQ)
  float* wl = wm + SPLIT_NW * NQ;                  // (NW, NQ)
  float* wa = wl + SPLIT_NW * NQ;                  // (NW, NQ, D)
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (i >= nq) continue;
    if (lane == 0) {
      wm[warp * NQ + i] = m[i];
      wl[warp * NQ + i] = l[i];
    }
    if (on) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        wa[(warp * NQ + i) * D + e0 + e] = acc[i][e];
    }
  }
  __syncthreads();
  const int D4 = D / 4;
  const int64_t pstride = (int64_t)SPLIT_NQ * (D + 2);  // one partial
  float* P0 = NS == 1 ? nullptr
                      : a.part + (((int64_t)b * Hkv + h) * a.QC + qc) * NS *
                                     pstride;
  for (int t = threadIdx.x; t < nq * D4; t += SPLIT_NT) {
    const int i = t / D4, d = (t - i * D4) * 4;
    float mx = -INFINITY, L = 0.f, A[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < SPLIT_NW; ++w) mx = fmaxf(mx, wm[w * NQ + i]);
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < SPLIT_NW; ++w) {
        const float f = exp2f(wm[w * NQ + i] - mx);
        L = fmaf(wl[w * NQ + i], f, L);
        const float4 x =
            *reinterpret_cast<const float4*>(wa + (w * NQ + i) * D + d);
        A[0] = fmaf(x.x, f, A[0]);
        A[1] = fmaf(x.y, f, A[1]);
        A[2] = fmaf(x.z, f, A[2]);
        A[3] = fmaf(x.w, f, A[3]);
      }
    }
    if (NS == 1) {
      const int f = qi0 + i, r = f / G;
      write_result<T, 4>(out, a.lse, b, r, h * G + f - r * G, d, S, Hq, D,
                         mx, L, A);
    } else {
      float* pp = P0 + sp * pstride;
      if (d == 0) {
        pp[i] = mx;
        pp[SPLIT_NQ + i] = L;
      }
      *reinterpret_cast<float4*>(pp + 2 * SPLIT_NQ + i * D + d) =
          make_float4(A[0], A[1], A[2], A[3]);
    }
  }
  if (NS == 1) return;

  // the last block of (slot, head, query chunk) to finish combines the
  // NS partials in split order
  if (!last_to_arrive(a.ticket + ((int64_t)b * Hkv + h) * a.QC + qc, NS))
    return;
  combine_partials<T>(P0, SPLIT_NQ, NS, D, reinterpret_cast<float*>(smem_raw),
                      out, a.lse, b, S, Hq, [&](int i, int& r, int& hq) {
                        const int f = qi0 + i;
                        r = f / G;
                        hq = h * G + f - r * G;
                        return i < nq;
                      });
}

// launch of a split kernel K (a __global__ wrapper of split_attend)
template <typename PT, typename K>
int split_launch(K kernel, const SplitArgs& a, int B, cudaStream_t stream) {
  const size_t smem = split_smem(a.D, a.NS, sizeof(PT));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(a.NS * a.QC, a.Hkv, B), SPLIT_NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch
