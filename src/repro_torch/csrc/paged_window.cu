// Paged window attention with a paged-write epilogue and store-site waste
// counters (Hopper, sm_90a): the admission prefill of the paged serving
// path, and the speculative verify window (store or defer).
//
// Replaces: src/repro/kernels/flash_prefill.py:paged_window_attention
// (the Pallas kernel _window_kernel). Plain version:
// repro_torch.kernels.ref.paged_window_ref.
//
// What it computes: an S-token window per slot b at offset idx[b]. Window
// row r (position idx+r) attends the committed history [0, idx) through
// the page table (unmapped pages masked) and window rows c <= r whose
// position is valid: in store mode, >= 0 and on a mapped page of the
// table; in defer mode, in [0, M*page). Window K/V are read rounded
// through the pool dtype, as the pool would hold them. Store mode also
// writes every landing window row into its page and counts
// [stored, silent, dropped] elements against the pool content before the
// store; rows on unmapped pages or past the table count as dropped,
// negative positions (idle sentinel) attempt nothing. Defer mode leaves
// the pool and the counters alone. A row that attends nothing (idle
// slot) comes back 0 with lse NEG_INF.
//
// Two launches, independent of each other: history positions are < idx,
// stores land at >= idx, and the copy-on-write invariant of
// serve/kv_cache.py keeps any page being extended exclusive to one slot.
//   (1) store-and-count, one block per (kv head, slot), store mode only;
//   (2) attention, one block per (kv head, slot, tile of BQ window rows),
//       all G = Hq/Hkv query heads of the group in the block.
//
// What bounds it on the H100: bytes. At the prefill shapes (S = 128,
// G = 2, D = 128, f32 pool) a call moves q, the window K/V, the output
// and, for every landing row, the old pool row (for the counters) and
// the new one: about 20 flops per byte, far below the card's ridge of
// ~295 flop/byte at bf16. With long committed histories the history
// reads add bytes at the same low intensity.
//
// What the design does about it, in this first version: every input
// byte is read once per block (the store kernel reads and writes each
// landing row once; the attention block reads each K/V chunk once for
// all its BQ rows and G heads), and the counters ride the store instead
// of a second pass. The arithmetic runs on the CUDA cores in f32 from
// shared-memory tiles (query tile and key chunk rows padded to D+1
// floats against bank conflicts). Simple first: no TMA, no wgmma, no
// overlap of loads and compute; those are later work.
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int NT = 128;  // threads per block
constexpr int CH = 16;   // key rows per shared-memory chunk

template <typename T, typename PT>
__global__ void __launch_bounds__(NT) window_store_kernel(
    const T* __restrict__ k_win,   // (B, S, Hkv, D)
    const T* __restrict__ v_win,   // (B, S, Hkv, D)
    PT* __restrict__ pool_k,       // (P, ps, Hkv, D)
    PT* __restrict__ pool_v,
    const int* __restrict__ pt,    // (B, M)
    const int* __restrict__ idx,   // (B,)
    int* __restrict__ cnt,         // (B, 3), zeroed by the caller
    int S, int Hkv, int D, int ps, int M, float tol) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  const int64_t i0 = idx[b];
  int stored = 0, silent = 0, dropped = 0;
  for (int s = warp; s < S; s += nwarp) {  // one warp per window row
    const int64_t pos = i0 + s;
    if (pos < 0) continue;  // idle sentinel: no store attempted
    const int64_t page_i = pos / ps;
    const int page = page_i < M ? pt[(int64_t)b * M + page_i] : -1;
    if (page < 0) {
      if (lane == 0) dropped += 2 * D;
      continue;
    }
    const int64_t off = (((int64_t)page * ps + pos % ps) * Hkv + h) * D;
    const int64_t src = (((int64_t)b * S + s) * Hkv + h) * D;
    for (int d = lane; d < D; d += 32) {
      const PT nk = from_f<PT>(to_f(k_win[src + d]));
      const PT nv = from_f<PT>(to_f(v_win[src + d]));
      silent += is_silent(to_f(pool_k[off + d]), to_f(nk), tol);
      silent += is_silent(to_f(pool_v[off + d]), to_f(nv), tol);
      pool_k[off + d] = nk;
      pool_v[off + d] = nv;
    }
    if (lane == 0) stored += 2 * D;
  }
  silent = warp_sum(silent);
  if (lane == 0) {
    if (stored) atomicAdd(&cnt[b * 3 + 0], stored);
    if (silent) atomicAdd(&cnt[b * 3 + 1], silent);
    if (dropped) atomicAdd(&cnt[b * 3 + 2], dropped);
  }
}

// One chunk of keys for the block's NQ = G*BQ queries: scores from the
// staged chunk, masked by key validity (kpos < 0 = invalid) and, for
// window keys, causality; then the online-softmax step and the P.V
// accumulation.
__device__ __forceinline__ void attend_chunk(
    const float* q_s, float* acc_s, const float* k_s, const float* v_s,
    float* p_s, float* m_s, float* l_s, float* a_s, const int* kpos_s, int n,
    bool causal, int r0, int BQ, int NQ, int S, int D, float scale) {
  const int DP = D + 1;
  for (int t = threadIdx.x; t < NQ * n; t += blockDim.x) {
    const int qi = t / n, j = t - qi * n;
    const int r = r0 + qi % BQ;  // window row of this query
    const int kp = kpos_s[j];
    float s = -INFINITY;
    if (r < S && kp >= 0 && (!causal || kp <= r)) {
      float acc = 0.f;
      const float* qr = q_s + qi * DP;
      const float* kr = k_s + j * DP;
      for (int d = 0; d < D; ++d) acc += qr[d] * kr[d];
      s = acc * scale;
    }
    p_s[qi * CH + j] = s;
  }
  __syncthreads();
  softmax_step(p_s, CH, n, m_s, l_s, a_s, NQ);
  __syncthreads();
  accumulate(acc_s, p_s, CH, v_s, n, a_s, NQ, D);
  __syncthreads();
}

template <typename T, typename PT>
__global__ void __launch_bounds__(NT) window_attn_kernel(
    const T* __restrict__ q,        // (B, S, Hq, D)
    const T* __restrict__ k_win,    // (B, S, Hkv, D)
    const T* __restrict__ v_win,
    const PT* __restrict__ pool_k,  // (P, ps, Hkv, D)
    const PT* __restrict__ pool_v,
    const int* __restrict__ pt,     // (B, M)
    const int* __restrict__ idx,    // (B,)
    T* __restrict__ out,            // (B, S, Hq, D)
    float* __restrict__ lse,        // (B, Hq, S)
    int S, int Hq, int Hkv, int D, int ps, int M, int BQ, int store,
    float scale) {
  const int h = blockIdx.x, b = blockIdx.y, r0 = blockIdx.z * BQ;
  const int G = Hq / Hkv, NQ = G * BQ, DP = D + 1;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;                 // (NQ, D+1) query tile
  float* acc_s = q_s + NQ * DP;      // (NQ, D)
  float* k_s = acc_s + NQ * D;       // (CH, D+1)
  float* v_s = k_s + CH * DP;        // (CH, D)
  float* p_s = v_s + CH * D;         // (NQ, CH)
  float* m_s = p_s + NQ * CH;        // (NQ,)
  float* l_s = m_s + NQ;             // (NQ,)
  float* a_s = l_s + NQ;             // (NQ,)
  int* kpos_s = reinterpret_cast<int*>(a_s + NQ);  // (CH,)

  const int64_t i0 = idx[b];
  // query qi = g*BQ + rr is head h*G+g at window row r0+rr
  for (int t = tid; t < NQ * D; t += blockDim.x) {
    const int qi = t / D, d = t - qi * D;
    const int g = qi / BQ, r = r0 + qi % BQ;
    q_s[qi * DP + d] =
        r < S ? to_f(q[(((int64_t)b * S + r) * Hq + h * G + g) * D + d]) : 0.f;
    acc_s[t] = 0.f;
  }
  for (int i = tid; i < NQ; i += blockDim.x) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  __syncthreads();

  // committed history [0, idx) from the pool
  for (int m = 0; m < M && (int64_t)m * ps < i0; ++m) {
    const int page = pt[(int64_t)b * M + m];
    if (page < 0) continue;  // unmapped: masked (block-uniform)
    for (int c0 = 0; c0 < ps && (int64_t)m * ps + c0 < i0; c0 += CH) {
      const int n = min(CH, ps - c0);
      for (int t = tid; t < n * D; t += blockDim.x) {
        const int j = t / D, d = t - j * D;
        const int64_t off = (((int64_t)page * ps + c0 + j) * Hkv + h) * D + d;
        k_s[j * DP + d] = round_to<T>(to_f(pool_k[off]));
        v_s[j * D + d] = round_to<T>(to_f(pool_v[off]));
      }
      for (int j = tid; j < n; j += blockDim.x) {
        const int64_t p = (int64_t)m * ps + c0 + j;
        kpos_s[j] = p < i0 ? 0 : -1;  // history keys precede every row
      }
      __syncthreads();
      attend_chunk(q_s, acc_s, k_s, v_s, p_s, m_s, l_s, a_s, kpos_s, n, false, r0,
                   BQ, NQ, S, D, scale);
    }
  }

  // the window itself, causal, rows valid where the pool would hold them
  const int r_last = min(r0 + BQ, S) - 1;
  for (int c0 = 0; c0 <= r_last; c0 += CH) {
    const int n = min(CH, S - c0);
    for (int t = tid; t < n * D; t += blockDim.x) {
      const int j = t / D, d = t - j * D;
      const int64_t src = (((int64_t)b * S + c0 + j) * Hkv + h) * D + d;
      k_s[j * DP + d] = round_to<T>(round_to<PT>(to_f(k_win[src])));
      v_s[j * D + d] = round_to<T>(round_to<PT>(to_f(v_win[src])));
    }
    for (int j = tid; j < n; j += blockDim.x) {
      const int c = c0 + j;
      const int64_t pos = i0 + c;
      bool ok = pos >= 0 && pos < (int64_t)M * ps;
      if (ok && store) ok = pt[(int64_t)b * M + pos / ps] >= 0;
      kpos_s[j] = ok ? c : -1;
    }
    __syncthreads();
    attend_chunk(q_s, acc_s, k_s, v_s, p_s, m_s, l_s, a_s, kpos_s, n, true, r0, BQ,
                 NQ, S, D, scale);
  }

  for (int t = tid; t < NQ * D; t += blockDim.x) {
    const int qi = t / D, d = t - qi * D;
    const int g = qi / BQ, r = r0 + qi % BQ;
    if (r >= S) continue;
    const float l = l_s[qi];
    out[(((int64_t)b * S + r) * Hq + h * G + g) * D + d] =
        from_f<T>(l > 0.f ? acc_s[t] / l : 0.f);
  }
  for (int qi = tid; qi < NQ; qi += blockDim.x) {
    const int g = qi / BQ, r = r0 + qi % BQ;
    if (r >= S) continue;
    const float l = l_s[qi];
    lse[((int64_t)b * Hq + h * G + g) * S + r] =
        l > 0.f ? m_s[qi] + logf(l) : NEG_INF;
  }
}

template <typename T, typename PT>
int launch(const void* q, const void* k_win, const void* v_win, void* pool_k,
           void* pool_v, const int* pt, const int* idx, void* out, float* lse,
           int* cnt, int B, int S, int Hq, int Hkv, int D, int ps, int M,
           int store, float scale, float tol, cudaStream_t stream) {
  if (store) {
    window_store_kernel<T, PT><<<dim3(Hkv, B), NT, 0, stream>>>(
        static_cast<const T*>(k_win), static_cast<const T*>(v_win),
        static_cast<PT*>(pool_k), static_cast<PT*>(pool_v), pt, idx, cnt, S,
        Hkv, D, ps, M, tol);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int G = Hq / Hkv;
  const int BQ = G >= 16 ? 1 : 16 / G;  // NQ = G*BQ queries per block
  const int NQ = G * BQ, DP = D + 1;
  const size_t smem = sizeof(float) * (NQ * DP + NQ * D + CH * DP + CH * D +
                                       NQ * CH + 3 * NQ + CH);
  auto kernel = window_attn_kernel<T, PT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(Hkv, B, (S + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_win),
      static_cast<const T*>(v_win), static_cast<const PT*>(pool_k),
      static_cast<const PT*>(pool_v), pt, idx, static_cast<T*>(out), lse, S,
      Hq, Hkv, D, ps, M, BQ, store, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entry point. Returns the cudaError_t of the launches (0 = success).
// act_dtype / pool_dtype: 0 = float32, 1 = bfloat16. store: 1 writes the
// window rows into the pool and counts them, 0 leaves pool and counters.
extern "C" int paged_window(const void* q, const void* k_win,
                            const void* v_win, void* pool_k, void* pool_v,
                            const int* pt, const int* idx, void* out,
                            float* lse, int* cnt, int B, int S, int Hq,
                            int Hkv, int D, int ps, int M, int store,
                            float scale, float tol, int act_dtype,
                            int pool_dtype, void* stream) {
  using namespace repro_torch;
  if (B == 0 || S == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (act_dtype == DT_F32 && pool_dtype == DT_F32)
    return launch<float, float>(q, k_win, v_win, pool_k, pool_v, pt, idx, out,
                                lse, cnt, B, S, Hq, Hkv, D, ps, M, store,
                                scale, tol, s);
  if (act_dtype == DT_F32 && pool_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(q, k_win, v_win, pool_k, pool_v, pt,
                                         idx, out, lse, cnt, B, S, Hq, Hkv, D,
                                         ps, M, store, scale, tol, s);
  if (act_dtype == DT_BF16 && pool_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(q, k_win, v_win, pool_k, pool_v, pt,
                                        idx, out, lse, cnt, B, S, Hq, Hkv, D,
                                        ps, M, store, scale, tol, s);
  if (act_dtype == DT_BF16 && pool_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_win, v_win, pool_k, pool_v, pt, idx, out, lse, cnt, B, S, Hq, Hkv,
        D, ps, M, store, scale, tol, s);
  return (int)cudaErrorInvalidValue;
}
