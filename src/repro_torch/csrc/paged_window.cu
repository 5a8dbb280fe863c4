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
// table; in defer mode, in [0, M*page); in defer mode on a chunk (a
// rank's localized table of a page-chunked pool), in [0, M*page) and on
// a page the table does not mark as another rank's (window_key_ok,
// common.cuh), so every window row is a key on exactly one rank. Window K/V are read rounded
// through the pool dtype, as the pool would hold them. Store mode also
// writes every landing window row into its page and counts [stored,
// silent, dropped] elements against the pool content before the store;
// rows on unmapped pages or past the table count as dropped, negative
// positions (idle sentinel) attempt nothing. Defer mode leaves the pool
// and the counters alone. A row that attends nothing (idle slot) comes
// back 0 with lse NEG_INF.
//
// The store rides the attention launch: every route's block stores and
// counts the window rows it owns (store_window, common.cuh). History
// positions are < idx, stores land at >= idx, attention reads window K/V
// from k_win/v_win and never from the pool, and the copy-on-write
// invariant of serve/kv_cache.py keeps any page being extended exclusive
// to one slot; so no block reads a row another block writes.
//
// What bounds it on the H100: bytes, if the products leave the CUDA
// cores. At the prefill (S 128 at 0, G 2, D 128, f32 pool) a call does
// 0.54 GFLOP over 29 MB, ~18 flops per byte: below the bf16 ridge (~295),
// but more than a scalar f32 loop on the CUDA cores keeps up with. At the
// verify width (W 5 at 144) a call is 10 query rows against ~150 history
// rows per (slot, kv head): bytes and the latency of reading them, and
// one block per (slot, kv head) leaves half the card idle.
//
// Three routes, chosen in the C entry from S, G = Hq/Hkv, D and the
// dtypes, all known to the host (choose_route; measured in PERF.md):
// * tensor cores (bfloat16 activations with S*G > 4, D in {16, 32, 64,
//   128}: the prefill, prefix-hit chunks and the verify windows):
//   window_tc_kernel.
//   A block stacks the G query heads of a kv group on the m dimension: 4
//   warps x 16 rows = 64 query rows = 64/G window rows, resident in a
//   swizzled bf16 tile. S = Q K^T and P V run as mma.sync m16n8k16 (bf16
//   operands, f32 sums; mma.cuh), online softmax in registers, P rounded
//   to bf16 as an operand; only tiles with a masked key (the diagonal,
//   ragged tails, unmapped pages) are masked. Keys come in tiles of 32
//   through a 2-stage ring: window tiles and bf16-pool history tiles by
//   cp.async (the window's pool round trip is exact for bf16
//   activations), f32-pool history tiles loaded into registers before the
//   current tile's products and rounded to bf16 into the ring after them.
//   A window of one row tile (the verify width) splits its history into
//   splits of 4 pages by page index (3 at M 11; 4 timed fastest of 2, 4
//   and 8 on the H100), one block each, combined in split order by the
//   last block to finish (paged_split.cuh's combine); longer windows take
//   a block per row tile instead.
// * split (S*G <= 4, and float32 activations with S*G <= 16): the
//   CUDA-core split-history kernel of paged_split.cuh, f32 throughout.
// * CUDA cores (float32 activations with S*G > 16, or head dims the
//   others do not take): window_attn_kernel, f32 arithmetic from
//   shared-memory tiles.
// The f32 tolerance of 1e-4 rules out bf16 and TF32 operands for f32
// activations.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"
#include "paged_split.cuh"

namespace repro_torch {
namespace {

// the routes; ROUTE_AUTO lets choose_route pick
constexpr int ROUTE_AUTO = 0, ROUTE_CORE = 1, ROUTE_TC = 2, ROUTE_SPLIT = 3;

// ----------------------------------------------------------------------
// CUDA-core route: float32 activations, long windows
// ----------------------------------------------------------------------
constexpr int NT = 128;  // threads per block
constexpr int CH = 16;   // key rows per shared-memory chunk

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
    PT* __restrict__ pool_k,        // (P, ps, Hkv, D)
    PT* __restrict__ pool_v,
    const int* __restrict__ pt,     // (B, M)
    const int* __restrict__ idx,    // (B,)
    T* __restrict__ out,            // (B, S, Hq, D)
    float* __restrict__ lse,        // (B, Hq, S)
    int* __restrict__ cnt,          // (B, 3), zeroed by the caller
    int S, int Hq, int Hkv, int D, int ps, int M, int BQ, int store,
    float scale, float tol) {
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
  if (store == WIN_STORE)  // the block's window rows: >= idx, no history
    store_window<T, PT, 2>(k_win + (int64_t)b * S * Hkv * D,
                        v_win + (int64_t)b * S * Hkv * D, pool_k, pool_v,
                        pt + (int64_t)b * M, cnt + 3 * b, h, (int)i0, r0,
                        min(r0 + BQ, S), Hkv, D, ps, M, tol);
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
      if (ok && store)
        ok = window_key_ok(store, pt[(int64_t)b * M + pos / ps]);
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
int launch_core(const void* q, const void* k_win, const void* v_win,
                void* pool_k, void* pool_v, const int* pt, const int* idx,
                void* out, float* lse, int* cnt, int B, int S, int Hq,
                int Hkv, int D, int ps, int M, int store, float scale,
                float tol, cudaStream_t stream) {
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
      static_cast<const T*>(v_win), static_cast<PT*>(pool_k),
      static_cast<PT*>(pool_v), pt, idx, static_cast<T*>(out), lse, cnt, S,
      Hq, Hkv, D, ps, M, BQ, store, scale, tol);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------
// tensor-core route: bfloat16 activations, long windows
// ----------------------------------------------------------------------
constexpr int TC_NW = 4;            // warps, one m16 tile of query rows each
constexpr int TC_NT = TC_NW * 32;
constexpr int TC_QT = TC_NW * 16;   // query rows per block
constexpr int TC_TK = 32;           // keys per tile
constexpr int TC_PAGES = 4;         // history pages per split (one row tile)

inline bool tc_dim(int D) {
  return D == 16 || D == 32 || D == 64 || D == 128;
}

template <typename PT, int D>
__global__ void __launch_bounds__(TC_NT) window_tc_kernel(
    const bf16* __restrict__ q,      // (B, S, Hq, D)
    const bf16* __restrict__ k_win,  // (B, S, Hkv, D)
    const bf16* __restrict__ v_win,
    PT* __restrict__ pool_k,         // (P, ps, Hkv, D)
    PT* __restrict__ pool_v,
    const int* __restrict__ pt,      // (B, M)
    const int* __restrict__ idx,     // (B,)
    bf16* __restrict__ out,          // (B, S, Hq, D)
    float* __restrict__ lse,         // (B, Hq, S)
    int* __restrict__ cnt,           // (B, 3), zeroed, then the tickets
    float* __restrict__ part,        // NS > 1: the splits' partials
    int S, int Hq, int Hkv, int ps, int M, int RW, int NS, int store,
    float scale_log2, float tol) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr bool F32POOL = sizeof(PT) == 4;
  // NS > 1 (one row tile): blockIdx.z is the history split; else it runs
  // over the row tiles, heaviest (last) first
  const int h = blockIdx.x, b = blockIdx.y;
  const int sp = NS > 1 ? blockIdx.z : 0;
  const int r0 = NS > 1 ? 0 : (gridDim.z - 1 - blockIdx.z) * RW;
  const int G = Hq / Hkv, NQ = G * RW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, c2 = 2 * (lane & 3);
  const int i0 = idx[b];
  const int* __restrict__ ptb = pt + (int64_t)b * M;
  const int rend = min(r0 + RW, S);  // the block's window rows [r0, rend)

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // (TC_QT, D)
  bf16* Ks = Qs + TC_QT * D;                     // 2 x (TC_TK, D)
  bf16* Vs = Ks + 2 * TC_TK * D;                 // 2 x (TC_TK, D)

  // query row i = g*RW + (r - r0): head h*G+g at window row r
  for (int t = threadIdx.x; t < TC_QT * CPR; t += TC_NT) {
    const int i = t / CPR, c = t - i * CPR;
    const int g = i / RW, r = r0 + i - g * RW;
    const bool ok = i < NQ && r < S;
    cp_async16(Qs + swz<D>(i, c),
               ok ? q + (((int64_t)b * S + r) * Hq + h * G + g) * D + c * 8
                  : q,
               ok);
  }

  // key tiles: nh of the split's history [hs, he) from the pool, then,
  // in the split that holds idx (ws), the window keys [0, rend) (no row
  // of the block sees a later one); splits of TC_PAGES pages
  const int SR = TC_PAGES * ps;
  const int ws = min(max(i0, 0) / SR, NS - 1);
  const int hend = max(0, min(i0, M * ps));
  const int hs = NS > 1 ? min(sp * SR, hend) : 0;
  const int he = NS > 1 ? min(hs + SR, hend) : hend;
  const int nh = (he - hs + TC_TK - 1) / TC_TK;
  const int nt = nh + (sp == ws ? (rend + TC_TK - 1) / TC_TK : 0);
  auto load_async_tile = [&](int j, int st) {  // window or bf16-pool tile
    bf16* kd = Ks + st * TC_TK * D;
    bf16* vd = Vs + st * TC_TK * D;
    for (int t = threadIdx.x; t < TC_TK * CPR; t += TC_NT) {
      const int jj = t / CPR, c = t - jj * CPR;
      const bf16 *ks, *vs;
      bool ok;
      if (j >= nh) {
        const int cc = (j - nh) * TC_TK + jj;
        ok = cc < S;
        const int64_t off = (((int64_t)b * S + cc) * Hkv + h) * D + c * 8;
        ks = k_win + (ok ? off : 0);
        vs = v_win + (ok ? off : 0);
      } else {
        const int p = hs + j * TC_TK + jj;
        const int page = p < he ? ptb[p / ps] : -1;
        ok = page >= 0;
        const int64_t off =
            ok ? (((int64_t)page * ps + p % ps) * Hkv + h) * D + c * 8 : 0;
        ks = reinterpret_cast<const bf16*>(pool_k) + off;
        vs = reinterpret_cast<const bf16*>(pool_v) + off;
      }
      cp_async16(kd + swz<D>(jj, c), ks, ok);
      cp_async16(vd + swz<D>(jj, c), vs, ok);
    }
  };
  // f32-pool history tiles: loads into registers (fetch), then rounded
  // to bf16 into the ring (put)
  constexpr int NCH = (TC_TK * CPR + TC_NT - 1) / TC_NT;
  float4 fk[NCH][2], fv[NCH][2];
  auto fetch = [&](int j) {
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      const int t = threadIdx.x + u * TC_NT;
      const int jj = t / CPR, c = t - jj * CPR;
      const int p = hs + j * TC_TK + jj;
      const int page = t < TC_TK * CPR && p < he ? ptb[p / ps] : -1;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      fk[u][0] = fk[u][1] = fv[u][0] = fv[u][1] = z;
      if (page >= 0) {
        const int64_t off =
            (((int64_t)page * ps + p % ps) * Hkv + h) * D + c * 8;
        const float4* kp = reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(pool_k) + off);
        const float4* vp = reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(pool_v) + off);
        fk[u][0] = kp[0];
        fk[u][1] = kp[1];
        fv[u][0] = vp[0];
        fv[u][1] = vp[1];
      }
    }
  };
  auto put = [&](int st) {
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      const int t = threadIdx.x + u * TC_NT;
      if (t >= TC_TK * CPR) continue;
      const int jj = t / CPR, c = t - jj * CPR;
      const float4 *x = fk[u], *y = fv[u];
      *reinterpret_cast<uint4*>(Ks + st * TC_TK * D + swz<D>(jj, c)) =
          make_uint4(pack_bf16(x[0].x, x[0].y), pack_bf16(x[0].z, x[0].w),
                     pack_bf16(x[1].x, x[1].y), pack_bf16(x[1].z, x[1].w));
      *reinterpret_cast<uint4*>(Vs + st * TC_TK * D + swz<D>(jj, c)) =
          make_uint4(pack_bf16(y[0].x, y[0].y), pack_bf16(y[0].z, y[0].w),
                     pack_bf16(y[1].x, y[1].y), pack_bf16(y[1].z, y[1].w));
    }
  };
  if (nt > 0) {
    if (F32POOL && nh > 0) {
      fetch(0);
      put(0);
    } else {
      load_async_tile(0, 0);
    }
  }
  cp_async_commit();

  if (store == WIN_STORE && sp == ws)  // the block's rows, as tiles load
    store_window<bf16, PT, 4>(k_win + (int64_t)b * S * Hkv * D,
                           v_win + (int64_t)b * S * Hkv * D, pool_k, pool_v,
                           ptb, cnt + 3 * b, h, i0, r0, rend, Hkv, D, ps, M,
                           tol);

  // this lane's rows g4 (e 0-1) and g4+8 (e 2-3) of the warp's m16 tile
  int rw[2];
  bool qok[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = 16 * warp + g4 + 8 * rr, g = i / RW;
    rw[rr] = r0 + i - g * RW;
    qok[rr] = i < NQ && rw[rr] < S;
  }
  // the warp's first and last live window rows
  const int wmax = __reduce_max_sync(
      0xffffffffu, max(qok[0] ? rw[0] : -1, qok[1] ? rw[1] : -1));
  const int wmin = -__reduce_max_sync(
      0xffffffffu,
      max(qok[0] ? -rw[0] : -(1 << 30), qok[1] ? -rw[1] : -(1 << 30)));

  float o[1][D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[0][n][e] = 0.f;

  for (int j = 0; j < nt; ++j) {
    const int st = j & 1;
    const bool put_next = F32POOL && j + 1 < nh;
    if (put_next)
      fetch(j + 1);
    else if (j + 1 < nt)
      load_async_tile(j + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bool hist = j < nh;
    const int k0 = hist ? hs + j * TC_TK : (j - nh) * TC_TK;
    if (hist || k0 <= wmax) {
      // key k0 + lane: live in the history, or a valid window position
      bool kv;
      if (hist) {
        const int p = k0 + lane;
        kv = p < he && ptb[p / ps] >= 0;
      } else {
        const int c = k0 + lane, pos = i0 + c;
        kv = c < S && pos >= 0 && pos < M * ps;
        if (kv && store) kv = window_key_ok(store, ptb[pos / ps]);
      }
      const unsigned live = __ballot_sync(0xffffffffu, kv);
      float s[1][TC_TK / 8][4];
      mma_abt<D, TC_TK, 1>(s, Qs, 16 * warp, Ks + st * TC_TK * D, 0, lane);
      if (live != 0xffffffffu || (!hist && k0 + TC_TK - 1 > wmin)) {
#pragma unroll
        for (int n = 0; n < TC_TK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * n + c2 + (e & 1);
            if (!((live >> col) & 1) || (!hist && k0 + col > rw[e >> 1]))
              s[0][n][e] = -INFINITY;
          }
      }
      // online softmax in log2 units, the 1/sqrt(D) scale folded in
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < TC_TK / 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[0][n][0], s[0][n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[0][n][2], s[0][n][3]));
      }
      float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
        mu[r] = mn == -INFINITY ? 0.f : mn;  // a row with no key yet
        alpha[r] = exp2f(m[r] - mu[r]);
        m[r] = mn;
      }
#pragma unroll
      for (int n = 0; n < TC_TK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[0][n][e] = exp2f(fmaf(s[0][n][e], scale_log2, -mu[e >> 1]));
          sum[e >> 1] += s[0][n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[0][n][0] *= alpha[0];
        o[0][n][1] *= alpha[0];
        o[0][n][2] *= alpha[1];
        o[0][n][3] *= alpha[1];
      }
      uint32_t p[1][TC_TK / 16][4];
      c_to_a<TC_TK>(p[0], s[0]);
      mma_pv<D, TC_TK, 1>(o, p, Vs + st * TC_TK * D, 0, lane);
    }
    if (put_next) put(st ^ 1);  // stage st^1 was consumed in step j-1
    __syncthreads();            // stage st is consumed before it is refilled
  }

  // NS > 1: this split's partial (rows of the tile: m, l, acc), and the
  // last split to finish combines them in split order
  const int64_t pstride = (int64_t)TC_QT * (D + 2);
  float* P0 = NS > 1 ? part + ((int64_t)b * Hkv + h) * NS * pstride : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (!qok[r]) continue;
    const int i = 16 * warp + g4 + 8 * r, hq = h * G + i / RW;
    if (NS > 1) {
      float* pp = P0 + sp * pstride;
      if ((lane & 3) == 0) {
        pp[i] = m[r];
        pp[TC_QT + i] = l[r];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(pp + 2 * TC_QT + i * D + 8 * n + c2) =
            make_float2(o[0][n][2 * r], o[0][n][2 * r + 1]);
      continue;
    }
    if ((lane & 3) == 0)
      lse[((int64_t)b * Hq + hq) * S + rw[r]] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : NEG_INF;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* po = out + (((int64_t)b * S + rw[r]) * Hq + hq) * D + c2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(po + 8 * n) =
          pack_bf16(o[0][n][2 * r] * inv, o[0][n][2 * r + 1] * inv);
  }
  if (NS == 1 || !last_to_arrive(cnt + 3 * gridDim.y + b * Hkv + h, NS))
    return;
  combine_partials<bf16>(P0, TC_QT, NS, D, reinterpret_cast<float*>(smem_raw),
                         out, lse, b, S, Hq, [&](int i, int& r, int& hq) {
                           const int g = i / RW;
                           r = i - g * RW;
                           hq = h * G + g;
                           return i < NQ && r < S;
                         });
}

// history splits of the tensor-core route: a window of one row tile
// (the verify width) splits its history as the split route does; longer
// windows have their row tiles for parallelism
inline int tc_splits(int S, int G, int M) {
  return S * G <= TC_QT ? (M + TC_PAGES - 1) / TC_PAGES : 1;
}

template <typename PT, int D>
int launch_tc(const void* q, const void* k_win, const void* v_win,
              void* pool_k, void* pool_v, const int* pt, const int* idx,
              void* out, float* lse, int* cnt, float* part, int B, int S,
              int Hq, int Hkv, int ps, int M, int store, float scale,
              float tol, cudaStream_t stream) {
  const int G = Hq / Hkv, RW = TC_QT / G, NS = tc_splits(S, G, M);
  const size_t tiles = sizeof(bf16) * (TC_QT + 4 * TC_TK) * D;
  const size_t combine = sizeof(float) * (2 * NS + 2) * TC_QT;
  const size_t smem = tiles > combine ? tiles : combine;
  auto kernel = window_tc_kernel<PT, D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(Hkv, B, NS > 1 ? NS : (S + RW - 1) / RW), TC_NT, smem,
           stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_win),
      static_cast<const bf16*>(v_win), static_cast<PT*>(pool_k),
      static_cast<PT*>(pool_v), pt, idx, static_cast<bf16*>(out), lse, cnt,
      part, S, Hq, Hkv, ps, M, RW, NS, store, scale * LOG2E, tol);
  return (int)cudaGetLastError();
}

template <typename PT>
int launch_tc_dim(int D, const void* q, const void* k_win, const void* v_win,
                  void* pool_k, void* pool_v, const int* pt, const int* idx,
                  void* out, float* lse, int* cnt, float* part, int B, int S,
                  int Hq, int Hkv, int ps, int M, int store, float scale,
                  float tol, cudaStream_t s) {
#define REPRO_TC_CASE(DD)                                                   \
  if (D == DD)                                                              \
    return launch_tc<PT, DD>(q, k_win, v_win, pool_k, pool_v, pt, idx, out, \
                             lse, cnt, part, B, S, Hq, Hkv, ps, M, store,   \
                             scale, tol, s);
  REPRO_TC_CASE(16) REPRO_TC_CASE(32) REPRO_TC_CASE(64) REPRO_TC_CASE(128)
#undef REPRO_TC_CASE
  return (int)cudaErrorInvalidValue;
}

// ----------------------------------------------------------------------
// split route: short windows in every dtype (paged_split.cuh)
// ----------------------------------------------------------------------
template <typename T, typename PT, int EPL, int NQ>
__global__ void __launch_bounds__(SPLIT_NT)
    window_split_kernel(const SplitArgs a) {
  split_attend<T, PT, EPL, NQ>(a);
}

template <typename T, typename PT, int NQ>
int launch_split(const SplitArgs& a, int B, cudaStream_t s) {
  switch (split_epl(a.D)) {
    case 1:
      return split_launch<PT>(window_split_kernel<T, PT, 1, NQ>, a, B, s);
    case 2:
      return split_launch<PT>(window_split_kernel<T, PT, 2, NQ>, a, B, s);
    case 4:
      return split_launch<PT>(window_split_kernel<T, PT, 4, NQ>, a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename PT>
int launch_split(const SplitArgs& a, int B, cudaStream_t s) {
  return split_nq(a.S, a.Hq / a.Hkv) == 4
             ? launch_split<T, PT, 4>(a, B, s)
             : launch_split<T, PT, SPLIT_NQ>(a, B, s);
}

// The route for a call, from the H100 measurement in PERF.md: the split
// while a kv group's S*G query rows fit its small block (4: the CUDA-core
// split beats the tensor cores there), then the tensor cores for bf16
// activations, the split for f32 while the rows fit one split block,
// else the CUDA cores.
int choose_route(int S, int G, int D, int act_dtype) {
  const bool split = split_epl(D) != 0;
  if (split && S * G <= 4) return ROUTE_SPLIT;
  if (act_dtype == DT_BF16 && tc_dim(D) && G <= TC_QT) return ROUTE_TC;
  if (split && S * G <= SPLIT_NQ) return ROUTE_SPLIT;
  return ROUTE_CORE;
}

// whether `route` takes these inputs
bool route_ok(int route, int G, int D, int act_dtype) {
  if (route == ROUTE_SPLIT) return split_epl(D) != 0;
  if (route == ROUTE_TC)
    return act_dtype == DT_BF16 && tc_dim(D) && G <= TC_QT;
  return route == ROUTE_CORE;
}

template <typename T, typename PT>
int launch(int route, const void* q, const void* k_win, const void* v_win,
           void* pool_k, void* pool_v, const int* pt, const int* idx,
           void* out, float* lse, int* cnt, float* part, int B, int S,
           int Hq, int Hkv, int D, int ps, int M, int store, float scale,
           float tol, cudaStream_t s) {
  if (route == ROUTE_SPLIT) {
    const SplitArgs a{q, k_win, v_win, pool_k, pool_v, pt, idx, out, lse,
                      cnt, part, cnt + 3 * B, S, Hq, Hkv, D, ps, M,
                      split_count(M), split_chunks(S, Hq / Hkv), store,
                      scale * LOG2E, tol};
    return launch_split<T, PT>(a, B, s);
  }
  if constexpr (sizeof(T) == 2) {
    if (route == ROUTE_TC)
      return launch_tc_dim<PT>(D, q, k_win, v_win, pool_k, pool_v, pt, idx,
                               out, lse, cnt, part, B, S, Hq, Hkv, ps, M,
                               store, scale, tol, s);
  }
  return launch_core<T, PT>(q, k_win, v_win, pool_k, pool_v, pt, idx, out,
                            lse, cnt, B, S, Hq, Hkv, D, ps, M, store, scale,
                            tol, s);
}

int resolve(int route, int S, int Hq, int Hkv, int D, int act_dtype) {
  const int G = Hq / Hkv;
  if (route == ROUTE_AUTO) return choose_route(S, G, D, act_dtype);
  return route_ok(route, G, D, act_dtype) ? route : -1;
}

}  // namespace
}  // namespace repro_torch

// Workspace of a paged_window call on `route` (0 = the entry's choice):
// sizes[0] ticket ints (zeroed, after the (B, 3) counters in the same
// buffer), sizes[1] partial floats; both 0 off the split route. Returns
// cudaErrorInvalidValue for a route that does not take these inputs.
extern "C" int paged_window_workspace(int B, int S, int Hq, int Hkv, int D,
                                      int M, int route, int act_dtype,
                                      int64_t* sizes) {
  using namespace repro_torch;
  route = resolve(route, S, Hq, Hkv, D, act_dtype);
  sizes[0] = sizes[1] = 0;
  if (route < 0) return (int)cudaErrorInvalidValue;
  if (route == ROUTE_SPLIT) split_workspace(B, S, Hq, Hkv, D, M, sizes);
  const int NS = tc_splits(S, Hq / Hkv, M);
  if (route == ROUTE_TC && NS > 1) {
    sizes[0] = (int64_t)B * Hkv;
    sizes[1] = sizes[0] * NS * TC_QT * (D + 2);
  }
  return 0;
}

// C entry point. Returns the cudaError_t of the launch (0 = success).
// act_dtype / pool_dtype: 0 = float32, 1 = bfloat16. store: 1 writes the
// window rows into the pool and counts them, 0 leaves pool and counters,
// 2 does as 0 with the window rows of a rank's chunk (WIN_DEFER_CHUNK).
// route: 0 = choose_route's pick, else ROUTE_CORE / ROUTE_TC / ROUTE_SPLIT
// (a forced route, for measurement and tests). D a multiple of 8; float
// operands 16-byte aligned. cnt: the (B, 3) counters followed by the
// tickets, zeroed; part: the partials (paged_window_workspace).
extern "C" int paged_window(const void* q, const void* k_win,
                            const void* v_win, void* pool_k, void* pool_v,
                            const int* pt, const int* idx, void* out,
                            float* lse, int* cnt, float* part, int B, int S,
                            int Hq, int Hkv, int D, int ps, int M, int store,
                            int route, float scale, float tol, int act_dtype,
                            int pool_dtype, void* stream) {
  using namespace repro_torch;
  if (B == 0 || S == 0) return 0;
  route = resolve(route, S, Hq, Hkv, D, act_dtype);
  if (route < 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_WINDOW_ARGS                                                  \
  route, q, k_win, v_win, pool_k, pool_v, pt, idx, out, lse, cnt, part, B, \
      S, Hq, Hkv, D, ps, M, store, scale, tol, s
  if (act_dtype == DT_F32 && pool_dtype == DT_F32)
    return launch<float, float>(REPRO_WINDOW_ARGS);
  if (act_dtype == DT_F32 && pool_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(REPRO_WINDOW_ARGS);
  if (act_dtype == DT_BF16 && pool_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(REPRO_WINDOW_ARGS);
  if (act_dtype == DT_BF16 && pool_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(REPRO_WINDOW_ARGS);
#undef REPRO_WINDOW_ARGS
  return (int)cudaErrorInvalidValue;
}
