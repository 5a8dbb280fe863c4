// RMSNorm forward and backward (Hopper, sm_90a), one launch a call each.
//
// Replaces: src/repro/kernels/rmsnorm.py:rmsnorm (the Pallas kernel
// _rmsnorm_kernel) and its gradient (the TPU package trains through
// XLA's autodiff of the inline norm). Plain versions:
// repro_torch.kernels.ref.rmsnorm_ref, ref.rmsnorm_bwd_ref, and
// ref.rmsnorm_bwd_blocked, which partitions the rows and combines the
// dscale partials as the backward kernel does.
//
// Forward, for rows x (n, d) read by row stride and scale s (d,):
//   r = 1 / sqrt(mean(x^2) + eps)  per row, f32 (written when asked),
//   y = x r s                      in x's dtype, contiguous.
// What bounds it: bytes (x read once, y written once; ~4 f32 operations
// an element), and on the serving paths' decode rows the launch itself.
// What the design does about it:
// - Every row's loads are issued before its first sum: a row (or R rows
//   of a warp) lives in registers as raw words, read by 16-byte loads
//   where the alignment allows, the scale's loads beside them and held
//   in registers. Outputs leave by explicit 16-byte stores (store16),
//   16-bit values converted in pairs; 1 / d is divided once on the host.
// - Three routes, picked by the wrapper (kernels/rmsnorm.py: row_route,
//   the backward's too): narrow rows (d <= 128): 16 lanes of 8 elements
//   a row (16-bit, 16-byte aligned) or 32 lanes of 4, R steps of rows a
//   warp, sums by shuffles only; wide rows (128 < d <= 4096, 16-byte
//   aligned): a row per warp (d <= 2048) or two, at most 64 values a
//   lane, no rounding of d to a power of two (1536 is 192 chunks, 6 a
//   lane, no idle lane); any other width up to 16384 or alignment: a
//   block per row, masked scalar loads.
// - A plain grid of ceil(n / rows) blocks (no cross-row combine): rows a
//   block from a timing sweep (PERF.md), fewer when the rows would not
//   fill the SMs, so decode rows spread over as many SMs as they can.
// - Each row's sum runs in one fixed order for a given route, so two
//   calls give the same bits (remat repeats the forward exactly).
//
// Backward, with the forward's f32 rstd r (n,) and dy (n, d) read by
// its own row stride: with xhat = x r and g = dy s in f32,
//   dx = r (g - xhat mean(g xhat))        per row, in x's dtype,
//   dscale = sum over rows of dy xhat     in scale's dtype.
//
// What bounds the backward on the H100: bytes. x and dy are read once,
// dx written once (3 n d elements; 50 MB at the training block norm, 15
// us at the memory rate); about 8 f32 operations an element are far
// below the card's ridge point. Each row is two reductions: the row's sum of
// g xhat (across the row) and dscale (down the rows).
//
// What the design does about it:
// - One launch, nothing else: no memset, no second reduction kernel, no
//   cast. The grid is persistent (a few blocks an SM, set by the
//   wrapper from timings); each row worker (a block, or a warp for
//   narrow rows) takes one contiguous range of rows and keeps the f32
//   dscale partials of its columns in registers across them.
// - Fixed-order combine: a block writes one (d,) partial (its warps'
//   partials summed in warp order) to a workspace row and takes an
//   integer ticket; the last block to take it resets it and releases
//   the grid (a generation count the others wait on: the launch is
//   cooperative, so every block is resident and the wait cannot
//   deadlock). Then each block sums its slice of the columns over all
//   the partials in a fixed order (groups of `group` consecutive blocks
//   in block order, then the groups in order) and writes dscale in
//   scale's dtype. The ticket is zeroed once, when the workspace is
//   allocated. No float atomics: two calls give the same bits. Summing
//   the partials column-parallel over the whole grid, not in one last
//   block, keeps the serial tail to one barrier and a few loads.
// - Loads in flight while rows reduce: the next rows' x, dy and rstd are
//   staged by cp.async into a shared-memory ring (3 rows ahead on the
//   wide route, 2 steps of several rows on the narrow one). Each thread
//   copies exactly what it later reads, so the ring needs no barrier; dx
//   leaves by 16-byte stores (8-byte for 16-bit narrow rows). The
//   combine keeps 8 partial rows' loads in flight a thread.
// - The forward's three routes (kernels/rmsnorm.py: row_route, bwd_plan):
//   wide rows (128 < d <= 4096, d % 8 == 0, 16-byte aligned rows): a
//   block per row, 8 elements a thread, one block barrier a row;
//   narrow rows (d <= 128, d % 4 == 0, rows aligned to 4 elements): a
//   warp per row, 4 elements a lane, several rows a step, the row sums
//   from shuffles only; any other width up to 16384 or alignment: the
//   general route, a block per row, masked scalar loads, the partial
//   kept in the workspace row itself.
// - dscale's products are rounded multiplies (__fmul_rn), never fused
//   into the add, so ref.rmsnorm_bwd_blocked reproduces dscale bit for
//   bit from the same plan.
#include <cuda_fp16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace repro_torch {

constexpr int ROUTE_GENERAL = 0;
constexpr int ROUTE_NARROW = 1;
constexpr int ROUTE_WIDE = 2;
constexpr int NARROW_WARPS = 16;  // row workers (warps) of a narrow block
constexpr int NARROW_D = 128;     // widest narrow row: 4 elements a lane
constexpr int WIDE_E = 8;         // elements a thread on the wide route
constexpr int WIDE_MAX_D = 4096;  // 512 threads
constexpr int WIDE_STAGES = 4;    // rows in the wide ring
constexpr int NARROW_STAGES = 3;  // steps of R rows in a warp's ring
constexpr int GENERAL_THREADS = 256;

struct BwdArgs {
  const void* x;
  const void* s;
  const void* dy;
  const float* rstd;
  void* dx;
  void* ds;
  float* part;  // (blocks, d) f32: the block partials
  int* ticket;  // [arrivals, generation] int32; arrivals zero between calls
  int64_t n;
  int64_t xs, dys;  // row strides of x and dy, in elements
  int d;
  int group;  // consecutive block partials summed first
  int s_dt;   // scale's dtype code
};

__device__ __forceinline__ float load_scale(const void* s, int c, int dt) {
  if (dt == DT_BF16) return to_f(static_cast<const __nv_bfloat16*>(s)[c]);
  if (dt == DT_F16) return to_f(static_cast<const __half*>(s)[c]);
  return static_cast<const float*>(s)[c];
}

__device__ __forceinline__ void store_scale(void* s, int c, float v, int dt) {
  if (dt == DT_BF16)
    static_cast<__nv_bfloat16*>(s)[c] = from_f<__nv_bfloat16>(v);
  else if (dt == DT_F16)
    static_cast<__half*>(s)[c] = from_f<__half>(v);
  else
    static_cast<float*>(s)[c] = v;
}

// BYTES (4, 8 or 16) global -> shared
template <int BYTES>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    cp_async16(dst, src, true);
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES));
}

// Rows [r0, r1) of worker j of `workers`: contiguous, balanced
__device__ __forceinline__ void row_range(int64_t n, int64_t j,
                                          int64_t workers, int64_t& r0,
                                          int64_t& r1) {
  r0 = n * j / workers;
  r1 = n * (j + 1) / workers;
}

// After every block's partial is in part[block] (this one's just
// written): the fixed-order combine into dscale. A grid barrier first:
// each block takes the ticket; the last to take it resets it and bumps
// a generation count the others wait on (the grid is co-resident: a
// cooperative launch). Thread 0 handshakes alone: last_to_arrive's
// block-wide election put a barrier and a fence of every thread on the
// grid's critical path, and timed slower. Then block b sums its slice
// of the columns over every block partial: groups of `group`
// consecutive partials each summed in block order (U loads in flight a
// thread), then the group sums in group order.
constexpr int U = 8;
constexpr int GROUP_SUMS = 1024;  // shared floats for the group sums
__device__ __forceinline__ void combine(const BwdArgs& a) {
  __shared__ float gs[GROUP_SUMS];
  const int G = gridDim.x, m = a.group, ng = (G + m - 1) / m;
  volatile int* gen = a.ticket + 1;
  const int g0 = threadIdx.x == 0 ? *gen : 0;
  __threadfence();  // the generation read and this block's partial,
  __syncthreads();  // before its ticket
  if (threadIdx.x == 0) {
    if (atomicAdd(a.ticket, 1) == G - 1) {
      a.ticket[0] = 0;
      __threadfence();
      atomicAdd(a.ticket + 1, 1);
    } else {
      while (*gen == g0) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
  const int b = blockIdx.x;
  const int c0 = (int)((int64_t)a.d * b / G);
  const int c1 = (int)((int64_t)a.d * (b + 1) / G);
  const int cw = max(1, GROUP_SUMS / ng);  // columns a pass
  for (int cc = c0; cc < c1; cc += cw) {
    const int w = min(cw, c1 - cc);
    for (int i = threadIdx.x; i < ng * w; i += blockDim.x) {
      const int q = i / w, c = cc + i - q * w;
      const int j1 = min(G, (q + 1) * m);
      float v = 0.f;
      for (int j = q * m; j < j1; j += U) {
        float p[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (j + u < j1) p[u] = __ldcg(a.part + (int64_t)(j + u) * a.d + c);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (j + u < j1) v += p[u];
      }
      gs[q * w + c - cc] = v;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < w; c += blockDim.x) {
      float v = 0.f;
      for (int q = 0; q < ng; ++q) v += gs[q * w + c];
      store_scale(a.ds, cc + c, v, a.s_dt);
    }
    __syncthreads();
  }
}

// Wide rows: a block per row, thread t holds columns [8t, 8t + 8); the
// next WIDE_STAGES - 1 rows in flight. Dynamic shared memory: the ring,
// [stages][x, dy][threads][8] of T, then [stages][threads] f32 rstd
// (each thread stages the copies it reads itself: no barrier guards the
// ring).
template <typename T>
__global__ void __launch_bounds__(WIDE_MAX_D / WIDE_E)
    rmsnorm_bwd_wide_kernel(const BwdArgs a) {
  constexpr int E = WIDE_E, NS = WIDE_STAGES;
  constexpr int CE = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int NC = E / CE;          // chunks a thread per operand
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[NS][32];
  const int t = threadIdx.x, tpb = blockDim.x, c = t * E;
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* rs = reinterpret_cast<float*>(ring + (int64_t)NS * 2 * tpb * E);
  const bool on = c < a.d;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  int64_t r0, r1;
  row_range(a.n, blockIdx.x, gridDim.x, r0, r1);
  float s[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    s[e] = on ? load_scale(a.s, c + e, a.s_dt) : 0.f;
    acc[e] = 0.f;
  }
  auto slot = [&](int st, int op) {
    return ring + ((int64_t)(st * 2 + op) * tpb + t) * E;
  };
  auto issue = [&](int64_t row, int st) {
    if (row < r1) {
      cp_async_bytes<4>(rs + st * tpb + t, a.rstd + row);
      if (on) {
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          cp_async16(slot(st, 0) + q * CE, x + row * a.xs + c + q * CE, true);
          cp_async16(slot(st, 1) + q * CE, dy + row * a.dys + c + q * CE,
                     true);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(r0 + i, i);
  int st = 0;
  for (int64_t row = r0; row < r1; ++row) {
    issue(row + NS - 1, st == 0 ? NS - 1 : st - 1);
    cp_async_wait<NS - 1>();
    const float r = rs[st * tpb + t];
    float xh[E], dv[E];
    float p = 0.f;
    if (on) {
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        float xv[CE], yv[CE];
        load_f<T, CE>(slot(st, 0) + q * CE, xv);
        load_f<T, CE>(slot(st, 1) + q * CE, yv);
#pragma unroll
        for (int e = 0; e < CE; ++e) {
          xh[q * CE + e] = __fmul_rn(xv[e], r);
          dv[q * CE + e] = yv[e];
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e) p = fmaf(dv[e] * s[e], xh[e], p);
    }
    p = warp_sum(p);
    if ((t & 31) == 0) red[st][t >> 5] = p;
    __syncthreads();
    float tot = 0.f;
    for (int w = 0; w < (tpb >> 5); ++w) tot += red[st][w];
    if (on) {
      const float mean = tot / a.d;
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        Vec<T, CE> o;
#pragma unroll
        for (int e = 0; e < CE; ++e) {
          const int i = q * CE + e;
          o.v[e] = from_f<T>(r * (dv[i] * s[i] - xh[i] * mean));
          acc[i] += __fmul_rn(dv[i], xh[i]);
        }
        *reinterpret_cast<Vec<T, CE>*>(dx + row * a.d + c + q * CE) = o;
      }
    }
    st = st == NS - 1 ? 0 : st + 1;
  }
  cp_async_wait<0>();
  if (on) {
    float* P = a.part + (int64_t)blockIdx.x * a.d + c;
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<float4*>(P + e) =
          make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  }
  combine(a);
}

// Narrow rows: a warp per row, lane l holds columns [4l, 4l + 4); each
// warp is a row worker and takes R rows a step, the next
// NARROW_STAGES - 1 steps in flight, each lane staging its own copies
// (rstd included) in the warp's ring.
template <typename T>
__global__ void __launch_bounds__(NARROW_WARPS * 32)
    rmsnorm_bwd_narrow_kernel(const BwdArgs a) {
  constexpr int E = 4, W = NARROW_WARPS, NS = NARROW_STAGES;
  constexpr int R = 8 / sizeof(T);  // 2 rows a step at f32, 4 at 16 bits
  constexpr int BYTES = E * sizeof(T);
  // dynamic shared memory (narrow_smem<T>()): the ring, rstd, partials
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto ring = reinterpret_cast<T(*)[NS][2][R][NARROW_D]>(smem_raw);
  auto rs = reinterpret_cast<float(*)[NS][R][32]>(
      smem_raw + sizeof(T) * W * NS * 2 * R * NARROW_D);
  auto wpart = reinterpret_cast<float(*)[NARROW_D]>(
      smem_raw + sizeof(T) * W * NS * 2 * R * NARROW_D +
      sizeof(float) * W * NS * R * 32);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane * E;
  const bool on = c < a.d;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  int64_t r0, r1;
  row_range(a.n, (int64_t)blockIdx.x * W + w, (int64_t)gridDim.x * W, r0,
            r1);
  float s[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    s[e] = on ? load_scale(a.s, c + e, a.s_dt) : 0.f;
    acc[e] = 0.f;
  }
  auto issue = [&](int64_t row0, int st) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = row0 + i;
      if (row < r1) {
        cp_async_bytes<4>(&rs[w][st][i][lane], a.rstd + row);
        if (on) {
          cp_async_bytes<BYTES>(&ring[w][st][0][i][c], x + row * a.xs + c);
          cp_async_bytes<BYTES>(&ring[w][st][1][i][c], dy + row * a.dys + c);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(r0 + (int64_t)i * R, i);
  int st = 0;
  for (int64_t row0 = r0; row0 < r1; row0 += R) {
    issue(row0 + (int64_t)(NS - 1) * R, st == 0 ? NS - 1 : st - 1);
    cp_async_wait<NS - 1>();
    float r[R], xh[R][E], dv[R][E], p[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      p[i] = 0.f;
      r[i] = rs[w][st][i][lane];
      if (on && row0 + i < r1) {
        float xv[E];
        load_f<T, E>(&ring[w][st][0][i][c], xv);
        load_f<T, E>(&ring[w][st][1][i][c], dv[i]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          xh[i][e] = __fmul_rn(xv[e], r[i]);
          p[i] = fmaf(dv[i][e] * s[e], xh[i][e], p[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = warp_sum(p[i]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (!(on && row0 + i < r1)) continue;
      const float mean = p[i] / a.d;
      Vec<T, E> o;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        o.v[e] = from_f<T>(r[i] * (dv[i][e] * s[e] - xh[i][e] * mean));
        acc[e] += __fmul_rn(dv[i][e], xh[i][e]);
      }
      *reinterpret_cast<Vec<T, E>*>(dx + (row0 + i) * a.d + c) = o;
    }
    st = st == NS - 1 ? 0 : st + 1;
  }
  cp_async_wait<0>();
  if (on) {
#pragma unroll
    for (int e = 0; e < E; ++e) wpart[w][c + e] = acc[e];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < a.d; col += blockDim.x) {
    float v = 0.f;
    for (int j = 0; j < W; ++j) v += wpart[j][col];  // in warp order
    a.part[(int64_t)blockIdx.x * a.d + col] = v;
  }
  combine(a);
}

// Any other width or alignment: a block per row, columns strided over
// the threads, the row read twice (its sum, then dx), the partial
// accumulated in the block's workspace row.
template <typename T>
__global__ void __launch_bounds__(GENERAL_THREADS)
    rmsnorm_bwd_general_kernel(const BwdArgs a) {
  __shared__ float red[2][GENERAL_THREADS / 32];
  const int t = threadIdx.x;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  float* P = a.part + (int64_t)blockIdx.x * a.d;
  int64_t r0, r1;
  row_range(a.n, blockIdx.x, gridDim.x, r0, r1);
  for (int c = t; c < a.d; c += blockDim.x) P[c] = 0.f;
  int k = 0;
  for (int64_t row = r0; row < r1; ++row, ++k) {
    const float r = __ldg(a.rstd + row);
    const T* xr = x + row * a.xs;
    const T* yr = dy + row * a.dys;
    float p = 0.f;
    for (int c = t; c < a.d; c += blockDim.x) {
      const float xh = __fmul_rn(to_f(xr[c]), r);
      p = fmaf(to_f(yr[c]) * load_scale(a.s, c, a.s_dt), xh, p);
    }
    p = warp_sum(p);
    const int st = k & 1;
    if ((t & 31) == 0) red[st][t >> 5] = p;
    __syncthreads();
    float tot = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot += red[st][w];
    const float mean = tot / a.d;
    for (int c = t; c < a.d; c += blockDim.x) {
      const float xh = __fmul_rn(to_f(xr[c]), r);
      const float yv = to_f(yr[c]);
      dx[row * a.d + c] =
          from_f<T>(r * (yv * load_scale(a.s, c, a.s_dt) - xh * mean));
      P[c] += __fmul_rn(yv, xh);
    }
  }
  combine(a);
}

// Dynamic shared memory of a narrow block: its warps' rings of x and dy,
// their staged rstd, and the warps' dscale partials.
template <typename T>
constexpr size_t narrow_smem() {
  constexpr size_t R = 8 / sizeof(T);
  return NARROW_WARPS * (NARROW_STAGES * R * (2 * NARROW_D * sizeof(T) +
                                              32 * sizeof(float)) +
                         NARROW_D * sizeof(float));
}

// Above 48 KB a kernel must be allowed its dynamic shared memory first
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The kernel, block size and dynamic shared memory of a route
template <typename T>
struct Route {
  void (*kernel)(BwdArgs);
  int threads;
  size_t smem;
};

template <typename T>
bool route_of(int route, int d, Route<T>& r) {
  if (route == ROUTE_NARROW && d <= NARROW_D && d % 4 == 0) {
    r = {rmsnorm_bwd_narrow_kernel<T>, NARROW_WARPS * 32, narrow_smem<T>()};
  } else if (route == ROUTE_WIDE && d <= WIDE_MAX_D && d % WIDE_E == 0) {
    const int threads = (d / WIDE_E + 31) / 32 * 32;
    r = {rmsnorm_bwd_wide_kernel<T>, threads,
         (size_t)WIDE_STAGES * threads *
             (2 * WIDE_E * sizeof(T) + sizeof(float))};
  } else if (route == ROUTE_GENERAL) {
    r = {rmsnorm_bwd_general_kernel<T>, GENERAL_THREADS, 0};
  } else {
    return false;
  }
  return true;
}

// One cooperative launch: the grid must be co-resident (the combine's
// barrier waits for every block); a grid too large is refused, not run.
template <typename T>
int launch(BwdArgs a, int route, int grid, cudaStream_t stream) {
  Route<T> r;
  if (!route_of<T>(route, a.d, r)) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(r.kernel, r.smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)r.kernel, dim3(grid),
                                  dim3(r.threads), args, r.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Blocks of a route that fit on one SM at once
template <typename T>
int resident(int route, int d, int* blocks) {
  Route<T> r;
  if (!route_of<T>(route, d, r)) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(r.kernel, r.smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, r.kernel, r.threads, r.smem);
}

// ---------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------
constexpr int FWD_MAX_THREADS = 256;  // threads of a narrow or wide block
constexpr int FWD_LANE_VALUES = 64;   // wide route: most values a lane
constexpr int FWD_WIDE_WARP_D = 32 * FWD_LANE_VALUES;  // 2048: one warp

struct FwdArgs {
  const void* x;
  const void* s;
  void* y;
  float* rstd;  // (n,) f32, or null: not written
  int64_t n;
  int64_t xs;  // x's row stride, in elements
  int d;
  float eps;
  float inv_d;  // 1 / d, rounded on the host
  int s_dt;     // scale's dtype code
};

// 1 / sqrt(mean of squares + eps) by the reciprocal square root unit
// (rsqrtf, within 2 ulp), the mean as sumsq times 1 / d (inv_d, divided
// once on the host): one dependent instruction each after the row's
// sum, where an IEEE-rounded division and square root put some 30 on
// every row's critical path
__device__ __forceinline__ float inv_rms(float sumsq, float inv_d,
                                         float eps) {
  return rsqrtf(sumsq * inv_d + eps);
}

// Sum of v over each group of LR consecutive lanes (LR a power of two),
// in the order of warp_sum
template <int LR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Element i (< 4 / sizeof(T)) of the 32-bit word w of packed T values
template <typename T>
__device__ __forceinline__ float from_bits(uint32_t w, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w);
  } else {
    const uint32_t h = i ? w >> 16 : w & 0xffffu;
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return __uint_as_float(h << 16);
    else
      return __half2float(__ushort_as_half((unsigned short)h));
  }
}

// a, b (a first in memory) as one word of 16-bit T, rounded to nearest
// even as from_f<T> rounds
template <typename T>
__device__ __forceinline__ uint32_t to_bits2(float a, float b) {
  uint32_t u;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(b), "f"(a));
  else
    asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(b), "f"(a));
  return u;
}

// BYTES (16 or 8) at p as BYTES / 4 words, one vector load
template <int BYTES>
__device__ __forceinline__ void load_words(const void* p, uint32_t* w) {
  if constexpr (BYTES == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  }
}

// One 16-byte (8-byte) global store of u at p. Written out, since a
// struct store through a cast pointer leaves the vector store to the
// compiler, which splits it into 4-byte stores wherever it cannot prove
// the address aligned (y + i rows of a runtime width d: the narrow
// route's later rows were 4 stores each in cuobjdump -sass).
__device__ __forceinline__ void store16(void* p, uint4 u) {
  asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w)
               : "memory");
}

__device__ __forceinline__ void store8(void* p, uint2 u) {
  asm volatile("st.global.v2.b32 [%0], {%1, %2};" ::"l"(p), "r"(u.x),
               "r"(u.y)
               : "memory");
}

// N floats as N consecutive T at p, one vector store (16-bit T packed
// in pairs, as to_bits2 rounds)
template <typename T, int N>
__device__ __forceinline__ void store_f(T* p, const float (&f)[N]) {
  if constexpr (sizeof(T) == 4) {
    static_assert(N == 4, "four floats a 16-byte store");
    store16(p, make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                          __float_as_uint(f[2]), __float_as_uint(f[3])));
  } else if constexpr (N == 8) {
    store16(p, make_uint4(to_bits2<T>(f[0], f[1]), to_bits2<T>(f[2], f[3]),
                          to_bits2<T>(f[4], f[5]), to_bits2<T>(f[6], f[7])));
  } else {
    static_assert(N == 4, "four 16-bit values an 8-byte store");
    store8(p, make_uint2(to_bits2<T>(f[0], f[1]), to_bits2<T>(f[2], f[3])));
  }
}

// Narrow rows: LR = 128 / E lanes a row, E elements a lane, so a warp
// holds 32 / LR rows a step; warp w of block b takes R steps of rows
// from ((b W + w) R) (32 / LR), every row's load issued before the first
// sum, the lane's E scale values beside them, held across the R steps.
// E = 8 (16-bit rows, x and the scale 16-byte aligned): one 16-byte
// load of x a row and vector loads of the scale in its type S (a load
// an element is 8 load instructions a lane, more than x's); E = 4 (any
// other narrow row):
// 4 elements a lane, the scale read element by element in its runtime
// dtype (S unused). Row sums by shuffles only.
template <typename T, typename S, int E, int R>
__global__ void __launch_bounds__(FWD_MAX_THREADS, 1)
    rmsnorm_fwd_narrow_kernel(const FwdArgs a) {
  constexpr int LR = NARROW_D / E;
  constexpr int RS = 32 / LR;  // rows a warp a step
  const int lane = threadIdx.x & 31, c = (lane % LR) * E;
  const int64_t row0 =
      ((int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * R * RS +
      lane / LR;  // this lane's rows: row0 + i RS
  constexpr int XP = 4 / sizeof(T);  // x elements a word
  constexpr int XW = E / XP;         // x words a lane: 2 or 4
  const bool on = c < a.d;
  const T* x = static_cast<const T*>(a.x) + row0 * a.xs + c;
  T* y = static_cast<T*>(a.y) + row0 * a.d + c;
  uint32_t xw[R][XW];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (on && row0 + i * RS < a.n)
      load_words<4 * XW>(x + i * RS * a.xs, xw[i]);
  }
  float s[E];
  if constexpr (E == 8) {
    constexpr int SP = 4 / sizeof(S);  // scale elements a word
    uint32_t sw[E / SP];
    if (on) {
#pragma unroll
      for (int q = 0; q < E / SP; q += 4)
        load_words<16>(static_cast<const S*>(a.s) + c + q * SP, sw + q);
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      s[e] = on ? from_bits<S>(sw[e / SP], e % SP) : 0.f;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      s[e] = on ? load_scale(a.s, c + e, a.s_dt) : 0.f;
  }
  float ss[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    ss[i] = 0.f;
    if (on && row0 + i * RS < a.n) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float f = from_bits<T>(xw[i][e / XP], e % XP);
        ss[i] = fmaf(f, f, ss[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) ss[i] = group_sum<LR>(ss[i]);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t row = row0 + i * RS;
    if (row < a.n) {  // the same for the row's lanes
      const float r = inv_rms(ss[i], a.inv_d, a.eps);
      if (on) {
        float o[E];
#pragma unroll
        for (int e = 0; e < E; ++e)
          o[e] = from_bits<T>(xw[i][e / XP], e % XP) * r * s[e];
        store_f<T, E>(y + i * RS * a.d, o);
      }
      if (a.rstd != nullptr && lane % LR == 0) a.rstd[row] = r;
    }
  }
}

// Wide rows: a row per group of W warps (L = 32 W lanes), in 16-byte
// chunks of CE elements: chunk j of the row at lane j % L, at most K a
// lane (FWD_LANE_VALUES values), every chunk's load and its scale's (in
// scale's type S, 16- or 8-byte pieces) issued before the sum, all held
// as raw 32-bit words and converted in registers. Lane sums in chunk
// order, then the warp's shuffle sum, then (W > 1) the group's warps in
// order through shared memory.
template <typename T, typename S, int W>
__global__ void __launch_bounds__(FWD_MAX_THREADS, 1)
    rmsnorm_fwd_wide_kernel(const FwdArgs a) {
  constexpr int CE = 16 / sizeof(T);     // elements a chunk
  constexpr int K = FWD_LANE_VALUES / CE;
  constexpr int L = 32 * W;
  constexpr int XP = 4 / sizeof(T);      // x elements a word
  constexpr int SP = 4 / sizeof(S);      // scale elements a word
  constexpr int SW = CE / SP;            // scale words a chunk: 2, 4 or 8
  __shared__ float red[FWD_MAX_THREADS / 32];
  const int t = threadIdx.x % L, g = threadIdx.x / L;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / L) + g;
  const int nc = a.d / CE;
  const bool live = row < a.n;
  const T* __restrict__ xr = static_cast<const T*>(a.x) + row * a.xs;
  const S* __restrict__ s = static_cast<const S*>(a.s);
  uint32_t xw[K][4], sw[K][SW];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = t + k * L;
    if (live && j < nc) load_words<16>(xr + j * CE, xw[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = t + k * L;
    if (live && j < nc) {
      if constexpr (SW == 2) {
        load_words<8>(s + j * CE, sw[k]);
      } else {
#pragma unroll
        for (int q = 0; q < SW / 4; ++q)
          load_words<16>(s + j * CE + q * 4 * SP, sw[k] + 4 * q);
      }
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (live && t + k * L < nc) {
#pragma unroll
      for (int e = 0; e < CE; ++e) {
        const float f = from_bits<T>(xw[k][e / XP], e % XP);
        ss = fmaf(f, f, ss);
      }
    }
  }
  ss = warp_sum(ss);
  if constexpr (W > 1) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) ss += red[g * W + w];
  }
  if (!live) return;
  const float r = inv_rms(ss, a.inv_d, a.eps);
  T* __restrict__ yr = static_cast<T*>(a.y) + row * a.d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = t + k * L;
    if (j < nc) {
      float o[CE];
#pragma unroll
      for (int e = 0; e < CE; ++e)
        o[e] = from_bits<T>(xw[k][e / XP], e % XP) * r *
               from_bits<S>(sw[k][e / SP], e % SP);
      store_f<T, CE>(yr + j * CE, o);
    }
  }
  if (a.rstd != nullptr && t == 0) a.rstd[row] = r;
}

// Any other width or alignment: a block per row, columns strided over
// the threads, the row read twice (its sum, then y).
template <typename T>
__global__ void __launch_bounds__(GENERAL_THREADS)
    rmsnorm_fwd_general_kernel(const FwdArgs a) {
  __shared__ float red[GENERAL_THREADS / 32];
  const int64_t row = blockIdx.x;
  const T* __restrict__ xr = static_cast<const T*>(a.x) + row * a.xs;
  float ss = 0.f;
  for (int c = threadIdx.x; c < a.d; c += blockDim.x) {
    const float f = to_f(xr[c]);
    ss = fmaf(f, f, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot += red[w];
  const float r = inv_rms(tot, a.inv_d, a.eps);
  T* __restrict__ yr = static_cast<T*>(a.y) + row * a.d;
  for (int c = threadIdx.x; c < a.d; c += blockDim.x)
    yr[c] = from_f<T>(to_f(xr[c]) * r * load_scale(a.s, c, a.s_dt));
  if (a.rstd != nullptr && threadIdx.x == 0) a.rstd[row] = r;
}

template <typename T, typename S>
void (*wide_kernel(int w))(FwdArgs) {
  return w == 1 ? rmsnorm_fwd_wide_kernel<T, S, 1>
                : rmsnorm_fwd_wide_kernel<T, S, 2>;
}

template <typename T, typename S, int E>
void (*narrow_kernel(int r))(FwdArgs) {
  switch (r) {
    case 1: return rmsnorm_fwd_narrow_kernel<T, S, E, 1>;
    case 2: return rmsnorm_fwd_narrow_kernel<T, S, E, 2>;
    case 4: return rmsnorm_fwd_narrow_kernel<T, S, E, 4>;
    default: return nullptr;
  }
}

// A plan word as the wrapper packs it (kernels/rmsnorm.py: FwdPlan.word,
// BwdPlan.word): the width, the route and the dtypes (0 = float32, 1 =
// bfloat16, 2 = float16) in the low 22 bits, each direction's block
// shape or grid above them, read by at()
struct PlanWord {
  int64_t w;
  __host__ int at(int shift, int bits) const {
    return (int)((w >> shift) & ((int64_t(1) << bits) - 1));
  }
  __host__ int d() const { return at(0, 16); }
  __host__ int route() const { return at(16, 2); }
  __host__ int x_dt() const { return at(18, 2); }
  __host__ int s_dt() const { return at(20, 2); }
};

// A forward plan (FwdPlan.word): `threads` a block of `rows` rows,
// `lanes` lanes a row
struct FwdPlan {
  int d, route, x_dt, s_dt, lanes, threads, rows;
};

__host__ FwdPlan unpack_fwd(int64_t w) {
  const PlanWord p{w};
  return FwdPlan{p.d(), p.route(), p.x_dt(), p.s_dt(), p.at(22, 9),
                 p.at(31, 9), p.at(40, 8)};
}

// The kernel of a forward plan (`threads` a block of `rows` rows, `lanes`
// lanes a row), or null when the plan does not fit its route or the
// width: a narrow block of W warps, 32 or (16-bit rows) 16 lanes a row,
// rows * lanes / threads (1, 2 or 4) steps of rows a warp; a wide
// block of rows groups of 32 (d <= 2048) or 64 lanes; a general block
// of one row.
template <typename T>
void (*fwd_kernel(const FwdPlan& p))(FwdArgs) {
  if (p.threads <= 0 || p.threads % 32 || p.threads > FWD_MAX_THREADS ||
      p.rows <= 0 || p.lanes <= 0)
    return nullptr;
  if (p.route == ROUTE_NARROW) {
    if (p.d > NARROW_D || p.d % 4 || (p.rows * p.lanes) % p.threads)
      return nullptr;
    const int r = p.rows * p.lanes / p.threads;
    if (p.lanes == 32) return narrow_kernel<T, float, 4>(r);  // S unused
    if constexpr (sizeof(T) == 2) {  // 8 elements a lane: 16-bit rows
      if (p.lanes != 16 || p.d % 8) return nullptr;
      if (p.s_dt == DT_BF16) return narrow_kernel<T, __nv_bfloat16, 8>(r);
      if (p.s_dt == DT_F16) return narrow_kernel<T, __half, 8>(r);
      if (p.s_dt == DT_F32) return narrow_kernel<T, float, 8>(r);
    }
    return nullptr;
  }
  if (p.route == ROUTE_WIDE) {
    if (p.d <= NARROW_D || p.d > WIDE_MAX_D || p.d % WIDE_E ||
        p.threads != p.rows * p.lanes ||
        p.lanes != (p.d > FWD_WIDE_WARP_D ? 64 : 32))
      return nullptr;
    const int w = p.lanes / 32;
    if (p.s_dt == DT_BF16) return wide_kernel<T, __nv_bfloat16>(w);
    if (p.s_dt == DT_F16) return wide_kernel<T, __half>(w);
    if (p.s_dt == DT_F32) return wide_kernel<T, float>(w);
    return nullptr;
  }
  if (p.route == ROUTE_GENERAL && p.threads == GENERAL_THREADS &&
      p.lanes == GENERAL_THREADS && p.rows == 1)
    return rmsnorm_fwd_general_kernel<T>;
  return nullptr;
}

template <typename T>
int fwd_launch(const FwdArgs& a, const FwdPlan& p, cudaStream_t stream) {
  void (*k)(FwdArgs) = fwd_kernel<T>(p);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  k<<<(unsigned)((a.n + p.rows - 1) / p.rows), p.threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// An empty kernel: what any launch costs the device
__global__ void launch_floor_kernel() {}

}  // namespace repro_torch

// How many blocks of a route fit on one SM at once (the most a
// cooperative launch's grid may hold an SM).
extern "C" int rmsnorm_bwd_resident(int route, int d, int x_dtype,
                                    int* blocks) {
  using namespace repro_torch;
  if (x_dtype == DT_F32) return resident<float>(route, d, blocks);
  if (x_dtype == DT_BF16) return resident<__nv_bfloat16>(route, d, blocks);
  if (x_dtype == DT_F16) return resident<__half>(route, d, blocks);
  return (int)cudaErrorInvalidValue;
}

// x (n, d) and dy (n, d) by row strides xs, dys (elements); rstd (n,)
// f32; dx (n, d) contiguous in x's dtype; ds (d,) in scale's dtype.
// `plan` packs the width, the route, the dtypes (0 = float32, 1 =
// bfloat16, 2 = float16; dy in x's), the grid (at most
// rmsnorm_bwd_resident blocks an SM) and the group
// (kernels/rmsnorm.py: BwdPlan.word); part: grid * d floats; ticket: two
// ints, zero when allocated (each launch leaves the first at zero).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int rmsnorm_bwd(const void* x, const void* s, const void* dy,
                           const float* rstd, void* dx, void* ds,
                           float* part, int* ticket, int64_t n, int64_t xs,
                           int64_t dys, int64_t plan, void* stream) {
  using namespace repro_torch;
  const PlanWord p{plan};
  const int d = p.d(), route = p.route(), x_dtype = p.x_dt();
  const int s_dtype = p.s_dt(), group = p.at(22, 12), grid = p.at(34, 24);
  if (n <= 0 || d <= 0 || grid <= 0 || group <= 0)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, s, dy, rstd, dx, ds, part, ticket, n, xs, dys, d, group,
                  s_dtype};
  auto st = static_cast<cudaStream_t>(stream);
  if (x_dtype == DT_F32) return launch<float>(a, route, grid, st);
  if (x_dtype == DT_BF16) return launch<__nv_bfloat16>(a, route, grid, st);
  if (x_dtype == DT_F16) return launch<__half>(a, route, grid, st);
  return (int)cudaErrorInvalidValue;
}

// x (n, d) by row stride xs (elements); s (d,); y (n, d) contiguous in
// x's dtype; rstd (n,) f32 or null (not written). `plan` packs the
// width, the route, the dtypes (0 = float32, 1 = bfloat16, 2 = float16)
// and the block's shape (kernels/rmsnorm.py: FwdPlan.word); the grid is
// ceil(n / rows). Returns the cudaError_t of the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* s, void* y,
                           float* rstd, int64_t n, int64_t xs, float eps,
                           int64_t plan, void* stream) {
  using namespace repro_torch;
  const FwdPlan p = unpack_fwd(plan);
  if (n <= 0 || p.d <= 0) return (int)cudaErrorInvalidValue;
  const FwdArgs a{x, s, y, rstd, n, xs, p.d, eps, 1.f / p.d, p.s_dt};
  auto st = static_cast<cudaStream_t>(stream);
  if (p.x_dt == DT_F32) return fwd_launch<float>(a, p, st);
  if (p.x_dt == DT_BF16) return fwd_launch<__nv_bfloat16>(a, p, st);
  if (p.x_dt == DT_F16) return fwd_launch<__half>(a, p, st);
  return (int)cudaErrorInvalidValue;
}

// An empty kernel on grid x threads: the device's floor under any launch
// (chip_smoke times it beside the forward)
extern "C" int launch_floor(int grid, int threads, void* stream) {
  using namespace repro_torch;
  launch_floor_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
