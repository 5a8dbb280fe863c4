// RMSNorm backward (Hopper, sm_90a): dx and dscale in one launch.
//
// Replaces: the gradient of src/repro/kernels/rmsnorm.py:rmsnorm (the
// Pallas kernel _rmsnorm_kernel; the TPU package trains through XLA's
// autodiff of the inline norm). Plain versions:
// repro_torch.kernels.ref.rmsnorm_bwd_ref, and ref.rmsnorm_bwd_blocked,
// which partitions the rows and combines the dscale partials as this
// kernel does.
//
// What it computes, for rows x (n, d) read by row stride, dy (n, d) read
// by its own row stride, the forward's f32 rstd r (n,) and scale s (d,):
// with xhat = x r and g = dy s in f32,
//   dx = r (g - xhat mean(g xhat))        per row, in x's dtype,
//   dscale = sum over rows of dy xhat     in scale's dtype.
//
// What bounds it on the H100: bytes. x and dy are read once, dx written
// once (3 n d elements; 50 MB at the training block norm, 15 us at the
// memory rate); about 8 f32 operations an element are far below the
// card's ridge point. Each row is two reductions: the row's sum of
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
// - Three routes, picked by the wrapper (kernels/rmsnorm.py: bwd_plan):
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

}  // namespace repro_torch

// C entry point. Returns the cudaError_t of the launch (0 = success).
// x (n, d) and dy (n, d) by row strides xs, dys (elements); rstd (n,) f32;
// dx (n, d) contiguous in x's dtype; ds (d,) in scale's dtype; x_dtype /
// s_dtype: 0 = float32, 1 = bfloat16, 2 = float16 (dy in x's). route,
// grid and group from the wrapper's plan (grid at most
// rmsnorm_bwd_resident blocks an SM); part: grid * d floats; ticket: two
// ints, zero when allocated (each launch leaves the first at zero).
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

extern "C" int rmsnorm_bwd(const void* x, const void* s, const void* dy,
                           const float* rstd, void* dx, void* ds,
                           float* part, int* ticket, int64_t n, int d,
                           int64_t xs, int64_t dys, int route, int grid,
                           int group, int x_dtype, int s_dtype,
                           void* stream) {
  using namespace repro_torch;
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
