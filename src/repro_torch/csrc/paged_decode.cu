// Paged-attention decode with store-site waste counters (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py:paged_decode_attention
// (the Pallas kernel _decode_kernel). Plain version:
// repro_torch.kernels.ref.paged_decode_ref.
//
// What it computes, per slot b with write position idx[b] >= 0: one new
// query token attends the slot's paged K/V history [0, idx] through the
// page table pt (unmapped pages masked), with the new K/V row spliced in
// at idx after its round trip through the pool dtype; the row is stored
// into its page (dropped when the page is unmapped or past the table);
// and the store is counted as [stored, silent, dropped] elements against
// the pool content it overwrites (tol 0 = exact). Idle slots (idx < 0)
// attend and store nothing: out = 0, lse = NEG_INF. Unlike the Pallas
// kernel, which left the one-row scatter to the caller, this kernel does
// the store itself (the plain version's paged_update), so a decode tick
// needs no separate scatter.
//
// What bounds it on the H100: bytes. Each (slot, kv head) reads its live
// history once, (idx+1) rows of 2*D pool elements, and does 4*D flops per
// row and query head: at G = Hq/Hkv = 2 that is about one flop per byte,
// far below the ~295 flop/byte ridge of the card.
//
// What the design does about it: one block per (kv head, slot) serves all
// G query heads of the group, so every history page is read from device
// memory once (the Pallas grid (B, Hq, M) read it once per query head).
// The block walks the mapped pages itself (the TPU's sequential page axis
// with its scratch carry becomes a loop) in chunks of CH rows staged in
// shared memory as f32, with an online softmax in f32. Simple first: no
// TMA, no wgmma, no split of long histories over several blocks (at B=8,
// Hkv=8 only 64 of 132 SMs work), which are later work.
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int NT = 128;  // threads per block
constexpr int CH = 16;   // history rows staged per shared-memory chunk

template <typename T, typename PT>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q,        // (B, Hq, D)
    const T* __restrict__ k_new,    // (B, Hkv, D)
    const T* __restrict__ v_new,    // (B, Hkv, D)
    PT* __restrict__ pool_k,        // (P, ps, Hkv, D)
    PT* __restrict__ pool_v,        // (P, ps, Hkv, D)
    const int* __restrict__ pt,     // (B, M), -1 = unmapped
    const int* __restrict__ idx,    // (B,), < 0 = idle
    T* __restrict__ out,            // (B, Hq, D)
    float* __restrict__ lse,        // (B, Hq)
    int* __restrict__ cnt,          // (B, 3), zeroed by the caller
    int Hq, int Hkv, int D, int ps, int M, float scale, float tol) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarp = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;               // (G, D)
  float* acc_s = q_s + G * D;      // (G, D)
  float* k_s = acc_s + G * D;      // (CH, D)
  float* v_s = k_s + CH * D;       // (CH, D)
  float* p_s = v_s + CH * D;       // (G, CH) scores, then probabilities
  float* m_s = p_s + G * CH;       // (G,) running max
  float* l_s = m_s + G;            // (G,) running denominator
  float* a_s = l_s + G;            // (G,) rescale of the last step

  const int pos_new = idx[b];
  const int64_t q_off = ((int64_t)b * Hq + (int64_t)h * G) * D;
  const int64_t new_off = ((int64_t)b * Hkv + h) * D;

  for (int t = tid; t < G * D; t += blockDim.x) {
    q_s[t] = to_f(q[q_off + t]);
    acc_s[t] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  __syncthreads();

  if (pos_new >= 0) {
    const int last_page = min(pos_new / ps, M - 1);
    for (int m = 0; m <= last_page; ++m) {
      const int page = pt[(int64_t)b * M + m];
      if (page < 0) continue;  // unmapped: masked out (block-uniform)
      for (int c0 = 0; c0 < ps && m * ps + c0 <= pos_new; c0 += CH) {
        const int p0 = m * ps + c0;  // logical position of chunk row 0
        const int n = min(CH, ps - c0);
        for (int t = tid; t < n * D; t += blockDim.x) {
          const int r = t / D, d = t - r * D;
          float kv, vv;
          if (p0 + r == pos_new) {
            // the new row as the pool stores it, read back as activations
            kv = round_to<T>(round_to<PT>(to_f(k_new[new_off + d])));
            vv = round_to<T>(round_to<PT>(to_f(v_new[new_off + d])));
          } else {
            const int64_t off =
                (((int64_t)page * ps + c0 + r) * Hkv + h) * D + d;
            kv = round_to<T>(to_f(pool_k[off]));
            vv = round_to<T>(to_f(pool_v[off]));
          }
          k_s[t] = kv;
          v_s[t] = vv;
        }
        __syncthreads();
        // scores: one warp per (head, row) dot product
        for (int pr = warp; pr < G * n; pr += nwarp) {
          const int g = pr / n, r = pr - g * n;
          float s = 0.f;
          for (int d = lane; d < D; d += 32) s += q_s[g * D + d] * k_s[r * D + d];
          s = warp_sum(s);
          if (lane == 0) p_s[g * CH + r] = (p0 + r <= pos_new) ? s * scale : -INFINITY;
        }
        __syncthreads();
        softmax_step(p_s, CH, n, m_s, l_s, a_s, G);
        __syncthreads();
        accumulate(acc_s, p_s, CH, v_s, n, a_s, G, D);
        __syncthreads();
      }
    }

    // store site: this block owns the (slot, kv head) row at idx
    const int page_i = pos_new / ps;
    const int page = page_i < M ? pt[(int64_t)b * M + page_i] : -1;
    if (page >= 0) {
      const int64_t off =
          (((int64_t)page * ps + pos_new % ps) * Hkv + h) * D;
      int sil = 0;
      for (int d = tid; d < D; d += blockDim.x) {
        const PT nk = from_f<PT>(to_f(k_new[new_off + d]));
        const PT nv = from_f<PT>(to_f(v_new[new_off + d]));
        sil += is_silent(to_f(pool_k[off + d]), to_f(nk), tol);
        sil += is_silent(to_f(pool_v[off + d]), to_f(nv), tol);
        pool_k[off + d] = nk;
        pool_v[off + d] = nv;
      }
      sil = warp_sum(sil);
      if (lane == 0 && sil) atomicAdd(&cnt[b * 3 + 1], sil);
      if (tid == 0) atomicAdd(&cnt[b * 3 + 0], 2 * D);
    } else if (tid == 0) {
      atomicAdd(&cnt[b * 3 + 2], 2 * D);
    }
  }

  for (int t = tid; t < G * D; t += blockDim.x) {
    const float l = l_s[t / D];
    out[q_off + t] = from_f<T>(l > 0.f ? acc_s[t] / l : 0.f);
  }
  for (int g = tid; g < G; g += blockDim.x) {
    const float l = l_s[g];
    lse[(int64_t)b * Hq + h * G + g] = l > 0.f ? m_s[g] + logf(l) : NEG_INF;
  }
}

template <typename T, typename PT>
int launch(const void* q, const void* k_new, const void* v_new, void* pool_k,
           void* pool_v, const int* pt, const int* idx, void* out, float* lse,
           int* cnt, int B, int Hq, int Hkv, int D, int ps, int M,
           float scale, float tol, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * (2 * G * D + 2 * CH * D + G * CH + 3 * G);
  auto kernel = paged_decode_kernel<T, PT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(Hkv, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<PT*>(pool_k),
      static_cast<PT*>(pool_v), pt, idx, static_cast<T*>(out), lse, cnt, Hq,
      Hkv, D, ps, M, scale, tol);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entry point. Returns the cudaError_t of the launch (0 = success).
// act_dtype / pool_dtype: 0 = float32, 1 = bfloat16.
extern "C" int paged_decode(const void* q, const void* k_new,
                            const void* v_new, void* pool_k, void* pool_v,
                            const int* pt, const int* idx, void* out,
                            float* lse, int* cnt, int B, int Hq, int Hkv,
                            int D, int ps, int M, float scale, float tol,
                            int act_dtype, int pool_dtype, void* stream) {
  using namespace repro_torch;
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (act_dtype == DT_F32 && pool_dtype == DT_F32)
    return launch<float, float>(q, k_new, v_new, pool_k, pool_v, pt, idx, out,
                                lse, cnt, B, Hq, Hkv, D, ps, M, scale, tol, s);
  if (act_dtype == DT_F32 && pool_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(q, k_new, v_new, pool_k, pool_v, pt,
                                         idx, out, lse, cnt, B, Hq, Hkv, D, ps,
                                         M, scale, tol, s);
  if (act_dtype == DT_BF16 && pool_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(q, k_new, v_new, pool_k, pool_v, pt,
                                        idx, out, lse, cnt, B, Hq, Hkv, D, ps,
                                        M, scale, tol, s);
  if (act_dtype == DT_BF16 && pool_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_new, v_new, pool_k,
                                                pool_v, pt, idx, out, lse, cnt,
                                                B, Hq, Hkv, D, ps, M, scale,
                                                tol, s);
  return (int)cudaErrorInvalidValue;
}
