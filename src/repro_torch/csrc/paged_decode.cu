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
// What bounds it on the H100: bytes, and the latency of reading them.
// Each (slot, kv head) reads its live history once, (idx+1) rows of 2*D
// pool elements, and does 4*D flops per row and query head: at G =
// Hq/Hkv = 2 that is about one flop per byte, far below the ~295
// flop/byte ridge of the card. At the serving shapes (8 slots, 8 kv
// heads, ~150 rows) a call moves ~10 MB: 3 us at the memory rate, if
// enough blocks keep loads in flight.
//
// What the design does about it: the decode is the split-history kernel
// of paged_split.cuh with a window of one row in store mode. The history
// is cut into splits of 2 pages (6 at the serving table width of 11
// pages: 384 blocks instead of one per (kv head, slot)), each split
// streamed into shared memory by cp.async with all its rows in flight,
// one warp per history row with the G query rows in registers, and the
// splits' partials combined in split order by the last block to finish
// (deterministic, no float atomics). The split that holds idx splices in
// the new row and stores it.
#include <cstdint>

#include "paged_split.cuh"

namespace repro_torch {
namespace {

template <typename T, typename PT, int EPL, int NQ>
__global__ void __launch_bounds__(SPLIT_NT)
    paged_decode_split_kernel(const SplitArgs a) {
  split_attend<T, PT, EPL, NQ>(a);
}

template <typename T, typename PT, int NQ>
int launch(const SplitArgs& a, int B, cudaStream_t s) {
  switch (split_epl(a.D)) {
    case 1:
      return split_launch<PT>(paged_decode_split_kernel<T, PT, 1, NQ>, a,
                              B, s);
    case 2:
      return split_launch<PT>(paged_decode_split_kernel<T, PT, 2, NQ>, a,
                              B, s);
    case 4:
      return split_launch<PT>(paged_decode_split_kernel<T, PT, 4, NQ>, a,
                              B, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename PT>
int launch(const SplitArgs& a, int B, cudaStream_t s) {
  return split_nq(1, a.Hq / a.Hkv) == 4 ? launch<T, PT, 4>(a, B, s)
                                        : launch<T, PT, SPLIT_NQ>(a, B, s);
}

}  // namespace
}  // namespace repro_torch

// Workspace of a paged_decode call: sizes[0] ticket ints (zeroed, after
// the (B, 3) counters in the same buffer), sizes[1] partial floats.
extern "C" int paged_decode_workspace(int B, int Hq, int Hkv, int D, int M,
                                      int64_t* sizes) {
  repro_torch::split_workspace(B, 1, Hq, Hkv, D, M, sizes);
  return 0;
}

// C entry point. Returns the cudaError_t of the launch (0 = success).
// act_dtype / pool_dtype: 0 = float32, 1 = bfloat16. D a multiple of 8, at
// most 32, or 64 or 128; float operands 16-byte aligned. cnt: the (B, 3)
// counters followed by the tickets, zeroed; part: the partials
// (paged_decode_workspace).
extern "C" int paged_decode(const void* q, const void* k_new,
                            const void* v_new, void* pool_k, void* pool_v,
                            const int* pt, const int* idx, void* out,
                            float* lse, int* cnt, float* part, int B, int Hq,
                            int Hkv, int D, int ps, int M, float scale,
                            float tol, int act_dtype, int pool_dtype,
                            void* stream) {
  using namespace repro_torch;
  if (B == 0) return 0;
  SplitArgs a{q, k_new, v_new, pool_k, pool_v, pt, idx, out, lse, cnt, part,
              cnt + 3 * B, 1, Hq, Hkv, D, ps, M, split_count(M),
              split_chunks(1, Hq / Hkv), 1, scale * LOG2E, tol};
  auto s = static_cast<cudaStream_t>(stream);
  if (act_dtype == DT_F32 && pool_dtype == DT_F32)
    return launch<float, float>(a, B, s);
  if (act_dtype == DT_F32 && pool_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(a, B, s);
  if (act_dtype == DT_BF16 && pool_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(a, B, s);
  if (act_dtype == DT_BF16 && pool_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
