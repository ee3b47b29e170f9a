// Position masks shared by the port's attention kernels (flash_attention.cu,
// flash_attention_wgmma.cu and their backwards): the mask of JAX's
// chunked_attention (src/repro/models/layers.py) over int32 position vectors
// q_pos (S,) and k_pos (T,), shared by every batch row and head, where a
// kernel otherwise masks by index. Key t is visible to query s iff
//   k_pos[t] >= 0, k_pos[t] <= q_pos[s] (causal), k_pos[t] > q_pos[s] - window (window > 0).
// Under M-RoPE the vectors are the t stream, in which all of an image's
// tokens share one position, so a query may see later keys: a tile cannot be
// skipped or left unmasked by its indices. A tile is judged by the min and max
// positions of its rows and of its keys instead (`Range`): it is skipped only
// where no pair of it can be visible (`any_visible` false) and left unmasked
// only where every pair is (`all_visible`). A skipped or a masked tile leaves
// the online softmax and the gradients as they were bit for bit (a masked
// score gives p = 0 exactly), so the judgement moves work, never results.
// Each kernel source includes this header and compiles on its own
// (kernels/build.py hashes it with the source).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// min and max position over a tile's entries; lo > hi for a tile past the end
struct Range {
  int lo, hi;
};

__device__ __forceinline__ bool pos_visible(int qp, int kp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp) &&
         (window <= 0 || static_cast<int64_t>(kp) > static_cast<int64_t>(qp) - window);
}

// Whether some (query, key) pair of the two ranges may be visible: a necessary
// condition (each of the three terms holds for a visible pair).
__device__ __forceinline__ bool any_visible(Range q, Range k, int causal, int window) {
  return q.lo <= q.hi && k.lo <= k.hi && k.hi >= 0 && (!causal || k.lo <= q.hi) &&
         (window <= 0 || static_cast<int64_t>(k.hi) > static_cast<int64_t>(q.lo) - window);
}

// Whether every pair of the two (non-empty) ranges is visible.
__device__ __forceinline__ bool all_visible(Range q, Range k, int causal, int window) {
  return k.lo >= 0 && (!causal || k.hi <= q.lo) &&
         (window <= 0 || static_cast<int64_t>(k.lo) > static_cast<int64_t>(q.hi) - window);
}

// The range of pos[start .. start + count) within [0, len), reduced over
// the warp: every lane of the calling (whole) warp gets it.
__device__ __forceinline__ Range warp_range(const int* __restrict__ pos, int start, int count,
                                            int len) {
  const int lane = threadIdx.x % 32;
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
  for (int i = lane; i < count; i += 32) {
    if (start + i < len) {
      const int p = pos[start + i];
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return Range{lo, hi};
}

constexpr int kTileFull = 1 << 30;  // a listed tile's flag: every pair visible, no entry past the end
constexpr int kErrTileList = -3;    // the tile list does not fit in shared memory

// The tiles (of `tile` entries of `pos`, `len` long, `n_all` tiles) that
// some pair with the CTA's own range `own` may see, in order, into the
// shared-memory array `list` (n_all ints), each entry the tile's index, or'ed
// with kTileFull where every pair is visible and the tile is whole. `own_is_q`:
// the CTA's own entries are queries (the tiles keys), else the reverse. Every
// thread of the CTA calls it; it returns the count to all of them.
__device__ __forceinline__ int list_tiles(int* list, int* count, const int* __restrict__ pos,
                                          int tile, int n_all, int len, Range own, bool own_is_q,
                                          int causal, int window) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  for (int t = warp; t < n_all; t += n_warps) {
    const Range r = warp_range(pos, t * tile, tile, len);
    const Range q = own_is_q ? own : r, k = own_is_q ? r : own;
    int e = -1;
    if (any_visible(q, k, causal, window))
      e = t | (all_visible(q, k, causal, window) && (t + 1) * tile <= len ? kTileFull : 0);
    if (lane == 0) list[t] = e;
  }
  __syncthreads();
  if (warp == 0) {  // compact in place, in order: a chunk's writes land at or before its reads
    int base = 0;
    for (int c = 0; c < n_all; c += 32) {
      const int e = c + lane < n_all ? list[c + lane] : -1;
      const unsigned keep = __ballot_sync(0xffffffffu, e >= 0);
      __syncwarp();
      if (e >= 0) list[base + __popc(keep & ((1u << lane) - 1u))] = e;
      base += __popc(keep);
      __syncwarp();
    }
    if (lane == 0) *count = base;
  }
  __syncthreads();
  return *count;
}

}  // namespace
