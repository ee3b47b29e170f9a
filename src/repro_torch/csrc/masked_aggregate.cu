// Masked weighted client average (the paper's Eq. 1 server reduction) for
// sm_90a — the port's aggregation kernel, one launch for all the leaves of
// a round.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/masked_aggregate/kernel.py:masked_aggregate_kernel
//   (_agg_kernel)
//
// What it computes, for each leaf i of a table: x_i (C, P_i) of float32 or
// bfloat16 (one dtype a launch), its row r_i of a weight matrix w (R, C)
// float32, an optional snapshot s_i (C, P_i) of x's type, and an optional
// fallback_i or base_i (P_i,) of x's type:
//   d[c, p] = s_i ? x_i[c, p] - s_i[c, p] : x_i[c, p]
//   total   = sum_c w[r_i, c]
//   mean[p] = (sum_c w[r_i, c] * d[c, p]) / max(total, 1e-12)
//   out_i[p] = total > 0 ? mean[p] : fallback_i[p]      (0 without one)
//   out_i[p] = base_i[p] + (total > 0 ? mean[p] : 0)    (a base leaf)
// accumulated in float32 and written in x's type. The aggregators pass one
// row w = selected * |d_i| for every leaf (fedavg, R = 1), or a row per
// layer, that times the layer's share mask, with the previous global layer
// as the fallbacks (masked-partial, R = L). The staleness merge of the
// async scheduler (the JAX package's core/aggregation.staleness_weighted_merge,
// computed there in jnp) passes each landing slot's transmitted parameters
// as x, its dispatch snapshot as s, the row per layer
// w = landed * |d_i| * s(staleness) * share, and the current global layer as
// the base: g + sum_c w_c (x_c - s_c) / sum_c w_c, one launch an event.
// The subtraction is one IEEE rounding in float32, as the JAX package's
// a - r before its product, so for float32 leaves the fused form is bitwise
// the unfused one (the deltas formed first, then aggregated with no
// snapshot). Not for bf16 leaves: there the unfused deltas are rounded to
// bf16 before the kernel reads them, the fused ones are not.
//
// Bound on an H100 (3.35 TB/s): bytes. The kernel reads x once (4 or 2 B an
// element) and writes P outputs, against 2 flops per x element; it reads the
// fallback only where the weights sum to 0. At K = 30 clients the 8 har-mlp
// leaves are 8.31 M client elements: 33.2 MB of x plus 1.1 MB of output,
// 34.3 MB or 10.3 us a round when some client carries weight. The staleness
// merge reads the snapshots too (another 33.2 MB) and the base (1.1 MB):
// 68.7 MB or 20.5 us an event at M = 30 slots.
//
// Design: the TPU kernel holds a (C, 512) tile in VMEM and sums over C in
// one step; here blocks run in parallel with no carried state, so the C
// loop runs inside each thread instead. One launch covers every leaf: the
// leaves' pointers, sizes, weight rows and first blocks travel in a table
// passed as a __grid_constant__ parameter, each block finds its leaf in it
// (no block straddles two leaves), so a round costs one launch and one
// tail instead of one per leaf (4 of har-mlp's 8 leaves are biases of 6-256
// elements). Inside a leaf a thread owns 4 neighbouring columns, so a warp
// reads 128 consecutive elements of a client row per step (one 16-byte
// load a thread where aligned), and walks the rows c in ascending order,
// accumulating in float32 registers. It issues the loads of 4 rows before
// it adds them, so each thread keeps 4 loads in flight, and blocks are 64
// threads (256 columns), so even a 65,536-element leaf spreads over all 132
// SMs. The leaf's weight row is staged in shared memory 1024 at a time, and
// each thread sums it itself in the same ascending order, so every thread
// sees the same total with no second pass. Products and sums are rounded
// one at a time (__fmul_rn, __fadd_rn: no fused multiply-add) and the
// division is IEEE (__fdiv_rn), so every leaf equals the plain version's
// ascending loop on that leaf exactly; the order differs from jnp's
// reduction, hence a stated ulp bound against the JAX package.
//
// Edge mode (two-level client -> edge -> server aggregation, the JAX
// package's core/aggregation._weighted_mean with edge_ids, computed there
// in jnp with segment_sum): with E > 1 edge groups the table carries one
// launch-level pair for every leaf, `order` (C,) int32, the lanes sorted
// stably by edge id (built on the device by the wrapper), and `edge` (C,),
// the edge id of each lane in that order. Each thread walks the lanes in
// that order, accumulating an edge's partial numerator and weight total
// (products and sums rounded one at a time, as above) and adding the
// partials into the running sums when the edge id changes, so the server
// sums the E partials in ascending edge order:
//   num = sum_e (sum_{c in e, ascending} w_c d_c),  total likewise,
// and the epilogues are the flat mode's. The weight row is staged in
// shared memory in the permuted order, with the lane ids and edge ids
// beside it. Edge mode is its own kernel, so the flat kernel (E <= 1)
// keeps its code, its registers and its 4 KB of shared memory; it reads x
// once as well, so its bound is the flat mode's: 10.3 us a round at K = 30
// (21.5 us at K = 64), 20.5 us a merge at M = 30.
//
// Partial and combine modes (cohort lanes sharded over the D ranks of a
// process group, the JAX package's core/aggregation._weighted_mean with
// axis_name, computed there as a local sum and a psum): a partial leaf
// (mode kModePartial) runs the flat or the edge sums above over this rank's
// lanes and stops before the divide: it writes its float32 numerator into
// this rank's row of a flat (D, width) float32 buffer, and the leaf that
// owns its weight row writes the row's total beside the numerators. After
// an all-reduce has filled every rank's row, the combine kernel (a table
// with slot_stride set) reads the D slots of each leaf and total in
// ascending rank order, sums them from 0 (one rounding an add), divides and
// applies the epilogue of the flat mode (fallback or base). A rank's
// partial is what an edge group's partial is in the edge mode, and the
// combine is its second level, so the two launches give bitwise the edge
// mode with edge_ids = lane / (K / D) and E = D. Bound on an H100: bytes;
// the partial reads this rank's x (K/D lanes) once and writes the leaves'
// P numerators, 10.3 us / D + 1.1 MB a round for har-mlp at K = 30; the
// combine reads D x 1.1 MB of slots and writes 1.1 MB, 0.66 us at D = 1.
//
// Built by nvcc into a shared library with a C interface
// (repro_torch/kernels/build.py); the Python wrapper in
// repro_torch/kernels/masked_aggregate/ops.py launches it on torch's
// current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kCols = 4;
constexpr int kWeightChunk = 1024;
// leaves a launch: the table is 64 x 56 + 48 = 3,632 bytes, inside the
// classic 4 KB kernel-parameter limit (no CUDA 12.1 large-parameter path
// needed): the fallback, the base and a partial leaf's total slot share one
// pointer, told apart by mode
constexpr int kMaxLeaves = 64;
constexpr int kModeFallback = 0;  // total > 0 ? mean : fallback (0 if null)
constexpr int kModeBase = 1;      // base + (total > 0 ? mean : 0)
constexpr int kModePartial = 2;   // the float32 numerator, and the row's total

// One leaf of a launch; the Python wrapper fills the same layout (ctypes).
struct Leaf {
  const void* x;         // (C, cols), x's dtype; combine: slot 0 of the numerator
  const void* snap;      // (C, cols) subtracted from x, or null; combine: slot 0
                         // of the leaf's row total
  const void* other;     // (cols,): the fallback (null: zeros) or the base;
                         // partial: the row's total slot (null: another leaf's)
  void* out;             // (cols,); partial: this rank's numerator slot (float32)
  int64_t cols;
  int64_t block0;        // the leaf's first block; its blocks are ceil(cols / 256)
  int32_t row;           // its row of the weight matrix
  int32_t mode;          // kModeFallback or kModeBase
};

struct Table {
  Leaf leaf[kMaxLeaves];
  const float* w;        // (R, C) float32, row-major
  int n_leaves;
  int c_rows;            // C
  const int32_t* order;  // edge mode: (C,) lanes sorted stably by edge id; null: flat
  const int32_t* edge;   // edge mode: (C,) the edge id of each lane of `order`
  int n_edges;           // E (> 1 in edge mode)
  int pad;
  int64_t slot_stride;   // combine: float32 elements from one rank's slot to the
                         // next (c_rows is then the number of slots D); 0: not combine
};
static_assert(sizeof(Leaf) == 56 && sizeof(Table) == 3632 && sizeof(Table) <= 4096,
              "the table must stay inside the classic 4 KB kernel-parameter limit");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Loads kCols neighbouring elements starting at p (all in range) as float.
__device__ __forceinline__ void load_cols(const float* p, float v[kCols]) {
  if ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    for (int k = 0; k < kCols; ++k) v[k] = p[k];
  }
}

__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float v[kCols]) {
  if ((reinterpret_cast<uintptr_t>(p) & 7u) == 0) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&t);
    for (int k = 0; k < kCols; ++k) v[k] = __bfloat162float(h[k]);
  } else {
    for (int k = 0; k < kCols; ++k) v[k] = __bfloat162float(p[k]);
  }
}

// The epilogues: the weighted mean, the fallback where the weights sum to
// 0, or the base plus the mean (merge); written in x's type. A partial leaf
// writes its float32 sums instead (the thread of column 0 the row's total).
template <typename T>
__device__ __forceinline__ void write_out(const Leaf& leaf, const float acc[kCols], float total,
                                          int64_t p0) {
  if (leaf.mode == kModePartial) {
    float* __restrict__ num = static_cast<float*>(leaf.out);
    for (int k = 0; k < kCols && p0 + k < leaf.cols; ++k) num[p0 + k] = acc[k];
    if (p0 == 0 && leaf.other) *static_cast<float*>(const_cast<void*>(leaf.other)) = total;
    return;
  }
  const T* __restrict__ other = static_cast<const T*>(leaf.other);
  T* __restrict__ out = static_cast<T*>(leaf.out);
  const float denom = fmaxf(total, 1e-12f);
  for (int k = 0; k < kCols && p0 + k < leaf.cols; ++k) {
    float r;
    if (leaf.mode == kModeBase) {
      r = __fadd_rn(to_f32(other[p0 + k]), total > 0.0f ? __fdiv_rn(acc[k], denom) : 0.0f);
    } else if (total > 0.0f) {
      r = __fdiv_rn(acc[k], denom);
    } else {
      r = other ? to_f32(other[p0 + k]) : 0.0f;
    }
    out[p0 + k] = from_f32<T>(r);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_aggregate_kernel(const __grid_constant__ Table table) {
  __shared__ float w_s[kWeightChunk];
  int li = 0;  // this block's leaf
  while (li + 1 < table.n_leaves && blockIdx.x >= table.leaf[li + 1].block0) ++li;
  const Leaf& leaf = table.leaf[li];
  const T* __restrict__ x = static_cast<const T*>(leaf.x);
  const T* __restrict__ snap = static_cast<const T*>(leaf.snap);
  const float* __restrict__ w = table.w + leaf.row * table.c_rows;
  const int c_rows = table.c_rows;
  const int64_t p_cols = leaf.cols;

  const int64_t p0 = ((blockIdx.x - leaf.block0) * kThreads + threadIdx.x) * kCols;
  const bool full = p0 + kCols <= p_cols;
  float acc[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
  float total = 0.0f;
  for (int c0 = 0; c0 < c_rows; c0 += kWeightChunk) {
    const int m = c_rows - c0 < kWeightChunk ? c_rows - c0 : kWeightChunk;
    __syncthreads();  // the previous chunk's weights are no longer read
    for (int i = threadIdx.x; i < m; i += kThreads) w_s[i] = w[c0 + i];
    __syncthreads();
    int c = 0;
    if (full) {
      // 4 rows' loads in flight (8 with a snapshot), then the adds in
      // ascending row order
      for (; c + 4 <= m; c += 4) {
        const int64_t off = static_cast<int64_t>(c0 + c) * p_cols + p0;
        float v[4][kCols];
        for (int r = 0; r < 4; ++r) load_cols(x + off + r * p_cols, v[r]);
        if (snap) {
          float sv[4][kCols];
          for (int r = 0; r < 4; ++r) load_cols(snap + off + r * p_cols, sv[r]);
          for (int r = 0; r < 4; ++r)
            for (int k = 0; k < kCols; ++k) v[r][k] = __fsub_rn(v[r][k], sv[r][k]);
        }
        for (int r = 0; r < 4; ++r) {
          const float wc = w_s[c + r];
          total = __fadd_rn(total, wc);
          for (int k = 0; k < kCols; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wc, v[r][k]));
        }
      }
    }
    for (; c < m; ++c) {
      const float wc = w_s[c];
      total = __fadd_rn(total, wc);
      if (p0 >= p_cols) continue;
      const int64_t off = static_cast<int64_t>(c0 + c) * p_cols + p0;
      float v[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (full) {
        load_cols(x + off, v);
      } else {
        for (int k = 0; p0 + k < p_cols; ++k) v[k] = to_f32(x[off + k]);
      }
      if (snap) {
        float sv[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (full) {
          load_cols(snap + off, sv);
        } else {
          for (int k = 0; p0 + k < p_cols; ++k) sv[k] = to_f32(snap[off + k]);
        }
        for (int k = 0; k < kCols; ++k) v[k] = __fsub_rn(v[k], sv[k]);
      }
      for (int k = 0; k < kCols; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wc, v[k]));
    }
  }
  if (p0 >= p_cols) return;
  write_out<T>(leaf, acc, total, p0);
}

// Edge mode: the lanes walked in `order`, each edge's partial sums added
// into the running sums in ascending edge order (see the header).
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_aggregate_edges_kernel(const __grid_constant__ Table table) {
  __shared__ float w_s[kWeightChunk];
  __shared__ int32_t lane_s[kWeightChunk];
  __shared__ int32_t edge_s[kWeightChunk];
  int li = 0;  // this block's leaf
  while (li + 1 < table.n_leaves && blockIdx.x >= table.leaf[li + 1].block0) ++li;
  const Leaf& leaf = table.leaf[li];
  const T* __restrict__ x = static_cast<const T*>(leaf.x);
  const T* __restrict__ snap = static_cast<const T*>(leaf.snap);
  const float* __restrict__ w = table.w + leaf.row * table.c_rows;
  const int c_rows = table.c_rows;
  const int64_t p_cols = leaf.cols;

  const int64_t p0 = ((blockIdx.x - leaf.block0) * kThreads + threadIdx.x) * kCols;
  const bool full = p0 + kCols <= p_cols;
  float acc[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
  float part[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
  float total = 0.0f;
  float part_total = 0.0f;
  int cur = -1;  // the edge whose partials are open
  // closes the open edge: its partials join the running sums
  auto next_edge = [&](int e) {
    if (cur >= 0) {
      total = __fadd_rn(total, part_total);
      for (int k = 0; k < kCols; ++k) acc[k] = __fadd_rn(acc[k], part[k]);
    }
    part_total = 0.0f;
    for (int k = 0; k < kCols; ++k) part[k] = 0.0f;
    cur = e;
  };
  for (int c0 = 0; c0 < c_rows; c0 += kWeightChunk) {
    const int m = c_rows - c0 < kWeightChunk ? c_rows - c0 : kWeightChunk;
    __syncthreads();  // the previous chunk's staging is no longer read
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const int32_t lane = table.order[c0 + i];
      lane_s[i] = lane;
      edge_s[i] = table.edge[c0 + i];
      w_s[i] = w[lane];
    }
    __syncthreads();
    int c = 0;
    if (full) {
      // 4 rows' loads in flight (8 with a snapshot), then the adds in order
      for (; c + 4 <= m; c += 4) {
        float v[4][kCols];
        for (int r = 0; r < 4; ++r)
          load_cols(x + static_cast<int64_t>(lane_s[c + r]) * p_cols + p0, v[r]);
        if (snap) {
          float sv[4][kCols];
          for (int r = 0; r < 4; ++r)
            load_cols(snap + static_cast<int64_t>(lane_s[c + r]) * p_cols + p0, sv[r]);
          for (int r = 0; r < 4; ++r)
            for (int k = 0; k < kCols; ++k) v[r][k] = __fsub_rn(v[r][k], sv[r][k]);
        }
        for (int r = 0; r < 4; ++r) {
          if (edge_s[c + r] != cur) next_edge(edge_s[c + r]);
          const float wc = w_s[c + r];
          part_total = __fadd_rn(part_total, wc);
          for (int k = 0; k < kCols; ++k) part[k] = __fadd_rn(part[k], __fmul_rn(wc, v[r][k]));
        }
      }
    }
    for (; c < m; ++c) {
      if (edge_s[c] != cur) next_edge(edge_s[c]);
      const float wc = w_s[c];
      part_total = __fadd_rn(part_total, wc);
      if (p0 >= p_cols) continue;
      const int64_t off = static_cast<int64_t>(lane_s[c]) * p_cols + p0;
      float v[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (full) {
        load_cols(x + off, v);
      } else {
        for (int k = 0; p0 + k < p_cols; ++k) v[k] = to_f32(x[off + k]);
      }
      if (snap) {
        float sv[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (full) {
          load_cols(snap + off, sv);
        } else {
          for (int k = 0; p0 + k < p_cols; ++k) sv[k] = to_f32(snap[off + k]);
        }
        for (int k = 0; k < kCols; ++k) v[k] = __fsub_rn(v[k], sv[k]);
      }
      for (int k = 0; k < kCols; ++k) part[k] = __fadd_rn(part[k], __fmul_rn(wc, v[k]));
    }
  }
  next_edge(-1);
  if (p0 >= p_cols) return;
  write_out<T>(leaf, acc, total, p0);
}

// Combine mode: each leaf's D numerator slots and its row's D total slots
// summed in ascending rank order, then the flat mode's epilogues.
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_aggregate_combine_kernel(const __grid_constant__ Table table) {
  int li = 0;  // this block's leaf
  while (li + 1 < table.n_leaves && blockIdx.x >= table.leaf[li + 1].block0) ++li;
  const Leaf& leaf = table.leaf[li];
  const float* __restrict__ num = static_cast<const float*>(leaf.x);
  const float* __restrict__ tot = static_cast<const float*>(leaf.snap);
  const int64_t stride = table.slot_stride;
  const int64_t p_cols = leaf.cols;
  const int64_t p0 = ((blockIdx.x - leaf.block0) * kThreads + threadIdx.x) * kCols;
  if (p0 >= p_cols) return;
  const bool full = p0 + kCols <= p_cols;
  float acc[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
  float total = 0.0f;
  for (int d = 0; d < table.c_rows; ++d) {
    const float* slot = num + d * stride + p0;
    float v[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (full) {
      load_cols(slot, v);
    } else {
      for (int k = 0; p0 + k < p_cols; ++k) v[k] = slot[k];
    }
    total = __fadd_rn(total, tot[d * stride]);
    for (int k = 0; k < kCols; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
  }
  write_out<T>(leaf, acc, total, p0);
}

}  // namespace

extern "C" {

// Aggregates every leaf of the Table at table_ptr in one launch of `blocks`
// blocks (the sum of the leaves' ceil(cols / 256)); a table with `order`
// set launches the edge-mode kernel, one with slot_stride set the combine
// kernel. dtype (x's, the combine's output's): 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 = launched).
int repro_masked_aggregate(const void* table_ptr, int64_t blocks, int dtype, void* stream) {
  const Table* table = static_cast<const Table*>(table_ptr);
  if (table->n_leaves < 1 || table->n_leaves > kMaxLeaves || blocks < 1 || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool combine = table->slot_stride > 0;
  const bool edges = table->order != nullptr;
  for (int i = 0; i < table->n_leaves; ++i) {
    const Leaf& leaf = table->leaf[i];
    if ((leaf.mode != kModeFallback && leaf.mode != kModeBase && leaf.mode != kModePartial) ||
        (leaf.mode == kModeBase && leaf.other == nullptr) ||
        (combine && (leaf.mode == kModePartial || leaf.x == nullptr || leaf.snap == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (edges && (combine || table->edge == nullptr || table->n_edges < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (combine && table->c_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (combine) {
    if (dtype == 0) {
      masked_aggregate_combine_kernel<float><<<grid, kThreads, 0, s>>>(*table);
    } else if (dtype == 1) {
      masked_aggregate_combine_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(*table);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 0) {
    if (edges) {
      masked_aggregate_edges_kernel<float><<<grid, kThreads, 0, s>>>(*table);
    } else {
      masked_aggregate_kernel<float><<<grid, kThreads, 0, s>>>(*table);
    }
  } else if (dtype == 1) {
    if (edges) {
      masked_aggregate_edges_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(*table);
    } else {
      masked_aggregate_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(*table);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
