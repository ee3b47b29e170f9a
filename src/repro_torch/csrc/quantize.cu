// Per-block absmax int8/int4 quantization with stochastic rounding, and its
// inverse, for sm_90a — the port's wire-codec kernels.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   src/repro/kernels/quantize/kernel.py:quantize_kernel   (_quant_kernel)
//   src/repro/kernels/quantize/kernel.py:dequantize_kernel (_dequant_kernel)
//
// What it computes, per row r of a (R, n) batch and per block b of bp
// elements of that row (bp = min(block, max(n, 8)), nb = ceil(n / bp), as
// the JAX wrapper's quant_blocks):
//   scale[r, b] = max(max|x[r, block b]|, 1e-12) * float32(1 / qmax)
//                                                  (qmax 127 or 7)
//   q[r, p]     = clip(floor(x[r, p] / scale + u[r, p]), -qmax, qmax)  int8
//   xhat[r, p]  = q[r, p] * scale[r, p / bp]                  (dequantize)
// u is uniform noise in [0, 1) drawn outside (the port's threefry, the JAX
// package's bits), or 0.5 everywhere (round to nearest) when u is null.
//
// Bound on an H100 (3.35 TB/s, ~67 TFLOP/s fp32): bytes. quantize reads x
// and u (8 B) and writes q and the scales (~1 B): ~9 B/element against ~5
// flops/element, far below the card's ~20 flop/B ridge. The 8 har-mlp
// leaves at K = 30 client rows are 8.31 M elements, ~75 MB, ~22 us a round.
// dequantize reads a code and writes a float (5 B/element, one multiply):
// ~42 MB, ~12 us a round. Each op is one launch a round.
//
// Design, both kernels: one launch covers a whole list of leaves (a round's
// 8 har-mlp leaves, each with K client rows): the leaves' pointers, row
// lengths, block sizes and first thread blocks travel in a table passed as
// a __grid_constant__ parameter, and each thread block finds its leaf in
// it, so a round pays one launch ramp and one tail instead of one per leaf
// (two of har-mlp's leaves are rows of 256 and 6 elements). Each row is cut
// into quant blocks on its own, like JAX's per-client vmap, so every
// client's scales match, and the ragged tail of a row is masked in the
// kernel instead of padded in memory.
//
// quantize: one thread block per (row, bp-block). Threads read 4
// neighbouring elements with one 16-byte load where the address allows;
// max|x| is reduced with warp shuffles and shared memory, thread 0 writes
// the scale, and the block then reads its 2 KB again from L1/L2 to write
// the codes (x and u as 16-byte loads, 4 codes as one 4-byte store), so
// device memory sees each byte once. Arithmetic is IEEE (__fdiv_rn,
// __fadd_rn, no fast math): an approximate division can move x/scale + u
// across an integer and flip floor(), and the codes must equal the plain
// version's bitwise. The scale is a product with float32(1 / qmax), not a
// division by qmax: XLA rewrites the JAX oracle's division by the constant
// qmax into that product, and the reference trajectories were made with it.
// A NaN in a block makes its scale NaN (fmaxf alone would drop it) and its
// codes 0, so the decoded update stays non-finite and the round's
// finite-update guard still rejects it.
//
// dequantize: each thread block covers whole quant blocks of one row, up to
// kDqBlocks of them when a quant block fits the block's 512-element stride
// (bp <= 512, every har-mlp leaf), else one. The quant blocks line up with
// the threads, so a thread's 4 elements of a quant block share one scale,
// loaded once into a register: no per-element division by bp and one scale
// load per quant block, where a flat 1024-element tiling needed four of
// each. A thread reads its 4 codes as one char4 and writes one float4; the
// unrolled loop over the quant blocks puts all of a thread's code loads in
// flight before its stores. A ragged row end or an unaligned row start
// (rows of 6 elements) takes a scalar path. Each element is one IEEE
// float32 product, so the result is bitwise the plain version's.
//
// Built by nvcc into a shared library with a C interface
// (repro_torch/kernels/build.py); the Python wrappers in
// repro_torch/kernels/quantize/ops.py launch it on torch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLeaves = 64;  // leaves a launch (each table stays under 4 KB)
constexpr int kDqBlocks = 4;    // quant blocks a dequantize thread block covers at most
constexpr int kDqStride = kThreads * kVec;  // elements a dequantize block's threads take at once

// One leaf of a quantize launch; the Python wrapper fills the same layout (ctypes).
struct Leaf {
  const float* x;  // (rows, n)
  const float* u;  // (rows, n), or null: round to nearest
  int8_t* q;       // (rows, n)
  float* scales;   // (rows, nb)
  int64_t n;
  int64_t block0;  // the leaf's first block; its blocks are rows * nb
  int bp;
  int nb;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int n_leaves;
  float qmax;
  float inv_qmax;  // float32(1 / qmax)
};

// One leaf of a dequantize launch; the Python wrapper fills the same layout (ctypes).
struct DqLeaf {
  const int8_t* q;       // (rows, n)
  const float* scales;   // (rows, nb)
  float* out;            // (rows, n)
  int64_t n;
  int64_t block0;        // the leaf's first thread block; its blocks are rows * per_row
  int bp;
  int nb;
  int bpc;               // quant blocks a thread block covers (kDqBlocks or 1)
  int per_row;           // thread blocks a row: ceil(nb / bpc)
};

struct DqTable {
  DqLeaf leaf[kMaxLeaves];
  int n_leaves;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// One code: clip(floor(x / scale + u), +-qmax), IEEE-rounded; NaN -> 0.
__device__ __forceinline__ int8_t code(float x, float u, float scale, float qmax) {
  const float t = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  return (t != t) ? int8_t(0) : static_cast<int8_t>(fminf(fmaxf(t, -qmax), qmax));
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const __grid_constant__ Table table) {
  int li = 0;  // this block's leaf
  while (li + 1 < table.n_leaves && blockIdx.x >= table.leaf[li + 1].block0) ++li;
  const Leaf& leaf = table.leaf[li];
  const float* __restrict__ x = leaf.x;
  const float* __restrict__ u = leaf.u;
  int8_t* __restrict__ q = leaf.q;
  float* __restrict__ scales = leaf.scales;
  const int64_t n = leaf.n;
  const int bp = leaf.bp, nb = leaf.nb;
  const float qmax = table.qmax, inv_qmax = table.inv_qmax;
  const int64_t local = blockIdx.x - leaf.block0;
  const int64_t row = local / nb;
  const int blk = static_cast<int>(local % nb);
  const int64_t start = static_cast<int64_t>(blk) * bp;
  const int64_t rest = n - start;
  const int len = rest < bp ? static_cast<int>(rest) : bp;
  const float* xb = x + row * n + start;
  const float* ub = u ? u + row * n + start : nullptr;
  int8_t* qb = q + row * n + start;
  const bool vec_x = aligned16(xb);

  // pass 1: max |x| over the block (and whether it holds a NaN)
  float amax = 0.0f;
  bool nan_seen = false;
  for (int i = threadIdx.x * kVec; i < len; i += kThreads * kVec) {
    if (vec_x && i + kVec <= len) {
      const float4 v = *reinterpret_cast<const float4*>(xb + i);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
      nan_seen |= (v.x != v.x) | (v.y != v.y) | (v.z != v.z) | (v.w != v.w);
    } else {
      for (int k = i; k < min(i + kVec, len); ++k) {
        const float v = xb[k];
        amax = fmaxf(amax, fabsf(v));
        nan_seen |= (v != v);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  nan_seen = __any_sync(0xffffffffu, nan_seen);
  __shared__ float warp_max[kWarps];
  __shared__ int warp_nan[kWarps];
  __shared__ float block_scale;
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    warp_max[warp] = amax;
    warp_nan[warp] = nan_seen ? 1 : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    int bad = warp_nan[0];
    for (int w = 1; w < kWarps; ++w) {
      m = fmaxf(m, warp_max[w]);
      bad |= warp_nan[w];
    }
    const float s = bad ? __int_as_float(0x7fc00000) : __fmul_rn(fmaxf(m, 1e-12f), inv_qmax);
    block_scale = s;
    scales[row * nb + blk] = s;
  }
  __syncthreads();
  const float scale = block_scale;

  // pass 2: codes (the block's x is in L1/L2 by now)
  const bool vec_all = vec_x && (!ub || aligned16(ub)) &&
                       (reinterpret_cast<uintptr_t>(qb) & 3u) == 0;
  for (int i = threadIdx.x * kVec; i < len; i += kThreads * kVec) {
    if (vec_all && i + kVec <= len) {
      const float4 xv = *reinterpret_cast<const float4*>(xb + i);
      const float4 uv = ub ? *reinterpret_cast<const float4*>(ub + i)
                           : make_float4(0.5f, 0.5f, 0.5f, 0.5f);
      char4 c;
      c.x = code(xv.x, uv.x, scale, qmax);
      c.y = code(xv.y, uv.y, scale, qmax);
      c.z = code(xv.z, uv.z, scale, qmax);
      c.w = code(xv.w, uv.w, scale, qmax);
      *reinterpret_cast<char4*>(qb + i) = c;
    } else {
      for (int k = i; k < min(i + kVec, len); ++k) {
        qb[k] = code(xb[k], ub ? ub[k] : 0.5f, scale, qmax);
      }
    }
  }
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// 4 codes from q[i..] scaled by s into out[i..] (i < len): one char4 load and
// one float4 store where all 4 are in the row and both addresses allow it.
__device__ __forceinline__ void dequant4(const int8_t* __restrict__ q, float* __restrict__ out,
                                         int64_t i, int64_t len, float s) {
  if (i + kVec <= len && (reinterpret_cast<uintptr_t>(q + i) & 3u) == 0 && aligned16(out + i)) {
    const char4 c = *reinterpret_cast<const char4*>(q + i);
    *reinterpret_cast<float4*>(out + i) =
        make_float4(__fmul_rn(static_cast<float>(c.x), s), __fmul_rn(static_cast<float>(c.y), s),
                    __fmul_rn(static_cast<float>(c.z), s), __fmul_rn(static_cast<float>(c.w), s));
  } else {
    for (int64_t k = i; k < min64(i + kVec, len); ++k) {
      out[k] = __fmul_rn(static_cast<float>(q[k]), s);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const __grid_constant__ DqTable table) {
  int li = 0;  // this block's leaf
  while (li + 1 < table.n_leaves && blockIdx.x >= table.leaf[li + 1].block0) ++li;
  const DqLeaf& leaf = table.leaf[li];
  const int64_t n = leaf.n;
  const int bp = leaf.bp;
  const int64_t local = blockIdx.x - leaf.block0;
  const int64_t row = local / leaf.per_row;
  const int blk0 = static_cast<int>(local % leaf.per_row) * leaf.bpc;
  const int blocks = min(leaf.bpc, leaf.nb - blk0);
  const int8_t* __restrict__ q = leaf.q + row * n;
  const float* __restrict__ sr = leaf.scales + row * leaf.nb + blk0;
  float* __restrict__ out = leaf.out + row * n;
  const int64_t i0 = threadIdx.x * kVec;
  if (bp <= kDqStride) {
    // a quant block per step of the threads: thread t takes elements
    // [4t, 4t + 4) of each of the block's quant blocks
#pragma unroll
    for (int b = 0; b < kDqBlocks; ++b) {
      if (b < blocks) {
        const int64_t start = static_cast<int64_t>(blk0 + b) * bp;
        const int64_t len = min64(bp, n - start);
        const float s = sr[b];
        if (i0 < len) dequant4(q + start, out + start, i0, len, s);
      }
    }
  } else {
    // one quant block longer than the threads' stride (bpc == 1)
    const int64_t start = static_cast<int64_t>(blk0) * bp;
    const int64_t len = min64(bp, n - start);
    const float s = sr[0];
    for (int64_t i = i0; i < len; i += kDqStride) dequant4(q + start, out + start, i, len, s);
  }
}

}  // namespace

extern "C" {

// Quantizes every leaf of the Table at table_ptr in one launch of `blocks`
// blocks (the sum of the leaves' rows * nb; no leaf without blocks).
// Returns cudaGetLastError() after the launch (0 = launched).
int repro_quantize_leaves(const void* table_ptr, int64_t blocks, void* stream) {
  const Table* table = static_cast<const Table*>(table_ptr);
  if (table->n_leaves < 1 || table->n_leaves > kMaxLeaves || blocks < 1 || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  quantize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(*table);
  return static_cast<int>(cudaGetLastError());
}

// Dequantizes every leaf of the DqTable at table_ptr in one launch of
// `blocks` blocks (the sum of the leaves' rows * per_row; no leaf without
// blocks). Returns cudaGetLastError() after the launch (0 = launched).
int repro_dequantize_leaves(const void* table_ptr, int64_t blocks, void* stream) {
  const DqTable* table = static_cast<const DqTable*>(table_ptr);
  if (table->n_leaves < 1 || table->n_leaves > kMaxLeaves || blocks < 1 || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  dequantize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*table);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
