// Mamba-1 selective scan for sm_90a — the port's ssm_scan kernel.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/ssm_scan/kernel.py:ssm_scan_kernel (_ssm_kernel)
//
// What it computes, from h = 0 (or, where the caller passes an `h0` pointer,
// from the carried state h0 (B, di, ds) float32: a prefill that continues a
// cache), for dt and x (B, S, di), B and C (B, S, ds)
// (all four of one stream type, float32 or bfloat16), A (di, ds) and
// D (di,) float32:
//   h[b,c,:] = exp(dt[b,t,c] * A[c,:]) * h[b,c,:] + (dt[b,t,c] * x[b,t,c]) * B[b,t,:]
//   y[b,t,c] = sum_n h[b,c,n] * C[b,t,n] + D[c] * x[b,t,c]
// in float32 registers, for t = 0 .. S-1. It writes y (B, S, di) in the
// requested output type and the final state h (B, di, ds) in float32.
// Where the caller passes an `hs` pointer (training), it also writes the
// state at the start of every 128-step chunk, hs[j] = h before step 128 j,
// (ceil(S / 128), B, di, ds) float32: the residuals of the JAX package's
// models/ssm_vjp._fwd, from which ssm_scan_bwd.cu recomputes each chunk.
// The state goes out before every fourth 32-step stage; a null pointer
// writes nothing else and leaves the arithmetic as it was. hs[0] is h0 where
// one is given. A start state is read once, into the state registers the
// scan starts from (h = 0 otherwise): nothing else changes.
// The arithmetic is the Pallas kernel's order, (dt*x)*B, with
//   exp(dt*A) = ex2.approx.ftz(dt * A')   A' = A * log2(e), kept in registers
//   h = fma(exp(dt*A), h, (dt*x) * B)     y = fma(h, C, y) over n, then fma(D, x, y)
// so it does not follow ssm_scan_plain (accurate exp, no fma) step for step;
// kernels/ssm_scan/contract.py states how closely it must match the scan
// computed in float64.
//
// Bound on an H100 at falcon-mamba-7b's prefill (B=4, S=2048, di=8192,
// ds=16, bf16 streams, bf16 y): one exp per (b, t, c, n), 1.07 G exps on
// the special-function unit (MUFU.EX2, 16 a clock per SM: 132 SMs at the
// 1.98 GHz implied by the 67 TFLOP/s fp32 rate, 4.18e12/s), 0.257 ms. The
// FP32 pipe needs 4 instructions per (b, t, c, n) (dt*A', fma into h,
// (dt*x)*B, fma into y): 4.3 G at 33.5e12/s, 0.128 ms. Bytes: dt and x read
// once (268 MB), B and C (0.5 MB), y written once (134 MB), h (2 MB):
// ~405 MB, 0.121 ms at 3.35 TB/s. So the SFU binds, and the design keeps
// every other instruction off the issue slots the exps need.
//
// Design: the TPU kernel walks the sequence in grid order with h in VMEM;
// on Hopper blocks run in parallel, so the sequence loop runs inside each
// thread instead, with its states and its row of A' in registers.
// - States split over lanes: a channel's ds states belong to kLanes = 2
//   neighbouring lanes of a warp (8 states each for ds = 16, 4 for ds = 8).
//   A block holds 64 neighbouring channels of one batch row (128 threads);
//   falcon-mamba's shape runs 512 blocks, 4 an SM, in one wave. Splitting
//   over 4 lanes (4 states a thread, 131,072 threads) and over none (16
//   states a thread) were built and timed as well (by editing kLanes;
//   PERF.md): 4 lanes spend more instructions per update on shared-memory
//   loads of B and C and on the shuffles, 1 lane has too few warps to hide
//   latency.
// - y of a step is summed over the thread's states 4 at a time, then over
//   the channel's 2 lanes by one __shfl_xor_sync that leaves lane q with
//   the whole sum of step g + q of each pair of steps (a reduce-scatter:
//   each lane adds the other lane's partial of its own step), then
//   fma(D, x, y); each lane stores its step's y straight from registers (a
//   warp's stores cover neighbouring channels of two rows).
// - The sequence goes through shared memory in chunks of 32 steps, staged
//   with 16-byte cp.async copies into a double buffer, so chunk k+1 loads
//   while chunk k computes (zero-filled past S and past di: dt = x = B = 0
//   leaves h unchanged exactly, since 2^0 = 1 and 0 * B = 0). The lanes read
//   dt and x of their channel from the raw chunk; B and C rows, which every
//   channel reads, are converted once a chunk to float32 and read as
//   float4. Unaligned pointers, or di not a multiple of a 16-byte vector,
//   take scalar copies instead (same arithmetic).
//
// Built by nvcc into a shared library with a C interface
// (repro_torch/kernels/build.py); the Python wrapper in
// repro_torch/kernels/ssm_scan/ops.py launches it on torch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;  // channels per block
constexpr int kLanes = 2;      // lanes a channel's states are split over
constexpr int kThreads = kChannels * kLanes;
constexpr int kUnroll = 4;     // sequence steps of one unrolled scan-loop iteration
constexpr int kChunk = 32;     // sequence steps per staged chunk
constexpr int kMinBlocks = 4;  // falcon-mamba's 512 blocks in one wave on 132 SMs
constexpr int kStatesEvery = 128 / kChunk;  // stages a training chunk state spans
constexpr float kLog2e = 1.4426950408889634f;

template <typename Tin, int DS>
struct Smem {
  Tin dt[2][kChunk][kChannels];  // raw chunks as loaded, double-buffered
  Tin x[2][kChunk][kChannels];
  Tin b[2][kChunk][DS];
  Tin c[2][kChunk][DS];
  float bf[kChunk][DS];  // the chunk's B and C in float32
  float cf[kChunk][DS];
};

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

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 16 bytes from global to shared memory, asynchronously; zeros when !in.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 4 neighbouring stream elements of shared memory as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Lane q of a channel's 2 lanes, holding partial sums v[j] of steps g + j,
// returns the sum over both lanes of step g + q.
__device__ __forceinline__ float reduce_scatter(const float (&v)[kLanes], int q) {
  const bool lo = q & 1;
  const float k = lo ? v[1] : v[0], s = lo ? v[0] : v[1];
  return k + __shfl_xor_sync(0xffffffffu, s, 1);
}

// Starts the copies of the chunk whose rows begin at row t0 into buffer st.
// vec: 16-byte cp.async, each thread's pieces at offsets fixed for the whole
// sequence (32-bit, from a per-chunk base); else scalar loads that complete
// here. Rows past S and channels past di are zero-filled.
template <typename Tin, int DS>
__device__ __forceinline__ void stage_chunk(Smem<Tin, DS>& sm, int st, const Tin* __restrict__ dt,
                                            const Tin* __restrict__ x,
                                            const Tin* __restrict__ bm,
                                            const Tin* __restrict__ cm, int64_t row0, int t0,
                                            int s_len, int di, int c0, bool vec) {
  const int steps = s_len - t0 < kChunk ? s_len - t0 : kChunk;
  const int64_t base = (row0 + t0) * di + c0;  // (t0, c0) in dt and x
  const int64_t bc_base = (row0 + t0) * DS;    // row t0 in B and C
  if (vec) {
    constexpr int kVec = 16 / static_cast<int>(sizeof(Tin));
    constexpr int kPieces = kChannels / kVec;  // 16-byte pieces of a channel row
    constexpr int kPer = (kChunk * kPieces + kThreads - 1) / kThreads;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int t = i / kPieces, cc = (i % kPieces) * kVec;
      if (kChunk * kPieces % kThreads == 0 || i < kChunk * kPieces) {
        const bool in = t < steps && c0 + cc < di;
        const int off = in ? t * di + cc : 0;
        cp_async16(&sm.dt[st][t][cc], dt + base + off, in);
        cp_async16(&sm.x[st][t][cc], x + base + off, in);
      }
    }
    // B and C: the chunk's rows are contiguous; a piece never straddles a
    // row (a row is DS * sizeof(Tin) = 16, 32 or 64 bytes)
    constexpr int kBc = kChunk * DS / kVec;
#pragma unroll
    for (int j = 0; j < (kBc + kThreads - 1) / kThreads; ++j) {
      const int e = (threadIdx.x + j * kThreads) * kVec;
      if (kBc % kThreads == 0 || e < kBc * kVec) {
        const bool in = e / DS < steps;
        const int off = in ? e : 0;
        cp_async16(&sm.b[st][0][0] + e, bm + bc_base + off, in);
        cp_async16(&sm.c[st][0][0] + e, cm + bc_base + off, in);
      }
    }
  } else {
    const Tin zero = from_f32<Tin>(0.0f);
    for (int i = threadIdx.x; i < kChunk * kChannels; i += kThreads) {
      const int t = i / kChannels, cc = i % kChannels;
      const bool in = t < steps && c0 + cc < di;
      const int64_t off = base + static_cast<int64_t>(t) * di + cc;
      sm.dt[st][t][cc] = in ? dt[off] : zero;
      sm.x[st][t][cc] = in ? x[off] : zero;
    }
    for (int e = threadIdx.x; e < kChunk * DS; e += kThreads) {
      const bool in = e / DS < steps;
      (&sm.b[st][0][0])[e] = in ? bm[bc_base + e] : zero;
      (&sm.c[st][0][0])[e] = in ? cm[bc_base + e] : zero;
    }
  }
}

template <typename Tin, typename Tout, int DS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssm_scan_kernel(const Tin* __restrict__ dt, const float* __restrict__ a,
                const Tin* __restrict__ bm, const Tin* __restrict__ cm,
                const Tin* __restrict__ x, const float* __restrict__ d, Tout* __restrict__ y,
                float* __restrict__ h_out, float* __restrict__ hs,
                const float* __restrict__ h0, int s_len, int di, int vec_in) {
  constexpr int L = kLanes, kS = DS / kLanes;  // kS: this thread's states, 8 or 4
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<Tin, DS>& sm = *reinterpret_cast<Smem<Tin, DS>*>(smem_raw);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int64_t row0 = static_cast<int64_t>(b) * s_len;  // (b, t = 0) row index
  const int lane = threadIdx.x & 31;
  const int ch = (threadIdx.x >> 5) * (32 / L) + lane / L;  // this thread's channel in the block
  const int q = lane % L;                                    // its states: kS q .. kS q + kS-1
  const int c = c0 + ch;
  const bool active = c < di;

  float ap[kS], h[kS];
  const int64_t h_at = (static_cast<int64_t>(b) * di + c) * DS + kS * q;  // this thread's states
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    ap[j] = active ? a[static_cast<int64_t>(c) * DS + kS * q + j] * kLog2e : 0.0f;
    h[j] = h0 != nullptr && active ? h0[h_at + j] : 0.0f;
  }
  const float d_c = active ? d[c] : 0.0f;

  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  if (n_chunks > 0) stage_chunk(sm, 0, dt, x, bm, cm, row0, 0, s_len, di, c0, vec_in);
  cp_async_commit();
  for (int k = 0; k < n_chunks; ++k) {
    const int st = k & 1, t0 = k * kChunk;
    if (hs != nullptr && k % kStatesEvery == 0 && active) {  // the chunk's start state
      const int64_t chunk = k / kStatesEvery;
      float* hp = hs + ((chunk * gridDim.y + b) * di + c) * DS + kS * q;
#pragma unroll
      for (int j = 0; j < kS; ++j) hp[j] = h[j];
    }
    cp_async_wait_all();
    __syncthreads();  // chunk k is in; every thread is done with chunk k-1
    if (k + 1 < n_chunks) {
      stage_chunk(sm, st ^ 1, dt, x, bm, cm, row0, t0 + kChunk, s_len, di, c0, vec_in);
      cp_async_commit();  // in flight while chunk k computes
    }
    // B and C rows of the chunk in float32, 4 elements an item
    for (int i = threadIdx.x; i < kChunk * DS / 4; i += kThreads) {
      *reinterpret_cast<float4*>(&sm.bf[0][0] + 4 * i) = load4(&sm.b[st][0][0] + 4 * i);
      *reinterpret_cast<float4*>(&sm.cf[0][0] + 4 * i) = load4(&sm.c[st][0][0] + 4 * i);
    }
    __syncthreads();

    // scan: L steps at a time, then their sums over the channel's lanes
    // (lane q keeps step q's); y of a step sums the thread's states 4 at a
    // time, then the groups, then fma(D, x, .), stored straight from the
    // registers (a warp's lanes write neighbouring channels of a row)
    const int steps = s_len - t0 < kChunk ? s_len - t0 : kChunk;
    Tout* yrow = y + (row0 + t0) * di + c;
#pragma unroll (kUnroll / kLanes)
    for (int g = 0; g < kChunk; g += L) {
      float part[L], xq = 0.0f;  // xq: x of step g + q, the step this lane writes
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int t = g + j;
        const float dtv = to_f32(sm.dt[st][t][ch]);
        const float xv = to_f32(sm.x[st][t][ch]);
        const float dtx = dtv * xv;
        xq = j == 0 || q == j ? xv : xq;
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < kS; n += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(&sm.bf[t][kS * q + n]);
          const float4 cv = *reinterpret_cast<const float4*>(&sm.cf[t][kS * q + n]);
          h[n] = fmaf(ex2(dtv * ap[n]), h[n], dtx * bv.x);
          h[n + 1] = fmaf(ex2(dtv * ap[n + 1]), h[n + 1], dtx * bv.y);
          h[n + 2] = fmaf(ex2(dtv * ap[n + 2]), h[n + 2], dtx * bv.z);
          h[n + 3] = fmaf(ex2(dtv * ap[n + 3]), h[n + 3], dtx * bv.w);
          float acc = h[n] * cv.x;
          acc = fmaf(h[n + 1], cv.y, acc);
          acc = fmaf(h[n + 2], cv.z, acc);
          acc = fmaf(h[n + 3], cv.w, acc);
          sum = n == 0 ? acc : sum + acc;
        }
        part[j] = sum;
      }
      const Tout yv = from_f32<Tout>(fmaf(d_c, xq, reduce_scatter(part, q)));
      if (active && g + q < steps) yrow[static_cast<int64_t>(g + q) * di] = yv;
    }
  }
  if (active) {
    float* hp = h_out + (static_cast<int64_t>(b) * di + c) * DS + kS * q;
#pragma unroll
    for (int j = 0; j < kS; ++j) hp[j] = h[j];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename Tin, typename Tout, int DS>
int launch(const void* dt, const void* a, const void* bm, const void* cm, const void* x,
           const void* d, void* y, void* h, void* hs, const void* h0, int batch, int s_len,
           int di, void* stream) {
  constexpr int smem = static_cast<int>(sizeof(Smem<Tin, DS>));
  static bool configured = false;  // raise the dynamic shared memory limit once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ssm_scan_kernel<Tin, Tout, DS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(ssm_scan_kernel<Tin, Tout, DS>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((di + kChannels - 1) / kChannels, batch);
  if (grid.x > 0 && grid.y > 0) {
    const int vec_in = di % (16 / static_cast<int>(sizeof(Tin))) == 0 && aligned16(dt) &&
                       aligned16(x) && aligned16(bm) && aligned16(cm);
    ssm_scan_kernel<Tin, Tout, DS><<<grid, kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Tin*>(dt), static_cast<const float*>(a), static_cast<const Tin*>(bm),
        static_cast<const Tin*>(cm), static_cast<const Tin*>(x), static_cast<const float*>(d),
        static_cast<Tout*>(y), static_cast<float*>(h), static_cast<float*>(hs),
        static_cast<const float*>(h0), s_len, di, vec_in);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int launch_ds(int ds, const void* dt, const void* a, const void* bm, const void* cm,
              const void* x, const void* d, void* y, void* h, void* hs, const void* h0,
              int batch, int s_len, int di, void* stream) {
  if (ds == 8)
    return launch<Tin, Tout, 8>(dt, a, bm, cm, x, d, y, h, hs, h0, batch, s_len, di, stream);
  if (ds == 16)
    return launch<Tin, Tout, 16>(dt, a, bm, cm, x, d, y, h, hs, h0, batch, s_len, di, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16; ds: 8 or 16.
// All pointers are contiguous: dt, x (B, S, di); bm, cm (B, S, ds);
// a (di, ds); d (di); y (B, S, di); h (B, di, ds) float32 (h0's values, or
// 0, when S = 0); hs null, or (ceil(S / 128), B, di, ds) float32 for the
// chunk start states; h0 null (start from h = 0), or (B, di, ds) float32.
// Returns cudaGetLastError() after the launch (0 = launched).
int repro_ssm_scan(const void* dt, const void* a, const void* bm, const void* cm,
                   const void* x, const void* d, void* y, void* h, void* hs, const void* h0,
                   int batch, int s_len, int di, int ds, int in_dtype, int out_dtype,
                   void* stream) {
  if (in_dtype == 0 && out_dtype == 0)
    return launch_ds<float, float>(ds, dt, a, bm, cm, x, d, y, h, hs, h0, batch, s_len, di,
                                   stream);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_ds<float, __nv_bfloat16>(ds, dt, a, bm, cm, x, d, y, h, hs, h0, batch, s_len,
                                           di, stream);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_ds<__nv_bfloat16, float>(ds, dt, a, bm, cm, x, d, y, h, hs, h0, batch, s_len,
                                           di, stream);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_ds<__nv_bfloat16, __nv_bfloat16>(ds, dt, a, bm, cm, x, d, y, h, hs, h0, batch,
                                                   s_len, di, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
