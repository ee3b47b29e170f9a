// Mamba-1 selective scan for sm_90a — the port's ssm_scan kernel.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/ssm_scan/kernel.py:ssm_scan_kernel (_ssm_kernel)
//
// What it computes, from h = 0, for dt and x (B, S, di), B and C (B, S, ds)
// (all four of one stream type, float32 or bfloat16), A (di, ds) and
// D (di,) float32:
//   h[b,c,:] = exp(dt[b,t,c] * A[c,:]) * h[b,c,:] + (dt[b,t,c] * B[b,t,:]) * x[b,t,c]
//   y[b,t,c] = sum_n h[b,c,n] * C[b,t,n] + D[c] * x[b,t,c]
// in float32 registers, for t = 0 .. S-1. It writes y (B, S, di) in the
// requested output type and the final state h (B, di, ds) in float32.
// The update keeps the model layer's order of operations
// (src/repro/models/layers.py:mamba_block: (dt*B)*x, then da*h + that, and
// the ds sum after the update), one rounding per product and per sum, so it
// follows the plain version step for step; only exp and the order of the
// ds sum may differ from torch's.
//
// Bound on an H100 at falcon-mamba-7b's prefill (B=4, S=2048, di=8192,
// ds=16, bf16 streams): bytes — dt and x read once (268 MB), B and C
// (0.5 MB), y written once (134 MB), h (2 MB): ~405 MB, 0.121 ms at
// 3.35 TB/s. Operations — 8 per (b, t, c, n) (dt*A, exp, da*h, +, dt*B,
// *x, h*C, +) and 2 per (b, t, c) (D*x, +): 8.7 GFLOP, 0.130 ms at the
// 67 TFLOP/s fp32 rate. The two are within 8%; operations bind by a hair,
// and exp is not one instruction, so the instruction throughput of the
// CUDA cores is the real limit.
//
// Design: the TPU kernel walks the sequence in grid order with h in VMEM;
// on Hopper blocks run in parallel, so the sequence loop runs inside each
// thread instead. One thread owns one (b, channel) pair: its ds states and
// its row of A stay in registers for the whole sequence, and the ds
// independent updates of a step give the thread its instruction-level
// parallelism. A block holds 64 neighbouring channels of one batch row, so
// each step's dt, x and y accesses are 128 coalesced bytes (bf16) per
// block. The sequence goes in chunks of 16 steps: each thread first starts
// the loads of its 16 dt and 16 x values (all in flight together), and the
// block stages the chunk's B and C rows, which every channel reads, in
// shared memory. A ragged sequence end is masked, with no padding.
//
// Built by nvcc into a shared library with a C interface
// (repro_torch/kernels/build.py); the Python wrapper in
// repro_torch/kernels/ssm_scan/ops.py launches it on torch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // channels per block
constexpr int kChunk = 16;    // sequence steps per staged chunk

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

template <typename Tin, typename Tout, int DS>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const Tin* __restrict__ dt, const float* __restrict__ a,
                const Tin* __restrict__ bmat, const Tin* __restrict__ cmat,
                const Tin* __restrict__ x, const float* __restrict__ d,
                Tout* __restrict__ y, float* __restrict__ h_out, int s_len, int di) {
  __shared__ float b_s[kChunk][DS];
  __shared__ float c_s[kChunk][DS];
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool active = c < di;

  float a_r[DS];
  float h[DS];
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    a_r[n] = active ? a[static_cast<int64_t>(c) * DS + n] : 0.0f;
    h[n] = 0.0f;
  }
  const float d_c = active ? d[c] : 0.0f;

  const int64_t row0 = static_cast<int64_t>(b) * s_len;  // (b, t=0) row index
  for (int t0 = 0; t0 < s_len; t0 += kChunk) {
    const int steps = s_len - t0 < kChunk ? s_len - t0 : kChunk;
    // this thread's dt and x for the chunk: independent loads, all in flight
    float dt_r[kChunk], x_r[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      dt_r[t] = 0.0f;
      x_r[t] = 0.0f;
      if (active && t < steps) {
        const int64_t off = (row0 + t0 + t) * di + c;
        dt_r[t] = to_f32(dt[off]);
        x_r[t] = to_f32(x[off]);
      }
    }
    __syncthreads();  // the previous chunk's B and C are no longer read
    for (int i = threadIdx.x; i < kChunk * DS; i += kThreads) {
      const int t = i / DS, n = i % DS;
      float bv = 0.0f, cv = 0.0f;
      if (t < steps) {
        const int64_t off = (row0 + t0 + t) * DS + n;
        bv = to_f32(bmat[off]);
        cv = to_f32(cmat[off]);
      }
      b_s[t][n] = bv;
      c_s[t][n] = cv;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        if (t < steps) {
          const float dtv = dt_r[t], xv = x_r[t];
          float acc = 0.0f;
#pragma unroll
          for (int n = 0; n < DS; ++n) {
            const float da = expf(__fmul_rn(dtv, a_r[n]));
            const float dbx = __fmul_rn(__fmul_rn(dtv, b_s[t][n]), xv);
            h[n] = __fadd_rn(__fmul_rn(da, h[n]), dbx);
            acc = __fadd_rn(acc, __fmul_rn(h[n], c_s[t][n]));
          }
          const float yv = __fadd_rn(acc, __fmul_rn(d_c, xv));
          y[(row0 + t0 + t) * di + c] = from_f32<Tout>(yv);
        }
      }
    }
  }
  if (active) {
    float* hp = h_out + (static_cast<int64_t>(b) * di + c) * DS;
#pragma unroll
    for (int n = 0; n < DS; ++n) hp[n] = h[n];
  }
}

template <typename Tin, typename Tout, int DS>
int launch(const void* dt, const void* a, const void* bm, const void* cm, const void* x,
           const void* d, void* y, void* h, int batch, int s_len, int di, void* stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, batch);
  if (grid.x > 0 && grid.y > 0) {
    ssm_scan_kernel<Tin, Tout, DS><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Tin*>(dt), static_cast<const float*>(a), static_cast<const Tin*>(bm),
        static_cast<const Tin*>(cm), static_cast<const Tin*>(x), static_cast<const float*>(d),
        static_cast<Tout*>(y), static_cast<float*>(h), s_len, di);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int launch_ds(int ds, const void* dt, const void* a, const void* bm, const void* cm,
              const void* x, const void* d, void* y, void* h, int batch, int s_len, int di,
              void* stream) {
  if (ds == 8) return launch<Tin, Tout, 8>(dt, a, bm, cm, x, d, y, h, batch, s_len, di, stream);
  if (ds == 16) return launch<Tin, Tout, 16>(dt, a, bm, cm, x, d, y, h, batch, s_len, di, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16; ds: 8 or 16.
// All pointers are contiguous: dt, x (B, S, di); bm, cm (B, S, ds);
// a (di, ds); d (di); y (B, S, di); h (B, di, ds) float32.
// Returns cudaGetLastError() after the launch (0 = launched).
int repro_ssm_scan(const void* dt, const void* a, const void* bm, const void* cm,
                   const void* x, const void* d, void* y, void* h, int batch, int s_len,
                   int di, int ds, int in_dtype, int out_dtype, void* stream) {
  if (in_dtype == 0 && out_dtype == 0)
    return launch_ds<float, float>(ds, dt, a, bm, cm, x, d, y, h, batch, s_len, di, stream);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_ds<float, __nv_bfloat16>(ds, dt, a, bm, cm, x, d, y, h, batch, s_len, di, stream);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_ds<__nv_bfloat16, float>(ds, dt, a, bm, cm, x, d, y, h, batch, s_len, di, stream);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_ds<__nv_bfloat16, __nv_bfloat16>(ds, dt, a, bm, cm, x, d, y, h, batch, s_len,
                                                   di, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
