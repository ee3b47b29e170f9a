// Backward of the port's Mamba-1 selective scan for sm_90a: the gradients
// of y with respect to dt, A, B, C, x and D, from the chunk start states
// that the forward kernel (ssm_scan.cu) writes in training.
//
// Replaces no TPU kernel: the JAX package trains through
// src/repro/models/ssm_vjp.py, a jnp custom VJP (_fwd saves the state at
// the start of each 128-step chunk, _bwd recomputes each chunk and runs the
// reverse recurrence), and its Pallas kernel
// (src/repro/kernels/ssm_scan/kernel.py:ssm_scan_kernel) has no backward.
// This kernel is _bwd for the port, behind
// repro_torch/models/ssm_vjp.py:selective_scan.
//
// What it computes, for dt, x (B, S, di) and B, C (B, S, ds) of one stream
// type (float32 or bfloat16), A (di, ds) and D (di,) float32, the chunk
// start states hs (ceil(S / 128), B, di, ds), the cotangent gy (B, S, di)
// and optionally gh (B, di, ds) of the final state, all float32:
//   for each chunk, last to first: the chunk's states h_t again from its
//   start state (the forward's arithmetic: h = fma(2^(dt A log2 e), h,
//   (dt x) B), so the states are the forward's bit for bit), then for t
//   from the chunk's end down, with g the state's cotangent:
//     g      += gy_t C_t                       da = exp(dt_t A)
//     d_dt_t  = sum_n g A da h_{t-1} + (sum_n g B_t) x_t
//     d_x_t   = dt_t (sum_n g B_t) + D gy_t
//     d_B_t   = sum_c g dt_t x_t      d_C_t = sum_c h_t gy_t
//     d_A    += sum_{b,t} dt_t g da h_{t-1}    d_D += sum_{b,t} gy_t x_t
//     g       = g da
// in float32; d_dt, d_x, d_B, d_C in the stream type, d_A and d_D float32.
// kernels/ssm_scan/contract.py holds it to ssm_scan_backward_plain, which
// follows _bwd step for step, run in float64 on the same inputs.
//
// Bound on an H100 at falcon-mamba-7b's layer (B=4, S=2048, di=8192,
// ds=16): the reverse recurrence needs at least one exp (da) and about 10
// FP32-pipe instructions (the fmas into g, sum g B, the d_dt and d_A terms,
// the d_B and d_C shares, the decay of g, the state's own update) per
// (b, t, c, n): 1.07 G exps on the special-function unit (4.18e12/s),
// 0.257 ms, and 10.7 G instructions at 33.5e12/s, 0.32 ms; bytes: dt, x,
// B, C read once in bf16, gy in float32, hs (34 MB at 16 chunks), the four
// stream-type outputs written once, 0.57 GB, 0.17 ms. So the FP32 pipe
// binds, the SFU close behind. This first kernel takes three exps per
// element (the chunk sweep, the segment recompute, da of the reverse step)
// and pays for its shuffles (ROADMAP.md queue 2 has the SFU-bound redesign).
//
// Design. As the forward, one thread block holds 64 neighbouring channels of
// one batch row, a channel's ds states split over 2 neighbouring lanes (8
// states a thread at ds = 16, 4 at ds = 8), and walks the sequence inside
// the threads: chunks of 128 steps from last to first, g carried across
// them in registers.
// - A chunk's 128 states cannot stay in registers, so the chunk is swept
//   once from its start state, keeping the state at the start of each
//   8-step segment in shared memory (64 KB at ds = 16); then, segment by
//   segment from the last, the 8 states are recomputed into registers and
//   the reverse recurrence runs over them.
// - d_dt and d_x need sums over a channel's states: one shuffle between its
//   2 lanes. d_B and d_C sum over all di channels, across blocks: within a
//   warp a reduce-scatter of shuffles (15 at ds = 16) leaves each lane with
//   one of the 32 sums of its 16 channels, the 4 warps' sums are added in
//   shared memory after each segment, and each block writes its partial
//   (64 channels) to a float32 scratch (di / 64, B, S, ds). d_A and d_D sum
//   over batch and time: each (b, channel) keeps its sums in registers over
//   the sequence and writes a partial (B, di, ds) and (B, di).
// - A second grid adds the partials in a fixed order (block by block, batch
//   entry by batch entry) and writes d_B, d_C, d_A, d_D. No float atomics:
//   two calls give the same bits.
// - The last chunk may be ragged (S not a multiple of 128, or S < 128):
//   steps past S are skipped; the step index is the same for the whole
//   block, so the skips never split a warp's shuffles.
//
// Built by nvcc into a shared library with a C interface
// (repro_torch/kernels/build.py); the Python wrapper
// repro_torch/kernels/ssm_scan/ops.py:ssm_scan_bwd launches it on torch's
// current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;  // channels per block
constexpr int kLanes = 2;      // lanes a channel's states are split over
constexpr int kThreads = kChannels * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;    // steps between saved states (ssm_vjp.CHUNK)
constexpr int kSeg = 8;        // steps a segment recomputes into registers
constexpr int kSegs = kChunk / kSeg;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

template <int DS>
struct Smem {
  float seg[kSegs][DS / kLanes][kThreads];  // each thread's state at each segment start
  float red[kSeg][kWarps][2 * DS];          // a segment's d_B, d_C sums over each warp
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

// Sums v[0 .. N) of the 16 lanes that share this lane's state half (lane
// bits 1..4 vary, bit 0 = the half) and leaves one sum in v[0]: halving
// stages over lane masks 16, 8, 4, 2 (a lane keeps the upper half where its
// mask bit is set), `idx` the index of the value it keeps; once one value
// remains (N < 16), the stages left sum it over the rest, so lanes that
// differ only in those bits hold the same sum.
template <int N, int M = N, int O = 16>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane, int& idx) {
  if constexpr (O >= 2) {
    if constexpr (M > 1) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < M / 2; ++i) {
        const float send = up ? v[i] : v[i + M / 2];
        const float keep = up ? v[i + M / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      idx = 2 * idx + (up ? 1 : 0);
      reduce_scatter<N, M / 2, O / 2>(v, lane, idx);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      reduce_scatter<N, 1, O / 2>(v, lane, idx);
    }
  }
}

template <typename Tin, int DS>
struct Step {
  float dt, x, b[DS / kLanes], c[DS / kLanes];
};

// Step t's dt and x of channel c and this thread's states of B and C (zero
// for a channel past di).
template <typename Tin, int DS>
__device__ __forceinline__ Step<Tin, DS> load_step(const Tin* __restrict__ dt,
                                                   const Tin* __restrict__ x,
                                                   const Tin* __restrict__ bm,
                                                   const Tin* __restrict__ cm, int64_t row, int di,
                                                   int c, int q, bool active, bool with_c) {
  constexpr int kS = DS / kLanes;
  Step<Tin, DS> st;
  st.dt = active ? to_f32(dt[row * di + c]) : 0.0f;
  st.x = active ? to_f32(x[row * di + c]) : 0.0f;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    st.b[j] = to_f32(bm[row * DS + kS * q + j]);
    st.c[j] = with_c ? to_f32(cm[row * DS + kS * q + j]) : 0.0f;
  }
  return st;
}

// One forward step of this thread's states, the forward kernel's arithmetic.
template <typename Tin, int DS>
__device__ __forceinline__ void advance(float (&h)[DS / kLanes], const Step<Tin, DS>& st,
                                        const float (&ap)[DS / kLanes]) {
  const float dtx = st.dt * st.x;
#pragma unroll
  for (int j = 0; j < DS / kLanes; ++j) h[j] = fmaf(ex2(st.dt * ap[j]), h[j], dtx * st.b[j]);
}

template <typename Tin, int DS>
__global__ void __launch_bounds__(kThreads, 2)
ssm_scan_bwd_kernel(const Tin* __restrict__ dt, const float* __restrict__ a,
                    const Tin* __restrict__ bm, const Tin* __restrict__ cm,
                    const Tin* __restrict__ x, const float* __restrict__ d,
                    const float* __restrict__ hs, const float* __restrict__ gy,
                    const float* __restrict__ gh, Tin* __restrict__ d_dt, Tin* __restrict__ d_x,
                    float* __restrict__ pb, float* __restrict__ pc, float* __restrict__ pa,
                    float* __restrict__ pd, int s_len, int di) {
  constexpr int kS = DS / kLanes, kN = 2 * kS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DS>& sm = *reinterpret_cast<Smem<DS>*>(smem_raw);

  const int b = blockIdx.y, batch = gridDim.y;
  const int c0 = blockIdx.x * kChannels;
  const int64_t row0 = static_cast<int64_t>(b) * s_len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = warp * (32 / kLanes) + lane / kLanes;
  const int q = lane % kLanes;  // this thread's states: kS q .. kS q + kS - 1
  const int c = c0 + ch;
  const bool active = c < di;
  const int64_t state0 = (static_cast<int64_t>(b) * di + c) * DS + kS * q;  // in (B, di, DS)

  float an[kS], ap[kS], g[kS], da_acc[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    an[j] = active ? a[static_cast<int64_t>(c) * DS + kS * q + j] : 0.0f;
    ap[j] = an[j] * kLog2e;
    g[j] = active && gh != nullptr ? gh[state0 + j] : 0.0f;
    da_acc[j] = 0.0f;
  }
  const float d_c = active ? d[c] : 0.0f;
  float dd_acc = 0.0f;

  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int t_c = ci * kChunk;
    const int n_segs = (min(kChunk, s_len - t_c) + kSeg - 1) / kSeg;
    // sweep the chunk from its saved start state: each segment's start state
    float h[kS];
    const int64_t hs0 = static_cast<int64_t>(ci) * batch * di * DS + state0;
#pragma unroll
    for (int j = 0; j < kS; ++j) h[j] = active ? hs[hs0 + j] : 0.0f;
    for (int sg = 0; sg < n_segs; ++sg) {
#pragma unroll
      for (int j = 0; j < kS; ++j) sm.seg[sg][j][threadIdx.x] = h[j];
#pragma unroll
      for (int jj = 0; jj < kSeg; ++jj) {
        const int t = t_c + sg * kSeg + jj;
        if (t < s_len)
          advance<Tin, DS>(h, load_step<Tin, DS>(dt, x, bm, cm, row0 + t, di, c, q, active, false),
                           ap);
      }
    }
    // segments last to first: recompute the 8 states, then the reverse steps
    for (int sg = n_segs - 1; sg >= 0; --sg) {
      float tr[kSeg + 1][kS];  // tr[j]: the state before step j of the segment
#pragma unroll
      for (int j = 0; j < kS; ++j) tr[0][j] = sm.seg[sg][j][threadIdx.x];
#pragma unroll
      for (int jj = 0; jj < kSeg; ++jj) {
        const int t = t_c + sg * kSeg + jj;
#pragma unroll
        for (int j = 0; j < kS; ++j) tr[jj + 1][j] = tr[jj][j];
        if (t < s_len)
          advance<Tin, DS>(tr[jj + 1],
                           load_step<Tin, DS>(dt, x, bm, cm, row0 + t, di, c, q, active, false),
                           ap);
      }
#pragma unroll
      for (int jj = kSeg - 1; jj >= 0; --jj) {
        const int t = t_c + sg * kSeg + jj;
        if (t >= s_len) continue;  // the same for the whole block
        const Step<Tin, DS> st =
            load_step<Tin, DS>(dt, x, bm, cm, row0 + t, di, c, q, active, true);
        const float gyv = active ? gy[(row0 + t) * di + c] : 0.0f;
        const float dtx = st.dt * st.x;
        float gb = 0.0f, ddt = 0.0f, v[kN];
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          g[j] = fmaf(gyv, st.c[j], g[j]);
          gb = fmaf(g[j], st.b[j], gb);
          const float da = ex2(st.dt * ap[j]);
          const float u = g[j] * da * tr[jj][j];  // g da h_{t-1}
          ddt = fmaf(an[j], u, ddt);
          da_acc[j] = fmaf(st.dt, u, da_acc[j]);
          v[j] = g[j] * dtx;                  // this channel's share of d_B
          v[kS + j] = tr[jj + 1][j] * gyv;    // ... of d_C
          g[j] *= da;
        }
        gb += __shfl_xor_sync(kFull, gb, 1);
        ddt += __shfl_xor_sync(kFull, ddt, 1);
        if (active) {
          const int64_t at = (row0 + t) * di + c;
          if (q == 0) {
            d_dt[at] = from_f32<Tin>(fmaf(gb, st.x, ddt));
            dd_acc = fmaf(gyv, st.x, dd_acc);
          } else {
            d_x[at] = from_f32<Tin>(fmaf(d_c, gyv, st.dt * gb));
          }
        }
        int idx = 0;
        reduce_scatter<kN>(v, lane, idx);
        if (kN == 16 || (lane & 2) == 0) {
          const int slot = idx < kS ? kS * q + idx : DS + kS * q + idx - kS;
          sm.red[jj][warp][slot] = v[0];
        }
      }
      __syncthreads();  // the segment's warp sums are in
      for (int o = threadIdx.x; o < kSeg * 2 * DS; o += kThreads) {
        const int jj = o / (2 * DS), slot = o % (2 * DS);
        const int t = t_c + sg * kSeg + jj;
        if (t < s_len) {
          float sum = sm.red[jj][0][slot];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) sum += sm.red[jj][w][slot];
          float* dst = slot < DS ? pb : pc;
          dst[((static_cast<int64_t>(blockIdx.x) * batch + b) * s_len + t) * DS + slot % DS] = sum;
        }
      }
      __syncthreads();  // red is free for the next segment
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < kS; ++j) pa[state0 + j] = da_acc[j];
    if (q == 0) pd[static_cast<int64_t>(b) * di + c] = dd_acc;
  }
}

// The partials' sums in a fixed order: d_B and d_C over the channel blocks,
// d_A and d_D over the batch.
template <typename Tin>
__global__ void ssm_scan_bwd_reduce_kernel(const float* __restrict__ pb,
                                           const float* __restrict__ pc,
                                           const float* __restrict__ pa,
                                           const float* __restrict__ pd, Tin* __restrict__ d_b,
                                           Tin* __restrict__ d_c, float* __restrict__ d_a,
                                           float* __restrict__ d_d, int n_blocks, int batch,
                                           int s_len, int di, int ds) {
  const int64_t n_bc = static_cast<int64_t>(batch) * s_len * ds;
  const int64_t n_a = static_cast<int64_t>(di) * ds;
  const int64_t total = 2 * n_bc + n_a + di;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float sum = 0.0f;
    if (i < 2 * n_bc) {
      const bool is_c = i >= n_bc;
      const int64_t e = is_c ? i - n_bc : i;
      const float* src = is_c ? pc : pb;
      for (int k = 0; k < n_blocks; ++k) sum += src[k * n_bc + e];
      (is_c ? d_c : d_b)[e] = from_f32<Tin>(sum);
    } else if (i < 2 * n_bc + n_a) {
      const int64_t e = i - 2 * n_bc;
      for (int k = 0; k < batch; ++k) sum += pa[k * n_a + e];
      d_a[e] = sum;
    } else {
      const int64_t e = i - 2 * n_bc - n_a;
      for (int k = 0; k < batch; ++k) sum += pd[static_cast<int64_t>(k) * di + e];
      d_d[e] = sum;
    }
  }
}

template <typename Tin, int DS>
int launch(const void* dt, const void* a, const void* bm, const void* cm, const void* x,
           const void* d, const void* hs, const void* gy, const void* gh, void* d_dt, void* d_x,
           void* d_b, void* d_c, void* d_a, void* d_d, void* pb, void* pc, void* pa, void* pd,
           int batch, int s_len, int di, void* stream) {
  constexpr int smem = static_cast<int>(sizeof(Smem<DS>));
  static bool configured = false;  // raise the dynamic shared memory limit once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_bwd_kernel<Tin, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (batch == 0 || di == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (di + kChannels - 1) / kChannels;
  ssm_scan_bwd_kernel<Tin, DS><<<dim3(n_blocks, batch), kThreads, smem, st>>>(
      static_cast<const Tin*>(dt), static_cast<const float*>(a), static_cast<const Tin*>(bm),
      static_cast<const Tin*>(cm), static_cast<const Tin*>(x), static_cast<const float*>(d),
      static_cast<const float*>(hs), static_cast<const float*>(gy),
      static_cast<const float*>(gh), static_cast<Tin*>(d_dt), static_cast<Tin*>(d_x),
      static_cast<float*>(pb), static_cast<float*>(pc), static_cast<float*>(pa),
      static_cast<float*>(pd), s_len, di);
  const int64_t total = 2 * static_cast<int64_t>(batch) * s_len * DS +
                        static_cast<int64_t>(di) * DS + di;
  const int64_t want = (total + 255) / 256;
  const int grid = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  ssm_scan_bwd_reduce_kernel<Tin><<<grid, 256, 0, st>>>(
      static_cast<const float*>(pb), static_cast<const float*>(pc),
      static_cast<const float*>(pa), static_cast<const float*>(pd), static_cast<Tin*>(d_b),
      static_cast<Tin*>(d_c), static_cast<float*>(d_a), static_cast<float*>(d_d), n_blocks,
      batch, s_len, di, DS);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int launch_ds(int ds, const void* dt, const void* a, const void* bm, const void* cm,
              const void* x, const void* d, const void* hs, const void* gy, const void* gh,
              void* d_dt, void* d_x, void* d_b, void* d_c, void* d_a, void* d_d, void* pb,
              void* pc, void* pa, void* pd, int batch, int s_len, int di, void* stream) {
  if (ds == 8)
    return launch<Tin, 8>(dt, a, bm, cm, x, d, hs, gy, gh, d_dt, d_x, d_b, d_c, d_a, d_d, pb, pc,
                          pa, pd, batch, s_len, di, stream);
  if (ds == 16)
    return launch<Tin, 16>(dt, a, bm, cm, x, d, hs, gy, gh, d_dt, d_x, d_b, d_c, d_a, d_d, pb,
                           pc, pa, pd, batch, s_len, di, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// in_dtype: 0 = float32, 1 = bfloat16 (dt, x, bm, cm and the d_dt, d_x,
// d_b, d_c outputs); ds: 8 or 16. All contiguous: dt, x, gy, d_dt, d_x
// (B, S, di); bm, cm, d_b, d_c (B, S, ds); a, d_a (di, ds); d, d_d (di);
// hs (ceil(S / 128), B, di, ds); gh null or (B, di, ds); gy, gh, hs, a, d,
// d_a, d_d float32. Scratch, float32: pb and pc (ceil(di / 64), B, S, ds),
// pa (B, di, ds), pd (B, di). Enqueues two grids on `stream`; returns
// cudaGetLastError() after them (0 = launched).
int repro_ssm_scan_bwd(const void* dt, const void* a, const void* bm, const void* cm,
                       const void* x, const void* d, const void* hs, const void* gy,
                       const void* gh, void* d_dt, void* d_x, void* d_b, void* d_c, void* d_a,
                       void* d_d, void* pb, void* pc, void* pa, void* pd, int batch, int s_len,
                       int di, int ds, int in_dtype, void* stream) {
  if (in_dtype == 0)
    return launch_ds<float>(ds, dt, a, bm, cm, x, d, hs, gy, gh, d_dt, d_x, d_b, d_c, d_a, d_d,
                            pb, pc, pa, pd, batch, s_len, di, stream);
  if (in_dtype == 1)
    return launch_ds<__nv_bfloat16>(ds, dt, a, bm, cm, x, d, hs, gy, gh, d_dt, d_x, d_b, d_c,
                                    d_a, d_d, pb, pc, pa, pd, batch, s_len, di, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
