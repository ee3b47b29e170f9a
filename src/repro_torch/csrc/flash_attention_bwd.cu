// Backward of the port's GQA flash attention for sm_90a, on the CUDA cores,
// for float32 tensors (the reduced parity configs): dQ, dK and dV from q, k,
// v, the forward's output o and row logsumexp lse, and dO. bfloat16 tensors
// (serving and training at full width) take the tensor-core kernel in
// flash_attention_bwd_wgmma.cu, as the float32 forward (flash_attention.cu)
// stays beside the bf16 one.
//
// Replaces no TPU kernel: the JAX package trains through autodiff of the
// jnp chunked_attention (src/repro/models/layers.py), and its Pallas kernel
// (src/repro/kernels/flash_attention/kernel.py:flash_attention_kernel) has
// no backward. The port's training runs its forward through the
// flash_attention kernels (flash_attention.cu, flash_attention_wgmma.cu,
// which write lse for it), so it needs a backward of its own: this kernel,
// behind kernels/flash_attention/ops.py:FlashAttentionFn.
//
// What it computes, for q (B, S, H, DQK), k (B, T, Hkv, DQK), v (B, T, Hkv,
// DV), o and dO (B, S, H, DV) in the model layout, lse (B, H, S) float32,
// G = H / Hkv, and the forward's mask (key t visible to query s iff t < T,
// t <= s when causal, t > s - window when window > 0; or, where the caller
// passes q_pos and k_pos, t < T and positions.cuh's rule):
//   D[s]    = sum_d dO[s, d] o[s, d]                      (pass 1)
//   P[s, t] = exp(scale q[s] . k[t] - lse[s]) if visible, else 0
//   dP      = dO V^T          dS = P * (dP - D)
//   dV[t]   = sum_{g, s} P[s, t] dO[s]       dK[t] = scale sum_{g, s} dS[s, t] q[s]   (pass 2)
//   dQ[s]   = scale sum_t dS[s, t] k[t]                                              (pass 3)
// every product and sum in float32, P and dS kept in float32, as the
// float32 forward keeps P. kernels/flash_attention/contract.py holds the
// result to the same formulas in float64 on the same inputs.
//
// Determinism: no atomics. Pass 2 runs one CTA per (b, kv head, 64-key
// tile), which sums its keys' dK and dV over the G query heads of the kv
// head and over their query tiles in a fixed order in registers; pass 3
// runs one CTA per (b, q head, 64-row q tile) over its key tiles in order.
// Two calls on the same inputs give the same bits.
//
// Bound: the five products over the visible pairs that the inputs require
// (S recomputed, dP, dV, dK, dQ; this kernel computes S and dP twice, in
// pass 2 and pass 3, seven in all) at 67 TFLOP/s, the H100's float32 rate
// on the CUDA cores. The reduced configs' shapes (a few hundred rows, 2-4
// heads) are far below the size where that rate is reached; they are
// parity checks, not a hot path. At granite-3-8b's full-width layer in bf16
// (B=4, S=T=2048, H=32, Hkv=8, D=128, causal) this kernel took 21.96 ms
// (PERF.md row 4b) against a bound of 0.348 ms on the tensor cores, which
// is why bf16 moved to flash_attention_bwd_wgmma.cu.
//
// Design (a CUDA-core kernel that is right first). 256 threads a CTA; the
// tiles it works on are staged in shared memory as float32 rows padded by 4
// floats, so that the float4 reads of 8 neighbouring threads along
// different rows hit distinct banks:
// - a score tile (64 x 64) is 4 x 4 scores a thread (rows tr + 16i, keys tc
//   + 16j), dot products over float4 columns; dP takes the same layout, so
//   dS = P (dP - D) is formed in registers and written to shared memory;
// - pass 2 keeps its 64 keys' dK (64 x DQK) and dV (64 x DV) in registers,
//   4 keys x DQK/16 (DV/16) columns a thread (columns cg + 16j), and reads
//   P and dS of a q tile as float4 from shared memory;
// - pass 3 keeps its 64 rows' dQ in registers, 4 rows x DQK/16 columns a
//   thread, and reads dS and the K tile from shared memory.
// Tiles that the mask hides from the whole tile (above the diagonal, or
// wholly outside the window) are skipped, as in the forward; under positions
// (the kPos instantiation) a tile is skipped where the ranges of its
// positions and the CTA's own (warp_range) admit no visible pair, and each P
// element is masked by its row's and key's positions. A skipped tile adds
// exact zeros, so the skips never change a bit.
// Shared memory at (128, 128): K, V, q and dO 34 KB each, P and dS 17 KB
// each, 170 KB, one CTA an SM.
//
// Built by nvcc into a shared library with a C interface
// (repro_torch/kernels/build.py); the Python wrapper
// repro_torch/kernels/flash_attention/ops.py:flash_attention_bwd launches it
// on torch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "positions.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows of a q tile, keys of a key tile
constexpr int kPad = 4;    // floats of padding per staged row
constexpr int kLdS = kTile + kPad;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// `rows` rows of D elements from `src` (row stride `stride` elements) into
// float32 shared memory at row stride D + kPad; rows at or past `valid` are 0.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int64_t stride,
                                      int rows, int valid) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + kPad) + c] = r < valid ? src[r * stride + c] : 0.0f;
  }
}

// acc[i][j] = A[tr + 16i] . B[tc + 16j] over D columns: a 4 x 4 block of a
// 64 x 64 product of two row-major tiles at row stride D + kPad.
template <int D>
__device__ __forceinline__ void tile_dots(float (&acc)[4][4], const float* a, const float* b,
                                          int tr, int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = load4(a + (tr + 16 * i) * (D + kPad) + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = load4(b + (tc + 16 * j) * (D + kPad) + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dot4(av[i], bv[j], acc[i][j]);
  }
}

// The mask by index, or (kPos) by the positions.
template <bool kPos>
struct Mask {
  int s_len, t_len, causal, window;
  const int* q_pos;
  const int* k_pos;
  __device__ __forceinline__ bool visible(int row, int key) const {
    if constexpr (kPos) {
      return row < s_len && key < t_len && pos_visible(q_pos[row], k_pos[key], causal, window);
    } else {
      return row < s_len && key < t_len && (!causal || key <= row) &&
             (window <= 0 || key > row - window);
    }
  }
};

// P and dS of a (q tile, key tile) pair into shared memory (row stride
// kLdS): the thread's 4 x 4 block, rows q0 + tr + 16i, keys k0 + tc + 16j.
template <int DQK, int DV, typename M>
__device__ __forceinline__ void scores(float* p_s, float* ds_s, const float* q_s,
                                       const float* k_s, const float* do_s, const float* v_s,
                                       const float* lse_s, const float* dd_s, int q0, int k0,
                                       const M& mask, float scale) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float s[4][4], dp[4][4];
  tile_dots<DQK>(s, q_s, k_s, tr, tc);
  tile_dots<DV>(dp, do_s, v_s, tr, tc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 16 * j;
      const float p = mask.visible(q0 + r, k0 + c) ? expf(fmaf(s[i][j], scale, -lse_s[r])) : 0.0f;
      p_s[r * kLdS + c] = p;
      ds_s[r * kLdS + c] = p * (dp[i][j] - dd_s[r]);
    }
  }
}

template <int DQK, int DV>
struct Smem {
  float k[kTile][DQK + kPad];
  float v[kTile][DV + kPad];
  float q[kTile][DQK + kPad];
  float dout[kTile][DV + kPad];
  float p[kTile][kLdS];
  float ds[kTile][kLdS];
  float lse[kTile];
  float dd[kTile];
};

// Pass 1: D[b, h, s] = sum_d dO[b, s, h, d] o[b, s, h, d]; a warp a row.
template <int DV>
__global__ void __launch_bounds__(kThreads)
row_dots_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                float* __restrict__ dd, int n_heads, int s_len) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int h = blockIdx.y, b = blockIdx.z, lane = threadIdx.x % 32;
  if (row >= s_len) return;
  const int64_t base = ((static_cast<int64_t>(b) * s_len + row) * n_heads + h) * DV;
  float acc = 0.0f;
  for (int d = lane; d < DV; d += 32)
    acc = fmaf(dout[base + d], out[base + d], acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) dd[(static_cast<int64_t>(b) * n_heads + h) * s_len + row] = acc;
}

// Pass 2: dK and dV of one (b, kv head, key tile), summed over the kv head's
// G query heads and their visible query tiles, in that order.
template <int DQK, int DV, bool kPos>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ dd, float* __restrict__ dk,
           float* __restrict__ dv, const int* __restrict__ q_pos, const int* __restrict__ k_pos,
           int n_heads, int n_kv_heads, int s_len, int t_len, int causal, int window,
           float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DQK, DV>& sm = *reinterpret_cast<Smem<DQK, DV>*>(smem_raw);
  constexpr int kCk = DQK / 16, kCv = DV / 16;  // columns a thread holds
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int g_count = n_heads / n_kv_heads;
  const int kg = threadIdx.x / 16, cg = threadIdx.x % 16;  // keys 4kg .. 4kg+3
  const Mask<kPos> mask{s_len, t_len, causal, window, q_pos, k_pos};

  const int64_t k_stride = static_cast<int64_t>(n_kv_heads) * DQK;
  const int64_t v_stride = static_cast<int64_t>(n_kv_heads) * DV;
  const int64_t q_stride = static_cast<int64_t>(n_heads) * DQK;
  const int64_t o_stride = static_cast<int64_t>(n_heads) * DV;
  stage<DQK>(&sm.k[0][0], k + (static_cast<int64_t>(b) * t_len + k0) * k_stride + hk * DQK,
             k_stride, kTile, t_len - k0);
  stage<DV>(&sm.v[0][0], v + (static_cast<int64_t>(b) * t_len + k0) * v_stride + hk * DV,
            v_stride, kTile, t_len - k0);

  float acc_k[4][kCk], acc_v[4][kCv];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCk; ++c) acc_k[i][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCv; ++c) acc_v[i][c] = 0.0f;
  }

  // query rows that see some key of the tile: q_lo .. q_hi (under positions
  // every q tile is judged by its range against the key tile's)
  const int k_last = min(k0 + kTile, t_len) - 1;
  const int q_lo = !kPos && causal ? k0 : 0;
  const int q_hi = !kPos && window > 0 ? min(s_len - 1, k_last + window - 1) : s_len - 1;
  Range k_range{0, 0};
  if constexpr (kPos) k_range = warp_range(k_pos, k0, kTile, t_len);
  for (int g = 0; g < g_count; ++g) {
    const int h = hk * g_count + g;
    for (int q0 = (q_lo / kTile) * kTile; q0 <= q_hi; q0 += kTile) {
      if constexpr (kPos) {  // the same in every warp
        if (!any_visible(warp_range(q_pos, q0, kTile, s_len), k_range, causal, window)) continue;
      }
      __syncthreads();  // the previous q tile is no longer read
      const int64_t row0 = static_cast<int64_t>(b) * s_len + q0;
      stage<DQK>(&sm.q[0][0], q + row0 * q_stride + h * DQK, q_stride, kTile, s_len - q0);
      stage<DV>(&sm.dout[0][0], dout + row0 * o_stride + h * DV, o_stride, kTile, s_len - q0);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const int64_t at = (static_cast<int64_t>(b) * n_heads + h) * s_len + q0 + r;
        sm.lse[r] = q0 + r < s_len ? lse[at] : 0.0f;
        sm.dd[r] = q0 + r < s_len ? dd[at] : 0.0f;
      }
      __syncthreads();
      scores<DQK, DV>(&sm.p[0][0], &sm.ds[0][0], &sm.q[0][0], &sm.k[0][0], &sm.dout[0][0],
                      &sm.v[0][0], sm.lse, sm.dd, q0, k0, mask, scale);
      __syncthreads();
      // dV += P^T dO and dK += dS^T q over the tile's rows, in order
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        const float4 p4 = load4(&sm.p[r][4 * kg]);
        const float4 s4 = load4(&sm.ds[r][4 * kg]);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int c = 0; c < kCv; ++c) {
          const float o = sm.dout[r][cg + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_v[i][c] = fmaf(pv[i], o, acc_v[i][c]);
        }
#pragma unroll
        for (int c = 0; c < kCk; ++c) {
          const float x = sm.q[r][cg + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_k[i][c] = fmaf(sv[i], x, acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * kg + i;
    if (key < t_len) {
      const int64_t row = static_cast<int64_t>(b) * t_len + key;
      float* dkr = dk + row * k_stride + hk * DQK;
      float* dvr = dv + row * v_stride + hk * DV;
#pragma unroll
      for (int c = 0; c < kCk; ++c) dkr[cg + 16 * c] = acc_k[i][c] * scale;
#pragma unroll
      for (int c = 0; c < kCv; ++c) dvr[cg + 16 * c] = acc_v[i][c];
    }
  }
}

// Pass 3: dQ of one (b, q head, q tile) over its visible key tiles, in order.
template <int DQK, int DV, bool kPos>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dd, float* __restrict__ dq,
          const int* __restrict__ q_pos, const int* __restrict__ k_pos, int n_heads,
          int n_kv_heads, int s_len, int t_len, int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DQK, DV>& sm = *reinterpret_cast<Smem<DQK, DV>*>(smem_raw);
  constexpr int kCk = DQK / 16;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;  // rows 4rg .. 4rg+3
  const Mask<kPos> mask{s_len, t_len, causal, window, q_pos, k_pos};

  const int64_t k_stride = static_cast<int64_t>(n_kv_heads) * DQK;
  const int64_t v_stride = static_cast<int64_t>(n_kv_heads) * DV;
  const int64_t q_stride = static_cast<int64_t>(n_heads) * DQK;
  const int64_t o_stride = static_cast<int64_t>(n_heads) * DV;
  const int64_t row0 = static_cast<int64_t>(b) * s_len + q0;
  stage<DQK>(&sm.q[0][0], q + row0 * q_stride + h * DQK, q_stride, kTile, s_len - q0);
  stage<DV>(&sm.dout[0][0], dout + row0 * o_stride + h * DV, o_stride, kTile, s_len - q0);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int64_t at = (static_cast<int64_t>(b) * n_heads + h) * s_len + q0 + r;
    sm.lse[r] = q0 + r < s_len ? lse[at] : 0.0f;
    sm.dd[r] = q0 + r < s_len ? dd[at] : 0.0f;
  }

  float acc[4][kCk];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCk; ++c) acc[i][c] = 0.0f;

  // keys visible to some row of the tile: lo .. hi (under positions every
  // key tile is judged by its range against the q tile's)
  const int q_last = min(q0 + kTile, s_len) - 1;
  const int lo = !kPos && window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = !kPos && causal ? min(t_len - 1, q_last) : t_len - 1;
  Range q_range{0, 0};
  if constexpr (kPos) q_range = warp_range(q_pos, q0, kTile, s_len);
  for (int k0 = (lo / kTile) * kTile; k0 <= hi; k0 += kTile) {
    if constexpr (kPos) {  // the same in every warp
      if (!any_visible(q_range, warp_range(k_pos, k0, kTile, t_len), causal, window)) continue;
    }
    __syncthreads();  // the previous key tile is no longer read
    const int64_t key0 = static_cast<int64_t>(b) * t_len + k0;
    stage<DQK>(&sm.k[0][0], k + key0 * k_stride + hk * DQK, k_stride, kTile, t_len - k0);
    stage<DV>(&sm.v[0][0], v + key0 * v_stride + hk * DV, v_stride, kTile, t_len - k0);
    __syncthreads();
    scores<DQK, DV>(&sm.p[0][0], &sm.ds[0][0], &sm.q[0][0], &sm.k[0][0], &sm.dout[0][0],
                    &sm.v[0][0], sm.lse, sm.dd, q0, k0, mask, scale);
    __syncthreads();
    // dQ += dS K over the tile's keys, in order
#pragma unroll 2
    for (int t = 0; t < kTile; ++t) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sm.ds[4 * rg + i][t];
#pragma unroll
      for (int c = 0; c < kCk; ++c) {
        const float x = sm.k[t][cg + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(sv[i], x, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row < s_len) {
      float* dqr = dq + (static_cast<int64_t>(b) * s_len + row) * q_stride + h * DQK;
#pragma unroll
      for (int c = 0; c < kCk; ++c) dqr[cg + 16 * c] = acc[i][c] * scale;
    }
  }
}

template <int DQK, int DV, bool kPos>
int launch(const void* q, const void* k, const void* v, const void* out, const void* lse,
           const void* dout, void* dq, void* dk, void* dv, void* dd, const int* q_pos,
           const int* k_pos, int batch, int n_heads, int n_kv_heads, int s_len, int t_len,
           int causal, int window, float scale, void* stream) {
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "16 column groups of a thread block");
  constexpr int smem = static_cast<int>(sizeof(Smem<DQK, DV>));
  static_assert(smem <= 232448, "over the 227 KB of shared memory an H100 block may take");
  static bool configured = false;  // raise the dynamic shared memory limit once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(dkv_kernel<DQK, DV, kPos>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dq_kernel<DQK, DV, kPos>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (batch == 0 || n_heads == 0 || s_len == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const float* lse_f = static_cast<const float*>(lse);
  float* dd_f = static_cast<float*>(dd);
  row_dots_kernel<DV><<<dim3((s_len + 7) / 8, n_heads, batch), kThreads, 0, st>>>(
      static_cast<const float*>(out), dot, dd_f, n_heads, s_len);
  if (t_len > 0) {
    dkv_kernel<DQK, DV, kPos><<<dim3((t_len + kTile - 1) / kTile, n_kv_heads, batch), kThreads,
                                   smem, st>>>(qt, kt, vt, dot, lse_f, dd_f,
                                               static_cast<float*>(dk), static_cast<float*>(dv),
                                               q_pos, k_pos, n_heads, n_kv_heads, s_len, t_len,
                                               causal, window, scale);
  }
  dq_kernel<DQK, DV, kPos><<<dim3((s_len + kTile - 1) / kTile, n_heads, batch), kThreads, smem,
                             st>>>(qt, kt, vt, dot, lse_f, dd_f, static_cast<float*>(dq), q_pos,
                                   k_pos, n_heads, n_kv_heads, s_len, t_len, causal, window,
                                   scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// float32 q (B, S, H, head_dim), k (B, T, Hkv, head_dim), v (B, T, Hkv,
// head_dim_v), out and dout (B, S, H, head_dim_v), dq, dk, dv like q, k, v,
// contiguous; lse (B, H, S) float32 from the forward; dd a float32 (B, H,
// S) scratch; q_pos and k_pos both null (the index mask) or the forward's
// int32 (S,) and (T,) position vectors. (head_dim, head_dim_v): (64, 64),
// (128, 128) or (48, 32).
// Enqueues three grids on `stream`; returns cudaGetLastError() after them
// (0 = launched).
int repro_flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                                  const void* lse, const void* dout, void* dq, void* dk,
                                  void* dv, void* dd, const int* q_pos, const int* k_pos,
                                  int batch, int n_heads, int n_kv_heads, int s_len, int t_len,
                                  int head_dim, int head_dim_v, int causal, int window,
                                  float scale, void* stream) {
#define REPRO_FA_BWD(DQK, DV)                                                                   \
  if (head_dim == DQK && head_dim_v == DV) {                                                  \
    if (q_pos != nullptr)                                                                     \
      return launch<DQK, DV, true>(q, k, v, out, lse, dout, dq, dk, dv, dd, q_pos, k_pos,     \
                                   batch, n_heads, n_kv_heads, s_len, t_len, causal, window,  \
                                   scale, stream);                                            \
    return launch<DQK, DV, false>(q, k, v, out, lse, dout, dq, dk, dv, dd, q_pos, k_pos,      \
                                  batch, n_heads, n_kv_heads, s_len, t_len, causal, window,   \
                                  scale, stream);                                             \
  }
  REPRO_FA_BWD(64, 64)
  REPRO_FA_BWD(128, 128)
  REPRO_FA_BWD(48, 32)
#undef REPRO_FA_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
