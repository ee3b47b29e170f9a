// Causal GQA flash attention in float32 for sm_90a, on the CUDA cores —
// the port's flash_attention kernel for float32 inputs (the reduced parity
// configs). bfloat16 inputs go to the tensor-core kernel in
// flash_attention_wgmma.cu; this library has no bfloat16 entry.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention/kernel.py:flash_attention_kernel
//   (_fa_kernel; wrapper ops.flash_attention)
//
// What it computes, for q (B, S, H, DQK), k (B, T, Hkv, DQK) and v (B, T,
// Hkv, DV) in float32 in the model's layout ((DQK, DV) = (64, 64), (128,
// 128), or the reduced MLA configs' (48, 32)), with G = H / Hkv:
//   out[b, s, h] = softmax_t(mask(q[b, s, h] . k[b, t, h / G] * scale)) @ v[b, :, h / G]
// where key t is visible to query s iff t < T (the real kv length; the
// Pallas kernel's t_real), t <= s when causal, and t > s - window when
// window > 0. Positions are the indices (query s and key t both count from
// 0), as in the Pallas kernel, unless the caller passes position vectors
// q_pos (S,) and k_pos (T,): then key t is visible to query s iff t < T and
// positions.cuh's rule holds (JAX's chunked_attention mask, which M-RoPE's t
// stream needs). The softmax is online over 64-key tiles, as
// the Pallas kernel does it: float32 scores, running max m and sum l,
// float32 P and a float32 P.V accumulator; out = acc / max(l, 1e-30). A
// masked key contributes p = 0 exactly. Where the caller passes an `lse`
// pointer (training: the backward in flash_attention_bwd.cu recomputes P
// from it), the kernel also writes the row's float32 logsumexp of the
// scaled scores, lse[b, h, s] = m + log(max(l, 1e-30)), (B, H, S); a null
// pointer writes nothing else and leaves every other instruction as it was.
//
// Bound: operations. In float32 the work runs on the CUDA cores (67
// TFLOP/s on an H100); at granite-3-8b's prefill shape (B=4, S=T=2048,
// H=32, Hkv=8, D=128) the visible half of the scores is 0.1375 TFLOP, a
// 2.05 ms floor.
//
// Design: the TPU kernel's grid walks kv blocks in order with m, l and acc
// in VMEM scratch; here one thread block owns one (b, q-head, 64-row
// q-tile) and walks the key tiles of kv head h / G itself, so nothing
// carries between blocks. The q tile and each 64-key K and V tile are
// staged in shared memory (K rows padded by 4 floats so that a
// warp's 16-byte row reads hit distinct banks). Each of the 8 warps owns 8
// query rows; lane l scores keys l and l+32 of the tile for all 8 rows
// (16 independent dot products), the row max and sum are warp shuffles,
// and for P.V lane l owns output columns l, l+32, ... (DV/32 of them) of its 8 rows, taking
// each p from the lane that scored it by shuffle. Key tiles that the mask
// hides from every row of the q tile (above the diagonal, or wholly before
// the window) are skipped: for a row with a visible key that leaves m, l and
// acc as processing them would. Under positions (a second instantiation,
// kPos; null pointers launch the index one, unchanged) every key tile is
// judged by the range of its 64 positions, each warp reducing the two it
// reads a lane (warp_range), against the q tile's range: skipped where no
// pair can be visible; each score is masked by its row's and key's
// positions, read from global memory.
//
// ptxas (CUDA 12.8): index mask 118, 128 and 120 registers at (64, 64),
// (128, 128) and (48, 32), 4 bytes of spill at (128, 128); position mask
// 123, 128 and 128, 40 and 16 bytes of spill at (128, 128) and (48, 32).
//
// Built by nvcc into a shared library with a C interface
// (repro_torch/kernels/build.py); the Python wrapper in
// repro_torch/kernels/flash_attention/ops.py launches it on torch's current
// stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "positions.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 64;    // query rows per block
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp
constexpr int kBlockK = 64;    // keys per tile: lane l scores keys l and l + 32
constexpr int kKPad = 4;       // floats of padding per staged K row
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}


// Stages `rows` rows of D elements (a multiple of 4) starting at `src`
// (row stride `stride` elements) into `dst` (row stride `ld` floats); rows
// at or past `valid` are zero.
template <int D>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, int64_t stride,
                                      int rows, int valid) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < valid) v = load4(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DQK, int DV>
constexpr int smem_bytes() {
  return (kBlockQ * DQK + kBlockK * (DQK + kKPad) + kBlockK * DV) * 4;
}

template <int DQK, int DV, bool kPos>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, int n_heads, int n_kv_heads, int s_len,
                       int t_len, int causal, int window, float scale) {
  static_assert(DQK % 4 == 0 && DV % 32 == 0, "float4 rows of q and k; 32-lane columns of v");
  constexpr int kCols = DV / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;                                  // [kBlockQ][DQK]
  float* k_s = q_s + kBlockQ * DQK;                   // [kBlockK][DQK + kKPad]
  float* v_s = k_s + kBlockK * (DQK + kKPad);         // [kBlockK][DV]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int64_t q_stride = static_cast<int64_t>(n_heads) * DQK;    // between sequence rows
  const int64_t k_stride = static_cast<int64_t>(n_kv_heads) * DQK;
  const int64_t v_stride = static_cast<int64_t>(n_kv_heads) * DV;
  const int64_t o_stride = static_cast<int64_t>(n_heads) * DV;
  const float* q_base = q + (static_cast<int64_t>(b) * s_len + q0) * q_stride + h * DQK;
  const float* k_base = k + static_cast<int64_t>(b) * t_len * k_stride + hk * DQK;
  const float* v_base = v + static_cast<int64_t>(b) * t_len * v_stride + hk * DV;

  stage<DQK>(q_s, DQK, q_base, q_stride, kBlockQ, s_len - q0);

  // keys visible to some row of this tile: [lo, hi] (under positions every
  // key tile is judged by its range against the q tile's)
  const int q_last = min(q0 + kBlockQ, s_len) - 1;
  const int lo = !kPos && window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = !kPos && causal ? min(t_len - 1, q_last) : t_len - 1;
  Range q_range{0, 0};
  int row_pos[kRows];  // the positions of the warp's rows (any value past S)
  if constexpr (kPos) {
    q_range = warp_range(q_pos, q0, kBlockQ, s_len);
#pragma unroll
    for (int i = 0; i < kRows; ++i) row_pos[i] = q_pos[min(q0 + warp * kRows + i, s_len - 1)];
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = (lo / kBlockK) * kBlockK; k0 <= hi; k0 += kBlockK) {
    int key_pos[2];  // positions of keys k0 + lane and k0 + lane + 32 (-1 past T)
    if constexpr (kPos) {
      key_pos[0] = k0 + lane < t_len ? k_pos[k0 + lane] : -1;
      key_pos[1] = k0 + lane + 32 < t_len ? k_pos[k0 + lane + 32] : -1;
      const Range k_range = warp_range(k_pos, k0, kBlockK, t_len);
      if (!any_visible(q_range, k_range, causal, window)) continue;  // the same in every warp
    }
    __syncthreads();  // the previous tile (and, first time, nothing) is no longer read
    stage<DQK>(k_s, DQK + kKPad, k_base + k0 * k_stride, k_stride, kBlockK, t_len - k0);
    stage<DV>(v_s, DV, v_base + k0 * v_stride, v_stride, kBlockK, t_len - k0);
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 for the warp's rows
    float p[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) p[i][0] = p[i][1] = 0.0f;
    const float* ka = k_s + lane * (DQK + kKPad);
    const float* kb = k_s + (lane + 32) * (DQK + kKPad);
#pragma unroll 4
    for (int d = 0; d < DQK; d += 4) {
      const float4 x0 = load4(ka + d), x1 = load4(kb + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = load4(q_s + (warp * kRows + i) * DQK + d);
        p[i][0] += qv.x * x0.x + qv.y * x0.y + qv.z * x0.z + qv.w * x0.w;
        p[i][1] += qv.x * x1.x + qv.y * x1.y + qv.z * x1.z + qv.w * x1.w;
      }
    }

    // online softmax: mask, row max, p = exp(s - m_new), rescale l and acc
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + warp * kRows + i;
      bool vis[2];
      float s[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + lane + 32 * c;
        if constexpr (kPos) {
          vis[c] = key < t_len && pos_visible(row_pos[i], key_pos[c], causal, window);
        } else {
          vis[c] = key < t_len && (!causal || key <= row) && (window <= 0 || key > row - window);
        }
        s[c] = vis[c] ? p[i][c] * scale : kNeg;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[0], s[1])));
      p[i][0] = vis[0] ? expf(s[0] - m_new) : 0.0f;
      p[i][1] = vis[1] ? expf(s[1] - m_new) : 0.0f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p[i][0] + p[i][1]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }

    // acc += P . V: lane owns columns lane + 32c; p of key j from lane j % 32
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const float* vr = v_s + (half * 32 + j) * DV + lane;
        float vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[c] = vr[32 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float pj = __shfl_sync(0xffffffffu, p[i][half], j);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] += pj * vv[c];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + warp * kRows + i;
    if (row < s_len) {
      const float denom = fmaxf(l[i], 1e-30f);
      float* o = out + (static_cast<int64_t>(b) * s_len + row) * o_stride + h * DV + lane;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[32 * c] = acc[i][c] / denom;
      if (lse != nullptr && lane == 0)
        lse[(static_cast<int64_t>(b) * n_heads + h) * s_len + row] = m[i] + logf(denom);
    }
  }
}

template <int DQK, int DV, bool kPos>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, const int* q_pos,
           const int* k_pos, int batch, int n_heads, int n_kv_heads, int s_len, int t_len,
           int causal, int window, float scale, void* stream) {
  static bool configured = false;  // raise the dynamic shared memory limit once
  constexpr int smem = smem_bytes<DQK, DV>();
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<DQK, DV, kPos>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((s_len + kBlockQ - 1) / kBlockQ, n_heads, batch);
  if (grid.x > 0 && grid.y > 0 && grid.z > 0) {
    flash_attention_kernel<DQK, DV, kPos>
        <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(lse),
            q_pos, k_pos, n_heads, n_kv_heads, s_len, t_len, causal, window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch_mask(const void* q, const void* k, const void* v, void* out, void* lse,
                const int* q_pos, const int* k_pos, int batch, int n_heads, int n_kv_heads,
                int s_len, int t_len, int causal, int window, float scale, void* stream) {
  if (q_pos != nullptr)
    return launch<DQK, DV, true>(q, k, v, out, lse, q_pos, k_pos, batch, n_heads, n_kv_heads,
                                 s_len, t_len, causal, window, scale, stream);
  return launch<DQK, DV, false>(q, k, v, out, lse, q_pos, k_pos, batch, n_heads, n_kv_heads,
                                s_len, t_len, causal, window, scale, stream);
}

}  // namespace

extern "C" {

// float32 q (B, S, H, DQK), k (B, T, Hkv, DQK), v (B, T, Hkv, DV) and out
// (B, S, H, DV), contiguous with 16-byte aligned starts; (head_dim,
// head_dim_v) = (64, 64), (128, 128) or (48, 32); H a multiple of Hkv;
// lse null, or float32 (B, H, S) for the rows' logsumexp; q_pos and k_pos
// both null (the index mask), or int32 (S,) and (T,) position vectors.
// Returns cudaGetLastError() after the launch (0 = launched).
int repro_flash_attention_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                              const int* q_pos, const int* k_pos, int batch, int n_heads,
                              int n_kv_heads, int s_len, int t_len, int head_dim, int head_dim_v,
                              int causal, int window, float scale, void* stream) {
#define REPRO_FA(DQK, DV)                                                                     \
  if (head_dim == DQK && head_dim_v == DV)                                                    \
    return launch_mask<DQK, DV>(q, k, v, out, lse, q_pos, k_pos, batch, n_heads, n_kv_heads,  \
                                s_len, t_len, causal, window, scale, stream);
  REPRO_FA(64, 64)
  REPRO_FA(128, 128)
  REPRO_FA(48, 32)
#undef REPRO_FA
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
