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
// ds=16), per update (b, t, c, n): at least one exp (da) and 11 FP32-pipe
// instructions, the count of this kernel's reverse step (7: the fmas into
// g, sum g B, the d_dt sum and d_A, the d_B share, the products g da and
// g da h_{t-1}) and of the recompute that gives it h_{t-1} (4: dt A',
// (dt x) B, the state's fma, the d_C share). 1.07 G exps on the
// special-function unit (4.18e12/s): 0.257 ms; 11.8 G instructions at
// 33.5e12/s: 0.352 ms; bytes: dt, x, B, C read once in bf16, gy in
// float32, hs (34 MB at 16 chunks), the four stream-type outputs written
// once, 0.57 GB: 0.17 ms. So the FP32 pipe binds. The checkpointed chunk
// sweep costs one more exp and 3 instructions an update on top.
//
// Design. A thread block holds 64 neighbouring channels of one batch row
// and walks the sequence inside the threads, g carried in registers across
// the chunks (last to first). A thread holds 2 neighbouring channels and a
// quarter of their states (4 at ds = 16, 2 at ds = 8): 8 values, 4 lanes a
// channel pair, 128 threads. Each chunk is swept once from its saved start
// state, keeping the state at each 8-step segment's start in shared
// memory; then segment by segment from the last, the segment's states are
// recomputed into registers and the reverse steps run over them. Against
// what held back the simpler kernel this one replaced (every step's inputs
// loaded from device memory in every pass, three exps an element, shuffle
// reductions every step, few warps):
// 1. Staging. The sequence goes through shared memory in stages, by
//    16-byte cp.async into a ring of 3 stages (2 for float32 streams), one
//    __syncthreads a stage. A stage pairs one reverse segment of chunk ci
//    (dt, x, gy, B, C) with one sweep segment of chunk ci - 1 (dt, x, B):
//    the sweep of the next chunk to reverse runs beside this chunk's
//    reverse pass, so a 128-step chunk takes 16 stages, not 31, and the
//    sweep's segment starts go to the slots the reverse pass has just read
//    (start_slot). The last chunk's sweep runs alone first. Each input is
//    read from device memory once per pass (sweep, reverse). B and C rows,
//    which every channel reads, are converted to float32 once a stage, 4
//    elements a thread. Rows past S and channels past di are zero-filled
//    (dt = x = B = C = gy = 0 leaves h and g unchanged, since 2^0 = 1, and
//    adds 0 to every sum); unaligned pointers or di not a multiple of the
//    vector take scalar copies (copy_scalar) with the same layout.
// 2. Two exps per element, the sweep's and the recompute's: the recompute
//    keeps h_{t-1} and da of its 8 steps in registers (128 of them) for
//    the reverse steps. The recompute also forms the d_C shares (h_t gy_t
//    needs no g), the reverse steps the d_B shares.
// 3. Reductions. d_B and d_C sum over channels: each thread sums its 2
//    channels in its fma chain, writes its 4 shares a step to a per-warp
//    buffer, and after each 8-step phase every lane adds one float4 of
//    shares over the warp's 8 pairs; the 4 warps' sums are added after the
//    next stage's barrier (double-buffered), in a fixed order, into the
//    block's float32 partial (di / 64, B, S, ds). sum_n g B and the d_dt
//    sum go over a pair's 4 lanes for all 8 steps at once after the
//    reverse steps (a reduce-scatter of 3 shuffles and one exchange a
//    step, no branch between steps); each lane's 8 outputs (d_dt or d_x of
//    one of its 2 channels) go through a tile in the warp's share buffer
//    to 16-byte stores. d_A and d_D sum over batch and time in registers
//    and go out as (B, di, ds) and (B, di) partials. A second grid adds
//    the partials in a fixed order (block by block, batch entry by batch
//    entry). No float atomics: two calls give the same bits.
// 4. Waves. 254-255 registers a thread (h_{t-1}, da, g, A', A, the d_A
//    sums, the sweep's state), no spills; about 109 KB of shared memory a
//    block (segment starts: 15 slots x 8 values x 128 threads x 4 bytes =
//    60 KB), so two blocks an SM (8 warps), __launch_bounds__(128, 2):
//    falcon-mamba's 512 blocks run in two full waves (264 + 248). One wave
//    would need the 524,288 states' segment starts on the card at once
//    (254 KB an SM at 8-step segments, or 16-step segments and twice the
//    registers), which does not fit.
// - The last chunk may be ragged (S not a multiple of 128, or S < 128): it
//   has ceil(steps / 8) segments, the padded steps are zeros and write
//   nothing.
//
// Variants measured with launch/ssm_bwd_ab.py (median of 20 eager calls at
// falcon's layer, S 2048, bf16; each against the kernel of its day in one
// call on an H100 80GB HBM3 at 700 W; PERF.md has every reading): the
// first redesign (8-step stages, the sweep in stages of its own, a
// shuffle chain and a store a reverse step) 2.33 ms against the replaced
// kernel's 6.49-6.58; one stage less in flight, da recomputed (three
// exps) and A from shared memory: no gain; 3 blocks an SM (168
// registers, at ds 8): no gain; loops rolled with register rotation: 3.5
// ms; stores without branches, but per step: slower (8 bytes of spills).
// The pairing of sweep and reverse segments: 2.17; the pair sums and
// stores batched after the 8 steps: 2.03-2.07; float2 block sums on all
// threads and the output channel's x, dt, gy kept from the reverse steps:
// 1.95; the 4-element B/C conversion: 1.86.
//
// Built by nvcc into a shared library with a C interface
// (repro_torch/kernels/build.py); the Python wrapper
// repro_torch/kernels/ssm_scan/ops.py:ssm_scan_bwd launches it on torch's
// current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChannels = 64;                 // channels per block
constexpr int kPairs = kChannels / 2;         // a thread holds 2 neighbouring channels
constexpr int kQ = 4;                         // lanes a pair's states are split over
constexpr int kThreads = kPairs * kQ;         // 128
constexpr int kWarps = kThreads / 32;
constexpr int kWarpPairs = 32 / kQ;           // pairs of a warp
constexpr int kChunk = 128;                   // steps between saved states (ssm_vjp.CHUNK)
constexpr int kSeg = 8;                       // steps of a segment, and of a stage
constexpr int kSegs = kChunk / kSeg;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

template <typename Tin>
__host__ __device__ constexpr int ring() {  // stages of the staging ring
  return std::is_same<Tin, float>::value ? 2 : 3;
}

template <typename Tin, int DS>
struct Stage {  // one stage's inputs as loaded
  // the reverse segment: dt, x, gy, B, C
  Tin dt[kSeg][kChannels];
  Tin x[kSeg][kChannels];
  float gy[kSeg][kChannels];
  Tin b[kSeg][DS];
  Tin c[kSeg][DS];
  // the sweep segment: dt, x, B
  Tin wdt[kSeg][kChannels];
  Tin wx[kSeg][kChannels];
  Tin wb[kSeg][DS];
};

template <typename Tin, int DS>
struct BcBuf {  // a stage's B and C rows (reverse) and B rows (sweep) in float32
  float v[2][3][kSeg][DS];
};
template <int DS>
struct BcBuf<float, DS> {};  // float32 streams read the staged rows

template <typename Tin, int DS>
struct Smem {  // every member 16-byte aligned (cp.async, float4)
  alignas(16) float start[kSegs - 1][2 * DS / kQ][kThreads];  // each thread's segment starts
  alignas(16) Stage<Tin, DS> raw[ring<Tin>()];
  alignas(16) BcBuf<Tin, DS> bc;
  alignas(16) float warp_sh[kWarps][kSeg][(kWarpPairs + 1) * DS];  // a phase's shares by pair (+ pad)
  alignas(16) float block_sh[2][2][kSeg][kWarps][DS];  // [stage parity][d_B, d_C][step][warp][n]
};

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

// 2 neighbouring stream elements (a thread's channel pair) as float32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// N (4 or 2) neighbouring floats of shared memory.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  }
}
template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// What stage s works on. First the sweep of the last chunk alone (its
// segments 0 .. nseg - 2, each storing the next segment's start); then, for
// each chunk ci from the last, a round of max(nseg(ci), 15) stages pairing
// the reverse pass over ci's segments (nseg(ci) - 1 .. 0) with the sweep of
// chunk ci - 1 (segments 0 .. 14). The last chunk has ceil(steps / kSeg)
// segments, the others kSegs.
struct StageInfo {
  bool rev, sweep;  // which parts the stage has
  int ci, seg;      // the reverse part's chunk and segment
  int wci, wseg;    // the sweep part's chunk (ci - 1, or the last chunk alone) and segment
};

__device__ __forceinline__ StageInfo stage_info(int s, int n_chunks, int last_segs) {
  StageInfo si;
  const int pro = last_segs - 1;
  if (s < pro) {
    si.rev = false, si.sweep = true, si.ci = n_chunks - 1, si.seg = 0;
    si.wci = n_chunks - 1, si.wseg = s;
    return si;
  }
  const int r0 = max(last_segs, n_chunks > 1 ? kSegs - 1 : 0);  // the last chunk's round
  int k, nseg;
  if (s - pro < r0) {
    si.ci = n_chunks - 1, k = s - pro, nseg = last_segs;
  } else {
    const int s2 = s - pro - r0;
    si.ci = n_chunks - 2 - s2 / kSegs, k = s2 % kSegs, nseg = kSegs;
  }
  si.rev = k < nseg, si.seg = nseg - 1 - k;
  si.sweep = si.ci >= 1 && k < kSegs - 1, si.wci = si.ci - 1, si.wseg = k;
  return si;
}

// The slot of chunk ci's segment seg (1 .. 15) start in Smem::start: in
// order for even chunks, reversed for odd ones, so that the sweep of chunk
// ci - 1 writes each slot just after the reverse pass over ci has read it.
__device__ __forceinline__ int start_slot(int ci, int seg) {
  return (ci & 1) ? kSegs - 1 - seg : seg - 1;
}

// Pieces [0, kN) of a copy spread over the block's threads, kN known here.
template <int kN, typename F>
__device__ __forceinline__ void for_pieces(F&& f) {
#pragma unroll
  for (int r = 0; r < (kN + kThreads - 1) / kThreads; ++r) {
    const int i = static_cast<int>(threadIdx.x) + r * kThreads;
    if (kN % kThreads == 0 || i < kN) f(i);
  }
}

// 16-byte cp.async copies of `steps` rows (zeros past them, and past di) of
// dt and x at (t0, c0) into sdt, sx, of B (and C, when sc) at row t0 into
// sb (sc), of gy (when sgy) into sgy.
template <typename Tin, int DS>
__device__ __forceinline__ void copy_vec(Tin (*sdt)[kChannels], Tin (*sx)[kChannels],
                                         float (*sgy)[kChannels], Tin (*sb)[DS], Tin (*sc)[DS],
                                         const Tin* __restrict__ dt, const Tin* __restrict__ x,
                                         const Tin* __restrict__ bm, const Tin* __restrict__ cm,
                                         const float* __restrict__ gy, int64_t row, int steps,
                                         int di, int c0) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(Tin));
  constexpr int kPieces = kChannels / kVec;  // 16-byte pieces of a dt or x row
  const int64_t base = row * di + c0;        // (t0, c0) in dt, x and gy
  for_pieces<kSeg * kPieces>([&](int i) {
    const int t = i / kPieces, cc = (i % kPieces) * kVec;
    const bool in = t < steps && c0 + cc < di;
    const int off = in ? t * di + cc : 0;
    cp_async16(&sdt[t][cc], dt + base + off, in);
    cp_async16(&sx[t][cc], x + base + off, in);
  });
  if (sgy != nullptr) {
    constexpr int kGy = kChannels / 4;  // pieces of a gy row
    for_pieces<kSeg * kGy>([&](int i) {
      const int t = i / kGy, cc = (i % kGy) * 4;
      const bool in = t < steps && c0 + cc < di;
      const int off = in ? t * di + cc : 0;
      cp_async16(&sgy[t][cc], gy + base + off, in);
    });
  }
  // B and C: the rows are contiguous; a piece never straddles a row (a row
  // is DS * sizeof(Tin) = 16, 32 or 64 bytes)
  for_pieces<kSeg * DS / kVec>([&](int i) {
    const int e = i * kVec;
    const bool in = e / DS < steps;
    const int off = in ? e : 0;
    cp_async16(&sb[0][0] + e, bm + row * DS + off, in);
    if (sc != nullptr) cp_async16(&sc[0][0] + e, cm + row * DS + off, in);
  });
}

// The same copies as scalar loads that complete here (unaligned pointers,
// or di not a multiple of the vector); kept out of the kernel's hot code.
template <typename Tin, int DS>
__device__ __noinline__ void copy_scalar(Tin (*sdt)[kChannels], Tin (*sx)[kChannels],
                                         float (*sgy)[kChannels], Tin (*sb)[DS], Tin (*sc)[DS],
                                         const Tin* __restrict__ dt, const Tin* __restrict__ x,
                                         const Tin* __restrict__ bm, const Tin* __restrict__ cm,
                                         const float* __restrict__ gy, int64_t row, int steps,
                                         int di, int c0) {
  const Tin zero = from_f32<Tin>(0.0f);
  const int64_t base = row * di + c0;
  for (int i = threadIdx.x; i < kSeg * kChannels; i += kThreads) {
    const int t = i / kChannels, cc = i % kChannels;
    const bool in = t < steps && c0 + cc < di;
    const int64_t off = base + static_cast<int64_t>(t) * di + cc;
    sdt[t][cc] = in ? dt[off] : zero;
    sx[t][cc] = in ? x[off] : zero;
    if (sgy != nullptr) sgy[t][cc] = in ? gy[off] : 0.0f;
  }
  for (int e = threadIdx.x; e < kSeg * DS; e += kThreads) {
    const bool in = e / DS < steps;
    (&sb[0][0])[e] = in ? bm[row * DS + e] : zero;
    if (sc != nullptr) (&sc[0][0])[e] = in ? cm[row * DS + e] : zero;
  }
}

// Starts the copies of stage si's segments into st: the reverse segment's
// dt, x, gy, B, C and the sweep segment's dt, x, B, each zero-filled past
// S (a stage without a sweep part gets zeros: its sweep steps change
// nothing). vec: 16-byte cp.async; else scalar loads.
template <typename Tin, int DS>
__device__ __forceinline__ void issue_stage(Stage<Tin, DS>& st, const StageInfo& si,
                                            const Tin* __restrict__ dt,
                                            const Tin* __restrict__ x,
                                            const Tin* __restrict__ bm,
                                            const Tin* __restrict__ cm,
                                            const float* __restrict__ gy, int64_t row0,
                                            int s_len, int di, int c0, bool vec) {
  const int t0 = si.ci * kChunk + si.seg * kSeg;
  const int w0 = si.wci * kChunk + si.wseg * kSeg;
  const int steps = s_len - t0 < kSeg ? s_len - t0 : kSeg;
  const int wsteps = si.sweep ? (s_len - w0 < kSeg ? s_len - w0 : kSeg) : 0;
  const int64_t wrow = row0 + (si.sweep ? w0 : 0);
  if (vec) {
    if (si.rev)
      copy_vec<Tin, DS>(st.dt, st.x, st.gy, st.b, st.c, dt, x, bm, cm, gy, row0 + t0, steps,
                        di, c0);
    copy_vec<Tin, DS>(st.wdt, st.wx, nullptr, st.wb, nullptr, dt, x, bm, cm, gy, wrow, wsteps,
                      di, c0);
  } else {
    if (si.rev)
      copy_scalar<Tin, DS>(st.dt, st.x, st.gy, st.b, st.c, dt, x, bm, cm, gy, row0 + t0, steps,
                           di, c0);
    copy_scalar<Tin, DS>(st.wdt, st.wx, nullptr, st.wb, nullptr, dt, x, bm, cm, gy, wrow,
                         wsteps, di, c0);
  }
}

// Adds a phase's shares (d_B or d_C, in warp_sh) over the warp's pairs, a
// float4 of one step a lane, into the warp's row of block_sh.
template <int DS>
__device__ __forceinline__ void warp_sum(const float (&wsh)[kSeg][(kWarpPairs + 1) * DS],
                                         float (&bsh)[kSeg][kWarps][DS], int warp, int lane) {
  constexpr int kG = DS / 4;  // float4 groups of a step
  if (lane < kSeg * kG) {
    const int jj = lane / kG, n = 4 * (lane % kG);
    float4 sum = *reinterpret_cast<const float4*>(&wsh[jj][n]);
#pragma unroll
    for (int pw = 1; pw < kWarpPairs; ++pw)
      sum = add4(sum, *reinterpret_cast<const float4*>(&wsh[jj][pw * DS + n]));
    *reinterpret_cast<float4*>(&bsh[jj][warp][n]) = sum;
  }
}

// One sweep step of a thread's 2 x N states: the forward kernel's arithmetic.
template <typename Tin, int N>
__device__ __forceinline__ void sweep_step(float (&h)[2][N], const Tin* sdt, const Tin* sx,
                                           const float* brow, const float (&ap)[2][N]) {
  const float2 dt2 = load2(sdt), x2 = load2(sx);
  float bv[N];
  load_n<N>(brow, bv);
  const float dts[2] = {dt2.x, dt2.y}, dtx[2] = {dt2.x * x2.x, dt2.y * x2.y};
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int j = 0; j < N; ++j) h[k][j] = fmaf(ex2(dts[k] * ap[k][j]), h[k][j], dtx[k] * bv[j]);
}

template <typename Tin, int DS>
__global__ void __launch_bounds__(kThreads, 2)
ssm_scan_bwd_kernel(const Tin* __restrict__ dt, const float* __restrict__ a,
                    const Tin* __restrict__ bm, const Tin* __restrict__ cm,
                    const Tin* __restrict__ x, const float* __restrict__ d,
                    const float* __restrict__ hs, const float* __restrict__ gy,
                    const float* __restrict__ gh, Tin* __restrict__ d_dt, Tin* __restrict__ d_x,
                    float* __restrict__ pb, float* __restrict__ pc, float* __restrict__ pa,
                    float* __restrict__ pd, int s_len, int di, int vec) {
  constexpr int N = DS / kQ;  // states a thread holds of each of its channels
  constexpr int kRing = ring<Tin>();
  constexpr bool kConvert = !std::is_same<Tin, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<Tin, DS>& sm = *reinterpret_cast<Smem<Tin, DS>*>(smem_raw);

  const int b = blockIdx.y, batch = gridDim.y;
  const int c0 = blockIdx.x * kChannels;
  const int64_t row0 = static_cast<int64_t>(b) * s_len;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane % kQ, pw = lane / kQ;  // this thread's states: N q .. N q + N - 1
  const int lp = 2 * (warp * kWarpPairs + pw);  // its channels in the block: lp, lp + 1
  const int cp = c0 + lp;
  const bool act[2] = {cp < di, cp + 1 < di};
  // the lane's output: d_dt (q < 2) or d_x (q >= 2) of channel cp + (q & 1)
  const bool hi = (q & 2) != 0, odd = (q & 1) != 0;
  const int c_out = cp + (odd ? 1 : 0);
  const bool act_out = c_out < di;
  const float d_out = act_out ? d[c_out] : 0.0f;

  float ap[2][N], an[2][N], g[2][N], dacc[2][N];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int64_t st0 = (static_cast<int64_t>(b) * di + cp + k) * DS + N * q;  // in (B, di, DS)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      an[k][j] = act[k] ? a[static_cast<int64_t>(cp + k) * DS + N * q + j] : 0.0f;
      ap[k][j] = an[k][j] * kLog2e;
      g[k][j] = act[k] && gh != nullptr ? gh[st0 + j] : 0.0f;
      dacc[k][j] = 0.0f;
    }
  }
  float dd_acc = 0.0f;

  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const int last_segs = n_chunks > 0 ? (s_len - (n_chunks - 1) * kChunk + kSeg - 1) / kSeg : 0;
  const int n_stages =
      n_chunks > 0 ? last_segs - 1 + max(last_segs, n_chunks > 1 ? kSegs - 1 : 0) +
                         kSegs * (n_chunks - 1)
                   : 0;

  // a chunk's start state (the first sweep segment's, the last reverse one's)
  auto load_start = [&](int ci, float (&h)[2][N]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int64_t hs0 = ((static_cast<int64_t>(ci) * batch + b) * di + cp + k) * DS + N * q;
#pragma unroll
      for (int j = 0; j < N; ++j) h[k][j] = act[k] ? hs[hs0 + j] : 0.0f;
    }
  };
  auto issue = [&](int s) {
    if (s < n_stages)
      issue_stage<Tin, DS>(sm.raw[s % kRing], stage_info(s, n_chunks, last_segs), dt, x, bm, cm,
                           gy, row0, s_len, di, c0, vec != 0);
    cp_async_commit();  // an empty group past the end keeps the counts uniform
  };
  auto convert = [&](int s) {  // stage s's B and C rows to float32, 4 elements an item
    if constexpr (kConvert) {
      if (s < n_stages) {
        const Stage<Tin, DS>& st = sm.raw[s % kRing];
        for_pieces<3 * kSeg * DS / 4>([&](int i) {
          const int kind = i / (kSeg * DS / 4), r = 4 * (i % (kSeg * DS / 4));
          const Tin* src = kind == 0 ? &st.b[0][0] : kind == 1 ? &st.c[0][0] : &st.wb[0][0];
          const uint2 raw = *reinterpret_cast<const uint2*>(src + r);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 hi2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          *reinterpret_cast<float4*>(&sm.bc.v[s & 1][kind][0][0] + r) =
              make_float4(lo.x, lo.y, hi2.x, hi2.y);
        });
      }
    }
  };
  // the block's d_B and d_C partials of reverse stage s (whose warp sums are in)
  auto block_sum = [&](int s, int t0) {  // a float2 a thread: 128 (ds 16) or 64 items
    constexpr int kG = DS / 2, kItems = 2 * kSeg * kG;
    if (tid < kItems) {
      const int kind = tid / (kSeg * kG), jj = (tid / kG) % kSeg, n = 2 * (tid % kG);
      const float* src = &sm.block_sh[s & 1][kind][jj][0][n];
      float2 sum = *reinterpret_cast<const float2*>(src);
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float2 v = *reinterpret_cast<const float2*>(src + w * DS);
        sum.x += v.x, sum.y += v.y;
      }
      const int t = t0 + jj;
      if (t < s_len) {
        float* dst = kind ? pc : pb;
        *reinterpret_cast<float2*>(
            &dst[((static_cast<int64_t>(blockIdx.x) * batch + b) * s_len + t) * DS + n]) = sum;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) issue(i);
  cp_async_wait_all();
  __syncthreads();
  convert(0);

  float h[2][N];  // the sweep's state
  int prev_t0 = -1;  // t0 of the previous stage if it ran a reverse part
  for (int s = 0; s < n_stages; ++s) {
    const StageInfo si = stage_info(s, n_chunks, last_segs);
    float hr[2][N], hw[2][N];  // chunk start states this stage begins from, loaded early
    if (si.rev && si.seg == 0) load_start(si.ci, hr);
    if (si.sweep && si.wseg == 0) load_start(si.wci, hw);
    cp_async_wait_all();
    __syncthreads();  // stages s, s + 1 are in; stage s - 1 is done everywhere
    if (prev_t0 >= 0) block_sum(s - 1, prev_t0);
    issue(s + kRing - 1);
    convert(s + 1);
    if (si.sweep && si.wseg == 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int j = 0; j < N; ++j) h[k][j] = hw[k][j];
    }
    const Stage<Tin, DS>& st = sm.raw[s % kRing];
    const float *brow, *crow, *wbrow;
    if constexpr (kConvert) {
      brow = &sm.bc.v[s & 1][0][0][0], crow = &sm.bc.v[s & 1][1][0][0];
      wbrow = &sm.bc.v[s & 1][2][0][0];
    } else {
      brow = &st.b[0][0], crow = &st.c[0][0], wbrow = &st.wb[0][0];
    }
    // the sweep's next segment start (after its 8 steps), where the stage has a sweep part
    float* wstart = si.sweep ? &sm.start[start_slot(si.wci, si.wseg + 1)][0][tid] : nullptr;

    if (!si.rev) {  // the last chunk's sweep, alone
#pragma unroll
      for (int jj = 0; jj < kSeg; ++jj)
        sweep_step<Tin, N>(h, &st.wdt[jj][lp], &st.wx[jj][lp], wbrow + jj * DS + N * q, ap);
#pragma unroll
      for (int v = 0; v < 2 * N; ++v) wstart[v * kThreads] = h[v / N][v % N];
      prev_t0 = -1;
      continue;
    }

    // the reverse part: recompute the segment's states (h_{t-1} and da
    // kept), forming the d_C shares
    const int t0 = si.ci * kChunk + si.seg * kSeg;
    float hc[2][N], hp[kSeg][2][N], da[kSeg][2][N];
    float gbs[kSeg][2], dds[kSeg][2];  // each step's sum_n g B and d_dt sum over this lane's states
    float xo[kSeg], dto[kSeg], gyo[kSeg];  // each step's x, dt, gy of the lane's output channel
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < N; ++j)
        hc[k][j] = si.seg == 0 ? hr[k][j]
                               : sm.start[start_slot(si.ci, si.seg)][k * N + j][tid];
#pragma unroll
    for (int jj = 0; jj < kSeg; ++jj) {
      const float2 dt2 = load2(&st.dt[jj][lp]), x2 = load2(&st.x[jj][lp]);
      const float2 gy2 = load2(&st.gy[jj][lp]);
      float bv[N], vc[N];
      load_n<N>(brow + jj * DS + N * q, bv);
      const float dts[2] = {dt2.x, dt2.y}, dtx[2] = {dt2.x * x2.x, dt2.y * x2.y};
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int j = 0; j < N; ++j) {
          hp[jj][k][j] = hc[k][j];
          da[jj][k][j] = ex2(dts[k] * ap[k][j]);
          hc[k][j] = fmaf(da[jj][k][j], hc[k][j], dtx[k] * bv[j]);
        }
#pragma unroll
      for (int j = 0; j < N; ++j) vc[j] = fmaf(hc[1][j], gy2.y, hc[0][j] * gy2.x);
      store_n<N>(&sm.warp_sh[warp][jj][pw * DS + N * q], vc);
    }
    __syncwarp();
    warp_sum<DS>(sm.warp_sh[warp], sm.block_sh[s & 1][1], warp, lane);
    __syncwarp();

    // the reverse steps, last to first, each beside one step of the sweep
    // part (the special-function unit's exps beside the FP32 pipe's work)
#pragma unroll
    for (int jj = kSeg - 1; jj >= 0; --jj) {
      const int wj = kSeg - 1 - jj;
      sweep_step<Tin, N>(h, &st.wdt[wj][lp], &st.wx[wj][lp], wbrow + wj * DS + N * q, ap);
      const float2 dt2 = load2(&st.dt[jj][lp]), x2 = load2(&st.x[jj][lp]);
      const float2 gy2 = load2(&st.gy[jj][lp]);
      float bv[N], cv[N], vb[N];
      load_n<N>(brow + jj * DS + N * q, bv);
      load_n<N>(crow + jj * DS + N * q, cv);
      const float dts[2] = {dt2.x, dt2.y}, gys[2] = {gy2.x, gy2.y};
      const float dtx[2] = {dt2.x * x2.x, dt2.y * x2.y};
      xo[jj] = odd ? x2.y : x2.x, dto[jj] = odd ? dt2.y : dt2.x, gyo[jj] = odd ? gy2.y : gy2.x;
      float (&gb)[2] = gbs[jj], (&ddt)[2] = dds[jj];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          g[k][j] = fmaf(gys[k], cv[j], g[k][j]);
          gb[k] = j == 0 ? g[k][j] * bv[j] : fmaf(g[k][j], bv[j], gb[k]);
          vb[j] = k == 0 ? g[k][j] * dtx[k] : fmaf(g[k][j], dtx[k], vb[j]);
          const float gd = g[k][j] * da[jj][k][j];
          const float u = gd * hp[jj][k][j];  // g da h_{t-1}
          ddt[k] = j == 0 ? an[k][j] * u : fmaf(an[k][j], u, ddt[k]);
          dacc[k][j] = fmaf(dts[k], u, dacc[k][j]);
          g[k][j] = gd;
        }
      }
      store_n<N>(&sm.warp_sh[warp][jj][pw * DS + N * q], vb);
    }
    if (wstart != nullptr) {
#pragma unroll
      for (int v = 0; v < 2 * N; ++v) wstart[v * kThreads] = h[v / N][v % N];
    }
    __syncwarp();
    warp_sum<DS>(sm.warp_sh[warp], sm.block_sh[s & 1][0], warp, lane);
    __syncwarp();
    // sum_n g B and the d_dt sums of the 8 steps over the pair's 4 lanes, all
    // at once: lanes with bit 1 keep the d_dt sums, the others sum g B; then
    // each lane keeps its channel (bit 0) and trades with its bit-1 partner
    float kept[kSeg], other[kSeg];
#pragma unroll
    for (int jj = 0; jj < kSeg; ++jj) {
      float k0 = hi ? dds[jj][0] : gbs[jj][0], k1 = hi ? dds[jj][1] : gbs[jj][1];
      const float s0 = hi ? gbs[jj][0] : dds[jj][0], s1 = hi ? gbs[jj][1] : dds[jj][1];
      k0 += __shfl_xor_sync(kFull, s0, 2);
      k1 += __shfl_xor_sync(kFull, s1, 2);
      kept[jj] = odd ? k1 : k0;
      kept[jj] += __shfl_xor_sync(kFull, odd ? k0 : k1, 1);
    }
#pragma unroll
    for (int jj = 0; jj < kSeg; ++jj) other[jj] = __shfl_xor_sync(kFull, kept[jj], 2);
    // the lane's outputs, d_dt (bit 1 clear) or d_x of channel lp + bit 0,
    // into an output tile in the warp's share buffer, then to device memory
    // in 16-byte pieces
    Tin (*tile)[kSeg][2 * kWarpPairs] =
        reinterpret_cast<Tin (*)[kSeg][2 * kWarpPairs]>(&sm.warp_sh[warp][0][0]);
#pragma unroll
    for (int jj = kSeg - 1; jj >= 0; --jj) {  // d_D's order: the reverse steps'
      dd_acc = fmaf(gyo[jj], xo[jj], dd_acc);  // the d_x lanes' is written; padded steps add 0
      const float out = hi ? fmaf(d_out, gyo[jj], dto[jj] * other[jj])  // D gy + dt sum g B
                           : fmaf(kept[jj], xo[jj], other[jj]);      // (sum g B) x + the d_dt sum
      tile[hi][jj][2 * pw + odd] = from_f32<Tin>(out);
    }
    __syncwarp();
    {
      constexpr int kVec = 16 / static_cast<int>(sizeof(Tin));
      constexpr int kPer = 2 * kWarpPairs / kVec;  // 16-byte pieces of a tile row
      const int cw = c0 + warp * 2 * kWarpPairs;   // the warp's first channel
#pragma unroll
      for (int i = lane; i < 2 * kSeg * kPer; i += 32) {
        const int kind = i / (kSeg * kPer), jj = (i / kPer) % kSeg, cc = (i % kPer) * kVec;
        const int t = t0 + jj;
        Tin* dst = (kind ? d_x : d_dt) + (row0 + t) * di + cw + cc;
        const Tin* src = &tile[kind][jj][cc];
        if (t < s_len) {
          if (vec) {
            if (cw + cc < di) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              if (cw + cc + e < di) dst[e] = src[e];
          }
        }
      }
    }
    prev_t0 = t0;  // the next stage's barrier orders its share writes after these reads
  }
  __syncthreads();
  if (prev_t0 >= 0) block_sum(n_stages - 1, prev_t0);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (act[k]) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        pa[(static_cast<int64_t>(b) * di + cp + k) * DS + N * q + j] = dacc[k][j];
    }
  if (hi && act_out) pd[static_cast<int64_t>(b) * di + c_out] = dd_acc;
}

// The partials' sums in a fixed order: d_B and d_C over the channel blocks
// (4 neighbouring elements a thread, float4 loads; B S ds is a multiple of
// 4), d_A and d_D over the batch.
template <typename Tin>
__global__ void ssm_scan_bwd_reduce_kernel(const float* __restrict__ pb,
                                           const float* __restrict__ pc,
                                           const float* __restrict__ pa,
                                           const float* __restrict__ pd, Tin* __restrict__ d_b,
                                           Tin* __restrict__ d_c, float* __restrict__ d_a,
                                           float* __restrict__ d_d, int n_blocks, int batch,
                                           int s_len, int di, int ds) {
  const int64_t n_bc = static_cast<int64_t>(batch) * s_len * ds;
  const int64_t n_bc4 = n_bc / 4;
  const int64_t n_a = static_cast<int64_t>(di) * ds;
  const int64_t total = 2 * n_bc4 + n_a + di;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i < 2 * n_bc4) {
      const bool is_c = i >= n_bc4;
      const int64_t e = 4 * (is_c ? i - n_bc4 : i);
      const float* src = (is_c ? pc : pb) + e;
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int k = 0; k < n_blocks; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(src + k * n_bc);
        sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
      }
      Tin* dst = (is_c ? d_c : d_b) + e;
      dst[0] = from_f32<Tin>(sum.x), dst[1] = from_f32<Tin>(sum.y);
      dst[2] = from_f32<Tin>(sum.z), dst[3] = from_f32<Tin>(sum.w);
    } else if (i < 2 * n_bc4 + n_a) {
      const int64_t e = i - 2 * n_bc4;
      float sum = 0.0f;
      for (int k = 0; k < batch; ++k) sum += pa[k * n_a + e];
      d_a[e] = sum;
    } else {
      const int64_t e = i - 2 * n_bc4 - n_a;
      float sum = 0.0f;
      for (int k = 0; k < batch; ++k) sum += pd[static_cast<int64_t>(k) * di + e];
      d_d[e] = sum;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename Tin, int DS>
int configure() {  // raise the dynamic shared memory limit once
  static int err = -1;
  if (err < 0) {
    cudaError_t e = cudaFuncSetAttribute(ssm_scan_bwd_kernel<Tin, DS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(Smem<Tin, DS>)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssm_scan_bwd_kernel<Tin, DS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    err = static_cast<int>(e);
  }
  return err;
}

template <typename Tin, int DS>
int launch(const void* dt, const void* a, const void* bm, const void* cm, const void* x,
           const void* d, const void* hs, const void* gy, const void* gh, void* d_dt, void* d_x,
           void* d_b, void* d_c, void* d_a, void* d_d, void* pb, void* pc, void* pa, void* pd,
           int batch, int s_len, int di, void* stream) {
  constexpr int smem = static_cast<int>(sizeof(Smem<Tin, DS>));
  const int err = configure<Tin, DS>();
  if (err != 0) return err;
  if (batch == 0 || di == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (di + kChannels - 1) / kChannels;
  const int vec = di % (16 / static_cast<int>(sizeof(Tin))) == 0 && di % 4 == 0 &&
                  aligned16(dt) && aligned16(x) && aligned16(bm) && aligned16(cm) &&
                  aligned16(gy) && aligned16(d_dt) && aligned16(d_x);
  ssm_scan_bwd_kernel<Tin, DS><<<dim3(n_blocks, batch), kThreads, smem, st>>>(
      static_cast<const Tin*>(dt), static_cast<const float*>(a), static_cast<const Tin*>(bm),
      static_cast<const Tin*>(cm), static_cast<const Tin*>(x), static_cast<const float*>(d),
      static_cast<const float*>(hs), static_cast<const float*>(gy),
      static_cast<const float*>(gh), static_cast<Tin*>(d_dt), static_cast<Tin*>(d_x),
      static_cast<float*>(pb), static_cast<float*>(pc), static_cast<float*>(pa),
      static_cast<float*>(pd), s_len, di, vec);
  const int64_t total = 2 * static_cast<int64_t>(batch) * s_len * DS / 4 +
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

template <typename Tin, int DS>
int occupancy(int* out) {
  const int err = configure<Tin, DS>();
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, ssm_scan_bwd_kernel<Tin, DS>);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ssm_scan_bwd_kernel<Tin, DS>, kThreads, static_cast<int>(sizeof(Smem<Tin, DS>)));
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(sizeof(Smem<Tin, DS>));
  out[3] = blocks;
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// in_dtype: 0 = float32, 1 = bfloat16 (dt, x, bm, cm and the d_dt, d_x,
// d_b, d_c outputs); ds: 8 or 16. All contiguous: dt, x, gy, d_dt, d_x
// (B, S, di); bm, cm, d_b, d_c (B, S, ds); a, d_a (di, ds); d, d_d (di);
// hs (ceil(S / 128), B, di, ds); gh null or (B, di, ds); gy, gh, hs, a, d,
// d_a, d_d float32. Scratch, float32: pb and pc (ceil(di / kChannels), B, S, ds),
// pa (B, di, ds), pd (B, di). Enqueues two grids on `stream`; returns
// cudaGetLastError() after them (0 = launched).
int repro_ssm_scan_bwd(const void* dt, const void* a, const void* bm, const void* cm,
                       const void* x, const void* d, const void* hs, const void* gy,
                       const void* gh, void* d_dt, void* d_x, void* d_b, void* d_c, void* d_a,
                       void* d_d, void* pb, void* pc, void* pa, void* pd, int batch, int s_len,
                       int di, int ds, int in_dtype, void* stream) {
#define REPRO_ARGS dt, a, bm, cm, x, d, hs, gy, gh, d_dt, d_x, d_b, d_c, d_a, d_d, pb, pc, pa, \
                   pd, batch, s_len, di, stream
  if (in_dtype == 0 && ds == 8) return launch<float, 8>(REPRO_ARGS);
  if (in_dtype == 0 && ds == 16) return launch<float, 16>(REPRO_ARGS);
  if (in_dtype == 1 && ds == 8) return launch<__nv_bfloat16, 8>(REPRO_ARGS);
  if (in_dtype == 1 && ds == 16) return launch<__nv_bfloat16, 16>(REPRO_ARGS);
#undef REPRO_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Channels a block of the main grid holds: the scratch pb and pc are
// (ceil(di / this), B, S, ds).
int repro_ssm_scan_bwd_block_channels() { return kChannels; }

// The main grid's resources for one instantiation: out[0] registers a
// thread, out[1] local (spilled) bytes a thread, out[2] dynamic shared
// memory bytes a block, out[3] resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
int repro_ssm_scan_bwd_occupancy(int ds, int in_dtype, int* out) {
  if (in_dtype == 0 && ds == 8) return occupancy<float, 8>(out);
  if (in_dtype == 0 && ds == 16) return occupancy<float, 16>(out);
  if (in_dtype == 1 && ds == 8) return occupancy<__nv_bfloat16, 8>(out);
  if (in_dtype == 1 && ds == 16) return occupancy<__nv_bfloat16, 16>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
