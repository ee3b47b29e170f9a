// Backward of the port's GQA flash attention in bfloat16 for sm_90a, on
// Hopper's tensor cores: dQ, dK and dV from q, k, v, the forward's output o
// and row logsumexp lse, and dO. Every product is a wgmma; the q/dO and K/V
// tiles arrive by TMA. (float32 inputs keep the CUDA-core kernel in
// flash_attention_bwd.cu, for the reduced parity configs.)
//
// Replaces no TPU kernel: the JAX package trains through autodiff of the
// jnp chunked_attention (src/repro/models/layers.py), and its Pallas kernel
// (src/repro/kernels/flash_attention/kernel.py:flash_attention_kernel) has
// no backward. The port's training runs its forward through
// flash_attention_wgmma.cu (which writes lse for it), so it needs a
// backward of its own: this kernel, behind
// kernels/flash_attention/ops.py:FlashAttentionFn.
//
// What it computes, for q (B, S, H, DQK), k (B, T, Hkv, DQK), v (B, T, Hkv,
// DV), o and dO (B, S, H, DV) in bfloat16 in the model layout, (DQK, DV) =
// (64, 64) whisper, (128, 128) the dense and MoE decoders, (192, 128) MLA or
// (160, 160) stablelm, lse (B, H, S) float32, G = H / Hkv, and the
// forward's mask (key t visible to query s iff s < S, t < T, t <= s when
// causal, t > s - window when window > 0; or, where the caller passes q_pos
// and k_pos, iff s < S, t < T and positions.cuh's rule holds):
//   D[s]    = sum_d dO[s, d] o[s, d]                             (pre-pass)
//   P[s, t] = 2^(q[s] . k[t] scale log2 e - lse[s] log2 e) if visible, else 0
//   dP      = dO V^T          dS = P (dP - D)
//   dV[t]   = sum_{g, s} bf16(P[s, t]) dO[s]
//   dK[t]   = scale sum_{g, s} bf16(dS[s, t]) q[s]                 (dK/dV pass)
//   dQ[s]   = scale sum_t bf16(dS[s, t]) k[t]                      (dQ pass)
// P and dS are float32 and are rounded to bfloat16 only where they enter a
// product as wgmma's A operand (P before dV, dS before dK and dQ; dS is
// formed from the float32 P); the sums accumulate in float32 and dQ, dK, dV
// are written in bfloat16. That is flash_attention_backward_plain's
// arithmetic for bf16 inputs; kernels/flash_attention/contract.py holds the
// result to the same formulas in float64 with the same rounding points.
// exp is ex2.approx with log2 e folded into the scale and into lse (the
// pre-pass stages lse log2 e), as the forward does.
//
// Determinism: no atomics. The dK/dV pass runs one CTA per (b, kv head,
// 128-key block), which sums its keys' dK and dV over the G query heads and
// their q tiles in a fixed order in registers; the dQ pass runs one CTA per
// (b, q head, 128-row q tile) over its key tiles in order. Two calls on the
// same inputs give the same bits. The price: S and dP are computed in both
// passes, seven products where the inputs require five. Ordered float32
// adds of per-key-block dQ partials (a scratch and a reduction pass) would
// save the dQ pass's two (ROADMAP.md queue 2, item P's remaining lever).
//
// Bound on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s), at the shapes
// chip_smoke.py times, B H pairs = the visible (s, t) pairs over all heads;
// five products = 2 (3 DQK + 2 DV) B H pairs, this design's seven = 2 (4 DQK
// + 3 DV) B H pairs; bytes: q, k, v, o, dO, lse read once, dQ, dK, dV
// written once:
//   granite-3-8b (B 4, S = T 2048, H 32, Hkv 8, D 128, causal): 0.344 and
//     0.481 TFLOP, 0.3476 and 0.4866 ms; 0.34 GB, 0.10 ms;
//   whisper-tiny encoder (B 4, S = T 1500, H = Hkv 6, D 64, non-causal):
//     0.0346 and 0.0484 TFLOP, 0.0349 and 0.0489 ms;
//   whisper cross (S 448 over T 1500): 0.0103 and 0.0145 TFLOP, 0.0104 and
//     0.0146 ms;
//   deepseek-v2-lite MLA (B 1, S = T 2048, H = Hkv 16, (192, 128), causal):
//     0.0559 and 0.0774 TFLOP, 0.0565 and 0.0782 ms;
//   stablelm-12b (B 1, S = T 2048, H 32, Hkv 8, D 160, causal): 0.1074
//     and 0.1504 TFLOP, 0.1086 and 0.1521 ms.
// Operations bind at every shape, so every product runs on wgmma.
//
// Design. 256 threads a CTA in both passes: two warpgroups, each owning 64
// accumulator rows; thread 0 also issues every TMA load, keeping up to
// three ring tiles in flight. In the dK/dV pass it issues a tile as soon as
// its stage is free (checked without waiting at three points of an
// iteration) and waits for a stage only when the tile about to be computed
// is not issued yet; in the dQ pass it issues tile j + 2 at the top of
// iteration j, waiting for tile j - 1's stage. Each was the faster of the
// two at all five of chip_smoke.py's shapes in launch/attention_bwd_ab.py's
// A/B on the H100 (the other dQ policy 3-8% slower, the other dK/dV one
// 0.6-3.5%; PERF.md section 6). A software pipeline that issued tile
// it + 1's S^T and dP^T right behind tile it's dV and dK ran slower: ptxas
// serialized the wgmmas (C7515), the P math writing registers inside an
// open stage.
// Eight warps put two on each SM sub-partition (16,384 registers each), so
// ptxas may give a thread 255 registers; the accumulators need them. (A
// ninth, producer warp would put three warps on one sub-partition and cap
// every thread at 168: the first build of this kernel did that, and its
// heavy instantiations spilled and serialized their wgmmas.)
// Tiles are loaded as 64-column boxes in the 128-byte swizzle (a bf16 row
// of 128 is two boxes, of 192 three); at DQK = DV = 160 the last 32
// columns are a 32-column box in the 64-byte swizzle (a canonical wgmma
// layout in both majors), so no product runs over zero fill. Rows past S or
// T are zero-filled by TMA and masked.
// - Pre-pass (a warp a row, as flash_attention_bwd.cu's row_dots): D and
//   lse log2 e into a float32 scratch (2, B, H, S_pad), S_pad = S rounded up
//   to 128, zero past S, so the 1-D bulk copies of a q tile's rows need no
//   bounds and a row past S reads 0.
// - dK/dV pass, in transposed form so that every product after the first
//   two takes its A operand from registers. The K and V tiles of the CTA's
//   128 keys are loaded once; warpgroup w owns keys 64w .. 64w + 63. The CTA
//   walks the kv head's G query heads and, for each, that head's visible q
//   tiles of BQ rows in order; each q tile's q, dO, lse and D arrive through
//   a 3-stage ring (full and empty mbarriers; the ring's index runs on
//   across heads, so a head with no visible tile moves no phase). Per tile:
//     S^T  = K Q^T and dP^T = V dO^T: wgmma m64nBQ, both operands K-major
//            in shared memory, two commit groups;
//     P^T  = 2^(S^T scale log2 e - lse log2 e) in the accumulator layout as
//            soon as S^T lands (columns are q rows: lse from the stage);
//     dS^T = P^T (dP^T - D) in float32 once dP^T lands; P^T and dS^T are
//            packed to bf16 pair by pair as wgmma's A fragments (the m64nBQ
//            accumulator layout is the m64k16 A layout, as the forward's
//            P), so S^T and dP^T die as the fragments fill;
//     dV  += P^T dO and dK += dS^T Q in one commit group: A from registers,
//            B = the dO or q tile as stored (rows x D, MN-major: the
//            transpose bit).
//   dK and dV stay in registers over the whole walk; the CTA's keys are
//   launched in order, so the early key blocks, which see the most rows
//   when causal, start first.
// - dQ pass, the forward's structure with the online softmax replaced by
//   the saved lse: the CTA's q and dO tiles (128 rows) are loaded once,
//   warpgroup w owns rows 64w .. 64w + 63, and 64-key K and V tiles come
//   through a 3-stage ring. Per tile: S = Q K^T and dP = dO V^T (A and B
//   in shared memory), P and dS = P (dP - D) in registers, dQ += dS K with
//   A = dS packed to bf16 and B = the K tile, MN-major. Late (heavy) q tiles
//   are launched first.
// Tiles that the mask hides from all of a warpgroup's rows and keys (above
// the diagonal, wholly outside the window, past S or T) are not computed;
// a tile is loaded when some row of the CTA sees it. The mask is applied
// element by element only on tiles that touch the diagonal, the window's
// edge, S or T; rows past S are masked in the dK/dV pass (a zero q row with
// lse = 0 would give P = 1) and keys past T in the dQ pass.
// Position masks (the kPos instantiations; null pointers launch the index
// ones, unchanged), as in the forward: each CTA first lists the tiles of the
// other side (q tiles in the dK/dV pass, key tiles in the dQ pass) where
// some pair with its own rows or keys may be visible, flagging those where
// every pair is (list_tiles, from warp_range's min and max positions; 4
// bytes a tile of shared memory after the ring), and the ring walks the
// list. A listed tile is computed by both warpgroups (a warpgroup that sees
// none of it adds exact zeros); one not flagged whole is masked through a
// bit mask of the thread's scores, gathered from the positions while S is
// in flight.
//
// Tiles and registers, by (DQK, DV): the dK/dV pass holds dK (DQK / 2
// registers a thread), dV (DV / 2), S^T and dP^T (BQ / 2 each) and their
// packed bf16 (BQ / 4 each); the dQ pass holds dQ (DQK / 2), S and dP (32
// each at 64 keys) and dS packed (16).
//   (64, 64), (128, 128): BQ = 64; (192, 128), (160, 160): BQ = 32 (m64n32
//   S^T and dP^T), so that dK + dV (160 registers) and the scores fit.
// Shared memory: dK/dV pass K and V tiles + three stages of (q, dO, lse,
// D): 82 KB at (64, 64), 162 KB at (128, 128), 141 KB at (192, 128) and
// (160, 160); dQ pass q and dO tiles + three stages of (K, V): 80 KB, 160
// KB, 200 KB, 200 KB; one CTA an SM.
// ptxas (CUDA 12.8) reports no spills and no serialized wgmmas; registers
// a thread, dK/dV pass and dQ pass: 168 and 134 at (64, 64), 232 and 164
// at (128, 128), 227 and 198 at (192, 128), 230 and 184 at (160, 160);
// position-masked: 171 and 132, 235 and 167, 230 and 196, 235 and 180;
// printed by python -c "from repro_torch.kernels import build;
// build.build(['flash_attention_bwd_wgmma'], verbose=True)".
//
// The TMA tensor maps are encoded on the host at each call (the driver's
// cuTensorMapEncodeTiled through the runtime, hopper.cuh) and passed as
// __grid_constant__ parameters, so a call can be captured in a CUDA graph.
//
// Built by nvcc into a shared library with a C interface
// (repro_torch/kernels/build.py); the Python wrapper
// repro_torch/kernels/flash_attention/ops.py:flash_attention_bwd launches it
// on torch's current stream.

#include "hopper.cuh"
#include "positions.cuh"

namespace {

constexpr int kConsumers = 2;                  // warpgroups, 64 accumulator rows each
constexpr int kThreads = 128 * kConsumers;
constexpr int kStages = 3;                     // ring depth of both passes
constexpr int kSpan = 64;                        // bf16 columns of one 128-byte swizzle span
constexpr int kTail = 32;                        // bf16 columns of the 64-byte swizzle tail
constexpr int kKeyBlock = 128;                   // dK/dV pass: keys of a CTA
constexpr int kRowBlock = 128;                   // dQ pass: q rows of a CTA
constexpr int kKeyTile = 64;                     // dQ pass: keys of a K/V tile
constexpr int kPadRows = 128;                    // the staged lse and D rows: S rounded up to this
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int spans(int d) { return d / kSpan; }
__host__ __device__ constexpr bool has_tail(int d) { return d % kSpan != 0; }

// R rows x D bf16 columns as TMA writes them: D / 64 spans of 64 columns in
// the 128-byte swizzle and, at D = 160, a 32-column tail in the 64-byte one.
template <int R, int D, bool Tail = has_tail(D)>
struct Tile {
  alignas(1024) __nv_bfloat16 span[spans(D)][R][kSpan];
};
template <int R, int D>
struct Tile<R, D, true> {
  alignas(1024) __nv_bfloat16 span[spans(D)][R][kSpan];
  alignas(1024) __nv_bfloat16 tail[R][kTail];
};

template <int R, int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return spans(D) * R * kSpan * 2 + (has_tail(D) ? R * kTail * 2 : 0);
}

// the tensor maps of one tensor: 64-column boxes (128-byte swizzle) and the
// 32-column tail box at column 128 (64-byte swizzle; a copy of `span` when
// there is no tail)
struct Maps {
  CUtensorMap span;
  CUtensorMap tail;
};

// a tile's boxes at (head, row0, b) into shared memory, completing `bar`
template <int R, int D>
__device__ __forceinline__ void load_tile(Tile<R, D>& t, const Maps& m, uint64_t* bar, int head,
                                          int row0, int b) {
#pragma unroll
  for (int c = 0; c < spans(D); ++c)
    tma_load(&t.span[c][0][0], &m.span, bar, c * kSpan, head, row0, b);
  if constexpr (has_tail(D)) tma_load(&t.tail[0][0], &m.tail, bar, spans(D) * kSpan, head, row0, b);
}

// wgmma descriptors of a tile's spans and tail
struct Desc {
  uint64_t span, tail;
};

// the tile from row `row` on as a K-major operand (rows x D, D contiguous)
template <int R, int D>
__device__ __forceinline__ Desc k_major(const Tile<R, D>& t, int row) {
  Desc d{sw128_desc(&t.span[0][row][0], 16, 1024), 0};
  if constexpr (has_tail(D)) d.tail = sw64_desc(&t.tail[row][0], 16, 512);
  return d;
}

// the tile as an MN-major B operand (K = its R rows, N = its D columns)
template <int R, int D>
__device__ __forceinline__ Desc mn_major(const Tile<R, D>& t) {
  Desc d{sw128_desc(&t.span[0][0][0], R * kSpan * 2, 1024), 0};
  if constexpr (has_tail(D)) d.tail = sw64_desc(&t.tail[0][0], R * kTail * 2, 512);
  return d;
}

template <int N, int OffA, int OffB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 32, "m64n64 or m64n32");
  if constexpr (N == 64) {
    wgmma_ss_m64n64k16<OffA, OffB>(d, a, b, scale_d);
  } else {
    wgmma_ss_m64n32k16<OffA, OffB>(d, a, b, scale_d);
  }
}

// acc (64 x N) = A (64 x D) . B (N x D)^T, both K-major in shared memory:
// D / 16 k16 steps, 32 bytes into the 128-byte rows of a span (the spans of
// A and B RA and RB rows long), then two over the 64-byte tail rows.
template <int N, int D, int RA, int RB, int KK = 0>
__device__ __forceinline__ void ss_steps(float (&acc)[N / 2], const Desc& a, const Desc& b) {
  if constexpr (KK < D / 16) {
    if constexpr (KK < spans(D) * 4) {
      constexpr int span = KK / 4, off = (KK % 4) * 2;
      wgmma_ss<N, span * RA * 8 + off, span * RB * 8 + off>(acc, a.span, b.span, KK > 0);
    } else {
      constexpr int off = (KK - spans(D) * 4) * 2;
      wgmma_ss<N, off, off>(acc, a.tail, b.tail, 1);
    }
    ss_steps<N, D, RA, RB, KK + 1>(acc, a, b);
  }
}

// acc (64 x D) += A (64 x 16 KS, bf16 registers) . B (16 KS x D, MN-major,
// its spans RB rows long): per k16 step (16 rows of B: 2048 bytes of the
// spans, 1024 of the tail) m64n128 over spans 0 and 1 (m64n64 over the one
// span at D = 64), m64n64 over span 2 at D = 192, m64n32 over the tail at
// D = 160. Accumulator register i holds column 8 (i / 4) + 2 (lane % 4) +
// i % 2 throughout.
template <int D, int RB, int KS, int KK = 0>
__device__ __forceinline__ void rs_steps(float (&acc)[D / 2], const uint32_t (&a)[KS][4],
                                         const Desc& b) {
  if constexpr (KK < KS) {
    if constexpr (spans(D) == 1) {
      wgmma_rs_m64n64k16<KK * 128, 0>(acc, a[KK], b.span);
    } else {
      wgmma_rs_m64n128k16<KK * 128, 0>(acc, a[KK], b.span);
      if constexpr (spans(D) == 3) {
        wgmma_rs_m64n64k16<2 * RB * 8 + KK * 128, 64>(acc, a[KK], b.span);
      }
    }
    if constexpr (has_tail(D)) wgmma_rs_m64n32k16<KK * 64, spans(D) * 32>(acc, a[KK], b.tail);
    rs_steps<D, RB, KS, KK + 1>(acc, a, b);
  }
}

struct Mask {
  int s_len, t_len, causal, window;
  __device__ __forceinline__ bool visible(int row, int key) const {
    return row < s_len && key < t_len && (!causal || key <= row) &&
           (window <= 0 || key > row - window);
  }
};

// Pre-pass: dd[b, h, s] = sum_d dO[b, s, h, d] o[b, s, h, d] and ls[b, h, s]
// = lse[b, h, s] log2 e for s < S, both 0 for S <= s < s_pad; a warp a row.
template <int DV>
__global__ void __launch_bounds__(256)
prep_kernel(const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ ls, float* __restrict__ dd,
            int n_heads, int s_len, int s_pad) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int h = blockIdx.y, b = blockIdx.z, lane = threadIdx.x % 32;
  if (row >= s_pad) return;
  float acc = 0.0f;
  if (row < s_len) {
    const int64_t base = ((static_cast<int64_t>(b) * s_len + row) * n_heads + h) * DV;
    for (int d = lane; d < DV; d += 32)
      acc = fmaf(__bfloat162float(dout[base + d]), __bfloat162float(out[base + d]), acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    const int64_t at = (static_cast<int64_t>(b) * n_heads + h) * s_pad + row;
    dd[at] = acc;
    ls[at] = row < s_len ? lse[(static_cast<int64_t>(b) * n_heads + h) * s_len + row] * kLog2e
                         : 0.0f;
  }
}

template <int DQK, int DV, int BQ>
struct KvSmem {
  Tile<kKeyBlock, DQK> k;
  Tile<kKeyBlock, DV> v;
  Tile<BQ, DQK> q[kStages];
  Tile<BQ, DV> dout[kStages];
  alignas(16) float ls[kStages][BQ];  // the stage's rows' lse log2 e
  alignas(16) float dd[kStages][BQ];  // ... and D
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// dK/dV pass: one CTA per (b, kv head, 128-key block).
template <int DQK, int DV, int BQ, bool kPos>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ Maps q_map, const __grid_constant__ Maps k_map,
           const __grid_constant__ Maps v_map, const __grid_constant__ Maps o_map,
           const float* __restrict__ ls, const float* __restrict__ dd,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           const int* __restrict__ q_pos, const int* __restrict__ k_pos, int n_heads,
           int n_kv_heads, int s_len, int t_len, int s_pad, int causal, int window, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;  // swizzle atoms
  KvSmem<DQK, DV, BQ>& sm = *reinterpret_cast<KvSmem<DQK, DV, BQ>*>(smem_raw + pad);
  constexpr uint32_t kStageBytes = tile_bytes<BQ, DQK>() + tile_bytes<BQ, DV>() + 2 * BQ * 4;

  const int k0 = blockIdx.x * kKeyBlock, hk = blockIdx.y, b = blockIdx.z;
  const int g_count = n_heads / n_kv_heads;
  // q rows that see some key of the block: tiles from q_first, n_tiles of them
  const int k_last = min(k0 + kKeyBlock, t_len) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(s_len - 1, k_last + window - 1) : s_len - 1;
  const int q_first = (q_lo / BQ) * BQ;
  int n_tiles = q_hi >= q_first ? (q_hi - q_first) / BQ + 1 : 0;
  // kPos: the listed q tiles (a count, then an entry a tile)
  int* tiles = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(&sm) + sizeof(sm));
  auto q_of = [&](int i) { return kPos ? (tiles[1 + i] & ~kTileFull) * BQ : q_first + i * BQ; };

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.kv_full, tile_bytes<kKeyBlock, DQK>() + tile_bytes<kKeyBlock, DV>());
    load_tile(sm.k, k_map, &sm.kv_full, hk, k0, b);
    load_tile(sm.v, v_map, &sm.kv_full, hk, k0, b);
  }
  if constexpr (kPos) {  // the K and V tiles load while every warp lists the q tiles
    n_tiles = list_tiles(tiles + 1, tiles, q_pos, BQ, (s_len + BQ - 1) / BQ, s_len,
                         warp_range(k_pos, k0, kKeyBlock, t_len), false, causal, window);
  }
  // ring tile j is q tile j % n_tiles of query head hk G + j / n_tiles
  const int n_total = g_count * n_tiles;
  auto issue = [&](int j) {
    const int st = j % kStages, h = hk * g_count + j / n_tiles;
    const int q0 = q_of(j % n_tiles);
    const int64_t rows = (static_cast<int64_t>(b) * n_heads + h) * s_pad;
    mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);  // passes at once on first use
    mbar_expect_tx(&sm.full[st], kStageBytes);
    load_tile(sm.q[st], q_map, &sm.full[st], h, q0, b);
    load_tile(sm.dout[st], o_map, &sm.full[st], h, q0, b);
    bulk_load(sm.ls[st], ls + rows + q0, BQ * 4, &sm.full[st]);
    bulk_load(sm.dd[st], dd + rows + q0, BQ * 4, &sm.full[st]);
  };
  // Thread 0 keeps up to kStages ring tiles in flight: while computing tile
  // it, it issues each later tile whose stage its previous tile has left,
  // and waits for a stage only when tile it itself is not issued yet, so
  // warpgroup 0 runs up to two tiles ahead of warpgroup 1 without stalling.
  int next = 0;
  auto refill = [&](int it) {
    while (next < n_total && next < it + kStages &&
           (next <= it || mbar_ready(&sm.empty[next % kStages], ((next / kStages) & 1) ^ 1)))
      issue(next++);
  };
  if (threadIdx.x == 0) refill(0);

  // ---- consumers: 64 keys per warpgroup ----
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int kw = k0 + wg * 64;                                    // the warpgroup's first key
  const int key0 = kw + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // keys key0, key0 + 8
  const int c0 = 2 * (lane % 4);  // first column of the thread in each 8-column block
  const int kw_last = min(kw + 63, t_len - 1);
  const float cs = scale * kLog2e;
  const Mask mask{s_len, t_len, causal, window};
  int key_pos[2] = {-1, -1};  // kPos: the positions of keys key0 and key0 + 8 (-1 past T)
  if constexpr (kPos) {
#pragma unroll
    for (int r = 0; r < 2; ++r) key_pos[r] = key0 + 8 * r < t_len ? k_pos[key0 + 8 * r] : -1;
  }
  float acc_k[DQK / 2], acc_v[DV / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc_k[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc_v[i] = 0.0f;
  const Desc ka = k_major(sm.k, wg * 64), va = k_major(sm.v, wg * 64);

  mbar_wait(&sm.kv_full, 0);
  for (int it = 0; it < n_total; ++it) {
    if (threadIdx.x == 0) refill(it);
    const int st = it % kStages, q0 = q_of(it % n_tiles);
    const int row_last = min(q0 + BQ, s_len) - 1;
    const bool sees = kPos ? kw < t_len
                           : kw < t_len && (!causal || kw <= row_last) &&
                                 (window <= 0 || kw_last > q0 - window);
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    if (sees) {
      const bool edge = kPos ? q0 + BQ > s_len || kw + 64 > t_len ||
                                   !(tiles[1 + it % n_tiles] & kTileFull)
                             : q0 + BQ > s_len || kw + 64 > t_len || (causal && kw + 63 > q0) ||
                                   (window > 0 && kw <= q0 + BQ - 1 - window);
      const float* ls_s = sm.ls[st];
      const float* dd_s = sm.dd[st];
      // S^T = K Q^T and dP^T = V dO^T, two commit groups
      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
      ss_steps<BQ, DQK, kKeyBlock, BQ>(s, ka, k_major(sm.q[st], 0));
      wgmma_commit();
      ss_steps<BQ, DV, kKeyBlock, BQ>(dp, va, k_major(sm.dout[st], 0));
      wgmma_commit();
      if (threadIdx.x == 0) refill(it);
      uint32_t vis_bits = 0;  // kPos: bit i = score register i's visibility, on an edge tile
      if constexpr (kPos) {
        if (edge) {
#pragma unroll 1
          for (int jb = 0; jb < BQ / 8; ++jb) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int row = q0 + 8 * jb + c0 + c;
              if (row >= s_len) continue;
              const int qp = q_pos[row];
#pragma unroll
              for (int r = 0; r < 2; ++r)
                if (key0 + 8 * r < t_len && pos_visible(qp, key_pos[r], causal, window))
                  vis_bits |= 1u << (4 * jb + 2 * r + c);
            }
          }
        }
      }
      wgmma_wait<1>();
      fence_regs(s);
      // P^T on the visible (key, row) pairs; columns are q rows
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int col = 8 * (i >> 2) + c0 + (i & 1);
        float p = ex2(fmaf(s[i], cs, -ls_s[col]));
        if constexpr (kPos) {
          if (edge && !((vis_bits >> i) & 1)) p = 0.0f;
        } else {
          if (edge && !mask.visible(q0 + col, key0 + 8 * ((i >> 1) & 1))) p = 0.0f;
        }
        s[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS^T = P^T (dP^T - D) in float32; P^T and dS^T packed to bf16 pair
      // by pair as A fragments (k16 step kk: columns 16kk .. 16kk + 15)
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int i = 0; i < BQ / 2; i += 2) {
        const float d = dd_s[8 * (i >> 2) + c0];
        const float d1 = dd_s[8 * (i >> 2) + c0 + 1];
        pa[i / 8][(i % 8) / 2] = pack_bf16(s[i], s[i + 1]);
        da[i / 8][(i % 8) / 2] = pack_bf16(s[i] * (dp[i] - d), s[i + 1] * (dp[i + 1] - d1));
      }
      // dV += P^T dO and dK += dS^T Q
      fence_regs(acc_v);
      fence_regs(acc_k);
      wgmma_fence();
      rs_steps<DV, BQ, BQ / 16>(acc_v, pa, mn_major(sm.dout[st]));
      rs_steps<DQK, BQ, BQ / 16>(acc_k, da, mn_major(sm.q[st]));
      wgmma_commit();
      if (threadIdx.x == 0) refill(it);
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(pa);  // the A fragments stay untouched until the products are done
      fence_regs(da);
    }
    mbar_arrive(&sm.empty[st]);  // this thread is done with the stage
  }

  // dK = scale acc_k, dV = acc_v, keys key0 and key0 + 8
  const int64_t k_stride = static_cast<int64_t>(n_kv_heads) * DQK;
  const int64_t v_stride = static_cast<int64_t>(n_kv_heads) * DV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= t_len) continue;
    const int64_t row = static_cast<int64_t>(b) * t_len + key;
    __nv_bfloat16* dkr = dk + row * k_stride + static_cast<int64_t>(hk) * DQK;
    __nv_bfloat16* dvr = dv + row * v_stride + static_cast<int64_t>(hk) * DV;
#pragma unroll
    for (int i = 2 * r; i < DQK / 2; i += 4)
      *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * (i >> 2) + c0) =
          __floats2bfloat162_rn(acc_k[i] * scale, acc_k[i + 1] * scale);
#pragma unroll
    for (int i = 2 * r; i < DV / 2; i += 4)
      *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * (i >> 2) + c0) =
          __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
  }
}

template <int DQK, int DV>
struct QSmem {
  Tile<kRowBlock, DQK> q;
  Tile<kRowBlock, DV> dout;
  Tile<kKeyTile, DQK> k[kStages];
  Tile<kKeyTile, DV> v[kStages];
  uint64_t qo_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// dQ pass: one CTA per (b, q head, 128-row q tile).
template <int DQK, int DV, bool kPos>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ Maps q_map, const __grid_constant__ Maps k_map,
          const __grid_constant__ Maps v_map, const __grid_constant__ Maps o_map,
          const float* __restrict__ ls, const float* __restrict__ dd,
          __nv_bfloat16* __restrict__ dq, const int* __restrict__ q_pos,
          const int* __restrict__ k_pos, int n_heads, int n_kv_heads, int s_len, int t_len,
          int s_pad, int causal, int window, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  QSmem<DQK, DV>& sm = *reinterpret_cast<QSmem<DQK, DV>*>(smem_raw + pad);
  constexpr uint32_t kStageBytes = tile_bytes<kKeyTile, DQK>() + tile_bytes<kKeyTile, DV>();

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowBlock;  // late (heavy) q tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  // key tiles visible to some row of this q tile: first .. first + n_tiles - 1
  const int q_last = min(q0 + kRowBlock, s_len) - 1;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(t_len - 1, q_last) : t_len - 1;
  const int first = lo / kKeyTile;
  int n_tiles = hi >= first * kKeyTile ? (hi - first * kKeyTile) / kKeyTile + 1 : 0;
  // kPos: the listed key tiles (a count, then an entry a tile)
  int* tiles = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(&sm) + sizeof(sm));
  auto k_of = [&](int j) { return kPos ? (tiles[1 + j] & ~kTileFull) * kKeyTile
                                       : (first + j) * kKeyTile; };

  if (threadIdx.x == 0) {
    mbar_init(&sm.qo_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int j) {
    const int st = j % kStages, k0 = k_of(j);
    mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);  // passes at once on first use
    mbar_expect_tx(&sm.full[st], kStageBytes);
    load_tile(sm.k[st], k_map, &sm.full[st], hk, k0, b);
    load_tile(sm.v[st], v_map, &sm.full[st], hk, k0, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.qo_full, tile_bytes<kRowBlock, DQK>() + tile_bytes<kRowBlock, DV>());
    load_tile(sm.q, q_map, &sm.qo_full, h, q0, b);
    load_tile(sm.dout, o_map, &sm.qo_full, h, q0, b);
  }
  if constexpr (kPos) {  // the q and dO tiles load while every warp lists the key tiles
    n_tiles = list_tiles(tiles + 1, tiles, k_pos, kKeyTile, (t_len + kKeyTile - 1) / kKeyTile,
                         t_len, warp_range(q_pos, q0, kRowBlock, s_len), true, causal, window);
  }
  if (threadIdx.x == 0) {
    for (int j = 0; j < kStages - 1 && j < n_tiles; ++j) issue(j);
  }

  // ---- consumers: 64 q rows per warpgroup ----
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int rw = q0 + wg * 64;                                    // the warpgroup's first row
  const int row0 = rw + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // rows row0, row0 + 8
  const int c0 = 2 * (lane % 4);
  const int rw_last = min(rw + 63, s_len - 1);
  const float cs = scale * kLog2e;
  const Mask mask{s_len, t_len, causal, window};
  float ls_r[2], dd_r[2];  // rows < s_pad: the scratch holds 0 past S
  int row_pos[2] = {0, 0};  // kPos: the positions of rows row0 and row0 + 8 (any past S)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at = (static_cast<int64_t>(b) * n_heads + h) * s_pad + row0 + 8 * r;
    ls_r[r] = ls[at];
    dd_r[r] = dd[at];
    if constexpr (kPos) row_pos[r] = q_pos[min(row0 + 8 * r, s_len - 1)];
  }
  float acc[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.0f;
  const Desc qa = k_major(sm.q, wg * 64), oa = k_major(sm.dout, wg * 64);

  mbar_wait(&sm.qo_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    if (threadIdx.x == 0 && j + kStages - 1 < n_tiles) issue(j + kStages - 1);
    const int st = j % kStages, k0 = k_of(j);
    const bool sees = kPos ? rw < s_len
                           : rw < s_len && (!causal || k0 <= rw_last) &&
                                 (window <= 0 || min(k0 + kKeyTile - 1, t_len - 1) > rw - window);
    mbar_wait(&sm.full[st], (j / kStages) & 1);
    if (sees) {
      const bool edge = kPos ? rw + 64 > s_len || k0 + kKeyTile > t_len ||
                                   !(tiles[1 + j] & kTileFull)
                             : rw + 64 > s_len || k0 + kKeyTile > t_len ||
                                   (causal && k0 + kKeyTile - 1 > rw) ||
                                   (window > 0 && k0 <= rw + 63 - window);
      // S = Q K^T and dP = dO V^T, two commit groups
      float s[kKeyTile / 2], dp[kKeyTile / 2];
      wgmma_fence();
      ss_steps<kKeyTile, DQK, kRowBlock, kKeyTile>(s, qa, k_major(sm.k[st], 0));
      wgmma_commit();
      ss_steps<kKeyTile, DV, kRowBlock, kKeyTile>(dp, oa, k_major(sm.v[st], 0));
      wgmma_commit();
      uint32_t vis_bits = 0;  // kPos: bit i = score register i's visibility, on an edge tile
      if constexpr (kPos) {
        if (edge) {
#pragma unroll 1
          for (int jb = 0; jb < kKeyTile / 8; ++jb) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int key = k0 + 8 * jb + c0 + c;
              const int kp = key < t_len ? k_pos[key] : -1;
#pragma unroll
              for (int r = 0; r < 2; ++r)
                if (row0 + 8 * r < s_len && pos_visible(row_pos[r], kp, causal, window))
                  vis_bits |= 1u << (4 * jb + 2 * r + c);
            }
          }
        }
      }
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < kKeyTile / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = ex2(fmaf(s[i], cs, -ls_r[r]));
        if constexpr (kPos) {
          if (edge && !((vis_bits >> i) & 1)) p = 0.0f;
        } else {
          if (edge && !mask.visible(row0 + 8 * r, k0 + 8 * (i >> 2) + c0 + (i & 1))) p = 0.0f;
        }
        s[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P (dP - D), packed; dQ += dS K
      uint32_t da[kKeyTile / 16][4];
#pragma unroll
      for (int i = 0; i < kKeyTile / 2; i += 2) {
        const float d = dd_r[(i >> 1) & 1];
        da[i / 8][(i % 8) / 2] = pack_bf16(s[i] * (dp[i] - d), s[i + 1] * (dp[i + 1] - d));
      }
      fence_regs(acc);
      wgmma_fence();
      rs_steps<DQK, kKeyTile, kKeyTile / 16>(acc, da, mn_major(sm.k[st]));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
    }
    mbar_arrive(&sm.empty[st]);
  }

  const int64_t row_stride = static_cast<int64_t>(n_heads) * DQK;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= s_len) continue;
    __nv_bfloat16* dqr =
        dq + (static_cast<int64_t>(b) * s_len + row) * row_stride + static_cast<int64_t>(h) * DQK;
#pragma unroll
    for (int i = 2 * r; i < DQK / 2; i += 4)
      *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * (i >> 2) + c0) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
  }
}

// The maps of a contiguous (batch, rows, heads, d) bf16 tensor, innermost
// first: boxes of 64 columns (128-byte swizzle) and, at d = 160, of the last
// 32 (64-byte swizzle), of one head over box_rows rows of one batch entry,
// rows past the end zero-filled.
bool encode_maps(EncodeTiled encode, Maps* m, const void* base, int d, int heads, int rows,
                 int batch, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(d) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads, row_bytes * heads * rows};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  auto one = [&](CUtensorMap* map, int cols, CUtensorMapSwizzle swizzle) {
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                               static_cast<cuuint32_t>(box_rows), 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                  strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  if (!one(&m->span, kSpan, CU_TENSOR_MAP_SWIZZLE_128B)) return false;
  if (!has_tail(d)) {
    m->tail = m->span;
    return true;
  }
  return one(&m->tail, kTail, CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int DQK, int DV, int BQ, bool kPos>
int launch(const void* q, const void* k, const void* v, const void* out, const void* lse,
           const void* dout, void* dq, void* dk, void* dv, void* aux, const int* q_pos,
           const int* k_pos, int batch, int n_heads, int n_kv_heads, int s_len, int t_len,
           int causal, int window, float scale, void* stream) {
  constexpr int kMaxSmem = 232448;  // the 227 KB of shared memory an H100 block may take
  constexpr int kv_base = static_cast<int>(sizeof(KvSmem<DQK, DV, BQ>)) + 1024;  // + alignment
  constexpr int q_base = static_cast<int>(sizeof(QSmem<DQK, DV>)) + 1024;
  static_assert(kv_base <= kMaxSmem && q_base <= kMaxSmem,
                "over the 227 KB of shared memory an H100 block may take");
  // kPos: each pass's tile list, a count then an entry a tile
  const int64_t kv_smem64 = kv_base + (kPos ? 4 * (static_cast<int64_t>(s_len + BQ - 1) / BQ + 1) : 0);
  const int64_t q_smem64 =
      q_base + (kPos ? 4 * (static_cast<int64_t>(t_len + kKeyTile - 1) / kKeyTile + 1) : 0);
  if (kv_smem64 > kMaxSmem || q_smem64 > kMaxSmem) return kErrTileList;
  const int kv_smem = static_cast<int>(kv_smem64), q_smem = static_cast<int>(q_smem64);
  static bool configured = false;  // raise the dynamic shared memory limits once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(dkv_kernel<DQK, DV, BQ, kPos>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kPos ? kMaxSmem : kv_base);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dq_kernel<DQK, DV, kPos>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kPos ? kMaxSmem : q_base);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (batch == 0 || n_heads == 0 || s_len == 0) return static_cast<int>(cudaGetLastError());
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s_pad = (s_len + kPadRows - 1) / kPadRows * kPadRows;
  float* ls = static_cast<float*>(aux);
  float* dd = ls + static_cast<int64_t>(batch) * n_heads * s_pad;
  const auto* out_b = static_cast<const __nv_bfloat16*>(out);
  const auto* dout_b = static_cast<const __nv_bfloat16*>(dout);
  prep_kernel<DV><<<dim3(s_pad / 8, n_heads, batch), 256, 0, st>>>(
      out_b, dout_b, static_cast<const float*>(lse), ls, dd, n_heads, s_len, s_pad);

  Maps q_map, o_map, k_map, v_map;
  if (t_len > 0) {
    if (!encode_maps(encode, &q_map, q, DQK, n_heads, s_len, batch, BQ) ||
        !encode_maps(encode, &o_map, dout, DV, n_heads, s_len, batch, BQ) ||
        !encode_maps(encode, &k_map, k, DQK, n_kv_heads, t_len, batch, kKeyBlock) ||
        !encode_maps(encode, &v_map, v, DV, n_kv_heads, t_len, batch, kKeyBlock)) {
      return kErrBadMap;
    }
    dkv_kernel<DQK, DV, BQ, kPos>
        <<<dim3((t_len + kKeyBlock - 1) / kKeyBlock, n_kv_heads, batch), kThreads, kv_smem,
           st>>>(q_map, k_map, v_map, o_map, ls, dd, static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv), q_pos, k_pos, n_heads, n_kv_heads, s_len,
                 t_len, s_pad, causal, window, scale);
  }
  if (!encode_maps(encode, &q_map, q, DQK, n_heads, s_len, batch, kRowBlock) ||
      !encode_maps(encode, &o_map, dout, DV, n_heads, s_len, batch, kRowBlock)) {
    return kErrBadMap;
  }
  if (t_len > 0) {
    if (!encode_maps(encode, &k_map, k, DQK, n_kv_heads, t_len, batch, kKeyTile) ||
        !encode_maps(encode, &v_map, v, DV, n_kv_heads, t_len, batch, kKeyTile)) {
      return kErrBadMap;
    }
  } else {
    k_map = q_map;  // no key tile is loaded
    v_map = o_map;
  }
  dq_kernel<DQK, DV, kPos><<<dim3((s_len + kRowBlock - 1) / kRowBlock, n_heads, batch),
                             kThreads, q_smem, st>>>(
      q_map, k_map, v_map, o_map, ls, dd, static_cast<__nv_bfloat16*>(dq), q_pos, k_pos,
      n_heads, n_kv_heads, s_len, t_len, s_pad, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bfloat16 q (B, S, H, head_dim), k (B, T, Hkv, head_dim), v (B, T, Hkv,
// head_dim_v), out and dout (B, S, H, head_dim_v), dq, dk, dv like q, k, v,
// contiguous with 16-byte aligned starts; lse (B, H, S) float32 from the
// forward; aux a float32 scratch of 2 * B * H * S_pad, S_pad = S rounded up
// to 128; q_pos and k_pos both null (the index mask) or the forward's
// int32 (S,) and (T,) position vectors. (head_dim, head_dim_v) = (64, 64),
// (128, 128), (192, 128) or (160, 160); H a multiple of Hkv. Enqueues three
// grids on `stream`; returns cudaGetLastError() after them (0 = launched),
// or a negative code when a TMA tensor map could not be built (-1, -2) or a
// tile list does not fit in shared memory (-3).
int repro_flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                                   const void* lse, const void* dout, void* dq, void* dk,
                                   void* dv, void* aux, const int* q_pos, const int* k_pos,
                                   int batch, int n_heads, int n_kv_heads, int s_len, int t_len,
                                   int head_dim, int head_dim_v, int causal, int window,
                                   float scale, void* stream) {
#define REPRO_FA_BWD(DQK, DV, BQ)                                                               \
  if (head_dim == DQK && head_dim_v == DV) {                                                  \
    if (q_pos != nullptr)                                                                     \
      return launch<DQK, DV, BQ, true>(q, k, v, out, lse, dout, dq, dk, dv, aux, q_pos,       \
                                       k_pos, batch, n_heads, n_kv_heads, s_len, t_len,       \
                                       causal, window, scale, stream);                        \
    return launch<DQK, DV, BQ, false>(q, k, v, out, lse, dout, dq, dk, dv, aux, q_pos, k_pos, \
                                      batch, n_heads, n_kv_heads, s_len, t_len, causal,       \
                                      window, scale, stream);                                 \
  }
  REPRO_FA_BWD(64, 64, 64)
  REPRO_FA_BWD(128, 128, 64)
  REPRO_FA_BWD(192, 128, 32)
  REPRO_FA_BWD(160, 160, 32)
#undef REPRO_FA_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
