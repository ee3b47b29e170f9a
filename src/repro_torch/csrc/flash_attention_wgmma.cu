// Causal GQA flash attention in bfloat16 for sm_90a, on Hopper's tensor
// cores — the port's flash_attention kernel for bf16 inputs.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention/kernel.py:flash_attention_kernel
//   (_fa_kernel; wrapper ops.flash_attention)
// (float32 inputs keep the CUDA-core kernel in flash_attention.cu).
//
// What it computes, for q (B, S, H, DQK), k (B, T, Hkv, DQK) and v (B, T,
// Hkv, DV) in bfloat16 in the model's layout ((DQK, DV) = (64, 64),
// (128, 128), MLA's (192, 128): deepseek-v2-lite's q and k carry 128
// content and 64 decoupled-RoPE dims, its v 128; or stablelm-12b's
// (160, 160)), with G = H / Hkv (any integer: chatglm3's 16, qwen2-vl's 6):
//   out[b, s, h] = softmax_t(mask(q[b, s, h] . k[b, t, h / G] * scale)) @ v[b, :, h / G]
// where key t is visible to query s iff t < T, t <= s when causal, and
// t > s - window when window > 0 (positions are the indices), or, where the
// caller passes position vectors q_pos (S,) and k_pos (T,), iff t < T and
// positions.cuh's rule holds (JAX's chunked_attention mask; M-RoPE's t
// stream gives all of an image's tokens one position). The softmax
// is online over key tiles (128 keys; 64 at (160, 160)): float32 scores, running max m and sum l,
// p = exp(s - m_new) in float32 (a masked key gives p = 0 exactly), l sums
// the float32 p, and P is rounded to bf16 before P.V, which accumulates in
// float32; out = acc / max(l, 1e-30), written in bf16. Where the caller
// passes an `lse` pointer (training: flash_attention_bwd_wgmma.cu recomputes P
// from it), the kernel also writes each row's float32 logsumexp of the
// scaled scores, lse[b, h, s] = m + log(max(l, 1e-30)), (B, H, S), from the
// quad's first thread; a null pointer leaves every other instruction, and
// so the output's bits, as they were. exp is taken as
// 2^((s - m_new) log2 e) on the special-function unit (ex2.approx, within
// ~2^-21 of expf), which flash_attention_plain's contract allows for
// (p_rounding_slack). That is the
// arithmetic of JAX's chunked_attention (models/layers.py: p.astype(v.dtype)
// into the P.V einsum), which the JAX model's prefill runs; the Pallas
// kernel keeps P in float32. flash_attention_plain repeats it with the
// same key tiles.
//
// Bound on an H100 at granite-3-8b's prefill (B=4, S=T=2048, H=32, Hkv=8,
// D=128): operations — the visible half of the score matrix,
// 4 * B * H * D * S(S+1)/2 = 0.1375 TFLOP, 0.139 ms at the 989 TFLOP/s
// bf16 tensor-core rate; bytes — q, k, v read once and out written once,
// 168 MB, 0.050 ms at 3.35 TB/s. Operations bind, so both products run on
// wgmma. At deepseek-v2-lite's (B=4, S=T=2048, H=Hkv=16, DQK=192, DV=128)
// the visible half is 2 * B * H * (DQK + DV) * S(S+1)/2 = 0.0859 TFLOP,
// 0.0869 ms; at deepseek-moe's (H=Hkv=16, D=128) 0.0687 TFLOP, 0.0695 ms;
// at stablelm-12b's (H=32, Hkv=8, D=160) 0.1719 TFLOP, 0.174 ms; at
// chatglm3-6b's (H=32, Hkv=2, D=128) granite's 0.139 ms; at qwen2-vl-2b's
// (H=12, Hkv=2, D=128) 0.0516 TFLOP, 0.052 ms.
//
// Design. One CTA per (b, q head, 128-row q tile), 384 threads in three
// warpgroups; heavy (late, causal) q tiles are launched first.
// - Warpgroup 2 is the producer: one thread loads the q tile once and then
//   keeps the K and V tiles of kv head h / G in flight in a 2-stage ring in
//   shared memory, with TMA (cp.async.bulk.tensor over 4-D tensor maps of
//   the model layout, (DQK or DV, heads, rows, B)) completing on mbarriers: a "full"
//   barrier per stage for K and one for V, and an "empty" barrier per stage
//   on which the 256 consumer threads arrive when they are done with it.
//   A bf16 row of D = 128 is 256 B (DQK = 192: 384 B), wider than the
//   128-byte swizzle span, so every tile is loaded as D/64 boxes of 64
//   columns, each a (rows x 128 B) block in TMA's 128-byte swizzle; rows
//   past S or T are zero-filled by TMA. The producer gives its registers
//   back (setmaxnreg 24).
// - Warpgroups 0 and 1 are consumers (setmaxnreg 240), 64 query rows each.
//   S = Q.K^T is wgmma m64n128k16 with both operands K-major in shared
//   memory (DQK/16 instructions a tile: 12 at DQK = 192). Its float32 accumulator fragment
//   holds rows r and r + 8 (r = 16 * warp + lane / 4) and columns
//   8j + 2(lane % 4) + {0, 1}: the mask is applied in those coordinates
//   (only on tiles that touch the diagonal, the window edge or T), row max
//   and row sum are two quad shuffles, and the accumulator is rescaled by
//   exp(m_old - m_new) in registers. P is packed to bf16 pairs in place:
//   the m64n128 accumulator layout matches wgmma's register A fragment
//   (m64k16: a0..a3 = columns 2c,2c+1 of rows r, r+8 and columns 8+2c,
//   9+2c), so O += P.V is wgmma m64n{DV}k16 with A from registers and V as
//   stored (keys x DV, MN-major: the transpose bit), 8 instructions a tile.
//   So at (192, 128) the registers are those of D = 128: a 64-register S
//   fragment and a 64-register O fragment; only S's k-loop is longer.
//   l is kept per thread and summed over the quad at the end.
// - The two consumer warpgroups take turns on the tensor cores (named
//   barriers 1 and 2): one issues its P.V of tile j and its S of tile j+1
//   only after the other has issued its own, so each warpgroup's softmax
//   runs while the other's products do. Without the turns both tended to
//   multiply at once and then both do softmax, leaving the tensor cores
//   idle; the turns made the kernel clearly faster on the H100.
//   Overlapping a warpgroup's own S of tile j+1 with its softmax of tile j
//   instead needs S, O and P live at once; ptxas then serializes the
//   wgmmas ("insufficient register resources") and it ran slower.
// - Key tiles that the mask hides from every row of the q tile (above the
//   diagonal, or wholly before the window) are neither loaded nor computed.
// - Position masks (the kPos instantiation; null pointers launch the index
//   one, unchanged). The visible key tiles of a q tile are no longer a run
//   of indices, so the CTA lists them first: while the q tile loads, its 12
//   warps reduce the positions of its 128 rows and of each key tile to
//   their min and max (warp_range) and keep, in order, the tiles where some
//   pair may be visible, flagging those where every pair is (list_tiles, in
//   shared memory after the ring: 4 bytes a key tile). Producer and
//   consumers then walk the list as they walked the run; a tile flagged
//   whole is not masked. On a tile that is masked, each consumer thread
//   first gathers the positions of its 32 keys into a bit mask of its 64
//   scores (before its S lands), so the masking keeps the index version's
//   form. The TMA boxes and wgmma tiles are laid out as before.
// - (160, 160), stablelm-12b. 160 is not a multiple of the 64-column span,
//   so every tile's third span is a full 64-column box at column 128 whose
//   last 32 columns lie past D: TMA fills them with zeros (the tensors are
//   read in place, 160 wide; no padded copy). S takes 10 k16 steps, none in
//   the zero fill; O is m64n128 over the first two spans plus m64n64 over
//   the third, 96 registers, whose zero-filled half is never written out.
//   With 128-key tiles that would be S's 64 registers + O's 96 live through
//   the softmax, over the 168 that ptxas allocates, and a 240 KB ring of
//   padded tiles, over the 227 KB a block may take; so this instantiation
//   takes 64-key tiles (BN = 64): S is m64n64 (32 registers), P 16, and
//   S + O = 128 as at D = 128; Q 48 KB + two 24 KB K stages + two 24 KB V
//   stages = 144 KB. The cost: twice the tiles, each with its barriers and
//   softmax, and 20% more P.V products (192 columns for 160).
//   flash_attention_plain takes the same 64-key tiles at this head dim.
//
// Tiles: 128 q rows x 128 keys, 2 stages: shared memory 160 KB + barriers
// at D = 128 (80 KB at D = 64), one CTA per SM (a third stage, 224 KB,
// ran slower). At (192, 128): a 48 KB q tile, a 96 KB K ring and a 64 KB V
// ring (V is not padded to 192), 208 KB + barriers, under the 227 KB a
// block may take. At (160, 160): 128 q rows x 64 keys, 144 KB.
// ptxas (CUDA 12.8) reports 168 registers for every instantiation
// (setmaxnreg moves registers at run time but ptxas still allocates within
// 168), no spills at D = 128, at (192, 128) and at (160, 160) with its
// 64-key tiles, 84 bytes of spill stores at D = 64; the position-masked
// instantiations 216 bytes at D = 128 and at (192, 128), none at D = 64
// and (160, 160); printed by
// `python -c "from repro_torch.kernels import build; build.build(verbose=True)"`.
//
// TMA's tensor maps need the CUDA driver API's cuTensorMapEncodeTiled; it is taken
// through cudaGetDriverEntryPoint(ByVersion), so the library links no
// libcuda. The maps are encoded on the host at each call and passed as
// __grid_constant__ parameters, so a call can be captured in a CUDA graph.
//
// Built by nvcc into a shared library with a C interface
// (repro_torch/kernels/build.py); the Python wrapper in
// repro_torch/kernels/flash_attention/ops.py launches it on torch's current
// stream.

#include "hopper.cuh"
#include "positions.cuh"

namespace {

constexpr int kBlockM = 128;               // query rows per CTA
constexpr int kStages = 2;                 // K/V ring depth
constexpr int kConsumers = 2;              // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSpan = 64;                  // bf16 columns of one 128-byte swizzle span
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// 64-column spans of a row of d columns, the last one zero-filled past d
__host__ __device__ constexpr int spans(int d) { return (d + kSpan - 1) / kSpan; }

// BN keys per K/V tile: 128, or 64 at (160, 160)
template <int DQK, int DV, int BN>
struct Smem {
  alignas(1024) __nv_bfloat16 q[spans(DQK)][kBlockM][kSpan];
  alignas(1024) __nv_bfloat16 k[kStages][spans(DQK)][BN][kSpan];
  alignas(1024) __nv_bfloat16 v[kStages][spans(DV)][BN][kSpan];
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t kv_empty[kStages];
};


// S = Q . K^T of a tile of BN keys: DQK/16 wgmma steps (10 at DQK = 160:
// the zero-filled half of the third span is not multiplied), each 32 bytes
// further into the 128-byte rows of a span (two 16-byte units), spans of
// the q and k tiles kBlockM * 128 and BN * 128 bytes apart.
template <int D, int BN, int KK = 0>
__device__ __forceinline__ void qk_steps(float (&s)[BN / 2], uint64_t q_desc, uint64_t k_desc) {
  if constexpr (KK < D / 16) {
    constexpr int span = KK / 4, off = (KK % 4) * 2;
    constexpr int off_q = span * kBlockM * 8 + off, off_k = span * BN * 8 + off;
    if constexpr (BN == 128) {
      wgmma_ss_m64n128k16<off_q, off_k>(s, q_desc, k_desc, KK > 0);
    } else {
      wgmma_ss_m64n64k16<off_q, off_k>(s, q_desc, k_desc, KK > 0);
    }
    qk_steps<D, BN, KK + 1>(s, q_desc, k_desc);
  }
}

// O += P . V of a tile: 16 keys (2048 bytes, 128 units) a step. O spans
// spans(D) * 64 columns: m64n128 over the first two spans (m64n64 over the
// one span at D = 64), and at D = 160 m64n64 over the third span, whose
// last 32 columns are TMA's zero fill and are never written out.
template <int D, int BN, int KK = 0>
__device__ __forceinline__ void pv_steps(float (&o)[spans(D) * 32],
                                         const uint32_t (&pa)[BN / 16][4], uint64_t v_desc) {
  if constexpr (KK < BN / 16) {
    if constexpr (D == 64) {
      wgmma_rs_m64n64k16<KK * 128>(o, pa[KK], v_desc);
    } else {
      wgmma_rs_m64n128k16<KK * 128>(o, pa[KK], v_desc);
      if constexpr (spans(D) == 3) {
        wgmma_rs_m64n64k16<2 * BN * 8 + KK * 128, 64>(o, pa[KK], v_desc);
      }
    }
    pv_steps<D, BN, KK + 1>(o, pa, v_desc);
  }
}

// Named barriers 1 and 2 (0 is __syncthreads) over the two consumer
// warpgroups: one syncs, the other arrives.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}


template <int DQK, int DV, int BN, bool kPos>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                             const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                             int n_heads, int n_kv_heads, int s_len, int t_len, int causal,
                             int window, float scale) {
  static_assert((DQK == 64 && DV == 64 && BN == 128) ||
                    (DQK == 128 && DV == 128 && BN == 128) ||
                    (DQK == 192 && DV == 128 && BN == 128) ||
                    (DQK == 160 && DV == 160 && BN == 64),
                "(DQK, DV, BN) = (64, 64, 128), (128, 128, 128), (192, 128, 128) or (160, 160, 64)");
  // what a tile's boxes write to shared memory, the zero fill past D included
  constexpr uint32_t kQTileBytes = spans(DQK) * kBlockM * kSpan * 2;
  constexpr uint32_t kKTileBytes = spans(DQK) * BN * kSpan * 2;
  constexpr uint32_t kVTileBytes = spans(DV) * BN * kSpan * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;  // swizzle atoms
  Smem<DQK, DV, BN>& sm = *reinterpret_cast<Smem<DQK, DV, BN>*>(smem_raw + pad);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // late (heavy) q tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);

  // key tiles visible to some row of this q tile: first .. first + n_tiles - 1
  // (under positions the list's n_tiles entries)
  const int q_last = min(q0 + kBlockM, s_len) - 1;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(t_len - 1, q_last) : t_len - 1;
  const int first = lo / BN;
  int n_tiles = hi >= first * BN ? (hi - first * BN) / BN + 1 : 0;
  int* tiles = reinterpret_cast<int*>(smem_raw + pad + sizeof(Smem<DQK, DV, BN>));  // kPos
  // the key tile of step j, and whether every pair of it is visible (kPos)
  auto tile_of = [&](int j) { return kPos ? (tiles[1 + j] & ~kTileFull) : first + j; };

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.kv_empty[st], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto load_q = [&] {
    mbar_expect_tx(&sm.q_full, kQTileBytes);
    for (int c = 0; c < spans(DQK); ++c)
      tma_load(&sm.q[c][0][0], &q_map, &sm.q_full, c * kSpan, h, q0, b);
  };
  if constexpr (kPos) {  // the q tile loads while every warp lists the key tiles
    if (threadIdx.x == kConsumers * 128) load_q();
    const int n_all = (t_len + BN - 1) / BN;
    n_tiles = list_tiles(tiles + 1, tiles, k_pos, BN, n_all, t_len,
                         warp_range(q_pos, q0, kBlockM, s_len), true, causal, window);
  }

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load of the CTA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      if constexpr (!kPos) load_q();
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&sm.kv_empty[st], ((j / kStages) & 1) ^ 1);  // passes at once on first use
        const int k0 = tile_of(j) * BN;
        mbar_expect_tx(&sm.k_full[st], kKTileBytes);
        for (int c = 0; c < spans(DQK); ++c)
          tma_load(&sm.k[st][c][0][0], &k_map, &sm.k_full[st], c * kSpan, hk, k0, b);
        mbar_expect_tx(&sm.v_full[st], kVTileBytes);
        for (int c = 0; c < spans(DV); ++c)
          tma_load(&sm.v[st][c][0][0], &v_map, &sm.v_full[st], c * kSpan, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int lane = threadIdx.x % 32;
    const int r0 = q0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // rows r0, r0 + 8
    const int c0 = 2 * (lane % 4);  // first column of the thread in each 8-column block
    constexpr int kO = spans(DV) * 32;  // accumulator registers of O (64 x spans(DV) * 64)
    float o[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.0f;
    float m[2] = {kNeg, kNeg};
    float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums

    // keys visible to the thread's rows r0 and r0 + 8: key_lo[r] .. key_hi[r]
    int key_lo[2], key_hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      key_hi[r] = causal ? min(t_len - 1, row) : t_len - 1;
      key_lo[r] = window > 0 ? row - window + 1 : 0;
    }
    int row_pos[2] = {0, 0};  // kPos: the positions of rows r0 and r0 + 8 (any past S)
    if constexpr (kPos) {
#pragma unroll
      for (int r = 0; r < 2; ++r) row_pos[r] = q_pos[min(r0 + 8 * r, s_len - 1)];
    }
    // kPos: bit i of a masked tile's S register i is its visibility
    uint64_t vis_bits = 0;
    // visibility of S register i (row r0 + 8 * ((i >> 1) & 1), key k0 + c0 + 8 * (i >> 2) + (i & 1))
    auto visible = [&](int k0, int i) {
      if constexpr (kPos) {
        return ((vis_bits >> i) & 1) != 0;
      } else {
        const int key = k0 + c0 + 8 * (i >> 2) + (i & 1);
        return key >= key_lo[(i >> 1) & 1] && key <= key_hi[(i >> 1) & 1];
      }
    };
    // wgmma descriptors of the tiles' starts; steps add 16-byte units to them
    const uint64_t q_desc = sw128_desc(&sm.q[0][wg * 64][0], 16, 1024);
    const uint64_t k_desc = sw128_desc(&sm.k[0][0][0][0], 16, 1024);
    const uint64_t v_desc = sw128_desc(&sm.v[0][0][0][0], BN * 128, 1024);
    constexpr uint32_t kKStage16 = sizeof(sm.k[0]) / 16;  // one K stage
    constexpr uint32_t kVStage16 = sizeof(sm.v[0]) / 16;  // one V stage

    // The two warpgroups take turns on the tensor cores: each issues its
    // P.V of one tile and S of the next (a turn) only after the other has
    // issued its own, so one's softmax runs while the other's products do.
    // Warpgroup 0 goes first.
    mbar_wait(&sm.q_full, 0);
    if (wg == 1 && n_tiles > 0) bar_arrive(1);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const int k0 = tile_of(j) * BN;
      bool edge = false;
      if constexpr (kPos) {
        edge = !(tiles[1 + j] & kTileFull) || k0 + BN > t_len;
        if (edge) {  // the 64 scores' visibility, from the positions of the thread's 32 keys
          vis_bits = 0;
#pragma unroll 1
          for (int jb = 0; jb < BN / 8; ++jb) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int key = k0 + c0 + 8 * jb + c;
              const int kp = key < t_len ? k_pos[key] : -1;
#pragma unroll
              for (int r = 0; r < 2; ++r)
                if (pos_visible(row_pos[r], kp, causal, window))
                  vis_bits |= 1ull << (4 * jb + 2 * r + c);
            }
          }
        }
      }

      // S = Q . K^T: DQK/16 wgmma steps, 32 bytes into each 128-byte span row
      float s[BN / 2];
      mbar_wait(&sm.k_full[st], parity);
      if (j == 0) bar_sync(1 + wg);
      wgmma_fence();
      qk_steps<DQK, BN>(s, q_desc, k_desc + st * kKStage16);
      wgmma_commit();
      bar_arrive(2 - wg);  // the other warpgroup's turn
      wgmma_wait<0>();
      fence_regs(s);

      // online softmax on the fragment: mask, row max, p = exp(s - m_new)
      if constexpr (!kPos) {
        edge = (causal && k0 + BN - 1 > q0) ||
               (window > 0 && k0 <= q0 + kBlockM - 1 - window) || k0 + BN > t_len;
      }
      float mx[2] = {m[0], m[1]};
      if (edge) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          s[i] = visible(k0, i) ? s[i] * scale : kNeg;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          s[i] *= scale;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      }
      float corr[2], ml[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        ml[r] = mx[r] * kLog2e;
      }
      if (edge) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          s[i] = visible(k0, i) ? ex2(fmaf(s[i], kLog2e, -ml[(i >> 1) & 1])) : 0.0f;
          sum[(i >> 1) & 1] += s[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          s[i] = ex2(fmaf(s[i], kLog2e, -ml[(i >> 1) & 1]));
          sum[(i >> 1) & 1] += s[i];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int i = 0; i < kO; ++i) o[i] *= corr[(i >> 1) & 1];

      // P in bf16 as wgmma's A fragment: k16 step kk takes S columns 16kk .. 16kk + 15
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);  // row r, columns 2c, 2c + 1
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);  // row r + 8
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);  // row r, columns 8 + 2c, 9 + 2c
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);  // row r + 8
      }

      // O += P . V: V as stored (keys x DV) is B in MN-major; its
      // 64-column spans lie BN * 128 bytes apart, 8-key groups 1024
      mbar_wait(&sm.v_full[st], parity);
      bar_sync(1 + wg);  // this warpgroup's turn
      fence_regs(o);
      wgmma_fence();
      pv_steps<DV, BN>(o, pa, v_desc + st * kVStage16);
      wgmma_commit();
      if (j + 1 == n_tiles && wg == 0) bar_arrive(2);  // warpgroup 1's last turn
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&sm.kv_empty[st]);  // this thread is done with the stage
    }

    // out = acc / max(l, 1e-30): l summed over the quad that shares the rows
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = fmaxf(l[r], 1e-30f);
      const int row = r0 + 8 * r;
      if (lse != nullptr && lane % 4 == 0 && row < s_len)
        lse[(static_cast<int64_t>(b) * n_heads + h) * s_len + row] = m[r] + logf(den[r]);
    }
    const int64_t row_stride = static_cast<int64_t>(n_heads) * DV;
#pragma unroll
    for (int i = 0; i < kO; i += 2) {
      const int rh = (i >> 1) & 1;
      const int row = r0 + 8 * rh;
      const int col = 8 * (i >> 2) + c0;  // past DV only in the zero-filled span
      if (row < s_len && col < DV) {
        __nv_bfloat16* dst = out + (static_cast<int64_t>(b) * s_len + row) * row_stride +
                             static_cast<int64_t>(h) * DV + col;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(__fdiv_rn(o[i], den[rh]), __fdiv_rn(o[i + 1], den[rh]));
      }
    }
  }
}


// A 4-D map over a contiguous (batch, rows, heads, D) bf16 tensor, innermost
// first; a box is 64 columns of one head over box_rows rows of one batch
// entry, 128-byte swizzled, rows past the end zero-filled.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* base, int d, int heads,
                int rows, int batch, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(d) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads, row_bytes * heads * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kSpan), 1, static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


template <int DQK, int DV, int BN, bool kPos>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, const int* q_pos,
           const int* k_pos, int batch, int n_heads, int n_kv_heads, int s_len, int t_len,
           int causal, int window, float scale, void* stream) {
  constexpr int kMaxSmem = 232448;  // the 227 KB of shared memory an H100 block may take
  constexpr int base = static_cast<int>(sizeof(Smem<DQK, DV, BN>)) + 1024;  // + alignment slack
  static_assert(base <= kMaxSmem, "over the 227 KB of shared memory an H100 block may take");
  // kPos: the key tile list (a count, then an entry a key tile)
  const int64_t smem64 = base + (kPos ? 4 * (static_cast<int64_t>(t_len + BN - 1) / BN + 1) : 0);
  if (smem64 > kMaxSmem) return kErrTileList;
  const int smem = static_cast<int>(smem64);
  static bool configured = false;  // raise the dynamic shared memory limit once
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_attention_wgmma_kernel<DQK, DV, BN, kPos>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kPos ? kMaxSmem : base);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((s_len + kBlockM - 1) / kBlockM, n_heads, batch);
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return static_cast<int>(cudaGetLastError());
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(encode, &q_map, q, DQK, n_heads, s_len, batch, kBlockM)) return kErrBadMap;
  if (t_len > 0) {
    if (!encode_map(encode, &k_map, k, DQK, n_kv_heads, t_len, batch, BN) ||
        !encode_map(encode, &v_map, v, DV, n_kv_heads, t_len, batch, BN)) {
      return kErrBadMap;
    }
  } else {
    k_map = v_map = q_map;  // no key tile is loaded
  }
  flash_attention_wgmma_kernel<DQK, DV, BN, kPos><<<grid, kThreads, smem,
                                                    static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), q_pos,
      k_pos, n_heads, n_kv_heads, s_len, t_len, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV, int BN>
int launch_mask(const void* q, const void* k, const void* v, void* out, void* lse,
                const int* q_pos, const int* k_pos, int batch, int n_heads, int n_kv_heads,
                int s_len, int t_len, int causal, int window, float scale, void* stream) {
  if (q_pos != nullptr)
    return launch<DQK, DV, BN, true>(q, k, v, out, lse, q_pos, k_pos, batch, n_heads,
                                     n_kv_heads, s_len, t_len, causal, window, scale, stream);
  return launch<DQK, DV, BN, false>(q, k, v, out, lse, q_pos, k_pos, batch, n_heads, n_kv_heads,
                                    s_len, t_len, causal, window, scale, stream);
}

}  // namespace

extern "C" {

// bfloat16 q (B, S, H, DQK), k (B, T, Hkv, DQK), v and out (B, T or S, Hkv
// or H, DV), contiguous with 16-byte aligned starts; (head_dim, head_dim_v)
// = (64, 64), (128, 128), (192, 128) or (160, 160); H a multiple of Hkv;
// lse null, or float32 (B, H, S) for the rows' logsumexp; q_pos and k_pos
// both null (the index mask), or int32 (S,) and (T,) position vectors.
// Returns cudaGetLastError() after the launch (0 = launched), or a negative
// code when a TMA tensor map could not be built (-1, -2) or the key tile
// list does not fit in shared memory (-3).
int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                               const int* q_pos, const int* k_pos, int batch, int n_heads,
                               int n_kv_heads, int s_len, int t_len, int head_dim,
                               int head_dim_v, int causal, int window, float scale,
                               void* stream) {
#define REPRO_FA(DQK, DV, BN)                                                                   \
  if (head_dim == DQK && head_dim_v == DV)                                                    \
    return launch_mask<DQK, DV, BN>(q, k, v, out, lse, q_pos, k_pos, batch, n_heads,          \
                                    n_kv_heads, s_len, t_len, causal, window, scale, stream);
  REPRO_FA(64, 64, 128)
  REPRO_FA(128, 128, 128)
  REPRO_FA(192, 128, 128)
  REPRO_FA(160, 160, 64)
#undef REPRO_FA
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
