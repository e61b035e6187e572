// Full-sequence GQA flash attention for Hopper (sm_90a): forward, and a
// FlashAttention-2 style backward in two deterministic kernels.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
//   (pallas_call at :114, body _flash_kernel at :23; wrapper ops.py:26)
// and computes what its oracle computes
//   src/repro/kernels/flash_attention/ref.py::attention_ref
// q [B,Sq,Hq,dh], k [B,Sk,Hkv,dh], v [B,Sk,Hkv,dv] with dv <= dh (MLA's
// values are narrower than its keys), out [B,Sq,Hq,dv]; query position s of
// head h attends key position t when t < Sk, and (causal) t <= s, and
// (window) t > s - window.
// Scores leave the Q.K product in fp32 (as the Pallas kernel, and unlike the
// einsum oracle, which rounds them to the input type first); probabilities
// are cast to V's type before P.V, as _flash_kernel:76 does.
//
// What bounds it on this card: operations.  At the training shape (S 2048,
// dh 64) a causal call does ~2*S*S*dh multiply-adds per head and moves each
// of q, k, v and o once, some 300 operations a byte, above the H100's bf16
// ridge.  Three variants, chosen from the shape before any launch by the
// wrapper's variant() (a launch checks that its variant takes the shape):
//  * wgmma: bf16 with G dividing 64, every head dim (the training, prefill
//    and smoke shapes, and gemma3's dh 256).  Warp-specialised kernels: a
//    producer warp feeds a TMA ring of K/V (or Q/dO) tiles, consumer
//    warpgroups run every tile product with wgmma and keep S, P, dS and the
//    O/dQ/dK/dV accumulators in registers; the tiles, ring depths and the
//    split of the dK/dV accumulators change with the head dim; see the
//    section below.
//  * wgmma_rows: bf16 with any other G (3, 5, 6, 72, ...), every head dim.
//    The same kernels, fed from a copy of q (and dout) that a gather pass
//    writes with the rows of one kv head contiguous, so that a 64-row tile
//    needs no whole positions; their backward keeps D and the A operands of
//    dV and dK to about 16 bits, where the many rows of a large group would
//    add up bf16's rounding past the tolerance.  See the section below.
//  * tf32x3: fp32, every head dim and every G.  Each fp32 product is three
//    TF32 products on wgmma (a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, fp32 sums),
//    which keep close to fp32's precision where one TF32 pass would round
//    the inputs to 11 bits; bounded by the tensor cores at 495 / 3 = 165
//    TFLOP/s, against the CUDA cores' 67 for plain fp32 FMAs.  A split pass
//    writes hi and lo (and the operands wgmma needs transposed), then the
//    same warp-specialised shape as wgmma streams them through a TMA ring;
//    see the section below.
// What the design does, in all three:
//  * The TPU grid (B, Hq, n_q, n_k) walks the KV axis in order and carries
//    m/l/acc in VMEM.  Here one block owns a tile of query rows and loops
//    over key tiles itself, carrying m/l/acc on the chip.  A block's rows
//    are (position, head) pairs of one KV head, r = s*G + g, so the G query
//    heads of a GQA group share every K/V tile the block stages.
//  * Key tiles wholly outside the rows' causal/window range are never read
//    (the TPU kernel computes them and lets alpha wash them out); the ragged
//    edge t >= Sk is masked here, so the wrapper pads nothing.
//  * Backward: a block per (b, kv head, key tile) accumulates dK and dV over
//    every query row of the G heads that sees the tile, recomputing P from Q,
//    K and the saved logsumexp.  bf16 at one or two column chunks and at
//    MLA's (3, 2) (the fused kernels, below): a first kernel sums D per row,
//    then persistent key-tile blocks also add each key tile's partial of dQ
//    into an fp32 accumulator, tile by tile in increasing key order behind a
//    counter.  At three or four equal chunks a block per (b, kv head, row
//    tile) accumulates dQ over key tiles.  No unordered float atomics: the
//    gradients are the same from run to run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int kp, int qpos, int Sk, int causal, int window) {
  return kp < Sk && (!causal || kp <= qpos) && (window <= 0 || kp > qpos - window);
}

// global offset of row r (= s*G + g) of kv head kvh in a [B,S,Hq,dh] tensor
__device__ __forceinline__ size_t row_offset(int b, int r, int G, int kvh, int S, int Hq,
                                             int dh) {
  const int s = r / G, h = kvh * G + (r - s * G);
  return (((size_t)b * S + s) * Hq + h) * dh;
}

__host__ __device__ constexpr int pad16(int x) { return (x + 15) / 16 * 16; }

// ---------------------------------------------------------------------------
// bf16 on Hopper: wgmma fed by TMA (variants wgmma and wgmma_rows)
//
// Each kernel is warp-specialised: warpgroup 0 is the producer (one thread
// starts TMA loads into a ring of stages, guarded by full/empty mbarriers),
// the other warpgroups are consumers that own 64 rows (or keys) each and run
// every tile product with wgmma.  Tiles are 128-byte rows (64 head columns)
// under the 128-byte swizzle; the padded head dim takes DC such column
// chunks, 1 to 4 (dh 8..64, 72..128, 136..192, 200..256).  TMA's zero fill
// pads dh to the chunk, the ragged Sq/Sk edges and rows past Sq; masks
// remain only on the scores.
//
// What grows with DC, and what each kernel does about it (each launcher
// holds its layout under the 227 KB a block may have with a static_assert;
// every layout below is 192 KB of tiles at DC 3 and 4, plus the dK/dV
// kernel's 32 KB hand-off):
//  * Forward: the O accumulator, DC x 32 fp32 registers a thread.  At DC
//    <= 2 a key tile is 128 keys (S two 64-key halves, 64 registers); at DC
//    3 and 4 it is 64 keys, so S takes 32 registers beside O's 128 and the
//    two-stage K/V ring fits (at 128 keys DC 4 would need 320 KB).  P.V is
//    DC wgmmas of N = 64 per 16 keys, one per column chunk of V.
//  * dQ: Q and dO stay resident for the block's rows beside a two-stage K/V
//    ring of 64 keys.  Two consumer warpgroups (128 rows) fit up to DC 3;
//    at DC 4 the block has one (64 rows; 192 KB rather than 256) and no
//    register rebalancing, since 256 threads may each hold 255.
//  * dK/dV (at DC 3 and 4; the fused kernels below take DC 1 and 2): a
//    thread would hold dK and dV for its keys, 2 x DC x 32 registers: 256
//    at DC 4, more than a thread has.  So (kv_split) the two consumer
//    warpgroups own the same 64 keys and split the head
//    columns: warpgroup w accumulates dK and dV
//    for the chunks [w * ceil(DC/2), (w+1) * ceil(DC/2)), 128 registers at
//    most.  Each needs all of P^T and dS^T, so warpgroup 0 computes S^T
//    (and P^T) over the whole head dim and warpgroup 1 dP^T, and they hand
//    the two 64 x 64 fp32 products over through 32 KB of shared memory
//    between two named barriers; both then form the same dS^T.  That is the
//    four products a tile and no more, where the alternatives cost more:
//    each warpgroup computing S^T and dP^T for itself does six, and dV and
//    dK in two passes re-read every Q/dO tile and recompute S^T.  The Q/dO
//    ring is three stages at DC 3 and two at DC 4, which with the hand-off
//    fills the 227 KB exactly.
// Values narrower than keys.  V, O and dO take DVC = ceil(dv / 64) column
// chunks (dv padded to 16) beside the keys' DC: P.V, dP = dO.V^T (and D =
// rowsum(P * dP) through it), dP^T and dV += P^T.dO run over the DVC chunks
// only, TMA's zero fill pads dv to its last chunk, and the stores write dv
// columns.  The kernels are instantiated at DVC == DC (DC 1 to 4) and at (3,
// 2), MLA's keys of 192 and values of 128, which has kernels of its own:
//  * Forward (flash_fwd_pp_wgmma_kernel, fwd_pingpong): O takes 2 x 32
//    registers, so the key tile is 128 keys (S 64 registers beside O's 64),
//    and its products use the N = 128 shapes (S = Q.K^T as 12 m64n128k16,
//    P.V over both value chunks as 8): an N = 64 product reads its A operand
//    from shared memory at the 128 bytes a clock the SM has, which the
//    tensor cores then wait on.  The two consumer warpgroups take turns on
//    the tensor cores (named barriers, a ping-pong): each issues its tile's S
//    beside the last tile's P.V, hands the turn over and runs its softmax
//    while the other's products run, so the exponentials and the rescale of
//    O overlap the products instead of following them (on one warpgroup's
//    own, keeping a product in flight across its softmax serialized its
//    wgmmas under ptxas).  K and V come through rings of their own (a K stage
//    is free once S is retired).  The grid is the row tiles of one kv head
//    next to each other, so that the blocks on the card at once read the
//    same K/V tiles from the L2: with one block a head at a time (MLA's 128
//    heads) every block streamed its own K/V from memory, which bounded the
//    earlier kernel.  Q 48 KB, the K ring 2 x 48 KB, the V ring 2 x 32 KB:
//    208 KB.
//  * Backward: the fused kernels (below), their dK/dV split between the
//    warpgroups by accumulator (kv_own), since dK (3 chunks) and dV (2) do
//    not fit one warpgroup's registers beside the products.
// Every sum keeps a fixed order: dK/dV over row tiles, dQ over key tiles,
// with no float atomics, so the backward gives equal bits from run to run.
//
// Q (and dO) come through one of two tensor maps, which the kernels' kRows
// flag picks; K and V always through a map (dh, Hkv, Sk, B).
//  * wgmma (kRows false): a 4-D map (dh, Hq, S, B) over the caller's tensor
//    with boxes of (64, G, 64/G, 1).  When G divides 64 the box is the 64
//    rows r = s*G + g of one kv head from r = 64i, loaded at (64c, kvh*G,
//    r/G, b), and a box past S reads zeros instead of the next batch's rows.
//    No copy.
//  * wgmma_rows (kRows true): for any other G a box of whole positions
//    would leave masked rows in every tile, and past G 64 could not hold
//    one position.  So flash_rows_gather_kernel first copies q (and dout)
//    into the wrapper's scratch as [B*Hkv][S*G][dh], row r = s*G + g of kv
//    head kvh at row r of slab b*Hkv + kvh, and a map (dh, S*G, B*Hkv, 1)
//    with boxes of (64, 64, 1, 1) loads the 64 rows from any r at (64c, r,
//    b*Hkv + kvh, 0); rows past S*G read zeros.  Everything else already
//    takes a row r as position r/G of head kvh*G + r%G (the masks, the
//    walks, lse and delta, the output rows), which holds for every G: past
//    G 64 a 64-row tile is part of one position's heads (pos_lo == pos_hi).
//  The flag is a template parameter, not a kernel argument: the map and the
//  gather are picked at compile time.
// The precision of the backward.  A key's dK and dV sum over every row that
// sees it, G times the positions: 5,040 rows at G 72, S 70; 32,768 at G 8,
// S 4,096.  With P^T and dS^T rounded once to bf16 as the A operands of dV
// and dK, and D = rowsum(dO * O) taken from the bf16 output, the rounding
// adds up past the 2e-2 tolerance against the fp32 oracle at such groups,
// and wherever the scores spread by a few units (the softmax picks a few
// keys): with queries at 4 times the keys' scale dK misses it by up to 4.7
// times at S 2,048 and at 4,096 alike, dQ and dV by 1.0 to 1.2 (a
// plain-torch emulation of both arithmetics: tests/test_torch_flash_rows.py
// and tests/test_torch_flash_spread.py).  So the dQ kernel first walks its
// key tiles once to sum D = rowsum(P * dP) in fp32 (two more products a
// tile), and the dK/dV kernel passes P^T and dS^T as hi + lo, hi = bf16(x)
// and lo = bf16(x - hi), two wgmmas each: six products a tile rather than
// four.  The fused kernels keep both (D in a kernel of its own).
//
// The softmax and the gradients' elementwise work run on the wgmma
// accumulators in registers: a thread holds two rows (lane/4 and lane/4 + 8
// of its warp's 16) and reduces over the quad of lanes that share them.  An
// accumulator converts to a bf16 A operand in registers without moving
// (wgmma_rs_64x64's layout), so P (and dS) feed the next product directly.
// ---------------------------------------------------------------------------
constexpr int kWgRows = 64;                  // rows (or keys) of one consumer warpgroup
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kWsThreads = 128 * (1 + kConsumers);
constexpr int kBlockRows = kWgRows * kConsumers;
constexpr int kStages = 2;                   // depth of the forward's and dQ's TMA ring
constexpr int kDqKeys = 64;                  // keys per dQ tile
constexpr int kChunk = 64;                   // head columns per 128-byte row
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLn2 = 0.6931471805599453f;

constexpr size_t kSmemPerBlock = 232448;    // dynamic shared memory a block may have
// The plan at DC column chunks of the keys and DVC of the values (see
// above).  The forward's key tile follows the O accumulator, DVC x 32.
__host__ __device__ constexpr int fwd_keys(int DVC) { return DVC <= 2 ? 128 : 64; }
// the forward whose two consumer warpgroups take turns on the tensor cores,
// each issuing a tile's S beside the last tile's P.V (MLA's (3, 2))
__host__ __device__ constexpr bool fwd_pingpong(int DC, int DVC) { return DC == 3 && DVC == 2; }
constexpr int kPpKeys = 128;    // keys of its tile
constexpr int kPpBarrier = 1;   // its named barriers: warpgroup w's turn is kPpBarrier + w
__host__ __device__ constexpr int dq_consumers(int DC) { return DC <= 3 ? 2 : 1; }
// the (DC, DVC) pairs the wgmma kernels are instantiated at
__host__ __device__ constexpr bool wgmma_pair(int DC, int DVC) {
  return DVC == DC || (DC == 3 && DVC == 2);
}
// dK/dV at values narrower than keys: over 64 shared keys, warpgroup 0 owns
// dK's first DVC column chunks, warpgroup 1 the rest of dK and all of dV
__host__ __device__ constexpr bool kv_own(int DC, int DVC) { return DVC < DC; }
// dK/dV at equal chunk counts: whether the two warpgroups split the head
// columns of 64 shared keys: from DC 2, where the layout of two 64-key
// halves with the hi + lo operands spills under ptxas (48 bytes)
__host__ __device__ constexpr bool kv_split(int DC) { return DC >= 2; }
// keys of a dK/dV block: 64 where the warpgroups share them and hand P^T
// and dP^T over
__host__ __device__ constexpr int kv_keys(int DC, int DVC) {
  return kv_own(DC, DVC) || kv_split(DC) ? 64 : 128;
}
__host__ __device__ constexpr int kv_stages(int DC) { return DC <= 3 ? 3 : 2; }
// dK/dV column chunks a consumer warpgroup accumulates
__host__ __device__ constexpr int kv_chunks(int DC) {
  return kv_split(DC) ? (DC + 1) / 2 : DC;
}

// bytes of one [rows][64] bf16 tile
__host__ __device__ constexpr uint32_t tile_bytes(int rows) { return (uint32_t)rows * kChunk * 2; }

// Scores of a tile whose every (row, key) pair is visible skip the masks.
__device__ __forceinline__ bool tile_needs_mask(int key0, int nkeys, int pos_lo, int pos_hi,
                                                int Sk, int causal, int window) {
  return key0 + nkeys > Sk || (causal && key0 + nkeys - 1 > pos_lo) ||
         (window > 0 && key0 <= pos_hi - window);
}

// No (row, key) pair of the tile is visible.
__device__ __forceinline__ bool tile_invisible(int key0, int nkeys, int pos_lo, int pos_hi,
                                               int Sk, int causal, int window) {
  const int key_last = min(Sk, key0 + nkeys) - 1;
  return key0 >= Sk || (causal && key0 > pos_hi) || (window > 0 && key_last <= pos_lo - window);
}

// Starts the TMA load of 64 rows from row r of kv head kvh (batch b), head
// columns from c0, of q or dout: at kRows from the gathered copy, any r; else
// from the caller's tensor at whole positions (r a multiple of 64, G
// dividing 64).  See above.
template <bool kRows>
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int c0, int r, int b, int kvh, int G, int Hkv) {
  if constexpr (kRows)
    tma_load_4d(dst, map, bar, c0, r, b * Hkv + kvh, 0);
  else
    tma_load_4d(dst, map, bar, c0, kvh * G, r / G, b);
}

// s[0..7] as two bf16 A fragments of one k-step (to_a_frag's layout), hi =
// bf16(s) and lo = bf16(s - hi): a product with hi and one with lo keep some
// 16 bits of each value where hi alone keeps 8.
__device__ __forceinline__ void to_a_frags_hilo(const float* s, uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
  to_a_frag(s, hi);
#pragma unroll
  for (int i = 0; i < 4; ++i)  // hi[i] holds bf16(s[2i]) in its low half
    lo[i] = pack_bf16(s[2 * i] - __uint_as_float(hi[i] << 16),
                      s[2 * i + 1] - __uint_as_float(hi[i] & 0xffff0000u));
}

template <int DC>
struct FwdWgSmem {
  alignas(1024) bf16 q[kConsumers][DC][kWgRows * kChunk];
  alignas(1024) bf16 k[kStages][DC][fwd_keys(DC) * kChunk];
  alignas(1024) bf16 v[kStages][DC][fwd_keys(DC) * kChunk];
  uint64_t q_full, full[kStages], empty[kStages];
};

// forward.  grid: (B*Hkv, ceil(Sq*G / 128)), heaviest row tiles first
template <int DC, bool kRows>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int dv,
                       int causal, int window, float scale) {
  constexpr int kFwdKeys = fwd_keys(DC);
  constexpr int NH = kFwdKeys / 64;  // 64-key blocks of a key tile
  extern __shared__ char smem_raw[];
  FwdWgSmem<DC>& sm = smem_layout<FwdWgSmem<DC>>(smem_raw);
  const int G = Hq / Hkv;
  const int Rtot = Sq * G;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = tile * kBlockRows;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int p_lo = r0 / G, p_hi = (min(Rtot, r0 + kBlockRows) - 1) / G;
  const int key_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int key_hi = causal ? min(Sk - 1, p_hi) : Sk - 1;
  const int t_first = key_lo / kFwdKeys;
  const int n_tiles = key_hi >= key_lo ? key_hi / kFwdKeys - t_first + 1 : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&sm.q_full, kConsumers * DC * tile_bytes(kWgRows));
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < DC; ++c)
          tma_load_rows<kRows>(sm.q[w][c], &q_map, &sm.q_full, kChunk * c, r0 + w * kWgRows,
                               b, kvh, G, Hkv);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&sm.empty[s], (i / kStages - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[s], 2 * DC * tile_bytes(kFwdKeys));
        const int t0 = (t_first + i) * kFwdKeys;
        for (int c = 0; c < DC; ++c) {
          tma_load_4d(sm.k[s][c], &k_map, &sm.full[s], kChunk * c, kvh, t0, b);
          tma_load_4d(sm.v[s][c], &v_map, &sm.full[s], kChunk * c, kvh, t0, b);
        }
      }
    }
  } else {
    warpgroup_reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int rw0 = r0 + cw * kWgRows;  // this warpgroup's first row
    const int r_lo = rw0 + 16 * warp + lane / 4;  // this thread's rows: r_lo, r_lo + 8
    const int pos[2] = {r_lo / G, (r_lo + 8) / G};
    const int wp_lo = rw0 / G, wp_hi = (min(Rtot, rw0 + kWgRows) - 1) / G;
    const int col = 2 * (lane % 4);
    const float sc = scale * kLog2e;  // exp(x * scale) = exp2(x * sc)

    float oacc[DC][32];
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[c][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    mbar_wait(&sm.q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int t0 = (t_first + i) * kFwdKeys;
      mbar_wait(&sm.full[s], (i / kStages) & 1);
      if (rw0 < Rtot && !tile_invisible(t0, kFwdKeys, wp_lo, wp_hi, Sk, causal, window)) {
        // S = Q . K^T: 64 rows x kFwdKeys keys, as NH blocks of 64 keys
        float sacc[NH][32];
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int kc = 0; kc < DC * 4; ++kc) {
            const uint64_t da = wgmma_desc(sm.q[cw][kc / 4]) + 2 * (kc % 4);
            const uint64_t db = wgmma_desc(sm.k[s][kc / 4] + h * 64 * kChunk) + 2 * (kc % 4);
            wgmma_ss_64x64(sacc[h], da, db, kc > 0);
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < NH; ++h) fence_regs(sacc[h]);

        if (tile_needs_mask(t0, kFwdKeys, wp_lo, wp_hi, Sk, causal, window)) {
#pragma unroll
          for (int h = 0; h < NH; ++h)
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int key = t0 + 64 * h + 8 * (e / 4) + col + (e & 1);
              if (!visible(key, pos[(e >> 1) & 1], Sk, causal, window)) sacc[h][e] = -INFINITY;
            }
        }
        // online softmax over the quad's rows
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sacc[h][e]);
        float m_use[2], alpha[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float m_new = fmaxf(m_run[x], quad_max(mx[x]) * sc);
          // rows that have seen no visible key keep m = -inf, l = 0, O = 0
          m_use[x] = m_new == -INFINITY ? 0.f : m_new;
          alpha[x] = fast_exp2(m_run[x] - m_use[x]);
          m_run[x] = m_new;
          l_run[x] *= alpha[x];
        }
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int x = (e >> 1) & 1;
            const float p = fast_exp2(sacc[h][e] * sc - m_use[x]);
            l_run[x] += p;
            sacc[h][e] = p;
          }
#pragma unroll
        for (int c = 0; c < DC; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) oacc[c][e] *= alpha[(e >> 1) & 1];
        // P in bf16 (the cast of _flash_kernel:76) as the A operand of O += P . V
        uint32_t pa[kFwdKeys / 16][4];
#pragma unroll
        for (int kk = 0; kk < kFwdKeys / 16; ++kk) to_a_frag(&sacc[kk / 4][8 * (kk % 4)], pa[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kFwdKeys / 16; ++kk)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            wgmma_rs_64x64(oacc[c], pa[kk], wgmma_desc(sm.v[s][c]) + kk * 16 * 128 / 16);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < DC; ++c) fence_regs(oacc[c]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float l = quad_sum(l_run[x]);
      const int r = r_lo + 8 * x;
      if (r >= Rtot) continue;  // rows past Sq write nothing
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const size_t off = row_offset(b, r, G, kvh, Sq, Hq, dv);
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cc = kChunk * c + 8 * j + col;
          if (cc < dv)
            *reinterpret_cast<__nv_bfloat162*>(o + off + cc) = __floats2bfloat162_rn(
                oacc[c][4 * j + 2 * x] * inv, oacc[c][4 * j + 2 * x + 1] * inv);
        }
      if (lane % 4 == 0) {
        const int sp = r / G, h = kvh * G + (r - sp * G);
        lse[((size_t)b * Hq + h) * Sq + sp] = l > 0.f ? (m_run[x] + log2f(l)) * kLn2 : -INFINITY;
      }
    }
  }
}

// The forward at values of two chunks beside keys of three (MLA's (3, 2);
// fwd_pingpong).  K and V come through rings of their own, so that a K
// stage is free once S is retired and a V stage once P.V is.
template <int DC, int DVC>
struct FwdPpSmem {
  alignas(1024) bf16 q[kConsumers][DC][kWgRows * kChunk];
  alignas(1024) bf16 k[kStages][DC][kPpKeys * kChunk];
  alignas(1024) bf16 v[kStages][DVC][kPpKeys * kChunk];
  uint64_t q_full, k_full[kStages], k_empty[kStages], v_full[kStages], v_empty[kStages];
};

// forward, the (3, 2) schedule (see above).  grid: (ceil(Sq*G / 128),
// B*Hkv), the row tiles of one kv head next to each other, heaviest first, so
// that the blocks on the card at once read the same K and V tiles from the L2
template <int DC, int DVC, bool kRows>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_pp_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                          float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int dv,
                          int causal, int window, float scale) {
  static_assert(fwd_pingpong(DC, DVC), "the ping-pong forward takes keys of 3 chunks, values of 2");
  constexpr int kKeys = kPpKeys, kKs = kPpKeys / 16;  // keys of a tile, k-steps of P.V
  extern __shared__ char smem_raw[];
  FwdPpSmem<DC, DVC>& sm = smem_layout<FwdPpSmem<DC, DVC>>(smem_raw);
  const int G = Hq / Hkv;
  const int Rtot = Sq * G;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int r0 = tile * kBlockRows;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int p_lo = r0 / G, p_hi = (min(Rtot, r0 + kBlockRows) - 1) / G;
  const int key_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int key_hi = causal ? min(Sk - 1, p_hi) : Sk - 1;
  const int t_first = key_lo / kKeys;
  const int n_tiles = key_hi >= key_lo ? key_hi / kKeys - t_first + 1 : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumers * 4);  // one arrival per consumer warp
      mbar_init(&sm.v_empty[s], kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&sm.q_full, kConsumers * DC * tile_bytes(kWgRows));
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < DC; ++c)
          tma_load_rows<kRows>(sm.q[w][c], &q_map, &sm.q_full, kChunk * c, r0 + w * kWgRows,
                               b, kvh, G, Hkv);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, ph = (i / kStages - 1) & 1;
        const int t0 = (t_first + i) * kKeys;
        if (i >= kStages) mbar_wait(&sm.k_empty[s], ph);
        mbar_arrive_expect_tx(&sm.k_full[s], DC * tile_bytes(kKeys));
        for (int c = 0; c < DC; ++c)
          tma_load_4d(sm.k[s][c], &k_map, &sm.k_full[s], kChunk * c, kvh, t0, b);
        if (i >= kStages) mbar_wait(&sm.v_empty[s], ph);
        mbar_arrive_expect_tx(&sm.v_full[s], DVC * tile_bytes(kKeys));
        for (int c = 0; c < DVC; ++c)
          tma_load_4d(sm.v[s][c], &v_map, &sm.v_full[s], kChunk * c, kvh, t0, b);
      }
    }
  } else {
    warpgroup_reg_alloc<kConsumerRegs>();
    // warp-uniform as ptxas sees it, so that the wgmmas in flight across
    // the branches below are not serialized
    const int cw = __shfl_sync(0xffffffffu, wg, 0) - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int rw0 = r0 + cw * kWgRows;  // this warpgroup's first row
    const int r_lo = rw0 + 16 * warp + lane / 4;  // this thread's rows: r_lo, r_lo + 8
    const int pos[2] = {r_lo / G, (r_lo + 8) / G};
    const int wp_lo = rw0 / G, wp_hi = (min(Rtot, rw0 + kWgRows) - 1) / G;
    const int col = 2 * (lane % 4);
    const float sc = scale * kLog2e;  // exp(x * scale) = exp2(x * sc)
    constexpr uint32_t kVBlock = kPpKeys * kChunk * 2;  // bytes from one V chunk to the next

    float oacc[64];  // O: 64 rows x 128 value columns (DVC chunks)
#pragma unroll
    for (int e = 0; e < 64; ++e) oacc[e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    uint32_t pa[kKs][4];  // P of the tile before, bf16, the A operand of its P.V
    mbar_wait(&sm.q_full, 0);

    // Every tile's S is issued, also where this warpgroup's rows see none
    // of its keys (its mask then takes them all): no wgmma stands under a
    // branch, and such tiles are rare (rows past Sq, a window's edge).
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages, sp = (i + kStages - 1) % kStages;  // this tile's, the last's
      const int t0 = (t_first + i) * kKeys;
      mbar_wait(&sm.k_full[s], (i / kStages) & 1);
      if (i > 0) mbar_wait(&sm.v_full[sp], ((i - 1) / kStages) & 1);
      // this warpgroup's turn on the tensor cores: S of this tile and P.V
      // of the last; the other warpgroup's products then run under this
      // one's softmax
      if (cw == 1 || i > 0) named_barrier(kPpBarrier + cw, 2 * 128);
      float sacc[64];  // S = Q . K^T: 64 rows x 128 keys
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DC * 4; ++kc)
        wgmma_ss_64x128(sacc, wgmma_desc(sm.q[cw][kc / 4]) + 2 * (kc % 4),
                        wgmma_desc(sm.k[s][kc / 4]) + 2 * (kc % 4), kc > 0);
      if (i > 0) {
#pragma unroll
        for (int kk = 0; kk < kKs; ++kk)
          wgmma_rs_64x128(oacc, pa[kk], wgmma_desc_mn(sm.v[sp][0], kVBlock) + kk * 16 * 128 / 16);
      }
      wgmma_commit();
      if (cw == 0 || i + 1 < n_tiles) named_barrier_arrive(kPpBarrier + 1 - cw, 2 * 128);
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(oacc);
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) fence_regs(pa[kk]);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&sm.k_empty[s]);
        if (i > 0) mbar_arrive(&sm.v_empty[sp]);
      }

      if (tile_needs_mask(t0, kKeys, wp_lo, wp_hi, Sk, causal, window) ||
          tile_invisible(t0, kKeys, wp_lo, wp_hi, Sk, causal, window)) {
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const int key = t0 + 8 * (e / 4) + col + (e & 1);
          if (!visible(key, pos[(e >> 1) & 1], Sk, causal, window)) sacc[e] = -INFINITY;
        }
      }
      // online softmax over the quad's rows: O, which holds the last tile's
      // P.V now, is rescaled to this tile's maximum
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 64; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sacc[e]);
      float m_use[2], alpha[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float m_new = fmaxf(m_run[x], quad_max(mx[x]) * sc);
        // rows that have seen no visible key keep m = -inf, l = 0, O = 0
        m_use[x] = m_new == -INFINITY ? 0.f : m_new;
        alpha[x] = fast_exp2(m_run[x] - m_use[x]);
        m_run[x] = m_new;
        l_run[x] *= alpha[x];
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int x = (e >> 1) & 1;
        const float p = fast_exp2(sacc[e] * sc - m_use[x]);
        l_run[x] += p;
        sacc[e] = p;
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) oacc[e] *= alpha[(e >> 1) & 1];
      // P in bf16 (the cast of _flash_kernel:76), the A operand of its P.V
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) to_a_frag(&sacc[8 * kk], pa[kk]);
    }
    if (n_tiles > 0) {  // the last tile's P.V
      const int sp = (n_tiles - 1) % kStages;
      mbar_wait(&sm.v_full[sp], ((n_tiles - 1) / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk)
        wgmma_rs_64x128(oacc, pa[kk], wgmma_desc_mn(sm.v[sp][0], kVBlock) + kk * 16 * 128 / 16);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.v_empty[sp]);
    }

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float l = quad_sum(l_run[x]);
      const int r = r_lo + 8 * x;
      if (r >= Rtot) continue;  // rows past Sq write nothing
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const size_t off = row_offset(b, r, G, kvh, Sq, Hq, dv);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int cc = 8 * j + col;
        if (cc < dv)
          *reinterpret_cast<__nv_bfloat162*>(o + off + cc) =
              __floats2bfloat162_rn(oacc[4 * j + 2 * x] * inv, oacc[4 * j + 2 * x + 1] * inv);
      }
      if (lane % 4 == 0) {
        const int sp = r / G, h = kvh * G + (r - sp * G);
        lse[((size_t)b * Hq + h) * Sq + sp] = l > 0.f ? (m_run[x] + log2f(l)) * kLn2 : -INFINITY;
      }
    }
  }
}

template <int DC>
struct DqWgSmem {
  alignas(1024) bf16 q[dq_consumers(DC)][DC][kWgRows * kChunk];
  alignas(1024) bf16 dout[dq_consumers(DC)][DC][kWgRows * kChunk];
  alignas(1024) bf16 k[kStages][DC][kDqKeys * kChunk];
  alignas(1024) bf16 v[kStages][DC][kDqKeys * kChunk];
  uint64_t q_full, full[kStages], empty[kStages];
};

// backward, dQ; also writes D = rowsum(P * dP), summed in a first walk over
// the key tiles, into delta [B,Hq,Sq] for the dK/dV kernel.  grid: (B*Hkv,
// ceil(Sq*G / (64 * dq_consumers(DC)))), heaviest first
template <int DC, bool kRows>
__global__ void __launch_bounds__(128 * (1 + dq_consumers(DC)), 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse, float* __restrict__ delta,
                          bf16* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int dh,
                          int dv, int causal, int window, float scale) {
  constexpr int NC = dq_consumers(DC);
  extern __shared__ char smem_raw[];
  DqWgSmem<DC>& sm = smem_layout<DqWgSmem<DC>>(smem_raw);
  const int G = Hq / Hkv;
  const int Rtot = Sq * G;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = tile * NC * kWgRows;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int p_lo = r0 / G, p_hi = (min(Rtot, r0 + NC * kWgRows) - 1) / G;
  const int key_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int key_hi = causal ? min(Sk - 1, p_hi) : Sk - 1;
  const int t_first = key_lo / kDqKeys;
  const int n_tiles = key_hi >= key_lo ? key_hi / kDqKeys - t_first + 1 : 0;
  constexpr int n_walks = 2;  // the ring carries the key tiles once per walk
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NC * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (NC == 2) warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&sm.q_full, NC * 2 * DC * tile_bytes(kWgRows));
      for (int w = 0; w < NC; ++w)
        for (int c = 0; c < DC; ++c) {
          const int rw = r0 + w * kWgRows;
          tma_load_rows<kRows>(sm.q[w][c], &q_map, &sm.q_full, kChunk * c, rw, b, kvh, G, Hkv);
          tma_load_rows<kRows>(sm.dout[w][c], &do_map, &sm.q_full, kChunk * c, rw, b, kvh, G,
                               Hkv);
        }
      for (int i = 0; i < n_walks * n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&sm.empty[s], (i / kStages - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[s], 2 * DC * tile_bytes(kDqKeys));
        const int t0 = (t_first + i % n_tiles) * kDqKeys;
        for (int c = 0; c < DC; ++c) {
          tma_load_4d(sm.k[s][c], &k_map, &sm.full[s], kChunk * c, kvh, t0, b);
          tma_load_4d(sm.v[s][c], &v_map, &sm.full[s], kChunk * c, kvh, t0, b);
        }
      }
    }
  } else {
    if constexpr (NC == 2) warpgroup_reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int rw0 = r0 + cw * kWgRows;
    const int r_lo = rw0 + 16 * warp + lane / 4;
    const int pos[2] = {r_lo / G, (r_lo + 8) / G};
    const int wp_lo = rw0 / G, wp_hi = (min(Rtot, rw0 + kWgRows) - 1) / G;
    const int col = 2 * (lane % 4);
    const float sc = scale * kLog2e;

    float D[2], L[2];  // D and lse * log2(e) of this thread's two rows
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r_lo + 8 * x;
      L[x] = 0.f;
      if (r < Rtot) {
        const int sp = r / G, h = kvh * G + (r - sp * G);
        L[x] = lse[((size_t)b * Hq + h) * Sq + sp] * kLog2e;
      }
    }
    // D = rowsum(P * dP) over the key tiles in order: the first walk
    float dsum[2] = {0.f, 0.f};
    mbar_wait(&sm.q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int t0 = (t_first + i) * kDqKeys;
      mbar_wait(&sm.full[s], (i / kStages) & 1);
      if (rw0 < Rtot && !tile_invisible(t0, kDqKeys, wp_lo, wp_hi, Sk, causal, window)) {
        float sacc[32], pacc[32];  // S = Q . K^T and dP = dO . V^T
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < DC * 4; ++kc) {
          const int c = kc / 4, kb = 2 * (kc % 4);
          wgmma_ss_64x64(sacc, wgmma_desc(sm.q[cw][c]) + kb, wgmma_desc(sm.k[s][c]) + kb,
                         kc > 0);
        }
#pragma unroll
        for (int kc = 0; kc < DC * 4; ++kc) {
          const int c = kc / 4, kb = 2 * (kc % 4);
          wgmma_ss_64x64(pacc, wgmma_desc(sm.dout[cw][c]) + kb, wgmma_desc(sm.v[s][c]) + kb,
                         kc > 0);
        }
        wgmma_commit();
        const bool masked = tile_needs_mask(t0, kDqKeys, wp_lo, wp_hi, Sk, causal, window);
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(pacc);
        if (masked) {  // the masks' tests only where a pair may be invisible
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int x = (e >> 1) & 1;
            const int key = t0 + 8 * (e / 4) + col + (e & 1);
            dsum[x] += visible(key, pos[x], Sk, causal, window)
                           ? fast_exp2(sacc[e] * sc - L[x]) * pacc[e] : 0.f;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 32; ++e)
            dsum[(e >> 1) & 1] += fast_exp2(sacc[e] * sc - L[(e >> 1) & 1]) * pacc[e];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      D[x] = quad_sum(dsum[x]);
      const int r = r_lo + 8 * x;
      if (lane % 4 == 0 && r < Rtot) {
        const int sp = r / G, h = kvh * G + (r - sp * G);
        delta[((size_t)b * Hq + h) * Sq + sp] = D[x];
      }
    }

    float dqacc[DC][32];
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) dqacc[c][e] = 0.f;
    mbar_wait(&sm.q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int j = (n_walks - 1) * n_tiles + i;  // the ring's count
      const int s = j % kStages;
      const int t0 = (t_first + i) * kDqKeys;
      mbar_wait(&sm.full[s], (j / kStages) & 1);
      if (rw0 < Rtot && !tile_invisible(t0, kDqKeys, wp_lo, wp_hi, Sk, causal, window)) {
        // two commit groups, so that P is formed while dP is computed
        float sacc[32], pacc[32];  // S = Q . K^T and dP = dO . V^T
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < DC * 4; ++kc) {
          const int c = kc / 4, kb = 2 * (kc % 4);
          wgmma_ss_64x64(sacc, wgmma_desc(sm.q[cw][c]) + kb, wgmma_desc(sm.k[s][c]) + kb, kc > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kc = 0; kc < DC * 4; ++kc) {
          const int c = kc / 4, kb = 2 * (kc % 4);
          wgmma_ss_64x64(pacc, wgmma_desc(sm.dout[cw][c]) + kb, wgmma_desc(sm.v[s][c]) + kb,
                         kc > 0);
        }
        wgmma_commit();
        const bool masked = tile_needs_mask(t0, kDqKeys, wp_lo, wp_hi, Sk, causal, window);
        wgmma_wait<1>();  // S is done
        fence_regs(sacc);
        if (masked) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int x = (e >> 1) & 1;
            const int key = t0 + 8 * (e / 4) + col + (e & 1);
            sacc[e] = visible(key, pos[x], Sk, causal, window)
                          ? fast_exp2(sacc[e] * sc - L[x]) : 0.f;  // P
          }
        } else {
#pragma unroll
          for (int e = 0; e < 32; ++e) sacc[e] = fast_exp2(sacc[e] * sc - L[(e >> 1) & 1]);
        }
        wgmma_wait<0>();
        fence_regs(pacc);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          sacc[e] *= pacc[e] - D[(e >> 1) & 1];  // dS, rounded to bf16 below
        uint32_t da[kDqKeys / 16][4];
#pragma unroll
        for (int kk = 0; kk < kDqKeys / 16; ++kk) to_a_frag(&sacc[8 * kk], da[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDqKeys / 16; ++kk)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            wgmma_rs_64x64(dqacc[c], da[kk], wgmma_desc(sm.k[s][c]) + kk * 16 * 128 / 16);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < DC; ++c) fence_regs(dqacc[c]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r_lo + 8 * x;
      if (r >= Rtot) continue;
      const size_t off = row_offset(b, r, G, kvh, Sq, Hq, dh);
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cc = kChunk * c + 8 * j + col;
          if (cc < dh)
            *reinterpret_cast<__nv_bfloat162*>(dq + off + cc) = __floats2bfloat162_rn(
                dqacc[c][4 * j + 2 * x] * scale, dqacc[c][4 * j + 2 * x + 1] * scale);
        }
    }
  }
}

constexpr int kBwdRows = 64;  // rows per dK/dV tile

// The 64 x 64 fp32 products that the dK/dV kernel's two consumer warpgroups
// hand each other where they share 64 keys (P^T, then dP^T): 8 float4 a
// thread each, thread-major, so that a warp's accesses touch every bank once.
template <int N> struct Handoff { float4 v[N][128]; };
template <> struct Handoff<0> {};

template <int DC>
struct DkdvWgSmem {
  alignas(1024) bf16 k[DC][kv_keys(DC, DC) * kChunk];
  alignas(1024) bf16 v[DC][kv_keys(DC, DC) * kChunk];
  alignas(1024) bf16 q[kv_stages(DC)][DC][kBwdRows * kChunk];
  alignas(1024) bf16 dout[kv_stages(DC)][DC][kBwdRows * kChunk];
  float lse2[kv_stages(DC)][kBwdRows];   // lse * log2(e) of the tile's rows
  float delta[kv_stages(DC)][kBwdRows];  // D of the tile's rows
  uint64_t kv_full, full[kv_stages(DC)], empty[kv_stages(DC)];
  Handoff<kv_split(DC) ? 16 : 0> handoff;
};

// backward, dK and dV, after the dQ kernel has written delta.  Keys are the
// M dimension: S^T = K . Q^T and dP^T = V . dO^T, then dV += P^T . dO and
// dK += dS^T . Q with P^T and dS^T as register A operands.  grid: (B*Hkv,
// ceil(Sk / kv_keys(DC, DC))); the first key tiles, which see the
// most rows under causal, launch first.  It runs at DC 3 and 4 (the fused
// kernels take the other pairs), where the two consumer warpgroups split the
// head columns of the block's 64 keys: warpgroup w the column chunks from w
// * kv_chunks(DC).  P^T and dS^T enter dV and dK as hi + lo (see above).
template <int DC, bool kRows>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dvo, int Sq, int Sk,
                            int Hq, int Hkv, int dh, int dv, int causal, int window,
                            float scale) {
  constexpr int kKvKeys = kv_keys(DC, DC), kBwdStages = kv_stages(DC);
  constexpr int CH = kv_chunks(DC);
  static_assert(kv_split(DC), "the dK/dV kernel takes DC 3 and 4");
  extern __shared__ char smem_raw[];
  DkdvWgSmem<DC>& sm = smem_layout<DkdvWgSmem<DC>>(smem_raw);
  const int G = Hq / Hkv;
  const int Rtot = Sq * G;
  const int k0 = blockIdx.y * kKvKeys;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  // query positions that can see a key of this block
  const int k_last = min(Sk, k0 + kKvKeys) - 1;
  const int p_min = causal ? k0 : 0;
  const int p_max = window > 0 ? min(Sq - 1, k_last + window - 1) : Sq - 1;
  const int row_first = (min(p_min, Sq) * G / kBwdRows) * kBwdRows;
  const int row_end = min(Rtot, (p_max + 1) * G);
  const int n_tiles = row_end > row_first ? (row_end - row_first + kBwdRows - 1) / kBwdRows : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      // the TMA's expect_tx, then every producer lane once its lse and D are written
      mbar_init(&sm.full[s], 1 + 32);
      mbar_init(&sm.empty[s], kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    warpgroup_reg_dealloc<kProducerRegs>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 32) {
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.kv_full, 2 * DC * tile_bytes(kKvKeys));
        for (int c = 0; c < DC; ++c) {
          tma_load_4d(sm.k[c], &k_map, &sm.kv_full, kChunk * c, kvh, k0, b);
          tma_load_4d(sm.v[c], &v_map, &sm.kv_full, kChunk * c, kvh, k0, b);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kBwdStages;
        const int rt0 = row_first + i * kBwdRows;
        if (i >= kBwdStages) mbar_wait(&sm.empty[s], (i / kBwdStages - 1) & 1);
        if (lane == 0) {  // the tiles first, so their latency overlaps the loads below
          mbar_arrive_expect_tx(&sm.full[s], 2 * DC * tile_bytes(kBwdRows));
          for (int c = 0; c < DC; ++c) {
            tma_load_rows<kRows>(sm.q[s][c], &q_map, &sm.full[s], kChunk * c, rt0, b, kvh, G,
                                 Hkv);
            tma_load_rows<kRows>(sm.dout[s][c], &do_map, &sm.full[s], kChunk * c, rt0, b, kvh,
                                 G, Hkv);
          }
        }
        for (int x = lane; x < kBwdRows; x += 32) {
          const int r = rt0 + x;
          float l2 = 0.f, d = 0.f;
          if (r < Rtot) {
            const int sp = r / G, h = kvh * G + (r - sp * G);
            const size_t idx = ((size_t)b * Hq + h) * Sq + sp;
            l2 = lse[idx] * kLog2e;
            d = delta[idx];
          }
          sm.lse2[s][x] = l2;
          sm.delta[s][x] = d;
        }
        mbar_arrive(&sm.full[s]);
      }
    }
  } else {
    warpgroup_reg_alloc<kConsumerRegs>();
    // warp-uniform as ptxas sees it, so that the wgmmas under branches on it
    // are not serialized
    const int cw = __shfl_sync(0xffffffffu, wg, 0) - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int kw0 = k0;  // the warpgroups' first key
    const int key_lo = kw0 + 16 * warp + lane / 4;  // this thread's keys: key_lo, key_lo + 8
    const int col = 2 * (lane % 4);
    const float sc = scale * kLog2e;
    const int c0 = cw * CH;  // dK/dV accumulator j holds column chunk c0 + j

    float dkacc[CH][32], dvacc[CH][32];
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) dkacc[j][e] = dvacc[j][e] = 0.f;
    mbar_wait(&sm.kv_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kBwdStages;
      const int rt0 = row_first + i * kBwdRows;
      mbar_wait(&sm.full[s], (i / kBwdStages) & 1);
      const int tp_lo = rt0 / G, tp_hi = (min(Rtot, rt0 + kBwdRows) - 1) / G;
      // the tile's rows against this warpgroup's keys, with rows and keys
      // swapped in the tests of tile_invisible and tile_needs_mask
      const int kw_last = min(Sk, kw0 + kWgRows) - 1;
      const bool skip = kw0 >= Sk || (causal && tp_hi < kw0) ||
                        (window > 0 && kw_last <= tp_lo - window);
      if (!skip) {
        // warpgroup 0 forms P^T from S^T = K . Q^T, warpgroup 1 forms
        // dP^T = V . dO^T, each over the whole head dim; they hand the
        // products over, so both hold the same P^T and dP^T and form the
        // same dS^T, and each adds its own column chunks to dV and dK
        const int tid = threadIdx.x % 128;
        const bf16* a_tile = cw == 0 ? sm.k[0] : sm.v[0];
        const bf16* b_tile = cw == 0 ? sm.q[s][0] : sm.dout[s][0];
        float mine[32], other[32];
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < DC * 4; ++kc) {
          const int c = kc / 4, kb = 2 * (kc % 4);
          wgmma_ss_64x64(mine, wgmma_desc(a_tile + c * kKvKeys * kChunk) + kb,
                         wgmma_desc(b_tile + c * kBwdRows * kChunk) + kb, kc > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(mine);
        if (cw == 0) {
          const bool masked = rt0 + kBwdRows > Rtot || kw0 + kWgRows > Sk ||
                              (causal && tp_lo < kw0 + kWgRows - 1) ||
                              (window > 0 && tp_hi - window + 1 > kw0);
          if (masked) {  // the masks' tests (a division by G a row) only here
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int rl = 8 * (e / 4) + col + (e & 1);  // the row, within the tile
              const int r = rt0 + rl;
              const int key = key_lo + 8 * ((e >> 1) & 1);
              const bool ok = r < Rtot && visible(key, r / G, Sk, causal, window);
              mine[e] = ok ? fast_exp2(mine[e] * sc - sm.lse2[s][rl]) : 0.f;  // P^T
            }
          } else {
#pragma unroll
            for (int e = 0; e < 32; ++e)
              mine[e] = fast_exp2(mine[e] * sc - sm.lse2[s][8 * (e / 4) + col + (e & 1)]);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sm.handoff.v[cw * 8 + j][tid] =
              make_float4(mine[4 * j], mine[4 * j + 1], mine[4 * j + 2], mine[4 * j + 3]);
        named_barrier(1, 2 * 128);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 t = sm.handoff.v[(1 - cw) * 8 + j][tid];
          other[4 * j] = t.x;
          other[4 * j + 1] = t.y;
          other[4 * j + 2] = t.z;
          other[4 * j + 3] = t.w;
        }
        named_barrier(1, 2 * 128);  // the hand-off is free for the next tile
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int rl = 8 * (e / 4) + col + (e & 1);
          const float p = cw == 0 ? mine[e] : other[e];
          const float dp = cw == 0 ? other[e] : mine[e];
          mine[e] = p;                              // P^T
          other[e] = p * (dp - sm.delta[s][rl]);    // dS^T, rounded to bf16 below
        }
        uint32_t pa[kBwdRows / 16][4], dsa[kBwdRows / 16][4];  // hi
        uint32_t pl[kBwdRows / 16][4], dsl[kBwdRows / 16][4];  // lo
#pragma unroll
        for (int kk = 0; kk < kBwdRows / 16; ++kk) {
          to_a_frags_hilo(&mine[8 * kk], pa[kk], pl[kk]);
          to_a_frags_hilo(&other[8 * kk], dsa[kk], dsl[kk]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBwdRows / 16; ++kk)
#pragma unroll
          for (int j = 0; j < CH; ++j)
            if (c0 + j < DC) {
              const uint64_t bo = wgmma_desc(sm.dout[s][c0 + j]) + kk * 16 * 128 / 16;
              const uint64_t bq = wgmma_desc(sm.q[s][c0 + j]) + kk * 16 * 128 / 16;
              wgmma_rs_64x64(dvacc[j], pa[kk], bo);
              wgmma_rs_64x64(dvacc[j], pl[kk], bo);
              wgmma_rs_64x64(dkacc[j], dsa[kk], bq);
              wgmma_rs_64x64(dkacc[j], dsl[kk], bq);
            }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int kk = 0; kk < kBwdRows / 16; ++kk) {
          fence_regs(pa[kk]);
          fence_regs(dsa[kk]);
          fence_regs(pl[kk]);
          fence_regs(dsl[kk]);
        }
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          fence_regs(dkacc[j]);
          fence_regs(dvacc[j]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int key = key_lo + 8 * x;
      if (key >= Sk) continue;
      const size_t row = ((size_t)b * Sk + key) * Hkv + kvh;
#pragma unroll
      for (int j = 0; j < CH; ++j)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int cc = kChunk * (c0 + j) + 8 * jj + col;  // past dh for a chunk past DC
          if (cc < dh) {
            const int e = 4 * jj + 2 * x;
            *reinterpret_cast<__nv_bfloat162*>(dk + row * dh + cc) =
                __floats2bfloat162_rn(dkacc[j][e] * scale, dkacc[j][e + 1] * scale);
            if (cc < dv)
              *reinterpret_cast<__nv_bfloat162*>(dvo + row * dv + cc) =
                  __floats2bfloat162_rn(dvacc[j][e], dvacc[j][e + 1]);
          }
        }
    }
  }
}

// ---------------------------------------------------------------------------
// The fused bf16 backward (keys and values of equal chunk counts, DC 1 and
// 2, and MLA's (3, 2); fused_bwd): three kernels a call where the dQ and
// dK/dV kernels above run two, and the dQ kernel's second walk (three
// products a tile) is gone.
//  * flash_bwd_delta_wgmma_kernel: D = rowsum(P * dP) of every row, summed
//    in fp32 over the 64-key tiles in order (the dQ kernel's first walk, on
//    its own), and lse * log2(e) beside it, both in the rows' order.  Two
//    products a tile, S and dP in commit groups of their own, the next
//    tile's issued before this tile's exp2, so that they run under it.
//  * flash_bwd_fused_wgmma_kernel: per (key block, 64-row tile) S^T and dP^T,
//    then dV += P^T . dO and dK += dS^T . Q with P^T and dS^T as hi + lo
//    (the arithmetic above), and dQ's partial dS . K over the warpgroup's 64
//    keys: bf16(dS^T), rounded once as the dQ kernel rounds it, is staged
//    in shared memory as the MN-major A operand of that product (K's tile
//    its MN-major B).  The partial goes through shared memory to the dQ
//    writers (warps 1 and 2 of the producer warpgroup, one for each of two
//    buffers, so that two row tiles' adds are in flight), which add it into
//    an fp32 accumulator [B*Hkv][row tiles][64 x dh] in the wrapper's
//    scratch by a bulk copy (the first key block to reach a row tile) or a
//    bulk fp32 add done in the L2 (the others), in increasing key order: a
//    per-row-tile counter, read with acquire and raised with release, holds
//    each key block until the one before it has added.  The blocks are
//    persistent (one an SM) and take their (key block, b*Hkv) items from a
//    ticket in that order, key block major, so that a block only ever waits
//    on an item a running block holds; a block walks its row tiles from the
//    last one down, so that the key blocks of one kv head reach a row tile
//    one after another, a writer's latency apart, not a walk apart.  The
//    counters and the ticket are zeroed in-stream before the launch, and a
//    tile's lse and D come with its Q and dO by bulk copy.
//  * flash_bwd_dq_convert_kernel: dq = scale x the accumulator, in bf16
//    (zeros where no key block reached a row tile).
// The layouts.  At DC 1 a block owns 128 keys, each consumer warpgroup 64
// of them and every column: per tile S^T, dP^T, dV and dK twice (hi, lo)
// and its dQ partial, seven products, and the writers add the second
// warpgroup's partial to the first's in shared memory before the one bulk
// add.  At DC 2 the two warpgroups share 64 keys and split the columns:
// each forms S^T and dP^T over the whole head dim itself (nine products a
// tile where the dK/dV kernel's hand-off of the two does seven, measured
// faster: the hand-off held both warpgroups in step, idle together) and
// takes its column chunk of dV, dK and dQ.  Each warpgroup's wgmmas of a
// tile are issued and retired in one straight block, and dV and dK retire
// before the dQ product: ptxas serializes the wgmmas (a wait after every
// one) where a group is in flight across a branch it cannot prove
// warp-uniform, where an accumulator is written while a group is in
// flight, or where the live registers run short.  At (3, 2) the two
// warpgroups share 64 keys and own the accumulators apart (kv_own):
// warpgroup 0 forms P^T from S^T over the keys' 192 columns, warpgroup 1
// dP^T over the values' 128, and the two cross through a 32 KB hand-off;
// warpgroup 0 forms dS^T, stages its bf16 hi for dQ and takes all three
// chunks of dK (hi + lo), warpgroup 1 takes both chunks of dV (hi + lo)
// and dQ's partial bf16(dS) . K over the 192 columns, chunk by chunk into
// one 48 KB buffer: 36 k-steps of 16 a tile each.  Each warpgroup's loop is
// compiled apart (its index a template argument), which kept ptxas from
// serializing them for registers.  The layout: K 24 KB, V 16 KB, a
// two-stage Q/dO ring of 2 x 40 KB, the dS^T tile 8 KB, the dQ buffer 48 KB
// and the hand-off 32 KB: 208 KB.  Measured slower (an H100 80GB HBM3 at 700
// W, deepseek-v2's S 4,096): each warpgroup forming dQ's chunks for its own dK/dV (C7512
// register serialization), dQ as one product of N = 192, K and V as
// register A operands, and dQ added from the registers by vector reds with
// a three-stage ring in place of the buffer (10.3 ms against 8.1).  The
// tickets take the kv heads in groups of hg (fused_item), each group key
// block first; the caller picks hg (flash_attention.ref.fused_heads_per_group:
// all the heads at DC 1 and 2, and at (3, 2), the only pair where groups
// were measured, as many as keep one group's Q, dO and dQ sums in the L2:
// key block major over all 128 heads took 17.2 ms with the first layout,
// against 10.2 in groups of 8).  Every sum keeps a fixed order, so the
// backward gives equal bits from run to run.
// ---------------------------------------------------------------------------
__host__ __device__ constexpr bool fused_bwd(int DC, int DVC) {
  return (DVC == DC && DC <= 2) || (DC == 3 && DVC == 2);
}
// the delta kernel's ring of K/V tiles: four stages, three at (3, 2)
__host__ __device__ constexpr int delta_stages(int DC, int DVC) { return DC + DVC <= 4 ? 4 : 3; }
// its grid with the row blocks of one kv head next to each other, so that
// the blocks on the card share its K/V in the L2: at (3, 2) only, the pair
// where it was measured (MLA's 128 heads); DC 1 and 2 keep the grid they
// were measured with
__host__ __device__ constexpr bool delta_rows_first(int DC, int DVC) { return kv_own(DC, DVC); }
// The fused kernel's ring of Q/dO row tiles and its buffers of a tile's dQ
// partial: three and two, and at (3, 2), whose partial is 48 KB, two and one.
__host__ __device__ constexpr int fused_stages(int DC, int DVC) { return kv_own(DC, DVC) ? 2 : 3; }
__host__ __device__ constexpr int fused_dq_bufs(int DC, int DVC) { return kv_own(DC, DVC) ? 1 : 2; }
constexpr int kDqTileFloats = kBwdRows * kChunk;  // fp32 of one 64 x 64 chunk of a dQ tile

template <int DC, int DVC>
struct DeltaWgSmem {
  alignas(1024) bf16 q[dq_consumers(DC)][DC][kWgRows * kChunk];
  alignas(1024) bf16 dout[dq_consumers(DC)][DVC][kWgRows * kChunk];
  alignas(1024) bf16 k[delta_stages(DC, DVC)][DC][kDqKeys * kChunk];
  alignas(1024) bf16 v[delta_stages(DC, DVC)][DVC][kDqKeys * kChunk];
  uint64_t q_full, full[delta_stages(DC, DVC)], empty[delta_stages(DC, DVC)];
};

// backward, D = rowsum(P * dP).  It writes D and lse * log2(e) in the rows'
// order, [B*Hkv][Rp] with Rp the rows rounded up to 64 (zeros past Sq*G):
// the fused kernel's producer then takes a row tile's 64 of each with one
// bulk copy.  grid: (B*Hkv, ceil(Sq*G / (64 * dq_consumers(DC)))), heaviest
// first; at delta_rows_first the two swapped, so that the blocks on the card
// at once are the row blocks of one kv head and read its K and V tiles from
// the L2 (at MLA's 128 heads one block a head would stream them from memory)
template <int DC, int DVC, bool kRows>
__global__ void __launch_bounds__(128 * (1 + dq_consumers(DC)), 1)
flash_bwd_delta_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const float* __restrict__ lse, float* __restrict__ lse2_rows,
                             float* __restrict__ delta_rows, int Sq, int Sk, int Hq, int Hkv,
                             int causal, int window, float scale) {
  constexpr int NC = dq_consumers(DC), kSt = delta_stages(DC, DVC);
  constexpr bool kRowsFirst = delta_rows_first(DC, DVC);
  extern __shared__ char smem_raw[];
  DeltaWgSmem<DC, DVC>& sm = smem_layout<DeltaWgSmem<DC, DVC>>(smem_raw);
  const int G = Hq / Hkv;
  const int Rtot = Sq * G;
  const int n_row = kRowsFirst ? gridDim.x : gridDim.y;
  const int row_i = kRowsFirst ? blockIdx.x : blockIdx.y;
  const int bh = kRowsFirst ? blockIdx.y : blockIdx.x;
  const int tile = causal ? n_row - 1 - row_i : row_i;
  const int r0 = tile * NC * kWgRows;
  const int b = bh / Hkv, kvh = bh % Hkv;
  const int p_lo = r0 / G, p_hi = (min(Rtot, r0 + NC * kWgRows) - 1) / G;
  const int key_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int key_hi = causal ? min(Sk - 1, p_hi) : Sk - 1;
  const int t_first = key_lo / kDqKeys;
  const int n_tiles = key_hi >= key_lo ? key_hi / kDqKeys - t_first + 1 : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NC * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (NC == 2) warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&sm.q_full, NC * (DC + DVC) * tile_bytes(kWgRows));
      for (int w = 0; w < NC; ++w)
        for (int c = 0; c < DC; ++c) {
          const int rw = r0 + w * kWgRows;
          tma_load_rows<kRows>(sm.q[w][c], &q_map, &sm.q_full, kChunk * c, rw, b, kvh, G, Hkv);
          if (c < DVC)
            tma_load_rows<kRows>(sm.dout[w][c], &do_map, &sm.q_full, kChunk * c, rw, b, kvh, G,
                                 Hkv);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kSt;
        if (i >= kSt) mbar_wait(&sm.empty[s], (i / kSt - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[s], (DC + DVC) * tile_bytes(kDqKeys));
        const int t0 = (t_first + i) * kDqKeys;
        for (int c = 0; c < DC; ++c) {
          tma_load_4d(sm.k[s][c], &k_map, &sm.full[s], kChunk * c, kvh, t0, b);
          if (c < DVC) tma_load_4d(sm.v[s][c], &v_map, &sm.full[s], kChunk * c, kvh, t0, b);
        }
      }
    }
  } else {
    if constexpr (NC == 2) warpgroup_reg_alloc<kConsumerRegs>();
    // warp-uniform as ptxas sees it, so that the wgmmas under branches on it
    // are not serialized
    const int cw = __shfl_sync(0xffffffffu, wg, 0) - 1;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int rw0 = r0 + cw * kWgRows;
    const int r_lo = rw0 + 16 * warp + lane / 4;
    const int pos[2] = {r_lo / G, (r_lo + 8) / G};
    const int wp_lo = rw0 / G, wp_hi = (min(Rtot, rw0 + kWgRows) - 1) / G;
    const int col = 2 * (lane % 4);
    const float sc = scale * kLog2e;
    float L[2];  // lse * log2(e) of this thread's two rows
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r_lo + 8 * x;
      L[x] = 0.f;
      if (r < Rtot) {
        const int sp = r / G, h = kvh * G + (r - sp * G);
        L[x] = lse[((size_t)b * Hq + h) * Sq + sp] * kLog2e;
      }
    }
    float dsum[2] = {0.f, 0.f};
    mbar_wait(&sm.q_full, 0);
    // S = Q . K^T and dP = dO . V^T of tile i, two commit groups
    auto issue = [&](float(&sacc)[32], float(&pacc)[32], int i) {
      const int s = i % kSt;
      mbar_wait(&sm.full[s], (i / kSt) & 1);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DC * 4; ++kc) {
        const int c = kc / 4, kb = 2 * (kc % 4);
        wgmma_ss_64x64(sacc, wgmma_desc(sm.q[cw][c]) + kb, wgmma_desc(sm.k[s][c]) + kb, kc > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kc = 0; kc < DVC * 4; ++kc) {
        const int c = kc / 4, kb = 2 * (kc % 4);
        wgmma_ss_64x64(pacc, wgmma_desc(sm.dout[cw][c]) + kb, wgmma_desc(sm.v[s][c]) + kb,
                       kc > 0);
      }
      wgmma_commit();
    };
    // tile i's share of D from its products, retired: frees its stage
    auto take = [&](const float(&cs)[32], const float(&cp)[32], int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[i % kSt]);
      const int t0 = (t_first + i) * kDqKeys;
      if (tile_needs_mask(t0, kDqKeys, wp_lo, wp_hi, Sk, causal, window)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int x = (e >> 1) & 1;
          const int key = t0 + 8 * (e / 4) + col + (e & 1);
          dsum[x] += visible(key, pos[x], Sk, causal, window)
                         ? fast_exp2(cs[e] * sc - L[x]) * cp[e] : 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) dsum[(e >> 1) & 1] += fast_exp2(cs[e] * sc - L[(e >> 1) & 1]) * cp[e];
      }
    };
    // the next tile's products are issued before this tile's exp2, so that
    // they run under it; every wait counts the groups issued after its own
    if (rw0 < Rtot && n_tiles > 0) {
      float sa[32], pa[32], sb[32], pb[32];
      issue(sa, pa, 0);
      int i = 0;
      for (; i + 2 < n_tiles; i += 2) {
        issue(sb, pb, i + 1);
        wgmma_wait<2>();
        fence_regs(sa);
        fence_regs(pa);
        take(sa, pa, i);
        issue(sa, pa, i + 2);
        wgmma_wait<2>();
        fence_regs(sb);
        fence_regs(pb);
        take(sb, pb, i + 1);
      }
      if (i + 1 < n_tiles) {
        issue(sb, pb, i + 1);
        wgmma_wait<2>();
        fence_regs(sa);
        fence_regs(pa);
        take(sa, pa, i);
        wgmma_wait<0>();
        fence_regs(sb);
        fence_regs(pb);
        take(sb, pb, i + 1);
      } else {
        wgmma_wait<0>();
        fence_regs(sa);
        fence_regs(pa);
        take(sa, pa, i);
      }
    } else {  // rows past Sq: the ring's stages are still freed
      for (int i = 0; i < n_tiles; ++i) {
        mbar_wait(&sm.full[i % kSt], (i / kSt) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[i % kSt]);
      }
    }
    const int Rp = (Rtot + kBwdRows - 1) / kBwdRows * kBwdRows;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float D = quad_sum(dsum[x]);
      const int r = r_lo + 8 * x;
      if (lane % 4 == 0 && r < Rp) {
        const size_t at = (size_t)bh * Rp + r;
        lse2_rows[at] = r < Rtot ? L[x] : 0.f;
        delta_rows[at] = r < Rtot ? D : 0.f;
      }
    }
  }
}

// Waits of the fused kernel (its barriers, and the counters of other
// blocks): one that lasts 2^36 cycles (some 40 seconds) traps, so that a
// fault in their bookkeeping fails the launch where it would hang the card.
constexpr long long kWaitCycles = 1LL << 36;
__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}
// until *counter == want, read with acquire
__device__ __forceinline__ void wait_count(const int* counter, int want) {
  if (ld_acquire_gpu(counter) == want) return;
  const long long t0 = clock64();
  while (ld_acquire_gpu(counter) != want)
    if (clock64() - t0 > kWaitCycles) __trap();
}

// The 64-row tiles a key block (keys from k0) walks: the rows of the
// positions that see one of its keys, from row_first, n of them (the dK/dV
// kernel's walk above).
struct KvWalk {
  int row_first, n;
};
__device__ __forceinline__ KvWalk kv_row_walk(int k0, int keys, int Sq, int Sk, int G, int causal,
                                              int window) {
  const int Rtot = Sq * G;
  const int k_last = min(Sk, k0 + keys) - 1;
  const int p_min = causal ? k0 : 0;
  const int p_max = window > 0 ? min(Sq - 1, k_last + window - 1) : Sq - 1;
  const int row_first = (min(p_min, Sq) * G / kBwdRows) * kBwdRows;
  const int row_end = min(Rtot, (p_max + 1) * G);
  return {row_first, row_end > row_first ? (row_end - row_first + kBwdRows - 1) / kBwdRows : 0};
}
// The first key block (of `keys` keys) whose walk holds the row tile from
// rt0: every key block from it up to the last whose walk starts at or below
// rt0 holds it, and each adds to the tile's dQ in that order.  Without a
// window it is 0; with one, the first block with a key at or past the
// tile's first position less window - 1.
__host__ __device__ inline int kv_block_first(int rt0, int G, int window, int keys) {
  const int x = window > 0 ? rt0 / G - window + 1 : 0;
  return x > 0 ? x / keys : 0;
}

// A k-step's bf16 A fragment of a [keys x 64 rows] accumulator (to_a_frag's
// layout: keys `key` and key + 8, the accumulator's columns 16kk..16kk+15,
// col and col + 1 of each 8) into the transposed tile [keys][64] of 128-byte
// rows under the 128-byte swizzle: the MN-major A operand of a product over
// the keys.
__device__ __forceinline__ void store_frag_t(bf16* tile, int key, int kk, int col,
                                             const uint32_t (&a)[4]) {
  char* base = reinterpret_cast<char*>(tile);
  *reinterpret_cast<uint32_t*>(base + swizzle128(key, 2 * kk) + 2 * col) = a[0];
  *reinterpret_cast<uint32_t*>(base + swizzle128(key + 8, 2 * kk) + 2 * col) = a[1];
  *reinterpret_cast<uint32_t*>(base + swizzle128(key, 2 * kk + 1) + 2 * col) = a[2];
  *reinterpret_cast<uint32_t*>(base + swizzle128(key + 8, 2 * kk + 1) + 2 * col) = a[3];
}

// The fused kernel's tickets: item t is key block kb of bh = b*Hkv + kvh.
// The kv heads go in groups of hg; within a group the items run key block
// first (a key block's predecessor, whose partials of dQ it waits for, has
// the earlier ticket), and the groups one after another.  With hg = B*Hkv
// (DC 1 and 2) that is key block major over every head, which the first
// line takes with one division: on an H100 80GB HBM3 at 700 W the general
// form alone cost the DC 1 kernel 8 B of spills under ptxas and 2% at
// TinyLlama's train_4k, and one warp decoding each ticket for the others
// through shared memory 3.5%.
struct FusedItem {
  int bh, kb;
};
__device__ __forceinline__ FusedItem fused_item(int t, int BH, int n_kb, int hg) {
  if (hg >= BH) return {t % BH, t / BH};
  const int g = t / (n_kb * hg), r = t - g * n_kb * hg;
  const int gs = min(hg, BH - g * hg);  // heads of this group
  return {g * hg + r % gs, r / gs};
}

template <int DC, int DVC>
struct FusedWgSmem {
  static constexpr int kSt = fused_stages(DC, DVC), kBufs = fused_dq_bufs(DC, DVC);
  // 64 x 64 fp32 parts of a dQ partial in a buffer: at DC 1 each
  // warpgroup's partial over its 64 keys (the writers add the second to the
  // first), else the partial's column chunks
  static constexpr int kParts = DC == 1 ? 2 : DC;
  alignas(1024) bf16 k[DC][kv_keys(DC, DVC) * kChunk];
  alignas(1024) bf16 v[DVC][kv_keys(DC, DVC) * kChunk];
  alignas(1024) bf16 q[kSt][DC][kBwdRows * kChunk];
  alignas(1024) bf16 dout[kSt][DVC][kBwdRows * kChunk];
  // dS^T [keys][rows]: each warpgroup's at DC 1 and 2, warpgroup 0's at (3, 2)
  alignas(1024) bf16 ds[kv_own(DC, DVC) ? 1 : kConsumers][kWgRows * kChunk];
  // a row tile's dQ partial, as the accumulator's layout: [part * 8 + j]
  // [thread] holds elements 4j..4j+3 of the thread's accumulator of part
  float4 dq[kBufs][kParts * 8][128];
  Handoff<kv_own(DC, DVC) ? 16 : 0> handoff;  // P^T and dP^T, at (3, 2)
  alignas(16) float lse2[kSt][kBwdRows];  // the tile's rows' lse * log2(e)
  alignas(16) float delta[kSt][kBwdRows];  // and D, by bulk copies
  int item[2];
  uint64_t kv_full, kv_empty, full[kSt], empty[kSt];
  uint64_t item_full[2], item_empty[2], dq_full[kBufs], dq_empty[kBufs];
};

// backward, dK and dV of a key block, and its partial of dQ into dq_acc,
// after the delta kernel.  Persistent: grid min(items, SMs); item t (taken
// from *ticket) is fused_item(t, B*Hkv, key blocks, hg).  Warp 0 of the
// producer warpgroup takes the tickets and keeps the TMA ring fed, the next
// kBufs warps are the dQ writers (one a buffer, so that at DC 1 and 2 two
// row tiles' adds are in flight), the consumer warpgroups compute (see
// above).
template <int DC, int DVC, bool kRows>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_fused_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const float* __restrict__ lse2_rows,
                             const float* __restrict__ delta_rows, float* __restrict__ dq_acc,
                             int* __restrict__ counters, int* __restrict__ ticket,
                             bf16* __restrict__ dk, bf16* __restrict__ dvo, int B, int Sq, int Sk,
                             int Hq, int Hkv, int dh, int dv, int causal, int window, float scale,
                             int hg) {
  static_assert(fused_bwd(DC, DVC), "the fused backward takes (1, 1), (2, 2) and (3, 2)");
  using Smem = FusedWgSmem<DC, DVC>;
  constexpr int kKeys = kv_keys(DC, DVC), kSt = Smem::kSt, kBufs = Smem::kBufs;
  constexpr bool kOwn = kv_own(DC, DVC);  // (3, 2): 64 shared keys, the accumulators owned apart
  constexpr bool kSplit = !kOwn && kv_split(DC);  // DC 2: 64 shared keys, the columns split
  static_assert(kOwn || kv_chunks(DC) == 1, "a warpgroup owns one column chunk of dK, dV and dQ");
  constexpr uint32_t kDqBytes = DC * kDqTileFloats * 4;
  extern __shared__ char smem_raw[];
  Smem& sm = smem_layout<Smem>(smem_raw);
  const int G = Hq / Hkv;
  const int Rtot = Sq * G;
  const int BH = B * Hkv;
  const int n_rt = (Rtot + kBwdRows - 1) / kBwdRows;  // row tiles of one kv head; Rp / 64
  const int n_kb = (Sk + kKeys - 1) / kKeys;
  const int n_items = n_kb * BH;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    mbar_init(&sm.kv_empty, kConsumers * 4);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers * 4);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.item_full[i], 1);
      mbar_init(&sm.item_empty[i], kConsumers * 4 + kBufs);  // the consumer warps, the writers
    }
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(&sm.dq_full[i], (kOwn ? 1 : kConsumers) * 4);  // the warps that write the partial
      mbar_init(&sm.dq_empty[i], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {  // tickets and loads
      int g = 0;             // row tiles through the ring
      for (int it = 0;; ++it) {
        const int slot = it & 1;
        if (it >= 2) mbar_wait_bounded(&sm.item_empty[slot], ((it >> 1) - 1) & 1);
        const int item = atomicAdd(ticket, 1);
        sm.item[slot] = item;
        mbar_arrive(&sm.item_full[slot]);
        if (item >= n_items) break;
        const FusedItem f = fused_item(item, BH, n_kb, hg);
        const int bh = f.bh, b = bh / Hkv, kvh = bh % Hkv, k0 = f.kb * kKeys;
        const KvWalk wk = kv_row_walk(k0, kKeys, Sq, Sk, G, causal, window);
        if (it >= 1) mbar_wait_bounded(&sm.kv_empty, (it - 1) & 1);
        mbar_arrive_expect_tx(&sm.kv_full, (DC + DVC) * tile_bytes(kKeys));
        for (int c = 0; c < DC; ++c) {
          tma_load_4d(sm.k[c], &k_map, &sm.kv_full, kChunk * c, kvh, k0, b);
          if (c < DVC) tma_load_4d(sm.v[c], &v_map, &sm.kv_full, kChunk * c, kvh, k0, b);
        }
        const size_t rows = (size_t)bh * n_rt * kBwdRows;  // this kv head's first row
        for (int j = 0; j < wk.n; ++j, ++g) {
          const int s = g % kSt;
          const int rt0 = wk.row_first + (wk.n - 1 - j) * kBwdRows;  // the last tile first
          if (g >= kSt) mbar_wait_bounded(&sm.empty[s], (g / kSt - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[s],
                                (DC + DVC) * tile_bytes(kBwdRows) + 2 * kBwdRows * 4);
          for (int c = 0; c < DC; ++c) {
            tma_load_rows<kRows>(sm.q[s][c], &q_map, &sm.full[s], kChunk * c, rt0, b, kvh, G,
                                 Hkv);
            if (c < DVC)
              tma_load_rows<kRows>(sm.dout[s][c], &do_map, &sm.full[s], kChunk * c, rt0, b, kvh,
                                   G, Hkv);
          }
          bulk_load(sm.lse2[s], lse2_rows + rows + rt0, kBwdRows * 4, &sm.full[s]);
          bulk_load(sm.delta[s], delta_rows + rows + rt0, kBwdRows * 4, &sm.full[s]);
        }
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 32 * (1 + kBufs)) {  // the dQ writers
      const int wr = threadIdx.x / 32 - 1;  // takes the row tiles g with g % kBufs == wr
      int g = 0;
      for (int it = 0;; ++it) {
        const int slot = it & 1;
        mbar_wait_bounded(&sm.item_full[slot], (it >> 1) & 1);
        const int item = __shfl_sync(0xffffffffu, sm.item[slot], 0);
        if (lane == 0) mbar_arrive(&sm.item_empty[slot]);
        if (item >= n_items) break;
        const FusedItem f = fused_item(item, BH, n_kb, hg);
        const int bh = f.bh, kb = f.kb;
        const KvWalk wk = kv_row_walk(kb * kKeys, kKeys, Sq, Sk, G, causal, window);
        for (int j = 0; j < wk.n; ++j, ++g) {
          const int buf = g % kBufs, u = g / kBufs;
          if (buf != wr) continue;
          const int rt0 = wk.row_first + (wk.n - 1 - j) * kBwdRows;
          const int ordinal = kb - kv_block_first(rt0, G, window, kKeys);
          const size_t t = (size_t)bh * n_rt + rt0 / kBwdRows;
          mbar_wait_bounded(&sm.dq_full[buf], u & 1);
          if constexpr (DC == 1) {  // the second warpgroup's partial into the first's
            for (int x = lane; x < 8 * 128; x += 32) {
              const float4 a = sm.dq[buf][x / 128][x % 128], b = sm.dq[buf][8 + x / 128][x % 128];
              sm.dq[buf][x / 128][x % 128] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
            }
            fence_proxy_async();
            __syncwarp();
          }
          if (lane == 0) {
            wait_count(counters + t, ordinal);
            fence_proxy_async_global();
            float* dst = dq_acc + t * (DC * kDqTileFloats);
            if (ordinal == 0)
              bulk_store(dst, sm.dq[buf], kDqBytes);
            else
              bulk_reduce_add_f32(dst, sm.dq[buf], kDqBytes);
            bulk_commit();
            bulk_wait<0>();
            fence_proxy_async_global();
            red_release_gpu_add(counters + t, 1);
            mbar_arrive(&sm.dq_empty[buf]);
          }
          __syncwarp();
        }
      }
    }
  } else {
    warpgroup_reg_alloc<kConsumerRegs>();
    // warp-uniform as ptxas sees it (as the item below), so that the wgmmas
    // under branches on what derives from them are not serialized
    const int cw = __shfl_sync(0xffffffffu, wg, 0) - 1;
    if constexpr (kOwn) {
      // (3, 2): both warpgroups take the block's 64 keys.  Warpgroup 0 forms
      // P^T from S^T = K . Q^T over the dh columns, warpgroup 1 dP^T = V .
      // dO^T over the dv columns, and the two cross through the hand-off;
      // warpgroup 0 then forms dS^T, stages its bf16 hi for dQ and adds
      // dS^T . Q to all of dK, warpgroup 1 adds P^T . dO to all of dV and
      // forms dQ's partial dS . K from the staged tile, a chunk at a time
      // into the one buffer: about as much tensor work a tile each.
      // Each warpgroup runs its own instance of the loop below (W its index
      // at compile time), so that ptxas allocates each one's registers apart.
      auto own = [&](auto w) {
        constexpr int W = decltype(w)::value;
        const int tid = threadIdx.x % 128, warp = tid / 32;
        const int col = 2 * (lane % 4);
        const float sc = scale * kLog2e;
        int g = 0;
        for (int it = 0;; ++it) {
          const int slot = it & 1;
          mbar_wait_bounded(&sm.item_full[slot], (it >> 1) & 1);
          const int item = __shfl_sync(0xffffffffu, sm.item[slot], 0);
          if (lane == 0) mbar_arrive(&sm.item_empty[slot]);
          if (item >= n_items) break;
          const FusedItem f = fused_item(item, BH, n_kb, hg);
          const int bh = f.bh, kb = f.kb;
          const int b = bh / Hkv, kvh = bh % Hkv, k0 = kb * kKeys;
          const KvWalk wk = kv_row_walk(k0, kKeys, Sq, Sk, G, causal, window);
          const int key_lo = k0 + 16 * warp + lane / 4;  // this thread's keys: key_lo, key_lo + 8
          constexpr int kAcc = W == 0 ? DC : DVC;
          float acc[kAcc][32];  // warpgroup 0: dK's chunks; 1: dV's
#pragma unroll
          for (int jj = 0; jj < kAcc; ++jj)
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[jj][e] = 0.f;
          mbar_wait_bounded(&sm.kv_full, it & 1);
          constexpr int kA = (W == 0 ? DC : DVC) * 4;  // k-steps of S^T or dP^T

          for (int j = 0; j < wk.n; ++j, ++g) {
            const int s = g % kSt;
            const int rt0 = wk.row_first + (wk.n - 1 - j) * kBwdRows;
            mbar_wait_bounded(&sm.full[s], (g / kSt) & 1);
            const int tp_lo = rt0 / G, tp_hi = (min(Rtot, rt0 + kBwdRows) - 1) / G;
            const int k_last = min(Sk, k0 + kWgRows) - 1;
            const bool live = !(k0 >= Sk || (causal && tp_hi < k0) ||
                                (window > 0 && k_last <= tp_lo - window));
            const bool masked = rt0 + kBwdRows > Rtot || k0 + kWgRows > Sk ||
                                (causal && tp_lo < k0 + kWgRows - 1) ||
                                (window > 0 && tp_hi - window + 1 > k0);
            if (live) {
              float x0[32];  // this warpgroup's product
              wgmma_fence();
#pragma unroll
              for (int kc = 0; kc < kA; ++kc) {
                const int c = kc / 4, kb = 2 * (kc % 4);
                wgmma_ss_64x64(x0, wgmma_desc(W == 0 ? sm.k[c] : sm.v[c]) + kb,
                               wgmma_desc(W == 0 ? sm.q[s][c] : sm.dout[s][c]) + kb, kc > 0);
              }
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(x0);
              // P^T; the masks' tests only on the tiles that hold an invisible pair
              if constexpr (W == 0) {
                if (masked) {
#pragma unroll
                  for (int e = 0; e < 32; ++e) {
                    const int rl = 8 * (e / 4) + col + (e & 1);  // the row, within the tile
                    const int r = rt0 + rl;
                    const int key = key_lo + 8 * ((e >> 1) & 1);
                    const bool ok = r < Rtot && visible(key, r / G, Sk, causal, window);
                    x0[e] = ok ? fast_exp2(x0[e] * sc - sm.lse2[s][rl]) : 0.f;
                  }
                } else {
#pragma unroll
                  for (int e = 0; e < 32; ++e)
                    x0[e] = fast_exp2(x0[e] * sc - sm.lse2[s][8 * (e / 4) + col + (e & 1)]);
                }
              }
#pragma unroll
              for (int jj = 0; jj < 8; ++jj)
                sm.handoff.v[W * 8 + jj][tid] =
                    make_float4(x0[4 * jj], x0[4 * jj + 1], x0[4 * jj + 2], x0[4 * jj + 3]);
              named_barrier(1, 2 * 128);
              // the other's product read from the hand-off 8 values at a time,
              // as the A fragments of one k-step take them
              if constexpr (W == 0) {
                // dS^T = P^T * (dP^T - D), hi + lo, its hi staged for dQ
                uint32_t da[kBwdRows / 16][4], dl[kBwdRows / 16][4];
#pragma unroll
                for (int kk = 0; kk < kBwdRows / 16; ++kk) {
                  const float4 t0 = sm.handoff.v[8 + 2 * kk][tid];
                  const float4 t1 = sm.handoff.v[8 + 2 * kk + 1][tid];
                  const float y[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
                  for (int i = 0; i < 8; ++i) {
                    const int e = 8 * kk + i;
                    x0[e] *= y[i] - sm.delta[s][8 * (e / 4) + col + (e & 1)];
                  }
                  to_a_frags_hilo(&x0[8 * kk], da[kk], dl[kk]);
                  store_frag_t(sm.ds[0], 16 * warp + lane / 4, kk, col, da[kk]);
                }
                named_barrier(1, 2 * 128);  // the hand-off is free for the next tile
                fence_proxy_async();
                named_barrier_arrive(2, 2 * 128);  // the dS^T tile is whole
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kBwdRows / 16; ++kk)
#pragma unroll
                  for (int jj = 0; jj < DC; ++jj) {
                    const uint64_t bq = wgmma_desc(sm.q[s][jj]) + kk * 16 * 128 / 16;
                    wgmma_rs_64x64(acc[jj], da[kk], bq);
                    wgmma_rs_64x64(acc[jj], dl[kk], bq);
                  }
                wgmma_commit();
                wgmma_wait<0>();
#pragma unroll
                for (int kk = 0; kk < kBwdRows / 16; ++kk) {
                  fence_regs(da[kk]);
                  fence_regs(dl[kk]);
                }
              } else {
                // P^T, hi + lo, into dV += P^T . dO
                uint32_t pa[kBwdRows / 16][4], pl[kBwdRows / 16][4];
#pragma unroll
                for (int kk = 0; kk < kBwdRows / 16; ++kk) {
                  const float4 t0 = sm.handoff.v[2 * kk][tid];
                  const float4 t1 = sm.handoff.v[2 * kk + 1][tid];
                  const float y[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
                  to_a_frags_hilo(y, pa[kk], pl[kk]);
                }
                named_barrier(1, 2 * 128);  // the hand-off is free for the next tile
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kBwdRows / 16; ++kk)
#pragma unroll
                  for (int jj = 0; jj < DVC; ++jj) {
                    const uint64_t bo = wgmma_desc(sm.dout[s][jj]) + kk * 16 * 128 / 16;
                    wgmma_rs_64x64(acc[jj], pa[kk], bo);
                    wgmma_rs_64x64(acc[jj], pl[kk], bo);
                  }
                wgmma_commit();
                wgmma_wait<0>();
#pragma unroll
                for (int kk = 0; kk < kBwdRows / 16; ++kk) {
                  fence_regs(pa[kk]);
                  fence_regs(pl[kk]);
                }
              }
#pragma unroll
              for (int jj = 0; jj < kAcc; ++jj) fence_regs(acc[jj]);
            }
            if constexpr (W == 1) {
              // dS (64 rows x the 64 keys) . K (the keys x dh), a chunk at a
              // time into the buffer, once its last add is done and warpgroup
              // 0's dS^T tile is whole (one product of N = 192 measured slower)
              if (g >= 1) mbar_wait_bounded(&sm.dq_empty[0], (g - 1) & 1);
              if (live) named_barrier(2, 2 * 128);
#pragma unroll
              for (int c = 0; c < DC; ++c) {
                float dq[32];
                if (live) {
                  wgmma_fence();
#pragma unroll
                  for (int kk = 0; kk < kWgRows / 16; ++kk)
                    wgmma_ss_64x64_mn(dq, wgmma_desc(sm.ds[0]) + kk * 16 * 128 / 16,
                                      wgmma_desc(sm.k[c]) + kk * 16 * 128 / 16, kk > 0);
                  wgmma_commit();
                  wgmma_wait<0>();
                  fence_regs(dq);
                } else {
#pragma unroll
                  for (int e = 0; e < 32; ++e) dq[e] = 0.f;
                }
#pragma unroll
                for (int x = 0; x < 8; ++x)
                  sm.dq[0][c * 8 + x][tid] =
                      make_float4(dq[4 * x], dq[4 * x + 1], dq[4 * x + 2], dq[4 * x + 3]);
              }
              fence_proxy_async();  // the bulk copy reads the buffer
              __syncwarp();
              if (lane == 0) mbar_arrive(&sm.dq_full[0]);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.empty[s]);
          }

          // warpgroup 0: dK's chunks in acc[0, DC); 1: dV's in acc[0, DVC)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int key = key_lo + 8 * x;
            if (key >= Sk) continue;
            const size_t row = ((size_t)b * Sk + key) * Hkv + kvh;
            bf16* out = W == 0 ? dk + row * dh : dvo + row * dv;
            const int width = W == 0 ? dh : dv;
            const float mul = W == 0 ? scale : 1.f;
#pragma unroll
            for (int c = 0; c < kAcc; ++c) {
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                const int cc = kChunk * c + 8 * q + col;
                const int e = 4 * q + 2 * x;
                if (cc < width)
                  *reinterpret_cast<__nv_bfloat162*>(out + cc) =
                      __floats2bfloat162_rn(acc[c][e] * mul, acc[c][e + 1] * mul);
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&sm.kv_empty);
        }
      };
      if (cw == 0)
        own(std::integral_constant<int, 0>{});
      else
        own(std::integral_constant<int, 1>{});
    } else {
      const int tid = threadIdx.x % 128, warp = tid / 32;
      const int col = 2 * (lane % 4);
      const float sc = scale * kLog2e;
      const int c0 = kSplit ? cw : 0;              // the column chunk this warpgroup owns
      const int koff = kSplit ? 0 : cw * kWgRows;  // its first key, within the block's
      int g = 0;
      for (int it = 0;; ++it) {
        const int slot = it & 1;
        mbar_wait_bounded(&sm.item_full[slot], (it >> 1) & 1);
        const int item = __shfl_sync(0xffffffffu, sm.item[slot], 0);
        if (lane == 0) mbar_arrive(&sm.item_empty[slot]);
        if (item >= n_items) break;
        const FusedItem f = fused_item(item, BH, n_kb, hg);
        const int bh = f.bh, kb = f.kb;
        const int b = bh / Hkv, kvh = bh % Hkv, k0 = kb * kKeys;
        const KvWalk wk = kv_row_walk(k0, kKeys, Sq, Sk, G, causal, window);
        const int kw0 = k0 + koff;                      // this warpgroup's first key
        const int key_lo = kw0 + 16 * warp + lane / 4;  // this thread's keys: key_lo, key_lo + 8
        float dkacc[32], dvacc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) dkacc[e] = dvacc[e] = 0.f;
        mbar_wait_bounded(&sm.kv_full, it & 1);

        for (int j = 0; j < wk.n; ++j, ++g) {
          const int s = g % kSt, buf = g & 1, u = g >> 1;
          const int rt0 = wk.row_first + (wk.n - 1 - j) * kBwdRows;
          mbar_wait_bounded(&sm.full[s], (g / kSt) & 1);
          const int tp_lo = rt0 / G, tp_hi = (min(Rtot, rt0 + kBwdRows) - 1) / G;
          // the tile's rows against this warpgroup's keys, with rows and keys
          // swapped in the tests of tile_invisible and tile_needs_mask
          const int kw_last = min(Sk, kw0 + kWgRows) - 1;
          const bool skip = kw0 >= Sk || (causal && tp_hi < kw0) ||
                            (window > 0 && kw_last <= tp_lo - window);
          const bool masked = rt0 + kBwdRows > Rtot || kw0 + kWgRows > Sk ||
                              (causal && tp_lo < kw0 + kWgRows - 1) ||
                              (window > 0 && tp_hi - window + 1 > kw0);
          float dqacc[32];  // this warpgroup's partial of the tile's dQ
          // This warpgroup's 64 keys (at DC 1 its own half of the block's,
          // at DC 2 the block's, shared) against the tile: S^T and dP^T over
          // the whole head dim, dV and dK of its column chunk c0 with hi and
          // lo fragments, and dQ's partial of that chunk over its keys from
          // its own dS^T tile, so that neither warpgroup waits on the other.
          // Every wgmma of the tile is issued and retired in one straight
          // block, dV and dK before dQ (see above)
          if (!skip) {
            float st[32], dpt[32];  // S^T = K . Q^T and dP^T = V . dO^T: 64 keys x 64 rows
            wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < DC * 4; ++kc) {
              const int c = kc / 4, kb = 2 * (kc % 4);
              wgmma_ss_64x64(st, wgmma_desc(sm.k[c] + koff * kChunk) + kb,
                             wgmma_desc(sm.q[s][c]) + kb, kc > 0);
            }
#pragma unroll
            for (int kc = 0; kc < DVC * 4; ++kc) {
              const int c = kc / 4, kb = 2 * (kc % 4);
              wgmma_ss_64x64(dpt, wgmma_desc(sm.v[c] + koff * kChunk) + kb,
                             wgmma_desc(sm.dout[s][c]) + kb, kc > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(st);
            fence_regs(dpt);
            // P^T and dS^T; the masks' tests (a division by G a row) only on
            // the tiles that hold an invisible pair
            if (masked) {
#pragma unroll
              for (int e = 0; e < 32; ++e) {
                const int rl = 8 * (e / 4) + col + (e & 1);  // the row, within the tile
                const int r = rt0 + rl;
                const int key = key_lo + 8 * ((e >> 1) & 1);
                const bool ok = r < Rtot && visible(key, r / G, Sk, causal, window);
                st[e] = ok ? fast_exp2(st[e] * sc - sm.lse2[s][rl]) : 0.f;
                dpt[e] = st[e] * (dpt[e] - sm.delta[s][rl]);
              }
            } else {
#pragma unroll
              for (int e = 0; e < 32; ++e) {
                const int rl = 8 * (e / 4) + col + (e & 1);
                st[e] = fast_exp2(st[e] * sc - sm.lse2[s][rl]);
                dpt[e] = st[e] * (dpt[e] - sm.delta[s][rl]);
              }
            }
            // P^T's fragments and dV, then dS^T's and dK: half the fragments
            // are live at a time
            uint32_t pa[kBwdRows / 16][4], pl[kBwdRows / 16][4];    // hi, lo
            uint32_t dsa[kBwdRows / 16][4], dsl[kBwdRows / 16][4];  // hi, lo
#pragma unroll
            for (int kk = 0; kk < kBwdRows / 16; ++kk) to_a_frags_hilo(&st[8 * kk], pa[kk], pl[kk]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBwdRows / 16; ++kk) {
              const uint64_t bo = wgmma_desc(sm.dout[s][c0]) + kk * 16 * 128 / 16;
              wgmma_rs_64x64(dvacc, pa[kk], bo);
              wgmma_rs_64x64(dvacc, pl[kk], bo);
            }
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < kBwdRows / 16; ++kk) {
              to_a_frags_hilo(&dpt[8 * kk], dsa[kk], dsl[kk]);
              store_frag_t(sm.ds[cw], 16 * warp + lane / 4, kk, col, dsa[kk]);
            }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBwdRows / 16; ++kk) {
              const uint64_t bq = wgmma_desc(sm.q[s][c0]) + kk * 16 * 128 / 16;
              wgmma_rs_64x64(dkacc, dsa[kk], bq);
              wgmma_rs_64x64(dkacc, dsl[kk], bq);
            }
            wgmma_commit();
            fence_proxy_async();
            named_barrier(2 + cw, 128);  // this warpgroup's dS^T tile is whole
            wgmma_wait<0>();
#pragma unroll
            for (int kk = 0; kk < kBwdRows / 16; ++kk) {
              fence_regs(pa[kk]);
              fence_regs(pl[kk]);
              fence_regs(dsa[kk]);
              fence_regs(dsl[kk]);
            }
            fence_regs(dkacc);
            fence_regs(dvacc);
            // dS (64 rows x these 64 keys) . K (these keys x chunk c0)
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kWgRows / 16; ++kk)
              wgmma_ss_64x64_mn(dqacc, wgmma_desc(sm.ds[cw]) + kk * 16 * 128 / 16,
                                wgmma_desc(sm.k[c0] + koff * kChunk) + kk * 16 * 128 / 16, kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dqacc);
          } else {
#pragma unroll
            for (int e = 0; e < 32; ++e) dqacc[e] = 0.f;
          }
          if (u >= 1) mbar_wait_bounded(&sm.dq_empty[buf], (u - 1) & 1);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            sm.dq[buf][cw * 8 + jj][tid] = make_float4(dqacc[4 * jj], dqacc[4 * jj + 1],
                                                       dqacc[4 * jj + 2], dqacc[4 * jj + 3]);
          if constexpr (kSplit) fence_proxy_async();  // the bulk copy reads it (at DC 1 the
                                                      // writers' sum fences)
          __syncwarp();
          if (lane == 0) mbar_arrive(&sm.dq_full[buf]);
          __syncwarp();
          if (lane == 0) mbar_arrive(&sm.empty[s]);
        }

#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int key = key_lo + 8 * x;
          if (key >= Sk) continue;
          const size_t row = ((size_t)b * Sk + key) * Hkv + kvh;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int cc = kChunk * c0 + 8 * jj + col;
            if (cc < dh) {
              const int e = 4 * jj + 2 * x;
              *reinterpret_cast<__nv_bfloat162*>(dk + row * dh + cc) =
                  __floats2bfloat162_rn(dkacc[e] * scale, dkacc[e + 1] * scale);
              if (cc < dv)
                *reinterpret_cast<__nv_bfloat162*>(dvo + row * dv + cc) =
                    __floats2bfloat162_rn(dvacc[e], dvacc[e + 1]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.kv_empty);
      }
    }
  }
}

// dq [B,Sq,Hq,dh] = scale x the fused kernel's fp32 sums dq_acc [B*Hkv]
// [n_rt][DC * 8][128] (float4s, the dQ buffers' layout: float4 t of part jj
// holds columns 8jj + 2(t%4) and one more of rows 16(t/32) + (t%32)/4 and 8
// more); zeros in a row tile whose counter no key block raised.  A thread a
// (row pair, 8-column group), the groups of one row pair on neighbouring
// threads: it reads the pair's four float4s of its group (64 contiguous
// bytes) and writes 16 bytes to each of the two rows.
__global__ void __launch_bounds__(256)
flash_bwd_dq_convert_kernel(const float4* __restrict__ dq_acc, const int* __restrict__ counters,
                            bf16* __restrict__ dq, long long total, int n_rt, int DC, int Sq,
                            int Hq, int Hkv, int dh, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int groups = DC * 8;
  const int jj = (int)(i % groups);  // columns 8jj..8jj+7
  const long long rest = i / groups;
  const int pair = (int)(rest % 32);  // rows 16(pair / 8) + pair % 8 and 8 more
  const long long tile = rest / 32;
  if (8 * jj >= dh) return;
  float lo[8], hi[8];
  const bool seen = counters[tile] > 0;
  const float4* src = dq_acc + (tile * groups + jj) * 128 + 32 * (pair / 8) + 4 * (pair % 8);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = seen ? src[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    lo[2 * q] = v.x * scale, lo[2 * q + 1] = v.y * scale;
    hi[2 * q] = v.z * scale, hi[2 * q + 1] = v.w * scale;
  }
  const int rt = (int)(tile % n_rt), bh = (int)(tile / n_rt);
  const int G = Hq / Hkv, Rtot = Sq * G;
  const int r = rt * kBwdRows + 16 * (pair / 8) + pair % 8;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float* f = x == 0 ? lo : hi;
    if (r + 8 * x < Rtot)
      *reinterpret_cast<uint4*>(dq + row_offset(bh / Hkv, r + 8 * x, G, bh % Hkv, Sq, Hq, dh) +
                                8 * jj) =
          make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                     pack_bf16(f[6], f[7]));
  }
}

// x0 [B,S,Hq,dh0] (and x1 [B,S,Hq,dh1], where it is not null) into the
// gathered copies y0 [B*Hkv][S*G][dh0] (y1) that the wgmma_rows kernels read:
// row r = s*G + g of slab b*Hkv + kvh is position s of head kvh*G + g.  The G
// heads of one position are contiguous on both sides, so this is a plain
// copy, 16 bytes a thread, with neighbouring threads on neighbouring
// addresses.  grid (ceil(B*Hq*S*max(dh0, dh1) / 8 / 256), 1 or 2): y picks
// the tensor.
__global__ void __launch_bounds__(256)
flash_rows_gather_kernel(const bf16* __restrict__ x0, const bf16* __restrict__ x1,
                         bf16* __restrict__ y0, bf16* __restrict__ y1, int B, int S, int Hq,
                         int Hkv, int dh0, int dh1) {
  const bf16* x = blockIdx.y == 0 ? x0 : x1;
  bf16* y = blockIdx.y == 0 ? y0 : y1;
  const int dh = blockIdx.y == 0 ? dh0 : dh1;
  const int G = Hq / Hkv, chunks = dh / 8;
  const long long R = (long long)S * G;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // chunk of y
  if (i >= (long long)B * Hkv * R * chunks) return;
  const long long row = i / chunks;  // over every slab
  const int bh = (int)(row / R), r = (int)(row % R), c = (int)(i % chunks);
  reinterpret_cast<uint4*>(y)[i] = *reinterpret_cast<const uint4*>(
      x + row_offset(bh / Hkv, r, G, bh % Hkv, S, Hq, dh) + 8 * c);
}

// ---------------------------------------------------------------------------
// fp32 on Hopper's tensor cores: three-pass TF32 (tf32x3) on wgmma, fed by TMA
//
// Every fp32 product a.b of the three kernels is a_hi.b_hi + a_hi.b_lo +
// a_lo.b_hi on wgmma ...f32.tf32.tf32 with fp32 sums, where hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest (cvt.rna, as CUTLASS's fast-fp32
// operator rounds): x - hi - lo is below 2^-22 |x| and the dropped a_lo.b_lo
// below 2^-22 |a.b|, so each product keeps close to fp32's 24 bits.
//
// A split pass (flash_x3_split_kernel) writes hi and lo of every operand
// once a call, in the layouts wgmma reads, into the wrapper's scratch:
//  * row-major "rows" tensors [2][B*Hkv][rows][dh] (hi, then lo): the query
//    rows r = s*G + g of one kv head laid out one after another (GroupRows),
//    and the keys of one kv head.  A tile is then 64 consecutive rows of one
//    kv head for every G, with no tail of masked rows for a G that does not
//    divide 64 and no case for G > 64.
//  * transposed tensors [2][B*Hkv][dh][Np] for the four B operands that are
//    MN-major as stored (V in O += P.V, K in dQ += dS.K, dO and Q in dV +=
//    P^T.dO and dK += dS^T.Q): tf32 wgmma reads shared memory K-major only.
// Rounding hi explicitly means nothing rests on how the tensor cores read
// the low 13 bits of an fp32 operand, and the producer does no arithmetic;
// the price is one more pass over the inputs in device memory.
//
// The kernels (forward, dQ, and dK/dV, every head dim and GQA group):
//  * Warp-specialised: two consumer warpgroups own 64 rows (query rows, or
//    keys in dK/dV) each, and one thread of the producer warpgroup keeps a
//    ring of shared-memory slots filled by TMA.  A slot holds one "unit": a
//    32-column chunk of the 128 A rows and of a 64-row B tile, hi and lo (S,
//    dP and their transposes are summed over the head dim one chunk at a
//    time), or a 64-column chunk of a transposed B tile over 64 keys (or
//    rows), hi and lo (the update of O, dQ, dK or dV).  Q, K, V and dO all
//    stream through the ring: fp32 hi and lo of 64 rows at dh 256 are 128
//    KB, too many to keep resident next to a ring in 227 KB.  A consumer
//    commits each S (or dP) unit's wgmmas as a group and frees a slot once
//    the group after it is issued (X3Ring), so at most two slots are held
//    and the rest are loads in flight.
//  * P (or dS, or their transposes) goes to the warpgroup's own hi/lo tile
//    in shared memory, the A operand of the update.  The tf32 A fragment in
//    registers is not the accumulator's layout, and hi/lo fragments of a 64
//    x 64 tile would hold 64 registers a thread for the whole update.
//  * The tensor cores sum a chain of wgmmas into their accumulator
//    truncating each step, a bias towards zero of up to an ulp a step: over
//    the 6,144 steps of a dK/dV accumulator at 16,384 rows that is some 2e-4
//    of the result.  So each update unit sums into fresh accumulators that
//    join the thread's O (dQ, dK or dV) by fp32 adds, rounded to nearest
//    (x3_update).  The a_hi.b_hi terms of an update are summed apart from
//    the cross terms, 2^-11 of their size, so that the chain that truncates
//    at the result's scale is a third as long (8 steps, up to dh 128), and
//    so are those of the S and dP products up to dh 192 (dh / 8 steps;
//    above, where the registers are not there, 3 dh / 8).
//  * Registers: the O (dQ, dK or dV) accumulator is ceil(dh/64) x 32 fp32 a
//    thread, 128 at dh 256, beside one product at a time (S, dP or the
//    update's; 32 or 64 registers): P is staged before dP is summed, and dS
//    is formed from the staged P (x3_staged).  The producer warpgroup gives
//    its registers to the consumers (setmaxnreg: 24 and 240).  dK and dV
//    are accumulated by separate blocks (grid z): each recomputes S^T (the
//    dV block needs no dP^T), five products a tile for the pair instead of
//    four, where holding both needs 256 registers at dh 256.
//  * The backward cuts a long walk over key (row) tiles into chunks, each
//    its own block, and adds the chunks' partial sums in a last kernel
//    (X3Walk): under a causal mask one wave of blocks would otherwise wait
//    on the longest walk.
//  * Every sum keeps a fixed order and no float atomics are used, so two
//    backward runs give equal bits.
// What bounds it: operations on the tensor cores, at 495 / 3 = 165 TFLOP/s
// for fp32 products in three TF32 passes; the streamed hi and lo tiles put
// some 32 operations a byte through the L2 in the S and dP products.
// ---------------------------------------------------------------------------
constexpr int kX3Box = 64 * 32 * 4;  // bytes of one [64][32] fp32 box (8 KB)
// The cross terms in accumulators of their own, where a second 32-register
// accumulator fits beside O: in S and dP (x3_product) up to dh 192, in the
// update (x3_update), whose chain is short, up to dh 128.
__host__ __device__ constexpr bool x3_two_products(int OC) { return OC <= 3; }
__host__ __device__ constexpr bool x3_two_updates(int OC) { return OC <= 2; }
constexpr int kX3Slots = 3;          // ring depth
constexpr int kX3SlotBytes = 6 * kX3Box;  // an S unit: A hi, lo (128 rows), B hi, lo
constexpr int kX3Threads = 3 * 128;  // the producer warpgroup and two consumers
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 <= 65,536
constexpr int kX3ProducerRegs = 24;
constexpr int kX3ConsumerRegs = 240;

struct X3Smem {
  alignas(1024) char slot[kX3Slots][kX3SlotBytes];
  alignas(1024) char pa[kConsumers][4 * kX3Box];  // a consumer's A tile: hi, lo
  uint64_t full[kX3Slots], empty[kX3Slots];
};

// The 64-wide B tiles a block walks: the key tiles of a 128-row block
// (forward, dQ) or the row tiles of a 128-key block (dK/dV) that the causal
// and window masks leave visible, from tile `first`, `n` of them.  The
// backward cuts a walk into chunks of kX3Chunk tiles, each its own block:
// under a causal mask the longest walk is twice the mean and, with B * Hkv
// small, one block of it would set the time of a kernel of one wave.  The
// chunks' partial sums are added in chunk order by a reduction kernel.
constexpr int kX3Chunk = 16;
struct X3Walk {
  int first, n;
};
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline X3Walk x3_key_walk(int r0, int Sq, int Sk, int G, int causal,
                                              int window) {
  const int R = Sq * G;
  const int p_lo = r0 / G, p_hi = (imin(R, r0 + kBlockRows) - 1) / G;
  const int key_lo = window > 0 ? imax(0, p_lo - window + 1) : 0;
  const int key_hi = causal ? imin(Sk - 1, p_hi) : Sk - 1;
  const int first = key_lo / 64;
  return {first, key_hi >= key_lo ? key_hi / 64 - first + 1 : 0};
}
__host__ __device__ inline X3Walk x3_row_walk(int k0, int Sq, int Sk, int G, int causal,
                                              int window) {
  const int R = Sq * G;
  const int k_last = imin(Sk, k0 + kBlockRows) - 1;
  const int p_min = causal ? k0 : 0;  // query positions that can see a key of the block
  const int p_max = window > 0 ? imin(Sq - 1, k_last + window - 1) : Sq - 1;
  const int first = imin(p_min, Sq) * G / 64;
  const int end = imin(R, (p_max + 1) * G);
  return {first, end > first * 64 ? (end - first * 64 + 63) / 64 : 0};
}
// chunks of a walk (a walk of no tile is one chunk, which writes zeros)
__host__ __device__ constexpr int x3_chunks(int n) {
  return n > kX3Chunk ? (n + kX3Chunk - 1) / kX3Chunk : 1;
}

// the maps of one launch: a1 . b1^T, then a2 . b2^T (dP), then updates
// from u (u2 in the dK blocks of the dK/dV kernel)
struct X3Maps {
  CUtensorMap a1, b1, a2, b2, u, u2;
};

// The query rows of one kv head: row r = s * G + g is position s of head
// kvh * G + g.  The tf32x3 kernels and the split pass map rows with it
// (keys are the case G = 1, H = Hkv).
struct GroupRows {
  int b, kvh, G, S, H, dh;
  __device__ int pos(int r) const { return r / G; }
  __device__ int head(int r) const { return kvh * G + r % G; }
  // offset of the row's first element in a [B,S,H,dh] tensor
  __device__ size_t offset(int r) const { return row_offset(b, r, G, kvh, S, H, dh); }
  // index of the row in a [B,H,S] tensor (the logsumexp)
  __device__ size_t lse_index(int r) const { return ((size_t)b * H + head(r)) * S + pos(r); }
};

// x [B,S,H,dx] (H = Hkv * G, dx <= dh) into hi and lo, zeros in the columns
// from dx to dh (the values' past dv): the rows tensor [2][B*Hkv][S*G][dh]
// (rows_out) and the transposed one [2][B*Hkv][dh][Np] (cols_out, zeros past
// S*G); either may be null.  grid (ceil(max(S*G, Np) / 32), ceil(dh / 32),
// B*Hkv), 256 threads: a 32 x 32 tile through shared memory, so that both
// writes are coalesced.
__global__ void __launch_bounds__(256)
flash_x3_split_kernel(const float* __restrict__ x, float* __restrict__ rows_out,
                      float* __restrict__ cols_out, int S, int H, int Hkv, int dh, int dx,
                      int Np) {
  __shared__ float tile[32][33];
  const int bh = blockIdx.z;
  const GroupRows g{bh / Hkv, bh % Hkv, H / Hkv, S, H, dx};
  const int R = S * g.G;
  const int r0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, d = d0 + tx;
    const float v = r < R && d < dx ? x[g.offset(r) + d] : 0.f;
    tile[i][tx] = v;
    if (rows_out != nullptr && r < R && d < dh) {
      const size_t at = ((size_t)bh * R + r) * dh + d;
      const uint32_t hi = tf32_rna(v);
      rows_out[at] = __uint_as_float(hi);
      rows_out[(size_t)gridDim.z * R * dh + at] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
    }
  }
  if (cols_out == nullptr) return;
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int d = d0 + i, p = r0 + tx;
    if (d >= dh || p >= Np) continue;
    const float v = tile[tx][i];
    const size_t at = ((size_t)bh * dh + d) * Np + p;
    const uint32_t hi = tf32_rna(v);
    cols_out[at] = __uint_as_float(hi);
    cols_out[(size_t)gridDim.z * dh * Np + at] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
  }
}

// Per row of the rows layout ([B*Hkv][R64], zeros past S*G): lse * log2(e)
// and D = rowsum(dO * O) over o's and dout's dv columns, one warp a row,
// summed in a fixed order.
__global__ void __launch_bounds__(256)
flash_x3_row_stats_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                          const float* __restrict__ lse, float* __restrict__ lse2,
                          float* __restrict__ delta, int Sq, int Hq, int Hkv, int dv, int R64,
                          int BH) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (w >= BH * R64) return;
  const int bh = w / R64, r = w % R64;
  const GroupRows g{bh / Hkv, bh % Hkv, Hq / Hkv, Sq, Hq, dv};
  float acc = 0.f, l2 = 0.f;
  if (r < Sq * g.G) {
    const size_t off = g.offset(r);
    for (int d = lane; d < dv; d += 32) acc = fmaf(dout[off + d], o[off + d], acc);
    l2 = lse[g.lse_index(r)] * kLog2e;
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    lse2[w] = l2;
    delta[w] = acc;
  }
}

// The producer (one thread): for each of n_tiles B tiles of 64 rows from
// n_first, the ncs S units of a1/b1 (A: the block's 128 rows from m0), the
// ncs dP units of a2/b2 when `two`, then the OC update units of `u`.
__device__ void x3_produce(X3Smem& sm, const X3Maps& m, const CUtensorMap* u_map, int n_tiles,
                           int n_first, int ncs, int two, int OC, int m0, int bh) {
  int u = 0;
  auto take = [&](uint32_t bytes) {
    const int s = u % kX3Slots;
    if (u >= kX3Slots) mbar_wait(&sm.empty[s], (u / kX3Slots - 1) & 1);
    mbar_arrive_expect_tx(&sm.full[s], bytes);
    ++u;
    return s;
  };
  for (int i = 0; i < n_tiles; ++i) {
    const int n0 = (n_first + i) * 64;
    for (int ph = 0; ph <= two; ++ph) {
      const CUtensorMap* a = ph ? &m.a2 : &m.a1;
      const CUtensorMap* b = ph ? &m.b2 : &m.b1;
      for (int c = 0; c < ncs; ++c) {
        const int s = take(kX3SlotBytes);
        char* base = sm.slot[s];
        for (int hl = 0; hl < 2; ++hl) {
          tma_load_4d(base + 2 * hl * kX3Box, a, &sm.full[s], 32 * c, m0, bh, hl);
          tma_load_4d(base + (4 + hl) * kX3Box, b, &sm.full[s], 32 * c, n0, bh, hl);
        }
      }
    }
    for (int o = 0; o < OC; ++o) {
      const int s = take(4 * kX3Box);
      char* base = sm.slot[s];
      for (int hl = 0; hl < 2; ++hl)
        for (int bx = 0; bx < 2; ++bx)
          tma_load_4d(base + (2 * hl + bx) * kX3Box, u_map, &sm.full[s], n0 + 32 * bx, 64 * o,
                      bh, hl);
    }
  }
}

// A consumer warpgroup's walk over the ring: one unit at a time, each
// unit's wgmmas one commit group; a slot is freed once the group after its
// own has been issued and the one before has completed.
struct X3Ring {
  int u = 0, pending = -1;
  __device__ int acquire(uint64_t* full) {
    const int s = u % kX3Slots;
    mbar_wait(&full[s], (u / kX3Slots) & 1);
    ++u;
    return s;
  }
  __device__ void release(uint64_t* empty, int s, int lane) {
    if (s < 0) return;
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // one arrival per consumer warp
  }
  __device__ void retire(uint64_t* empty, int s, int lane) {
    wgmma_commit();
    wgmma_wait<1>();
    release(empty, pending, lane);
    pending = s;
  }
  __device__ void drain(uint64_t* empty, int lane) {
    wgmma_wait<0>();
    release(empty, pending, lane);
    pending = -1;
  }
};

// A . B^T over the head dim, this warpgroup's 64 A rows (box cw of each
// unit) against the unit's 64 B rows: ncs units of 32 columns, ksteps (dh /
// 8) k-steps of 8 in all, each as three passes.  With kTwo the a_hi.b_hi
// terms sum into big and the cross terms into small (x3_finish adds them);
// without, all three into big.  The last group is left pending.
template <bool kTwo>
__device__ __forceinline__ void x3_product(float (&big)[32], float (&small)[32], X3Ring& ring,
                                           X3Smem& sm, int cw, int ncs, int ksteps, bool active,
                                           int lane) {
  for (int c = 0; c < ncs; ++c) {
    const int s = ring.acquire(sm.full);
    if (active) {
      const uint64_t d = wgmma_desc(sm.slot[s]);  // 16-byte units: a box is kX3Box / 16
      const uint64_t ah = d + cw * (kX3Box / 16), al = d + (2 + cw) * (kX3Box / 16);
      const uint64_t bh = d + 4 * (kX3Box / 16), bl = d + 5 * (kX3Box / 16);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * c + j < ksteps) {  // past dh the chunk is TMA's zeros
          if constexpr (kTwo) {
            wgmma_tf32_ss_64x64(small, ah + 2 * j, bl + 2 * j, c + j > 0);
            wgmma_tf32_ss_64x64(small, al + 2 * j, bh + 2 * j);
          } else {
            wgmma_tf32_ss_64x64(big, ah + 2 * j, bl + 2 * j, c + j > 0);
            wgmma_tf32_ss_64x64(big, al + 2 * j, bh + 2 * j);
          }
          wgmma_tf32_ss_64x64(big, ah + 2 * j, bh + 2 * j, kTwo ? c + j > 0 : 1);
        }
    }
    ring.retire(sm.empty, s, lane);
  }
}

// The product of x3_product once its last group is done (big += small).
template <bool kTwo>
__device__ __forceinline__ void x3_finish(float (&big)[32], float (&small)[32], X3Ring& ring,
                                          X3Smem& sm, int lane) {
  ring.drain(sm.empty, lane);
  fence_regs(big);
  if constexpr (kTwo) {
    fence_regs(small);
#pragma unroll
    for (int e = 0; e < 32; ++e) big[e] += small[e];
  }
}

// A 64 x 64 fp32 accumulator (P, dS or their transposes) as the hi and lo
// tf32 tiles of an update's A operand: two boxes of 32 columns each,
// 128-byte rows under the 128-byte swizzle, as TMA would write them.  The
// caller brackets it with barriers: before, every reader of the last tile
// is past its update; after, the tile is whole.
__device__ __forceinline__ void x3_stage_a(const float (&x)[32], char* pa, int warp, int lane) {
  const int c = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + lane / 4 + 8 * h;
      const float v0 = x[4 * j + 2 * h], v1 = x[4 * j + 2 * h + 1];
      const uint32_t h0 = tf32_rna(v0), h1 = tf32_rna(v1);
      const uint32_t l0 = tf32_rna(v0 - __uint_as_float(h0)), l1 = tf32_rna(v1 - __uint_as_float(h1));
      // columns 8j + 2c, +1: box j / 4, byte 32 (j % 4) + 8c of the row
      const uint32_t at = (j / 4) * kX3Box + swizzle128(row, 2 * (j % 4) + c / 2) + 8 * (c % 2);
      *reinterpret_cast<uint2*>(pa + at) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(pa + 2 * kX3Box + at) = make_uint2(l0, l1);
    }
  fence_proxy_async();
}

// Element e of this thread's 64 x 64 accumulator as staged by x3_stage_a
// (hi + lo, within 2^-22 of the value staged).
__device__ __forceinline__ float x3_staged(const char* pa, int e, int warp, int lane) {
  const int j = e / 4, c = lane % 4, row = 16 * warp + lane / 4 + 8 * ((e >> 1) & 1);
  const uint32_t at =
      (j / 4) * kX3Box + swizzle128(row, 2 * (j % 4) + c / 2) + 8 * (c % 2) + 4 * (e & 1);
  return *reinterpret_cast<const float*>(pa + at) +
         *reinterpret_cast<const float*>(pa + 2 * kX3Box + at);
}

// acc += X . Bt over one update unit: X this warpgroup's staged A tile
// (x3_stage_a); Bt 64 columns of the transposed operand over the tile's 64
// keys (or rows), two boxes of 32 along K.  The x_hi.b_hi terms and the
// two cross terms sum into fresh accumulators, which join acc by fp32 adds:
// apart with kTwo, else all three in one.  The unit is drained before its
// slot is freed.
template <bool kTwo>
__device__ __forceinline__ void x3_update(float (&acc)[32], const char* pa, X3Ring& ring,
                                          X3Smem& sm, bool active, int lane) {
  const int s = ring.acquire(sm.full);
  if (active) {
    // descriptors step in 16-byte units: a box is kX3Box / 16, a k-step 2
    const uint64_t a = wgmma_desc(pa), b = wgmma_desc(sm.slot[s]);
    constexpr int kLo = 2 * kX3Box / 16;
    if constexpr (kTwo) {
      float big[32], small[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int off = (kk / 4) * (kX3Box / 16) + 2 * (kk % 4);
        wgmma_tf32_ss_64x64(small, a + kLo + off, b + off, kk > 0);
        wgmma_tf32_ss_64x64(small, a + off, b + kLo + off);
        wgmma_tf32_ss_64x64(big, a + off, b + off, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(big);
      fence_regs(small);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += big[e] + small[e];
    } else {
      float part[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int off = (kk / 4) * (kX3Box / 16) + 2 * (kk % 4);
        wgmma_tf32_ss_64x64(part, a + kLo + off, b + off, kk > 0);
        wgmma_tf32_ss_64x64(part, a + off, b + kLo + off);
        wgmma_tf32_ss_64x64(part, a + off, b + off);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += part[e];
    }
  }
  ring.release(sm.empty, s, lane);
}

// The kernels' common start: barriers, then the producer warpgroup (one
// thread issuing every load) and the consumers part, with their registers.
__device__ __forceinline__ bool x3_start(X3Smem& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kX3Slots; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    warpgroup_reg_dealloc<kX3ProducerRegs>();
    return true;
  }
  warpgroup_reg_alloc<kX3ConsumerRegs>();
  return false;
}

// forward: O over the dh columns of V's split (zeros past dv), out written
// at dv.  grid: (B*Hkv, ceil(Sq*G / 128)), heaviest row tiles first
template <int OC>
__global__ void __launch_bounds__(kX3Threads, 1)
flash_fwd_x3_kernel(const __grid_constant__ X3Maps maps, float* __restrict__ o,
                    float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int dh, int dv,
                    int causal, int window, float scale) {
  constexpr bool kTwo = x3_two_products(OC), kTwoU = x3_two_updates(OC);
  extern __shared__ char smem_raw[];
  X3Smem& sm = smem_layout<X3Smem>(smem_raw);
  const int G = Hq / Hkv, R = Sq * G;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = tile * kBlockRows;
  const int bh = blockIdx.x;
  const GroupRows rows{bh / Hkv, bh % Hkv, G, Sq, Hq, dh};
  const X3Walk walk = x3_key_walk(r0, Sq, Sk, G, causal, window);
  const int t_first = walk.first, n_tiles = walk.n;
  const int ncs = (dh + 31) / 32;

  if (x3_start(sm)) {
    if (threadIdx.x == 0)
      x3_produce(sm, maps, &maps.u, n_tiles, t_first, ncs, 0, OC, r0, bh);
    return;
  }
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int rw0 = r0 + cw * 64;  // this warpgroup's first row
  const int r_lo = rw0 + 16 * warp + lane / 4;  // this thread's rows: r_lo, r_lo + 8
  const int pos[2] = {rows.pos(r_lo), rows.pos(r_lo + 8)};
  const int wp_lo = rows.pos(rw0), wp_hi = rows.pos(max(rw0, min(R, rw0 + 64) - 1));
  const int col = 2 * (lane % 4);
  const float sc = scale * kLog2e;  // exp(x * scale) = exp2(x * sc)
  char* pa = sm.pa[cw];

  float oacc[OC][32];
#pragma unroll
  for (int c = 0; c < OC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) oacc[c][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  X3Ring ring;

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = (t_first + i) * 64;
    const bool active = rw0 < R && !tile_invisible(t0, 64, wp_lo, wp_hi, Sk, causal, window);
    float sacc[32], small[32];  // S = Q . K^T, 64 rows x 64 keys
    x3_product<kTwo>(sacc, small, ring, sm, cw, ncs, dh / 8, active, lane);
    x3_finish<kTwo>(sacc, small, ring, sm, lane);
    if (active) {
      if (tile_needs_mask(t0, 64, wp_lo, wp_hi, Sk, causal, window)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int key = t0 + 8 * (e / 4) + col + (e & 1);
          if (!visible(key, pos[(e >> 1) & 1], Sk, causal, window)) sacc[e] = -INFINITY;
        }
      }
      // online softmax over the quad's rows
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sacc[e]);
      float m_use[2], alpha[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float m_new = fmaxf(m_run[x], quad_max(mx[x]) * sc);
        // rows that have seen no visible key keep m = -inf, l = 0, O = 0
        m_use[x] = m_new == -INFINITY ? 0.f : m_new;
        alpha[x] = fast_exp2(m_run[x] - m_use[x]);
        m_run[x] = m_new;
        l_run[x] *= alpha[x];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int x = (e >> 1) & 1;
        const float p = fast_exp2(sacc[e] * sc - m_use[x]);
        l_run[x] += p;
        sacc[e] = p;
      }
#pragma unroll
      for (int c = 0; c < OC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) oacc[c][e] *= alpha[(e >> 1) & 1];
      named_barrier(1 + cw, 128);  // every warp is past the last tile's update
      x3_stage_a(sacc, pa, warp, lane);  // P
      named_barrier(1 + cw, 128);
    }
#pragma unroll
    for (int c = 0; c < OC; ++c) x3_update<kTwoU>(oacc[c], pa, ring, sm, active, lane);
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float l = quad_sum(l_run[x]);
    const int r = r_lo + 8 * x;
    if (r >= R) continue;  // rows past Sq write nothing
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const size_t off = row_offset(rows.b, r, G, rows.kvh, Sq, Hq, dv);
#pragma unroll
    for (int c = 0; c < OC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = 64 * c + 8 * j + col;
        if (cc < dv)
          *reinterpret_cast<float2*>(o + off + cc) =
              make_float2(oacc[c][4 * j + 2 * x] * inv, oacc[c][4 * j + 2 * x + 1] * inv);
      }
    if (lane % 4 == 0) lse[rows.lse_index(r)] = l > 0.f ? (m_run[x] + log2f(l)) * kLn2 : -INFINITY;
  }
}

// backward, dQ: one chunk of a row block's key walk, its partial sum into
// dq_part [chunks][B*Hkv][Sq*G][dh] (unscaled).  lse2 and delta are the
// split's per-row stats ([B*Hkv][R64]).  grid: (B*Hkv, ceil(Sq*G / 128) *
// chunks), heaviest row blocks first.
template <int OC>
__global__ void __launch_bounds__(kX3Threads, 1)
flash_bwd_dq_x3_kernel(const __grid_constant__ X3Maps maps, const float* __restrict__ lse2,
                       const float* __restrict__ delta, float* __restrict__ dq_part, int Sq,
                       int Sk, int Hq, int Hkv, int dh, int causal, int window, float scale,
                       int R64, int chunks) {
  constexpr bool kTwo = x3_two_products(OC), kTwoU = x3_two_updates(OC);
  extern __shared__ char smem_raw[];
  X3Smem& sm = smem_layout<X3Smem>(smem_raw);
  const int G = Hq / Hkv, R = Sq * G;
  const int n_blocks = (R + kBlockRows - 1) / kBlockRows;
  const int rb = blockIdx.y / chunks, chunk = blockIdx.y % chunks;
  const int r0 = (causal ? n_blocks - 1 - rb : rb) * kBlockRows;
  const int bh = blockIdx.x;
  const GroupRows rows{bh / Hkv, bh % Hkv, G, Sq, Hq, dh};
  const X3Walk walk = x3_key_walk(r0, Sq, Sk, G, causal, window);
  if (chunk >= x3_chunks(walk.n)) return;
  const int t_first = walk.first + chunk * kX3Chunk;
  const int n_tiles = imin(kX3Chunk, walk.n - chunk * kX3Chunk);
  const int ncs = (dh + 31) / 32;

  if (x3_start(sm)) {
    if (threadIdx.x == 0) x3_produce(sm, maps, &maps.u, n_tiles, t_first, ncs, 1, OC, r0, bh);
    return;
  }
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int rw0 = r0 + cw * 64;  // this warpgroup's first row
  const int r_lo = rw0 + 16 * warp + lane / 4;
  const int pos[2] = {rows.pos(r_lo), rows.pos(r_lo + 8)};
  const int wp_lo = rows.pos(rw0), wp_hi = rows.pos(max(rw0, min(R, rw0 + 64) - 1));
  const int col = 2 * (lane % 4);
  const float sc = scale * kLog2e;
  char* pa = sm.pa[cw];
  float L[2], D[2];  // lse * log2(e) and D of this thread's two rows
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = r_lo + 8 * x;
    L[x] = r < R ? lse2[(size_t)bh * R64 + r] : 0.f;
    D[x] = r < R ? delta[(size_t)bh * R64 + r] : 0.f;
  }

  float dqacc[OC][32];
#pragma unroll
  for (int c = 0; c < OC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dqacc[c][e] = 0.f;
  X3Ring ring;

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = (t_first + i) * 64;
    const bool active = rw0 < R && !tile_invisible(t0, 64, wp_lo, wp_hi, Sk, causal, window);
    // S = Q . K^T, then P, staged; then dP = dO . V^T in the same registers
    // (one product beside the dQ accumulator at a time) and dS from the
    // staged P
    float prod[32], small[32];
    x3_product<kTwo>(prod, small, ring, sm, cw, ncs, dh / 8, active, lane);
    x3_finish<kTwo>(prod, small, ring, sm, lane);
    named_barrier(1 + cw, 128);  // every warp is past the last tile's update
    if (active) {
      const bool masked = tile_needs_mask(t0, 64, wp_lo, wp_hi, Sk, causal, window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int x = (e >> 1) & 1;
        const int key = t0 + 8 * (e / 4) + col + (e & 1);
        const bool ok = !masked || visible(key, pos[x], Sk, causal, window);
        prod[e] = ok ? fast_exp2(prod[e] * sc - L[x]) : 0.f;  // P
      }
      x3_stage_a(prod, pa, warp, lane);
    }
    x3_product<kTwo>(prod, small, ring, sm, cw, ncs, dh / 8, active, lane);
    x3_finish<kTwo>(prod, small, ring, sm, lane);
    if (active) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        prod[e] = x3_staged(pa, e, warp, lane) * (prod[e] - D[(e >> 1) & 1]);  // dS
      x3_stage_a(prod, pa, warp, lane);
    }
    named_barrier(1 + cw, 128);
#pragma unroll
    for (int c = 0; c < OC; ++c) x3_update<kTwoU>(dqacc[c], pa, ring, sm, active, lane);
  }

  float* out = dq_part + ((size_t)chunk * gridDim.x + bh) * R * dh;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = r_lo + 8 * x;
    if (r >= R) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = 64 * c + 8 * j + col;
        if (cc < dh)
          *reinterpret_cast<float2*>(out + (size_t)r * dh + cc) =
              make_float2(dqacc[c][4 * j + 2 * x], dqacc[c][4 * j + 2 * x + 1]);
      }
  }
}

// backward, dK (blockIdx.z 1) or dV (0): one chunk of a key block's row
// walk, its partial sum into dk_part or dv_part [chunks][B*Hkv][Sk][dh]
// (unscaled).  Keys are the M dimension: S^T = K . Q^T (and, for dK, dP^T =
// V . dO^T), then dV += P^T . dO or dK += dS^T . Q from the transposed dO
// or Q.  grid: (B*Hkv, ceil(Sk / 128) * chunks, 2); the first key blocks,
// which see the most rows under causal, launch first.
template <int OC>
__global__ void __launch_bounds__(kX3Threads, 1)
flash_bwd_dkdv_x3_kernel(const __grid_constant__ X3Maps maps, const float* __restrict__ lse2,
                         const float* __restrict__ delta, float* __restrict__ dk_part,
                         float* __restrict__ dv_part, int Sq, int Sk, int Hq, int Hkv, int dh,
                         int causal, int window, float scale, int R64, int chunks) {
  constexpr bool kTwo = x3_two_products(OC), kTwoU = x3_two_updates(OC);
  extern __shared__ char smem_raw[];
  X3Smem& sm = smem_layout<X3Smem>(smem_raw);
  const int G = Hq / Hkv, R = Sq * G;
  const int want_dk = blockIdx.z;
  const int chunk = blockIdx.y % chunks;
  const int k0 = blockIdx.y / chunks * kBlockRows;
  const int bh = blockIdx.x;
  const GroupRows rows{bh / Hkv, bh % Hkv, G, Sq, Hq, dh};
  const X3Walk walk = x3_row_walk(k0, Sq, Sk, G, causal, window);
  if (chunk >= x3_chunks(walk.n)) return;
  const int row_first = (walk.first + chunk * kX3Chunk) * 64;
  const int n_tiles = imin(kX3Chunk, walk.n - chunk * kX3Chunk);
  const int ncs = (dh + 31) / 32;

  if (x3_start(sm)) {
    if (threadIdx.x == 0)
      x3_produce(sm, maps, want_dk ? &maps.u2 : &maps.u, n_tiles, row_first / 64, ncs, want_dk,
                 OC, k0, bh);
    return;
  }
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int kw0 = k0 + cw * 64;  // this warpgroup's first key
  const int key_lo = kw0 + 16 * warp + lane / 4;  // this thread's keys: key_lo, key_lo + 8
  const int col = 2 * (lane % 4);
  const float sc = scale * kLog2e;
  char* pa = sm.pa[cw];

  float acc[OC][32];  // dK or dV of this thread's keys
#pragma unroll
  for (int c = 0; c < OC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  X3Ring ring;

  for (int i = 0; i < n_tiles; ++i) {
    const int rt0 = row_first + i * 64;
    const int tp_lo = rows.pos(rt0), tp_hi = rows.pos(min(R, rt0 + 64) - 1);
    // the tile's rows against this warpgroup's keys, with rows and keys
    // swapped in the tests of tile_invisible and tile_needs_mask
    const int kw_last = min(Sk, kw0 + 64) - 1;
    const bool active = !(kw0 >= Sk || (causal && tp_hi < kw0) ||
                          (window > 0 && kw_last <= tp_lo - window));
    const float* l2 = lse2 + (size_t)bh * R64 + rt0;  // the tile's rows (R64 covers them)
    const float* dl = delta + (size_t)bh * R64 + rt0;
    // S^T, then P^T, staged; for dK then dP^T in the same registers and dS^T
    // from the staged P^T, as in the dQ kernel
    float prod[32], small[32];
    x3_product<kTwo>(prod, small, ring, sm, cw, ncs, dh / 8, active, lane);
    x3_finish<kTwo>(prod, small, ring, sm, lane);
    named_barrier(1 + cw, 128);  // every warp is past the last tile's update
    if (active) {
      const bool masked = rt0 + 64 > R || kw0 + 64 > Sk || (causal && tp_lo < kw0 + 63) ||
                          (window > 0 && tp_hi - window + 1 > kw0);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int rl = 8 * (e / 4) + col + (e & 1);  // the row, within the tile
        const int r = rt0 + rl;
        const int key = key_lo + 8 * ((e >> 1) & 1);
        const bool ok = !masked || (r < R && visible(key, rows.pos(r), Sk, causal, window));
        prod[e] = ok ? fast_exp2(prod[e] * sc - l2[rl]) : 0.f;  // P^T
      }
      x3_stage_a(prod, pa, warp, lane);
    }
    if (want_dk) {
      x3_product<kTwo>(prod, small, ring, sm, cw, ncs, dh / 8, active, lane);
      x3_finish<kTwo>(prod, small, ring, sm, lane);
      if (active) {
#pragma unroll
        for (int e = 0; e < 32; ++e)  // dS^T
          prod[e] = x3_staged(pa, e, warp, lane) * (prod[e] - dl[8 * (e / 4) + col + (e & 1)]);
        x3_stage_a(prod, pa, warp, lane);
      }
    }
    named_barrier(1 + cw, 128);
#pragma unroll
    for (int c = 0; c < OC; ++c) x3_update<kTwoU>(acc[c], pa, ring, sm, active, lane);
  }

  float* out = (want_dk ? dk_part : dv_part) + ((size_t)chunk * gridDim.x + bh) * Sk * dh;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int key = key_lo + 8 * x;
    if (key >= Sk) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = 64 * c + 8 * j + col;
        if (cc < dh)
          *reinterpret_cast<float2*>(out + (size_t)key * dh + cc) =
              make_float2(acc[c][4 * j + 2 * x], acc[c][4 * j + 2 * x + 1]);
      }
  }
}

// The backward's partial sums added in chunk order, scaled, into dq
// [B,Sq,Hq,dh] (rows r of the rows layout), dk [B,Sk,Hkv,dh] and the first
// dvw columns of the dV sums into dv [B,Sk,Hkv,dvw]: one thread per 4 values.
__global__ void __launch_bounds__(256)
flash_x3_reduce_kernel(const float* __restrict__ dq_part, const float* __restrict__ dk_part,
                       const float* __restrict__ dv_part, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int Hq,
                       int Hkv, int dh, int dvw, int causal, int window, float scale) {
  const int G = Hq / Hkv, R = Sq * G, BH = gridDim.y;
  const int bh = blockIdx.y;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const long long nq = (long long)R * dh, nk = (long long)Sk * dh;
  const GroupRows rows{bh / Hkv, bh % Hkv, G, Sq, Hq, dh};
  if (i < nq) {  // dq
    const int r = (int)(i / dh), d = (int)(i % dh);
    const int rb0 = r / kBlockRows * kBlockRows;
    const int n = x3_chunks(x3_key_walk(rb0, Sq, Sk, G, causal, window).n);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < n; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(dq_part + ((size_t)c * BH + bh) * nq + i);
      t.x += p.x; t.y += p.y; t.z += p.z; t.w += p.w;
    }
    *reinterpret_cast<float4*>(dq + rows.offset(r) + d) =
        make_float4(t.x * scale, t.y * scale, t.z * scale, t.w * scale);
  }
  if (i < nk) {  // dk and dv
    const int key = (int)(i / dh), d = (int)(i % dh);
    const int kb0 = key / kBlockRows * kBlockRows;
    const int n = x3_chunks(x3_row_walk(kb0, Sq, Sk, G, causal, window).n);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    for (int c = 0; c < n; ++c) {
      const size_t at = ((size_t)c * BH + bh) * nk + i;
      const float4 p = *reinterpret_cast<const float4*>(dk_part + at);
      const float4 q = *reinterpret_cast<const float4*>(dv_part + at);
      a.x += p.x; a.y += p.y; a.z += p.z; a.w += p.w;
      b.x += q.x; b.y += q.y; b.z += q.z; b.w += q.w;
    }
    const size_t row = ((size_t)rows.b * Sk + key) * Hkv + rows.kvh;
    *reinterpret_cast<float4*>(dk + row * dh + d) =
        make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
    if (d < dvw) *reinterpret_cast<float4*>(dv + row * dvw + d) = b;  // dvw % 8 == 0
  }
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------
struct Shape {
  int B, Sq, Sk, Hq, Hkv, dh, dv, causal, window;  // v [B,Sk,Hkv,dv], dv <= dh
  float scale;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// bf16 through wgmma: scratch, tensor maps, shared memory and grids

// 64-column chunks of the padded head dim
int wgmma_chunks(int dh) { return (pad16(dh) + kChunk - 1) / kChunk; }

// The scratch of one wgmma call, carved from `base` (sizes only when base is
// null), in floats: at kRows the gathered copies of q, [B*Hkv][Sq*G][dh]
// bf16, and (backward) of dout, [B*Hkv][Sq*G][dv]; then the backward's delta
// [B,Hq,Sq]; or, where the fused kernels take the call (fused_bwd), lse *
// log2(e) and delta in the rows' order, [B*Hkv][n_rt * 64] each (n_rt row
// tiles of 64), the fp32 dQ accumulator [B*Hkv][n_rt][DC * 64 * 64] and the
// int counters [B*Hkv][n_rt] with the ticket after them.  Each part starts
// 16-byte aligned (every size is rounded up to 4 floats), as TMA and the
// bulk copies need.
struct WgWork {
  bf16 *q = nullptr, *dout = nullptr;
  float *delta = nullptr, *lse2_rows = nullptr;
  float* dq_acc = nullptr;
  int* counters = nullptr;  // n_counters, then the ticket
  size_t floats = 0, n_counters = 0;
  WgWork(const Shape& s, void* base, bool rows, bool backward) {
    const size_t rows_floats = rows ? (size_t)s.B * s.Hq * s.Sq * s.dh / 2 : 0;
    auto take = [&](size_t n) {
      void* p = base == nullptr ? nullptr : static_cast<float*>(base) + floats;
      floats += (n + 3) / 4 * 4;
      return p;
    };
    q = static_cast<bf16*>(take(rows_floats));
    if (!backward) return;
    dout = static_cast<bf16*>(take(rows ? (size_t)s.B * s.Hq * s.Sq * s.dv / 2 : 0));
    const int dc = wgmma_chunks(s.dh);
    if (!fused_bwd(dc, wgmma_chunks(s.dv))) {
      delta = static_cast<float*>(take((size_t)s.B * s.Hq * s.Sq));
      return;
    }
    const size_t n_rt = ((size_t)s.Sq * (s.Hq / s.Hkv) + kBwdRows - 1) / kBwdRows;
    n_counters = (size_t)s.B * s.Hkv * n_rt;
    lse2_rows = static_cast<float*>(take(n_counters * kBwdRows));
    delta = static_cast<float*>(take(n_counters * kBwdRows));
    dq_acc = static_cast<float*>(take(n_counters * dc * kDqTileFloats));
    counters = static_cast<int*>(take(n_counters + 1));
  }
};

// 16-byte chunks of the gathered copy of one tensor, and its gather's grid
long long rows_chunks(const Shape& s) { return (long long)s.B * s.Hq * s.Sq * (s.dh / 8); }
long long rows_gather_blocks(const Shape& s) { return (rows_chunks(s) + 255) / 256; }

// q (and dout, where x1 is not null: dv wide) into the gathered copies
cudaError_t gather_rows(const void* x0, const void* x1, bf16* y0, bf16* y1, const Shape& s,
                        cudaStream_t st) {
  const dim3 grid((unsigned)rows_gather_blocks(s), x1 == nullptr ? 1 : 2);
  flash_rows_gather_kernel<<<grid, 256, 0, st>>>(static_cast<const bf16*>(x0),
                                                 static_cast<const bf16*>(x1), y0, y1, s.B, s.Sq,
                                                 s.Hq, s.Hkv, s.dh, s.dv);
  return cudaGetLastError();
}

// the maps of the row tensors (q at dh, dout at dv columns: boxes of 64 rows
// r = s*G + g; at kRows over their gathered copies) and of the key tensors (k
// at dh, v at dv columns: boxes of `keys` keys)
template <bool kRows>
bool row_map(CUtensorMap* m, const void* p, const Shape& s, int width) {
  const int G = s.Hq / s.Hkv;
  if constexpr (kRows)
    return make_map_bf16_4d(m, p, width, (uint64_t)s.Sq * G, (uint64_t)s.B * s.Hkv, 1, kWgRows,
                            1);
  else
    return make_map_bf16_4d(m, p, width, s.Hq, s.Sq, s.B, G, kWgRows / G);
}
bool key_map(CUtensorMap* m, const void* p, const Shape& s, int keys, int width) {
  return make_map_bf16_4d(m, p, width, s.Hkv, s.Sk, s.B, 1, keys);
}

// a grid over row blocks of `rows` rows
dim3 row_grid(const Shape& s, int rows) {
  const int G = s.Hq / s.Hkv;
  return dim3(s.B * s.Hkv, (s.Sq * G + rows - 1) / rows);
}

template <int DC, int DVC, bool kRows>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                             void* work, const Shape& s, cudaStream_t st) {
  if constexpr (kRows) {
    const WgWork w(s, work, true, false);
    const cudaError_t e = gather_rows(q, nullptr, w.q, nullptr, s, st);
    if (e != cudaSuccess) return e;
    q = w.q;
  }
  CUtensorMap qm, km, vm;
  if (!row_map<kRows>(&qm, q, s, s.dh) || !key_map(&km, k, s, fwd_keys(DVC), s.dh) ||
      !key_map(&vm, v, s, fwd_keys(DVC), s.dv))
    return cudaErrorInvalidValue;
  auto launch = [&](auto kern, size_t smem, dim3 grid) {
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, kWsThreads, smem, st>>>(
        qm, km, vm, static_cast<bf16*>(o), lse, s.Sq, s.Sk, s.Hq, s.Hkv, s.dv, s.causal,
        s.window, s.scale);
    return cudaGetLastError();
  };
  if constexpr (fwd_pingpong(DC, DVC)) {
    static_assert(sizeof(FwdPpSmem<DC, DVC>) + 1024 <= kSmemPerBlock,
                  "ping-pong forward layout over 227 KB");
    static_assert(fwd_keys(DVC) == kPpKeys, "the maps' boxes are the ping-pong tile's keys");
    const dim3 g = row_grid(s, kBlockRows);
    return launch(flash_fwd_pp_wgmma_kernel<DC, DVC, kRows>, sizeof(FwdPpSmem<DC, DVC>) + 1024,
                  dim3(g.y, g.x));
  } else {
    static_assert(DVC == DC, "the forward at (3, 2) is the ping-pong one");
    static_assert(sizeof(FwdWgSmem<DC>) + 1024 <= kSmemPerBlock, "forward layout over 227 KB");
    return launch(flash_fwd_wgmma_kernel<DC, kRows>, sizeof(FwdWgSmem<DC>) + 1024,
                  row_grid(s, kBlockRows));
  }
}

// streaming multiprocessors of the current device: the fused kernel's grid
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev] > 0 ? counts[dev] : 1;
}

// The fused backward (fused_bwd): the delta kernel, the counters and the
// ticket zeroed, the fused kernel, the dq conversion; the maps of q and
// dout (or their gathered copies) made by the caller, and the kv heads of a
// group of the fused kernel's tickets, hg (fused_item), chosen by the
// caller (flash_attention.ref.fused_heads_per_group).
template <int DC, int DVC, bool kRows>
cudaError_t launch_bwd_fused(const CUtensorMap& qm, const CUtensorMap& dom, const void* k,
                             const void* v, const float* lse, const WgWork& w, void* dq,
                             void* dk, void* dv, const Shape& s, int hg, cudaStream_t st) {
  CUtensorMap km, vm;
  if (!key_map(&km, k, s, kDqKeys, s.dh) || !key_map(&vm, v, s, kDqKeys, s.dv))
    return cudaErrorInvalidValue;
  static_assert(sizeof(DeltaWgSmem<DC, DVC>) + 1024 <= kSmemPerBlock, "delta layout over 227 KB");
  static_assert(sizeof(FusedWgSmem<DC, DVC>) + 1024 <= kSmemPerBlock, "fused layout over 227 KB");
  size_t smem = sizeof(DeltaWgSmem<DC, DVC>) + 1024;
  auto delta_kern = flash_bwd_delta_wgmma_kernel<DC, DVC, kRows>;
  cudaError_t e = allow_smem(delta_kern, smem);
  if (e != cudaSuccess) return e;
  constexpr int nc = dq_consumers(DC);
  dim3 grid = row_grid(s, nc * kWgRows);
  if constexpr (delta_rows_first(DC, DVC)) grid = dim3(grid.y, grid.x);
  delta_kern<<<grid, 128 * (1 + nc), smem, st>>>(
      qm, km, vm, dom, lse, w.lse2_rows, w.delta, s.Sq, s.Sk, s.Hq, s.Hkv, s.causal, s.window,
      s.scale);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaMemsetAsync(w.counters, 0, (w.n_counters + 1) * sizeof(int), st);
  if (e != cudaSuccess) return e;

  constexpr int keys = kv_keys(DC, DVC);
  if (!key_map(&km, k, s, keys, s.dh) || !key_map(&vm, v, s, keys, s.dv))
    return cudaErrorInvalidValue;
  smem = sizeof(FusedWgSmem<DC, DVC>) + 1024;
  auto kern = flash_bwd_fused_wgmma_kernel<DC, DVC, kRows>;
  e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const long long items = (long long)(s.Sk + keys - 1) / keys * s.B * s.Hkv;
  const int n_blocks = (int)(items < sm_count() ? items : sm_count());
  kern<<<n_blocks, kWsThreads, smem, st>>>(
      qm, km, vm, dom, w.lse2_rows, w.delta, w.dq_acc, w.counters, w.counters + w.n_counters,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), s.B, s.Sq, s.Sk, s.Hq, s.Hkv, s.dh, s.dv,
      s.causal, s.window, s.scale, hg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int n_rt = (int)(w.n_counters / ((size_t)s.B * s.Hkv));
  const long long total = (long long)w.n_counters * 32 * DC * 8;  // row pairs x column groups
  flash_bwd_dq_convert_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(w.dq_acc), w.counters, static_cast<bf16*>(dq), total, n_rt,
      DC, s.Sq, s.Hq, s.Hkv, s.dh, s.scale);
  return cudaGetLastError();
}

// The other pairs: the dQ kernel, which also writes delta, then the dK/dV
// kernel.
template <int DC, int DVC, bool kRows>
cudaError_t launch_bwd_dq_dkdv(const CUtensorMap& qm, const CUtensorMap& dom, const void* k,
                               const void* v, const float* lse, const WgWork& w, void* dq,
                               void* dk, void* dv, const Shape& s, cudaStream_t st) {
  CUtensorMap km, vm;
  if (!key_map(&km, k, s, kDqKeys, s.dh) || !key_map(&vm, v, s, kDqKeys, s.dv))
    return cudaErrorInvalidValue;
  static_assert(DVC == DC, "the dQ and dK/dV kernels take equal chunk counts");
  static_assert(sizeof(DqWgSmem<DC>) + 1024 <= kSmemPerBlock, "dQ layout over 227 KB");
  static_assert(sizeof(DkdvWgSmem<DC>) + 1024 <= kSmemPerBlock, "dK/dV layout over 227 KB");
  size_t smem = sizeof(DqWgSmem<DC>) + 1024;
  auto dq_kern = flash_bwd_dq_wgmma_kernel<DC, kRows>;
  cudaError_t e = allow_smem(dq_kern, smem);
  if (e != cudaSuccess) return e;
  constexpr int nc = dq_consumers(DC);
  dq_kern<<<row_grid(s, nc * kWgRows), 128 * (1 + nc), smem, st>>>(
      qm, km, vm, dom, lse, w.delta, static_cast<bf16*>(dq), s.Sq, s.Sk, s.Hq, s.Hkv, s.dh, s.dv,
      s.causal, s.window, s.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  constexpr int keys = kv_keys(DC, DC);
  if (!key_map(&km, k, s, keys, s.dh) || !key_map(&vm, v, s, keys, s.dv))
    return cudaErrorInvalidValue;
  smem = sizeof(DkdvWgSmem<DC>) + 1024;
  auto kv_kern = flash_bwd_dkdv_wgmma_kernel<DC, kRows>;
  e = allow_smem(kv_kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(s.B * s.Hkv, (s.Sk + keys - 1) / keys);
  kv_kern<<<grid, kWsThreads, smem, st>>>(qm, km, vm, dom, lse, w.delta, static_cast<bf16*>(dk),
                                          static_cast<bf16*>(dv), s.Sq, s.Sk, s.Hq, s.Hkv, s.dh,
                                          s.dv, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

template <int DC, int DVC, bool kRows>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, void* work, void* dq, void* dk, void* dv,
                             const Shape& s, int hg, cudaStream_t st) {
  const WgWork w(s, work, kRows, true);
  const void *qr = q, *dor = dout;  // what the row maps read
  if constexpr (kRows) {
    const cudaError_t e = gather_rows(q, dout, w.q, w.dout, s, st);
    if (e != cudaSuccess) return e;
    qr = w.q;
    dor = w.dout;
  }
  CUtensorMap qm, dom;
  if (!row_map<kRows>(&qm, qr, s, s.dh) || !row_map<kRows>(&dom, dor, s, s.dv))
    return cudaErrorInvalidValue;
  if constexpr (fused_bwd(DC, DVC))
    return launch_bwd_fused<DC, DVC, kRows>(qm, dom, k, v, lse, w, dq, dk, dv, s, hg, st);
  else
    return launch_bwd_dq_dkdv<DC, DVC, kRows>(qm, dom, k, v, lse, w, dq, dk, dv, s, st);
}

// the launchers above at the counts of column chunks of the keys and the
// values (bad_variant has refused every pair but these)
template <bool kRows>
cudaError_t launch_fwd_wgmma_dc(const void* q, const void* k, const void* v, void* o, float* lse,
                                void* work, const Shape& s, cudaStream_t st) {
  if (wgmma_chunks(s.dh) == 3 && wgmma_chunks(s.dv) == 2)
    return launch_fwd_wgmma<3, 2, kRows>(q, k, v, o, lse, work, s, st);
  switch (wgmma_chunks(s.dh)) {
    case 1: return launch_fwd_wgmma<1, 1, kRows>(q, k, v, o, lse, work, s, st);
    case 2: return launch_fwd_wgmma<2, 2, kRows>(q, k, v, o, lse, work, s, st);
    case 3: return launch_fwd_wgmma<3, 3, kRows>(q, k, v, o, lse, work, s, st);
    default: return launch_fwd_wgmma<4, 4, kRows>(q, k, v, o, lse, work, s, st);
  }
}
template <bool kRows>
cudaError_t launch_bwd_wgmma_dc(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, void* work, void* dq, void* dk, void* dv,
                                const Shape& s, int hg, cudaStream_t st) {
  if (wgmma_chunks(s.dh) == 3 && wgmma_chunks(s.dv) == 2)
    return launch_bwd_wgmma<3, 2, kRows>(q, k, v, dout, lse, work, dq, dk, dv, s, hg, st);
  switch (wgmma_chunks(s.dh)) {
    case 1:
      return launch_bwd_wgmma<1, 1, kRows>(q, k, v, dout, lse, work, dq, dk, dv, s, hg, st);
    case 2:
      return launch_bwd_wgmma<2, 2, kRows>(q, k, v, dout, lse, work, dq, dk, dv, s, hg, st);
    case 3:
      return launch_bwd_wgmma<3, 3, kRows>(q, k, v, dout, lse, work, dq, dk, dv, s, hg, st);
    default:
      return launch_bwd_wgmma<4, 4, kRows>(q, k, v, dout, lse, work, dq, dk, dv, s, hg, st);
  }
}

// fp32 through tf32x3: the split's scratch, tensor maps and grids
static_assert(sizeof(X3Smem) + 1024 <= kSmemPerBlock, "tf32x3 layout over 227 KB");

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The scratch of one call, carved from `base` (sizes only when base is null),
// in floats: the rows tensors [2][B*Hkv][rows][dh] of q, dout, k (and v in
// the backward), the transposed [2][B*Hkv][dh][Np] of v (forward) or of q,
// dout and k (backward), Np the rows rounded up to 8, and the backward's
// per-row lse2 and delta [B*Hkv][R64] and its partial sums of dq
// [chunks][B*Hkv][rows][dh] and of dk and dv [chunks][B*Hkv][Sk][dh].  Every part starts 16-byte aligned
// (dh and Np are multiples of 8), as TMA needs.
// the most chunks a row block's key walk (q) or a key block's row walk (kv)
// is cut into (X3Walk)
int x3_q_chunks(const Shape& s) {
  const int G = s.Hq / s.Hkv;
  int most = 1;
  for (int r0 = 0; r0 < s.Sq * G; r0 += kBlockRows)
    most = imax(most, x3_chunks(x3_key_walk(r0, s.Sq, s.Sk, G, s.causal, s.window).n));
  return most;
}
int x3_kv_chunks(const Shape& s) {
  const int G = s.Hq / s.Hkv;
  int most = 1;
  for (int k0 = 0; k0 < s.Sk; k0 += kBlockRows)
    most = imax(most, x3_chunks(x3_row_walk(k0, s.Sq, s.Sk, G, s.causal, s.window).n));
  return most;
}

struct X3Work {
  float *qr = nullptr, *qt = nullptr, *dor = nullptr, *dot = nullptr, *kr = nullptr,
        *kt = nullptr, *vr = nullptr, *vt = nullptr, *lse2 = nullptr, *delta = nullptr,
        *dq_part = nullptr, *dk_part = nullptr, *dv_part = nullptr;
  size_t floats = 0;
  X3Work(const Shape& s, float* base, bool backward) {
    const size_t BH = (size_t)s.B * s.Hkv, R = (size_t)s.Sq * (s.Hq / s.Hkv), dh = s.dh;
    const size_t rows_q = 2 * BH * R * dh, rows_k = 2 * BH * s.Sk * dh;
    const size_t cols_q = 2 * BH * dh * round_up((int)R, 8), cols_k = 2 * BH * dh * round_up(s.Sk, 8);
    auto take = [&](float*& p, size_t n) {
      p = base == nullptr ? nullptr : base + floats;
      floats += n;
    };
    take(qr, rows_q);
    take(kr, rows_k);
    if (!backward) {
      take(vt, cols_k);
      return;
    }
    take(qt, cols_q);
    take(dor, rows_q);
    take(dot, cols_q);
    take(kt, cols_k);
    take(vr, rows_k);
    take(lse2, BH * round_up((int)R, 64));
    take(delta, BH * round_up((int)R, 64));
    take(dq_part, x3_q_chunks(s) * BH * R * dh);
    take(dk_part, x3_kv_chunks(s) * BH * s.Sk * dh);
    take(dv_part, x3_kv_chunks(s) * BH * s.Sk * dh);
  }
};

// x [B,S,H,dx] into hi/lo rows (if rows) and transposed (if cols, Np wide),
// dh wide with zeros past dx
cudaError_t x3_split(const void* x, int S, int H, int dx, float* rows, float* cols, int Np,
                     const Shape& s, cudaStream_t st) {
  const int R = S * (H / s.Hkv);
  const dim3 grid(((R > Np ? R : Np) + 31) / 32, (s.dh + 31) / 32, s.B * s.Hkv);
  flash_x3_split_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(x), rows, cols, S, H,
                                               s.Hkv, s.dh, dx, Np);
  return cudaGetLastError();
}

// maps over a rows tensor (boxes of `box_rows` rows of 32 columns) and over a
// transposed one (boxes of 64 head columns of 32 rows)
bool x3_rows_map(CUtensorMap* m, const float* p, int dh, int rows, const Shape& s, int box_rows) {
  return make_map_f32_4d(m, p, dh, rows, (uint64_t)s.B * s.Hkv, 2, box_rows);
}
bool x3_cols_map(CUtensorMap* m, const float* p, int Np, const Shape& s) {
  return make_map_f32_4d(m, p, Np, s.dh, (uint64_t)s.B * s.Hkv, 2, 64);
}

template <int OC>
cudaError_t launch_fwd_x3(const void* q, const void* k, const void* v, void* o, float* lse,
                          void* work, const Shape& s, cudaStream_t st) {
  const int G = s.Hq / s.Hkv, R = s.Sq * G, Skp = round_up(s.Sk, 8);
  const X3Work w(s, static_cast<float*>(work), false);
  cudaError_t e = x3_split(q, s.Sq, s.Hq, s.dh, w.qr, nullptr, R, s, st);
  if (e == cudaSuccess) e = x3_split(k, s.Sk, s.Hkv, s.dh, w.kr, nullptr, s.Sk, s, st);
  if (e == cudaSuccess) e = x3_split(v, s.Sk, s.Hkv, s.dv, nullptr, w.vt, Skp, s, st);
  if (e != cudaSuccess) return e;
  X3Maps m{};
  if (!x3_rows_map(&m.a1, w.qr, s.dh, R, s, kBlockRows) ||
      !x3_rows_map(&m.b1, w.kr, s.dh, s.Sk, s, 64) || !x3_cols_map(&m.u, w.vt, Skp, s))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(X3Smem) + 1024;
  auto kern = flash_fwd_x3_kernel<OC>;
  e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<row_grid(s, kBlockRows), kX3Threads, smem, st>>>(
      m, static_cast<float*>(o), lse, s.Sq, s.Sk, s.Hq, s.Hkv, s.dh, s.dv, s.causal, s.window,
      s.scale);
  return cudaGetLastError();
}

template <int OC>
cudaError_t launch_bwd_x3(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, void* work, void* dq, void* dk,
                          void* dv, const Shape& s, cudaStream_t st) {
  const int G = s.Hq / s.Hkv, R = s.Sq * G, Rp = round_up(R, 8), R64 = round_up(R, 64);
  const int Skp = round_up(s.Sk, 8), BH = s.B * s.Hkv;
  const X3Work w(s, static_cast<float*>(work), true);
  cudaError_t e = x3_split(q, s.Sq, s.Hq, s.dh, w.qr, w.qt, Rp, s, st);
  if (e == cudaSuccess) e = x3_split(dout, s.Sq, s.Hq, s.dv, w.dor, w.dot, Rp, s, st);
  if (e == cudaSuccess) e = x3_split(k, s.Sk, s.Hkv, s.dh, w.kr, w.kt, Skp, s, st);
  if (e == cudaSuccess) e = x3_split(v, s.Sk, s.Hkv, s.dv, w.vr, nullptr, s.Sk, s, st);
  if (e != cudaSuccess) return e;
  const long long warps = (long long)BH * R64;
  flash_x3_row_stats_kernel<<<(unsigned)((warps + 7) / 8), 256, 0, st>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), lse, w.lse2, w.delta, s.Sq,
      s.Hq, s.Hkv, s.dv, R64, BH);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem = sizeof(X3Smem) + 1024;
  X3Maps m{};
  if (!x3_rows_map(&m.a1, w.qr, s.dh, R, s, kBlockRows) ||
      !x3_rows_map(&m.b1, w.kr, s.dh, s.Sk, s, 64) ||
      !x3_rows_map(&m.a2, w.dor, s.dh, R, s, kBlockRows) ||
      !x3_rows_map(&m.b2, w.vr, s.dh, s.Sk, s, 64) || !x3_cols_map(&m.u, w.kt, Skp, s))
    return cudaErrorInvalidValue;
  const int q_chunks = x3_q_chunks(s), kv_chunks = x3_kv_chunks(s);
  auto dq_kern = flash_bwd_dq_x3_kernel<OC>;
  e = allow_smem(dq_kern, smem);
  if (e != cudaSuccess) return e;
  dq_kern<<<dim3(BH, (R + kBlockRows - 1) / kBlockRows * q_chunks), kX3Threads, smem, st>>>(
      m, w.lse2, w.delta, w.dq_part, s.Sq, s.Sk, s.Hq, s.Hkv, s.dh, s.causal, s.window, s.scale,
      R64, q_chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  if (!x3_rows_map(&m.a1, w.kr, s.dh, s.Sk, s, kBlockRows) ||
      !x3_rows_map(&m.b1, w.qr, s.dh, R, s, 64) ||
      !x3_rows_map(&m.a2, w.vr, s.dh, s.Sk, s, kBlockRows) ||
      !x3_rows_map(&m.b2, w.dor, s.dh, R, s, 64) || !x3_cols_map(&m.u, w.dot, Rp, s) ||
      !x3_cols_map(&m.u2, w.qt, Rp, s))
    return cudaErrorInvalidValue;
  auto kv_kern = flash_bwd_dkdv_x3_kernel<OC>;
  e = allow_smem(kv_kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (s.Sk + kBlockRows - 1) / kBlockRows * kv_chunks, 2);
  kv_kern<<<grid, kX3Threads, smem, st>>>(m, w.lse2, w.delta, w.dk_part, w.dv_part, s.Sq, s.Sk,
                                             s.Hq, s.Hkv, s.dh, s.causal, s.window, s.scale, R64,
                                             kv_chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long most = (long long)(R > s.Sk ? R : s.Sk) * s.dh / 4;
  flash_x3_reduce_kernel<<<dim3((unsigned)((most + 255) / 256), BH), 256, 0, st>>>(
      w.dq_part, w.dk_part, w.dv_part, static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), s.Sq, s.Sk, s.Hq, s.Hkv, s.dh, s.dv, s.causal, s.window,
      s.scale);
  return cudaGetLastError();
}

// The variants: 0 the fp32 tf32x3 kernels, 1 the bf16 wgmma kernels on the
// caller's q and dout, 2 the same kernels on their gathered copies
// (wgmma_rows).  The wrapper's variant() chooses one from the shape; a launch
// refuses a variant that cannot take the shape.
enum Variant { kTf32x3 = 0, kWgmma = 1, kWgmmaRows = 2 };

bool bad_shape(const Shape& s) {
  return s.B <= 0 || s.Sq <= 0 || s.Sk <= 0 || s.Hkv <= 0 || s.Hq % s.Hkv != 0 ||
         s.dh <= 0 || s.dh > 256 || s.dh % 8 != 0 || s.dv <= 0 || s.dv > s.dh || s.dv % 8 != 0;
}

bool bad_variant(const Shape& s, int dtype, int variant) {
  if (bad_shape(s)) return true;
  const int G = s.Hq / s.Hkv;
  if (variant == kTf32x3) {
    // the grids' second dimensions (row blocks, key blocks) and the split's third
    const long long rows = kBlockRows;
    return dtype != 0 || (long long)s.B * s.Hkv > 65535 ||
           ((long long)s.Sq * G + rows - 1) / rows * x3_q_chunks(s) > 65535 ||
           (s.Sk + rows - 1) / rows * x3_kv_chunks(s) > 65535;
  }
  if ((variant != kWgmma && variant != kWgmmaRows) || dtype != 1) return true;
  // whole positions per 64-row box (wgmma), the gather's grid (wgmma_rows),
  // and the grids' second dimension (the dQ kernel's row blocks are the
  // smallest, the dK/dV kernel's key blocks)
  // the pair of column-chunk counts an instantiation takes
  const int dc = wgmma_chunks(s.dh), dvc = wgmma_chunks(s.dv);
  const long long rows = dq_consumers(dc) * kWgRows;
  const int keys = kv_keys(dc, dvc);
  return !wgmma_pair(dc, dvc) || (variant == kWgmma && kWgRows % G != 0) ||
         (variant == kWgmmaRows && rows_gather_blocks(s) > 0x7fffffffLL) ||
         ((long long)s.Sq * G + rows - 1) / rows > 65535 || (s.Sk + keys - 1) / keys > 65535;
}

}  // namespace

// C entry points (bound with ctypes).  dtype: 0 = fp32, 1 = bf16.  variant:
// see Variant.  dv: the width of v, out, dout and dv (dv <= dh).  causal:
// 0/1.  window <= 0 means no window.  lse is fp32 [B,Hq,Sq].  work is fp32 scratch of flash_attention_work_floats() floats
// (null where that is 0).  Each returns cudaGetLastError() after its
// launches (0 on success), or cudaErrorInvalidValue for a shape or variant
// it refuses.

// Floats of scratch a call needs: the tf32x3 split's operands and row stats;
// the wgmma_rows gathered copies of q (and dout); the wgmma and wgmma_rows
// backward's delta [B,Hq,Sq], or the fused kernels' rows, accumulator and
// counters (WgWork); 0 otherwise.
extern "C" long long flash_attention_work_floats(int B, int Sq, int Sk, int Hq, int Hkv, int dh,
                                                 int dv, int causal, int window, int variant,
                                                 int backward) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || dh <= 0 || dv <= 0 || dv > dh)
    return 0;
  const Shape s{B, Sq, Sk, Hq, Hkv, dh, dv, causal, window, 0.f};
  if (variant == kTf32x3) return (long long)X3Work(s, nullptr, backward != 0).floats;
  if (variant == kWgmma || variant == kWgmmaRows)
    return (long long)WgWork(s, nullptr, variant == kWgmmaRows, backward != 0).floats;
  return 0;
}

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, void* work, int B, int Sq, int Sk, int Hq, int Hkv,
                                   int dh, int dv, int causal, int window, float scale, int dtype,
                                   int variant, void* stream) {
  const Shape s{B, Sq, Sk, Hq, Hkv, dh, dv, causal, window, scale};
  if (bad_variant(s, dtype, variant)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  if (variant == kTf32x3) {
    switch ((dh + 63) / 64) {
      case 1: return (int)launch_fwd_x3<1>(q, k, v, o, l, work, s, st);
      case 2: return (int)launch_fwd_x3<2>(q, k, v, o, l, work, s, st);
      case 3: return (int)launch_fwd_x3<3>(q, k, v, o, l, work, s, st);
      default: return (int)launch_fwd_x3<4>(q, k, v, o, l, work, s, st);
    }
  }
  if (variant == kWgmmaRows) return (int)launch_fwd_wgmma_dc<true>(q, k, v, o, l, work, s, st);
  return (int)launch_fwd_wgmma_dc<false>(q, k, v, o, l, work, s, st);
}

// The backward kernels: the split, then dQ, then dK/dV, then the reduce
// (tf32x3); for bf16 (wgmma; wgmma_rows first gathers q and dout into work)
// at one or two column chunks the delta kernel, the zeroing of the
// counters, the fused kernel and the dq conversion, else dQ, which also
// writes delta into work, then dK/dV.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* work, void* dq,
                                   void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
                                   int dh, int dvw, int causal, int window, float scale,
                                   int dtype, int variant, int hg, void* stream) {
  const Shape s{B, Sq, Sk, Hq, Hkv, dh, dvw, causal, window, scale};
  if (bad_variant(s, dtype, variant) || hg < 1 || hg > B * Hkv)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  if (variant == kTf32x3) {
    switch ((dh + 63) / 64) {
      case 1: return (int)launch_bwd_x3<1>(q, k, v, o, dout, l, work, dq, dk, dv, s, st);
      case 2: return (int)launch_bwd_x3<2>(q, k, v, o, dout, l, work, dq, dk, dv, s, st);
      case 3: return (int)launch_bwd_x3<3>(q, k, v, o, dout, l, work, dq, dk, dv, s, st);
      default: return (int)launch_bwd_x3<4>(q, k, v, o, dout, l, work, dq, dk, dv, s, st);
    }
  }
  if (variant == kWgmmaRows)
    return (int)launch_bwd_wgmma_dc<true>(q, k, v, dout, l, work, dq, dk, dv, s, hg, st);
  return (int)launch_bwd_wgmma_dc<false>(q, k, v, dout, l, work, dq, dk, dv, s, hg, st);
}
