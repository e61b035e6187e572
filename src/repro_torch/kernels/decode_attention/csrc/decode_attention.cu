// Cached GQA decode attention for Hopper (sm_90a), in three variants.
//
// All replace the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::decode_attention_kernel
//   (pallas_call at :106, body _decode_kernel at :22)
// and compute what the model function computes
//   src/repro/models/attention.py::decode_attention
// The fused and chunk variants also compute the two cache inserts before it
//   src/repro/models/attention.py::insert_kv / insert_chunk, as the layer
//   body calls them at decode (src/repro/models/transformer.py:351-353) and
//   for a prefill chunk (:448-450).
//
// What bounds all three on this card: the bytes of the visible K/V.  At decode the
// work per key is a few FMAs per query row, far below the ~295 operations a
// byte that would make the H100 compute-bound, so the least time is the
// visible K/V over the memory rate (at serving sizes that is well under a
// microsecond per layer, so in practice launch latency and the chain of
// dependent steps inside one launch set the time).
//
// ---------------------------------------------------------------------------
// Split variant (decode_attention_launch): S >= 1 query rows per sequence
// start at a per-sequence q_start (read on the device: it stands in for the
// TPU's scalar prefetch), are causal, and may carry a sliding window (local
// layers).  At S = 1 with lens = q_start + 1 it computes what the TPU kernel
// computes.  prefill_chunk takes it.
//  * The TPU grid (B, Hkv, n_k) walks the KV axis in order on one core; on
//    Hopper B*Hkv blocks would leave most of the 132 SMs idle at decode.  The
//    KV axis is split across blocks (flash-decoding): one block per
//    (KV split, tile of the S*G query rows of one KV head, b * KV head).  The
//    host picks the number of splits from T alone (static), never from the
//    valid length, so no launch waits on the host.
//  * The TPU kernel reads and masks every KV block.  Here each block reads
//    q_start[b], and a split that lies wholly after the last visible key or
//    before the window writes an empty partial (m = -inf, l = 0) and returns
//    without reading K/V; inside a split only tiles that hold visible keys are
//    read.
//  * K/V tiles are staged in shared memory as fp32 and shared by the block's
//    query rows; scores and the online softmax run in fp32.  Partials
//    (m, l, acc) go to scratch the wrapper allocates; a second small kernel
//    combines the splits and skips empty partials.
//  * Plain fp32 FMAs, no tensor cores: the smoke config's head dim of 8 is
//    below any MMA tile, and every head dim that is a multiple of 8 up to 256
//    is taken.
//
// ---------------------------------------------------------------------------
// Fused variant (decode_attention_fused_launch): one query row per sequence
// (S = 1, decode_step) and G <= 16 rows per KV head, one launch that writes
// the step's K/V row and attends.  Designed for caches of 1,024 to 524,288
// keys: at the serve cells (decode_32k, long_500k) a layer reads its whole
// live cache, so the time is the live K/V over the memory rate if enough
// bytes are in flight on every SM; at the engine's caches it is the chain
// of dependent steps in one block.
//  * The plan (ops.plan_fused) fixes only the grid, from static shapes:
//    (n_splits, B*Hkv) blocks, as many splits as fill every SM's blocks once
//    (one block a KV head at TinyLlama's B 98; 66 at long_500k's B 1), none
//    past the keys a row can see, in clusters of at most 8 (of 2 past one
//    cluster where an SM holds two blocks).  q_start stays
//    on the device, so a CUDA graph replays the launch as the cache grows.
//  * Each block reads q_start[b] and cuts its share of the visible keys
//    (window included) itself: the keys in tiles from the first visible one,
//    the tiles shared out evenly and in order (fused_split_range; Python's
//    ops.fused_partition).  No block is empty while there are as many live
//    tiles as splits.  A block with no key leaves an empty partial.
//  * The block that holds q_start writes k_new/v_new into the cache there
//    and puts the same 16-byte chunks in its tile in place of the cache row,
//    so the cache is never read back.  Positions at or past T write nothing.
//  * K/V tiles come in through 16-byte cp.async copies, in a ring of three:
//    two tiles in flight while one is used, one block barrier a tile.  Rows
//    past the split are not read (their V rows zeros).
//  * bf16: products on the tensor cores, mma.sync m16n8k16 with fp32 sums.
//    The G query rows are one m16 tile (rows past G zeros), its A fragments
//    loaded from device memory once.  Each of the four warps owns 16 keys of
//    every tile (64-key tiles up to dh 128; at dh 136-256 32-key tiles, two
//    warps along the keys and two along O's columns, each forming the same
//    S): K and V come by ldmatrix from rows padded by 16 bytes (no bank
//    conflict), S = Q.K^T and the online softmax in registers, then P in
//    bf16 (the reference's cast of the probabilities) as the A fragment of
//    O += P.V, as the chunk variant does (P in two bf16 parts, hi and the
//    rest, errs as fp32 P does but reads up to 16% slower).  The warps
//    run independently; after the loop their partials meet in shared memory.
//    Shared memory is the ring alone (55 KB at dh 64: four blocks an SM; 101
//    KB at dh 256: two), and __launch_bounds__ holds the registers to it.
//  * fp32 (the parity engines, dh 8 and up): the same plan, partition and
//    ring, with products on the CUDA cores (128/tk threads a key in the score
//    pass, over interleaved 16-byte chunks; per-row maxima across warps in
//    shared memory; each thread owning pairs of output elements in P.V),
//    three block barriers a tile.
//  * Combine (fused_combine), in two levels: each block leaves (m, l, acc)
//    in its shared memory; after a cluster barrier every rank takes 1/n of
//    the head's outputs and reads all ranks' partials for them through
//    distributed shared memory, summed in rank order.  With one cluster a
//    (b, KV head) that is the output.  With more, each cluster's sums go to
//    an fp32 workspace the wrapper allocates; each block takes an integer
//    ticket, and the last block of the (b, KV head) sums the clusters' in
//    cluster order, writes out, and sets the ticket back to 0 for the next
//    launch or replay.  Every sum runs in a fixed order: reruns are equal
//    bit for bit.
//  * Every loop over chunks, rows or keys inside a tile runs a fixed count
//    with a predicate.  An earlier form, with loops bounded by the visible
//    range, gave wrong sums in the G <= 4 kernels on the card and was right
//    when built with -Xptxas -O0 (nvcc 12.9; not reduced further).
//
// ---------------------------------------------------------------------------
// Chunk variant (decode_attention_chunk_launch): prefill_chunk's call, in
// bf16 with S > 1 query rows a sequence, the head dim padded to 16 at most
// 256 and G dividing 64 (TinyLlama's chunk: S 64, G 8, dh 64; gemma3-4b's:
// S 64, G 2, dh 256).  At the
// engine's chunk that is 512 query rows a KV head against at most 576 keys:
// well under a microsecond of bytes, so launch latency and the chain of
// dependent tile steps inside a block set the time.  The split variant ran
// it at 16 rows a block on fp32 FMAs, restaged every K/V tile as fp32 for
// each of a head's 32 row tiles, sent its partials through device memory to
// a second kernel, and needed two index writes before it.  This variant is
// one launch:
//  * Grid (n_split, ceil(S*G / 64), B*Hkv), one warpgroup a block (two at
//    dh above 192: below).  A block's 64
//    rows are r = s*G + g of one KV head (G divides 64, so they hold whole
//    positions), so every K/V tile it stages serves all G heads of the
//    group.  Scores S = Q.K^T and O += P.V are wgmma products on 64 x 64
//    tiles with fp32 sums; P is packed to bf16 in registers as the A operand
//    of P.V, and the online softmax's m and l stay in registers, as in the
//    flash kernels' forward.
//  * K/V tiles of 64 keys come in through 16-byte cp.async copies into the
//    128-byte-swizzled layout wgmma reads, double-buffered: the next tile's
//    copies fly while this tile is multiplied.  Each key row picks its
//    source: below q_start[b] the cache, at or above it the chunk's own
//    k_new/v_new.  So any q_start works, aligned to a tile or not, and no
//    block reads a cache row that another block of the launch writes.  Only
//    tiles that hold a key some row of the block sees are read; rows of keys
//    no row sees are zeros.
//  * At the engine's chunk the grid holds 32 row tiles for 132 SMs, each
//    walking 9 key tiles.  So the key tiles of a row tile are split over a
//    cluster of n_split blocks (1, 2, 4 or 8, from static shapes: enough to
//    give every SM two blocks, plan_chunk in ops.py), each
//    taking a contiguous share of the tiles its rows see.  Each block leaves
//    its partial (m, l, unnormalised O) in its own shared memory; after a
//    cluster barrier each rank takes 64 / n_split rows and reads every
//    rank's partial of them through distributed shared memory, summed in
//    rank order, and a second barrier keeps the partials alive until all
//    have read them.  With one block a row tile, out comes from registers:
//    the combine through shared memory took 0.0205 ms there against 0.0130
//    at the engine's chunk on an H100 (chip_smoke.py's cluster sweep).
//  * The blocks of a row tile write the chunk's K/V rows at its 64/G
//    positions into the cache, 16 bytes a thread: the values insert_chunk
//    writes, bit for bit.  Positions at or past T write nothing (the engine
//    refuses such requests).
//  * q_start is read on the device and the grid and tiles come from static
//    shapes, so a launch never waits on the host and a CUDA graph may
//    capture it.  No atomics: reruns are equal bit for bit.
//  * Every loop over chunks, rows or keys inside a tile runs a fixed count
//    with a predicate, as in the fused variant.
//  * The head dim takes DC column chunks of 64 (DC 1 to 4: dh 16..64,
//    72..128, 136..192, 200..256), one kernel each, as the flash kernels'
//    forward does; columns past dh are zeros in Q, K and V.  What grows with
//    DC is shared memory and the O accumulator.  Shared memory is Q plus two
//    buffers of K and V, 40 KB a chunk: 160 KB at DC 4, under the 227 KB a
//    block may have, so an SM holds one block there; the cluster's
//    partial O ([64][64 * DC] fp32) is exactly the two K buffers at every
//    DC and is kept in them.  O is DC x 32 fp32 registers a thread, beside
//    the scores' 32 and P's 16 as bf16 pairs.  With one warpgroup ptxas
//    fits DC 3 in 239 registers, but at DC 4 (O 128) it took all 255 and
//    spilled 68 bytes of stores and 92 of loads (nvcc 12, sm_90a).  So at DC
//    4 a block has two warpgroups over the same 64 rows (chunk_wgs): each
//    computes S = Q.K^T and the online softmax itself (the same bits in
//    both: 64 keys, 16 wgmma steps) and owns two of O's four column chunks,
//    64 registers, in P.V: 194 registers a thread, no spill.  That costs a
//    second S product a tile and nothing in shared memory; the 256 threads
//    share the copies.
//    chip_smoke.py prints ptxas's report of every chunk kernel and fails on
//    a spill.
//  * At gemma3-4b's chunk (S 64, G 2, Hkv 4, dh 256) a KV head has 2 row
//    tiles, 8 a call, each seeing 9 to 25 key tiles of 64: plan_chunk gives
//    clusters of 8, one block an SM.  decode_attention_chunk_init checks,
//    once, that a cluster of 8 can be placed at every DC's shared memory,
//    and fails otherwise: no launch quietly takes fewer blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "vec_io.cuh"

namespace {

constexpr int kWarps = 4;           // warps per block
constexpr int kRowsPerWarp = 4;     // query rows each warp owns
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kMaxDPL = 8;          // head-dim elements per lane: 256 / 32

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid: (n_splits, ceil(S*G / kRows), B * Hkv); block: kWarps * 32 threads.
// Partial index of (b, kv head, row r, split): ((bh * R + r) * n_splits + split).
template <typename T, int TK>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_split_kernel(const T* __restrict__ q,        // [B,S,Hq,dh]
                              const T* __restrict__ k,        // [B,T,Hkv,dh]
                              const T* __restrict__ v,        // [B,T,Hkv,dh]
                              const int32_t* __restrict__ q_start,  // [B]
                              float* __restrict__ m_part,
                              float* __restrict__ l_part,
                              float* __restrict__ acc_part,
                              int S, int Hq, int Hkv, int Tlen, int dh,
                              int window, int split_len) {
  constexpr int KPL = (TK + 31) / 32;  // keys per lane in the score pass
  extern __shared__ float smem[];
  float* qs = smem;                         // [kRows][dh]
  float* ks = qs + kRows * dh;              // [TK][dh + 1] (padded: no bank conflicts)
  float* vs = ks + TK * (dh + 1);           // [TK][dh]
  float* ps = vs + TK * dh;                 // [kWarps][TK]

  const int G = Hq / Hkv;
  const int R = S * G;
  const int split = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int bh = blockIdx.z;
  const int b = bh / Hkv;
  const int kvh = bh % Hkv;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // visible keys of this block's rows
  const int qs0 = q_start[b];
  const int r1 = min(R, r0 + kRows) - 1;
  const int qpos_min = qs0 + r0 / G;
  const int qpos_max = qs0 + r1 / G;
  int vis_lo = window > 0 ? max(0, qpos_min - window + 1) : 0;
  int vis_hi = min(Tlen - 1, qpos_max);  // inclusive
  const int split_lo = split * split_len;
  const int split_hi = min(Tlen, split_lo + split_len) - 1;  // inclusive
  const int key_lo = max(vis_lo, split_lo);
  const int key_hi = min(vis_hi, split_hi);

  if (key_lo > key_hi) {  // empty split: no K/V read at all
    for (int i = tid; i < kRows; i += blockDim.x) {
      const int r = r0 + i;
      if (r < R) {
        const size_t pi = ((size_t)bh * R + r) * n_splits + split;
        m_part[pi] = -INFINITY;
        l_part[pi] = 0.f;
      }
    }
    return;
  }

  // stage this block's query rows (fp32)
  for (int idx = tid; idx < kRows * dh; idx += blockDim.x) {
    const int i = idx / dh, d = idx - (idx / dh) * dh;
    const int r = r0 + i;
    float x = 0.f;
    if (r < R) {
      const int s = r / G, h = kvh * G + (r - (r / G) * G);
      x = to_f32(q[(((size_t)b * S + s) * Hq + h) * dh + d]);
    }
    qs[idx] = x;
  }

  const float scale = rsqrtf((float)dh);
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], acc[kRowsPerWarp][kMaxDPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDPL; ++c) acc[i][c] = 0.f;
  }

  const int tile_first = (key_lo / TK) * TK;
  for (int t0 = tile_first; t0 <= key_hi; t0 += TK) {
    __syncthreads();  // previous tile fully consumed (and q staged on entry)
    for (int idx = tid; idx < TK * dh; idx += blockDim.x) {
      const int j = idx / dh, d = idx - (idx / dh) * dh;
      const int kp = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp >= key_lo && kp <= key_hi) {
        const size_t gi = (((size_t)b * Tlen + kp) * Hkv + kvh) * dh + d;
        kx = to_f32(k[gi]);
        vx = to_f32(v[gi]);
      }
      ks[j * (dh + 1) + d] = kx;
      vs[j * dh + d] = vx;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rl = warp + kWarps * i;  // row within the block
      const int r = r0 + rl;
      if (r >= R) continue;  // warp-uniform
      const int qpos = qs0 + r / G;
      const float* qrow = qs + rl * dh;

      float sc[KPL];
      float mt = -INFINITY;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const int j = lane + 32 * u;
        const int kp = t0 + j;
        bool ok = j < TK && kp >= key_lo && kp <= key_hi && kp <= qpos &&
                  (window <= 0 || kp > qpos - window);
        float s = -INFINITY;
        if (ok) {
          const float* krow = ks + j * (dh + 1);
          float dot = 0.f;
          for (int d = 0; d < dh; ++d) dot = fmaf(qrow[d], krow[d], dot);
          s = dot * scale;
        }
        sc[u] = s;
        mt = fmaxf(mt, s);
      }
      mt = warp_max(mt);
      const float m_new = fmaxf(m_run[i], mt);
      if (m_new == -INFINITY) continue;  // nothing visible to this row yet (warp-uniform)
      const float alpha = expf(m_run[i] - m_new);  // exp(-inf) = 0 on the first hit
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const int j = lane + 32 * u;
        const float p = sc[u] == -INFINITY ? 0.f : expf(sc[u] - m_new);
        if (j < TK) ps[warp * TK + j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      l_run[i] = l_run[i] * alpha + psum;
      m_run[i] = m_new;
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kMaxDPL; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) {
          float a = acc[i][c] * alpha;
          for (int j = 0; j < TK; ++j) a = fmaf(ps[warp * TK + j], vs[j * dh + d], a);
          acc[i][c] = a;
        }
      }
      __syncwarp();  // ps reused by the warp's next row
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp + kWarps * i;
    if (r >= R) continue;
    const size_t pi = ((size_t)bh * R + r) * n_splits + split;
    if (lane == 0) {
      m_part[pi] = m_run[i];
      l_part[pi] = l_run[i];
    }
#pragma unroll
    for (int c = 0; c < kMaxDPL; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) acc_part[pi * dh + d] = acc[i][c];
    }
  }
}

// One thread per (b, kv head, row, d): weights each split by exp(m_i - M),
// skipping empty partials (m_i = -inf, whose acc was never written).
template <typename T>
__global__ void decode_attention_combine_kernel(const float* __restrict__ m_part,
                                                const float* __restrict__ l_part,
                                                const float* __restrict__ acc_part,
                                                T* __restrict__ out,  // [B,S,Hq,dh]
                                                int B, int S, int Hq, int Hkv, int dh,
                                                int n_splits) {
  const int G = Hq / Hkv;
  const int R = S * G;
  const size_t total = (size_t)B * Hkv * R * dh;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = (int)(idx % dh);
  const size_t rr = idx / dh;  // bh * R + r
  const int r = (int)(rr % R);
  const int bh = (int)(rr / R);
  const float* mp = m_part + rr * n_splits;
  const float* lp = l_part + rr * n_splits;
  float M = -INFINITY;
  for (int sp = 0; sp < n_splits; ++sp) M = fmaxf(M, mp[sp]);
  float L = 0.f, A = 0.f;
  if (M != -INFINITY) {
    for (int sp = 0; sp < n_splits; ++sp) {
      const float mi = mp[sp];
      if (mi == -INFINITY) continue;
      const float w = expf(mi - M);
      L = fmaf(lp[sp], w, L);
      A = fmaf(acc_part[(rr * n_splits + sp) * dh + d], w, A);
    }
  }
  const float o = L > 0.f ? A / L : 0.f;
  const int b = bh / Hkv, kvh = bh % Hkv;
  const int s = r / G, h = kvh * G + (r - s * G);
  out[(((size_t)b * S + s) * Hq + h) * dh + d] = from_f32<T>(o);
}

template <typename T, int TK>
cudaError_t launch_typed(const void* q, const void* k, const void* v, const int32_t* q_start,
                         void* out, float* m_part, float* l_part, float* acc_part, int B,
                         int S, int Hq, int Hkv, int Tlen, int dh, int window, int n_splits,
                         int split_len, cudaStream_t stream) {
  const int R = S * (Hq / Hkv);
  const size_t smem =
      sizeof(float) * ((size_t)kRows * dh + (size_t)TK * (dh + 1) + (size_t)TK * dh + kWarps * TK);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_attention_split_kernel<T, TK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(n_splits, (R + kRows - 1) / kRows, B * Hkv);
  decode_attention_split_kernel<T, TK><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_start,
      m_part, l_part, acc_part, S, Hq, Hkv, Tlen, dh, window, split_len);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t total = (size_t)B * Hkv * R * dh;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  decode_attention_combine_kernel<T><<<blocks, threads, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<T*>(out), B, S, Hq, Hkv, dh, n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tk(int tk, const void* q, const void* k, const void* v, const int32_t* qs,
                      void* out, float* m, float* l, float* a, int B, int S, int Hq, int Hkv,
                      int Tlen, int dh, int window, int n_splits, int split_len,
                      cudaStream_t st) {
  switch (tk) {
    case 64: return launch_typed<T, 64>(q, k, v, qs, out, m, l, a, B, S, Hq, Hkv, Tlen, dh, window, n_splits, split_len, st);
    case 32: return launch_typed<T, 32>(q, k, v, qs, out, m, l, a, B, S, Hq, Hkv, Tlen, dh, window, n_splits, split_len, st);
    case 16: return launch_typed<T, 16>(q, k, v, qs, out, m, l, a, B, S, Hq, Hkv, Tlen, dh, window, n_splits, split_len, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Fused variant
// ---------------------------------------------------------------------------
constexpr int kFusedThreads = 128;
constexpr int kFusedWarps = kFusedThreads / 32;
constexpr int kFusedMaxCluster = 8;  // the portable cluster size
constexpr int kFusedRows = 16;       // query rows of a KV head a block holds (G <= 16)
constexpr int kFusedStages = 3;      // K/V tiles in the ring: two in flight while one is used
// 16-byte chunks of the largest fp32 tile the launch takes (16 KB of K), of a
// G x dh query block (16 x 256 fp32) and of a row's score pass, per thread:
// every loop over them runs a fixed count with a predicate
constexpr int kFusedChunkIters = (16384 / 16) / kFusedThreads;

// The keys [key_lo, key_hi] of split `split` of `n_splits`: the keys a query
// at qpos sees (window included) cut into tiles of tk keys from the first
// one, the tiles shared out evenly and in order, so that no split is empty
// while there are at least as many tiles as splits.  An empty split gets
// key_lo > key_hi.  ops.fused_partition mirrors it.
__device__ __forceinline__ void fused_split_range(int qpos, int Tlen, int window, int split,
                                                  int n_splits, int tk, int& key_lo,
                                                  int& key_hi) {
  const int vis_lo = window > 0 ? max(0, qpos - window + 1) : 0;
  const int vis_hi = min(Tlen - 1, qpos);
  const int n_tiles = vis_hi >= vis_lo ? (vis_hi - vis_lo) / tk + 1 : 0;
  const int a = (int)((long long)split * n_tiles / n_splits);
  const int b = (int)((long long)(split + 1) * n_tiles / n_splits);
  key_lo = vis_lo + a * tk;
  key_hi = min(vis_hi, vis_lo + b * tk - 1);
}

template <bool LOG2> __device__ __forceinline__ float fused_exp(float x) {
  return LOG2 ? fast_exp2(x) : expf(x);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Combines the partials of one (b, KV head) and writes its G output rows
// (out_bh, contiguous).  Each block has left its partial in its own shared
// memory: part_m, part_l [G] and the unnormalised part_acc [G][dh], fp32
// (with LOG2 the maxima are in log2 units).  First over the cs blocks of
// the cluster: after a cluster barrier each rank takes 1/cs of the head's
// output pairs and reads every rank's partial of them through distributed
// shared memory, all loads in flight at once, summed in rank order; a
// second barrier keeps every rank's shared memory alive until all have read
// it.  With one cluster a (b, KV head) that is the output.  With more, each
// cluster's sums go to the workspace `ws` ([BH][n_clusters] m and l of
// kFusedRows rows, then [BH][n_clusters][G * dh] sums); every block then
// takes a ticket, and the last block of the (b, KV head) to take one
// combines the clusters' sums in cluster order, writes out, and sets the
// ticket back to 0 for the next launch or graph replay.  Every sum runs in
// a fixed order, so reruns are equal bit for bit; a partial with m = -inf
// (no visible key) is skipped.  Every thread of the block calls it.
template <typename T, bool LOG2>
__device__ void fused_combine(const float* part_m, const float* part_l, const float* part_acc,
                              int G, int dh, int bh, int n_clusters, T* out_bh, float* ws,
                              int* tickets) {
  __shared__ int last;
  const int tid = threadIdx.x;
  const int cs = gridDim.x / n_clusters;
  const int rank = blockIdx.x % cs;
  const size_t part0 = (size_t)bh * n_clusters;  // this head's first cluster sum
  const size_t n_parts = (size_t)gridDim.y * n_clusters;
  float* ws_m = ws;
  float* ws_l = ws + n_parts * kFusedRows;
  float* ws_acc = ws + 2 * n_parts * kFusedRows;
  const int n_pairs = G * dh / 2;
  const int per_rank = (n_pairs + cs - 1) / cs;
  const int p_end = min(n_pairs, (rank + 1) * per_rank);
  const size_t part = part0 + blockIdx.x / cs;
  __syncthreads();  // the block's partial is in
  if (cs > 1) cluster_sync();  // every rank's partial is in
#pragma unroll 1
  for (int it = 0; it < kFusedRows; ++it) {  // per_rank <= n_pairs <= kFusedThreads * 16
    const int pi = rank * per_rank + tid + kFusedThreads * it;
    if (pi >= p_end) continue;
    const int g = 2 * pi / dh;
    float mr[kFusedMaxCluster], lr[kFusedMaxCluster];
    float2 ar[kFusedMaxCluster];
#pragma unroll
    for (int r = 0; r < kFusedMaxCluster; ++r) {
      if (r < cs) {
        mr[r] = ld_cluster_f32(cluster_map(part_m + g, r));
        lr[r] = ld_cluster_f32(cluster_map(part_l + g, r));
        ar[r] = ld_cluster_f32x2(cluster_map(part_acc + 2 * pi, r));
      }
    }
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < kFusedMaxCluster; ++r)
      if (r < cs) M = fmaxf(M, mr[r]);
    float L = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int r = 0; r < kFusedMaxCluster; ++r) {
      if (r < cs && mr[r] != -INFINITY) {  // skip empty splits
        const float w = fused_exp<LOG2>(mr[r] - M);
        L = fmaf(lr[r], w, L);
        a0 = fmaf(ar[r].x, w, a0);
        a1 = fmaf(ar[r].y, w, a1);
      }
    }
    if (n_clusters == 1) {
      const float inv = L > 0.f ? 1.f / L : 0.f;
      store_pair(out_bh + 2 * pi, a0 * inv, a1 * inv);
    } else {
      *reinterpret_cast<float2*>(ws_acc + part * G * dh + 2 * pi) = make_float2(a0, a1);
      if (2 * pi - g * dh == 0) {  // the row's first pair carries its m and l
        ws_m[part * kFusedRows + g] = M;
        ws_l[part * kFusedRows + g] = L;
      }
    }
  }
  if (cs > 1) cluster_sync();  // every rank's shared memory stays until all have read it
  if (n_clusters == 1) return;

  __threadfence();  // this block's sums reach the device before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + bh, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // the sums the other blocks published before their tickets
#pragma unroll 1
  for (int it = 0; it < kFusedRows; ++it) {
    const int pi = tid + kFusedThreads * it;
    if (pi >= n_pairs) continue;
    const int g = 2 * pi / dh;
    float M = -INFINITY;
#pragma unroll 1
    for (int c = 0; c < n_clusters; ++c) M = fmaxf(M, __ldcg(ws_m + (part0 + c) * kFusedRows + g));
    float L = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll 1
    for (int c = 0; c < n_clusters; ++c) {
      const float mc = __ldcg(ws_m + (part0 + c) * kFusedRows + g);
      if (mc == -INFINITY) continue;  // a cluster with no visible key
      const float w = fused_exp<LOG2>(mc - M);
      L = fmaf(__ldcg(ws_l + (part0 + c) * kFusedRows + g), w, L);
      const float2 a = __ldcg(reinterpret_cast<const float2*>(ws_acc + (part0 + c) * G * dh) + pi);
      a0 = fmaf(a.x, w, a0);
      a1 = fmaf(a.y, w, a1);
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
    store_pair(out_bh + 2 * pi, a0 * inv, a1 * inv);
  }
  if (tid == 0) tickets[bh] = 0;  // for the next launch, or replay of the graph
}

// ---- fp32: products on the CUDA cores --------------------------------------

// Row stride (bytes) of an fp32 K tile: a row of dh elements padded so that
// the 16-byte chunks of a quarter-warp in the score pass ((key, sub) lanes,
// key stride `stride`, chunk `sub`) fall in distinct banks.
__host__ __device__ inline int fused_kstride(int row_bytes, int tpk) {
  const int want = (tpk * 16) & 127;
  return row_bytes + ((want - (row_bytes & 127)) & 127);
}

// Dynamic shared memory of an fp32 block: q (later the partial acc)
// [GMAX][dh], the ring's kFusedStages K and V tiles, probabilities
// [GMAX][tk + 1], per-warp row values [warps][GMAX], alpha, m and l [GMAX].
__host__ __device__ inline size_t fused_f32_smem_bytes(int dh, int tk, int gmax) {
  const int row = dh * 4;
  const int tpk = kFusedThreads / tk;
  return (size_t)gmax * dh * 4 + kFusedStages * (size_t)tk * (fused_kstride(row, tpk) + row) +
         4 * ((size_t)gmax * (tk + 1) + (size_t)kFusedWarps * gmax + 3 * (size_t)gmax);
}

__device__ __forceinline__ void chunk_to_f32(const uint4& raw, float (&x)[4]) {
  memcpy(x, &raw, 16);
}

// grid: (n_splits, B * Hkv), cluster (n_splits / n_clusters, 1, 1); block:
// kFusedThreads.  tk (16, 32, 64 or 128) keys per tile: TK if it is set at
// build, else the tk_arg of the launch.  GMAX >= G query rows per KV head.
template <int TK, int GMAX>
__global__ void __launch_bounds__(kFusedThreads)
decode_attention_fused_f32_kernel(const float* __restrict__ q,      // [B,1,Hq,dh]
                                  const float* __restrict__ k_new,  // [B,1,Hkv,dh]
                                  const float* __restrict__ v_new,
                                  float* __restrict__ k,            // [B,Tlen,Hkv,dh]
                                  float* __restrict__ v,
                                  const int32_t* __restrict__ q_start,  // [B]
                                  float* __restrict__ out,          // [B,1,Hq,dh]
                                  float* __restrict__ ws, int* __restrict__ tickets, int Hkv,
                                  int G, int Tlen, int dh, int window, int n_clusters,
                                  int tk_arg) {
  const int tk = TK > 0 ? TK : tk_arg;
  const int tpk = kFusedThreads / tk;  // threads per key in the score pass
  constexpr int EPC = 4;               // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char fsmem[];
  const int row_bytes = dh * 4;
  const int cpr = row_bytes / 16;  // chunks per K/V row
  const int kstride = fused_kstride(row_bytes, tpk);
  float* q_s = reinterpret_cast<float*>(fsmem);  // [GMAX][dh]; after the loop: the partial acc
  unsigned char* kb = fsmem + (size_t)GMAX * dh * 4;   // kFusedStages x [tk][kstride]
  unsigned char* vb = kb + kFusedStages * tk * kstride;  // kFusedStages x [tk][row_bytes]
  float* p_s = reinterpret_cast<float*>(vb + kFusedStages * tk * row_bytes);  // [GMAX][tk + 1]
  float* red = p_s + GMAX * (tk + 1);  // [warps][GMAX]
  float* alpha_s = red + kFusedWarps * GMAX;
  float* part_m = alpha_s + GMAX;
  float* part_l = part_m + GMAX;

  const int bh = blockIdx.y;
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // this split's share of the visible keys
  const int qpos = q_start[b];
  int key_lo, key_hi;
  fused_split_range(qpos, Tlen, window, blockIdx.x, gridDim.x, tk, key_lo, key_hi);
  const size_t pos_stride = (size_t)Hkv * dh;  // elements from one position to the next
  float* krows = k + (size_t)b * Tlen * pos_stride + (size_t)kvh * dh;  // position t at t * pos_stride
  float* vrows = v + (size_t)b * Tlen * pos_stride + (size_t)kvh * dh;
  const uint4* kn = reinterpret_cast<const uint4*>(k_new + (size_t)bh * dh);
  const uint4* vn = reinterpret_cast<const uint4*>(v_new + (size_t)bh * dh);

  // the split that holds q_start (the last visible key, below T) writes the
  // new row into the cache
  if (qpos >= key_lo && qpos <= key_hi) {
    for (int c = tid; c < cpr; c += kFusedThreads) {
      reinterpret_cast<uint4*>(krows + (size_t)qpos * pos_stride)[c] = __ldg(kn + c);
      reinterpret_cast<uint4*>(vrows + (size_t)qpos * pos_stride)[c] = __ldg(vn + c);
    }
  }

  // copies of the visible rows of the tile at t0 into buffer `buf` (one
  // cp.async group); the new row comes from k_new/v_new, never from the cache
  auto stage = [&](int t0, int buf) {
    const int r_hi = min(key_hi, t0 + tk - 1) - t0;
    unsigned char* kd = kb + buf * tk * kstride;
    unsigned char* vd = vb + buf * tk * row_bytes;
#pragma unroll
    for (int it = 0; it < kFusedChunkIters; ++it) {  // tk * cpr <= 1024 chunks
      const int c = tid + kFusedThreads * it;
      const int r = c / cpr;  // one division per 16-byte chunk
      const int ch = c - r * cpr;
      if (r >= tk) continue;
      const int kp = t0 + r;
      uint4* kdst = reinterpret_cast<uint4*>(kd + r * kstride) + ch;
      uint4* vdst = reinterpret_cast<uint4*>(vd + r * row_bytes) + ch;
      if (r > r_hi) {  // past the split: its probability is 0, its V row zeros
        *vdst = make_uint4(0u, 0u, 0u, 0u);
      } else if (kp == qpos) {
        *kdst = __ldg(kn + ch);
        *vdst = __ldg(vn + ch);
      } else {
        cp_async_16(kdst, reinterpret_cast<const uint4*>(krows + (size_t)kp * pos_stride) + ch);
        cp_async_16(vdst, reinterpret_cast<const uint4*>(vrows + (size_t)kp * pos_stride) + ch);
      }
    }
    cp_async_commit();
  };

  const int n_tiles = key_lo <= key_hi ? (key_hi - key_lo) / tk + 1 : 0;
  if (n_tiles > 0) {
    // this head's G query rows are contiguous: G * dh elements, in shared
    // memory, and rows G..GMAX-1 zeros (every row loop then runs GMAX rows
    // without a branch; those rows are never written out)
    const uint4* qg = reinterpret_cast<const uint4*>(q + (size_t)bh * G * dh);
#pragma unroll
    for (int it = 0; it < kFusedChunkIters; ++it) {  // GMAX * cpr <= 16 * 64 chunks
      const int c = tid + kFusedThreads * it;
      if (c >= GMAX * cpr) break;
      float x[EPC];
      chunk_to_f32(c < G * cpr ? __ldg(qg + c) : make_uint4(0u, 0u, 0u, 0u), x);
      *reinterpret_cast<float4*>(q_s + c * EPC) = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
  // the ring's first kFusedStages - 1 tiles (an empty group past the last)
#pragma unroll
  for (int s = 0; s < kFusedStages - 1; ++s) {
    if (s < n_tiles) stage(key_lo + s * tk, s);
    else cp_async_commit();
  }

  const float scale = rsqrtf((float)dh);
  const int j = tid / tpk;   // this thread's key in the score pass
  const int sub = tid % tpk;
  // output pairs this thread owns in P·V: element 2 * (tid + kFusedThreads * i)
  const int n_pairs = G * dh / 2;
  int pg[GMAX], pd[GMAX];
#pragma unroll
  for (int i = 0; i < GMAX; ++i) {
    const int e = 2 * (tid + kFusedThreads * i);
    pg[i] = e / dh;
    pd[i] = e - pg[i] * dh;
  }
  float m_run[GMAX], l_part[GMAX], acc[GMAX][2];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m_run[g] = -INFINITY;
    l_part[g] = 0.f;
    acc[g][0] = acc[g][1] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = key_lo + it * tk;
    const int buf = it % kFusedStages;
    cp_async_wait<kFusedStages - 2>();
    __syncthreads();  // tile `it` (and q) visible; the buffer of tile it - 1 fully consumed
    const int ahead = it + kFusedStages - 1;
    if (ahead < n_tiles) stage(key_lo + ahead * tk, ahead % kFusedStages);
    else cp_async_commit();

    // scores of key j for every row
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    const unsigned char* krow = kb + buf * tk * kstride + j * kstride;
#pragma unroll
    for (int c = 0; c < kFusedChunkIters; ++c) {  // cpr / tpk = tk * cpr / kFusedThreads chunks
      const int ch = sub + tpk * c;
      if (ch >= cpr) break;
      float kx[EPC];
      chunk_to_f32(*reinterpret_cast<const uint4*>(krow + ch * 16), kx);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + g * dh + ch * EPC);
        s[g] = fmaf(qv.x, kx[0], s[g]);
        s[g] = fmaf(qv.y, kx[1], s[g]);
        s[g] = fmaf(qv.z, kx[2], s[g]);
        s[g] = fmaf(qv.w, kx[3], s[g]);
      }
    }
    const bool visible = t0 + j <= key_hi;
#pragma unroll
    for (int o = tpk / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = visible ? s[g] * scale : -INFINITY;
    float mx[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) mx[g] = s[g];
#pragma unroll
    for (int o = tpk; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) red[warp * GMAX + g] = mx[g];
    }
    __syncthreads();  // per-warp maxima in

    // online softmax: every thread keeps the same (m) per row
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float tmax = red[g];
#pragma unroll
      for (int w = 1; w < kFusedWarps; ++w) tmax = fmaxf(tmax, red[w * GMAX + g]);
      const float m_new = fmaxf(m_run[g], tmax);  // finite: every tile holds a visible key
      const float alpha = expf(m_run[g] - m_new);  // 0 on the first tile
      const float p = s[g] == -INFINITY ? 0.f : expf(s[g] - m_new);
      if (sub == 0) {
        p_s[g * (tk + 1) + j] = p;
        l_part[g] = l_part[g] * alpha + p;
      }
      m_run[g] = m_new;
      if (tid == 0) alpha_s[g] = alpha;
    }
    __syncthreads();  // probabilities and alpha in

    // acc = acc * alpha + P·V over the whole tile (a key past the split has
    // probability 0 and a zero V row), eight keys in flight
    const unsigned char* vt = vb + buf * tk * row_bytes;
#pragma unroll
    for (int i = 0; i < GMAX; ++i) {
      if (tid + kFusedThreads * i < n_pairs) {
        const float a = alpha_s[pg[i]];
        acc[i][0] *= a;
        acc[i][1] *= a;
      }
    }
#pragma unroll 8
    for (int jj = 0; jj < tk; ++jj) {
      const float* vrow = reinterpret_cast<const float*>(vt + jj * row_bytes);
#pragma unroll
      for (int i = 0; i < GMAX; ++i) {
        if (tid + kFusedThreads * i < n_pairs) {
          const float p = p_s[pg[i] * (tk + 1) + jj];
          const float2 vv = *reinterpret_cast<const float2*>(vrow + pd[i]);
          acc[i][0] = fmaf(p, vv.x, acc[i][0]);
          acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        }
      }
    }
  }

  // this block's partial: l summed over threads, acc into q's place (no
  // thread reads q after the last tile's scores)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) l_part[g] += __shfl_xor_sync(0xffffffffu, l_part[g], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) red[warp * GMAX + g] = l_part[g];
  }
  float* part_acc = q_s;
#pragma unroll
  for (int i = 0; i < GMAX; ++i) {
    const int pi = tid + kFusedThreads * i;
    if (pi < n_pairs) store_pair(part_acc + 2 * pi, acc[i][0], acc[i][1]);
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float l = red[g];
#pragma unroll
      for (int w = 1; w < kFusedWarps; ++w) l += red[w * GMAX + g];
      part_m[g] = m_run[g];
      part_l[g] = l;
    }
  }
  fused_combine<float, false>(part_m, part_l, part_acc, G, dh, bh, n_clusters,
                              out + (size_t)bh * G * dh, ws, tickets);
}

// ---- bf16: products on the tensor cores (mma.sync m16n8k16) -----------------

// The bf16 kernel at DC column chunks of 64 (dh up to 64 * DC).  The G <= 16
// query rows of a KV head are one m16 tile; each warp owns 16 keys of every
// K/V tile (kWk warps along the keys) and, at DC 3 and 4, half of O's
// columns (kWc warps along them, each forming the same S for its keys).
template <int DC> struct FusedMma {
  static constexpr int kWc = DC >= 3 ? 2 : 1;    // warps along O's columns
  static constexpr int kWk = kFusedWarps / kWc;  // warps along a tile's keys
  static constexpr int kTk = 16 * kWk;           // keys a tile
  static constexpr int kRs = 128 * DC + 16;      // bytes a K or V row takes in shared memory
  static constexpr int kCols = 64 * DC / kWc;    // O's columns a warp owns
  static constexpr int kNt = kCols / 8;          // its n-tiles of 8
  static constexpr int kKs = 4 * DC;             // k-steps of 16 over the padded head dim
  // the ring: kFusedStages x (K, V) x [kTk][kRs], all the dynamic shared memory
  static constexpr int kRing = kFusedStages * 2 * kTk * kRs;
  // after the key loop the ring holds the warps' partials (O [kWk][16][64 DC],
  // m and l [kWk][16]) and the block's (m, l [16], acc [16][64 DC]), fp32
  static constexpr int kAfter = 4 * (kWk * 16 * 64 * DC + 2 * kWk * 16 + 2 * 16 + 16 * 64 * DC);
  // blocks an SM holds at that shared memory (233,472 bytes an SM; a block
  // also takes the combine's static flag, 128 bytes as allocated, and 1,024
  // reserved); __launch_bounds__ keeps the registers within it
  static constexpr int kBlocksPerSm = 233472 / (kRing + 128 + 1024);
};
template <int DC> constexpr bool fused_mma_fits() {
  static_assert(FusedMma<DC>::kAfter <= FusedMma<DC>::kRing, "partials outgrow the ring");
  static_assert(FusedMma<DC>::kRing <= 232448, "ring over 227 KB");
  return true;
}
static_assert(fused_mma_fits<1>() && fused_mma_fits<2>() && fused_mma_fits<3>() &&
              fused_mma_fits<4>(), "fused layouts");

// grid: (n_splits, B * Hkv), cluster (n_splits / n_clusters, 1, 1); block:
// kFusedThreads.  sc = log2(e) / sqrt(dh): scores in log2 units.
template <int DC>
__global__ void __launch_bounds__(kFusedThreads, FusedMma<DC>::kBlocksPerSm)
decode_attention_fused_mma_kernel(const __nv_bfloat16* __restrict__ q,      // [B,1,Hq,dh]
                                  const __nv_bfloat16* __restrict__ k_new,  // [B,1,Hkv,dh]
                                  const __nv_bfloat16* __restrict__ v_new,
                                  __nv_bfloat16* __restrict__ k,            // [B,Tlen,Hkv,dh]
                                  __nv_bfloat16* __restrict__ v,
                                  const int32_t* __restrict__ q_start,      // [B]
                                  __nv_bfloat16* __restrict__ out,          // [B,1,Hq,dh]
                                  float* __restrict__ ws, int* __restrict__ tickets, int Hkv,
                                  int G, int Tlen, int dh, int window, int n_clusters,
                                  float sc) {
  using F = FusedMma<DC>;
  extern __shared__ __align__(16) unsigned char fsmem[];
  const int bh = blockIdx.y;
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wk = warp % F::kWk, wc = warp / F::kWk;
  const int cpr = dh / 8;  // 16-byte chunks of a row
  const int g0 = lane >> 2;  // this thread's rows of the m16 tile: g0 and g0 + 8
  const int col = 2 * (lane & 3);

  const int qpos = q_start[b];
  int key_lo, key_hi;
  fused_split_range(qpos, Tlen, window, blockIdx.x, gridDim.x, F::kTk, key_lo, key_hi);
  const int n_tiles = key_lo <= key_hi ? (key_hi - key_lo) / F::kTk + 1 : 0;
  const size_t pos_stride = (size_t)Hkv * dh;
  __nv_bfloat16* krows = k + (size_t)b * Tlen * pos_stride + (size_t)kvh * dh;
  __nv_bfloat16* vrows = v + (size_t)b * Tlen * pos_stride + (size_t)kvh * dh;
  const uint4* kn = reinterpret_cast<const uint4*>(k_new + (size_t)bh * dh);
  const uint4* vn = reinterpret_cast<const uint4*>(v_new + (size_t)bh * dh);

  // the split that holds q_start (the last visible key, below T) writes the
  // new row into the cache
  if (qpos >= key_lo && qpos <= key_hi) {
    for (int c = tid; c < cpr; c += kFusedThreads) {
      reinterpret_cast<uint4*>(krows + (size_t)qpos * pos_stride)[c] = __ldg(kn + c);
      reinterpret_cast<uint4*>(vrows + (size_t)qpos * pos_stride)[c] = __ldg(vn + c);
    }
  }
  // at dh = 16 n + 8 the last k-step and the last column pair reach one
  // chunk past the row: zeros in every K and V row, written once
  if (cpr & 1) {
    for (int r = tid; r < kFusedStages * 2 * F::kTk; r += kFusedThreads)
      reinterpret_cast<uint4*>(fsmem + (size_t)r * F::kRs)[cpr] = make_uint4(0u, 0u, 0u, 0u);
  }

  // copies of tile `tile` into buffer `buf` (one cp.async group): rows past
  // the split are not read, their V zeros; the new row from k_new/v_new
  auto stage = [&](int tile, int buf) {
    const int t0 = key_lo + tile * F::kTk;
    unsigned char* kd = fsmem + (size_t)buf * 2 * F::kTk * F::kRs;
    unsigned char* vd = kd + F::kTk * F::kRs;
#pragma unroll
    for (int it = 0; it < F::kTk * 8 * DC / kFusedThreads; ++it) {
      const int c = tid + kFusedThreads * it;
      const int r = c / (8 * DC), ch = c % (8 * DC);
      if (ch >= cpr) continue;
      const int kp = t0 + r;
      uint4* kdst = reinterpret_cast<uint4*>(kd + r * F::kRs) + ch;
      uint4* vdst = reinterpret_cast<uint4*>(vd + r * F::kRs) + ch;
      if (kp > key_hi) {
        *vdst = make_uint4(0u, 0u, 0u, 0u);
      } else if (kp == qpos) {
        *kdst = __ldg(kn + ch);
        *vdst = __ldg(vn + ch);
      } else {
        cp_async_16(kdst, reinterpret_cast<const uint4*>(krows + (size_t)kp * pos_stride) + ch);
        cp_async_16(vdst, reinterpret_cast<const uint4*>(vrows + (size_t)kp * pos_stride) + ch);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kFusedStages - 1; ++s) {
    if (s < n_tiles) stage(s, s);
    else cp_async_commit();
  }

  // Q as the A fragments of the kKs k-steps, from device memory once; rows
  // past G and columns past dh are zeros
  uint32_t qa[F::kKs][4];
  const __nv_bfloat16* qh = q + (size_t)bh * G * dh;
#pragma unroll
  for (int kk = 0; kk < F::kKs; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = g0 + 8 * (x & 1), c = 16 * kk + col + 8 * (x >> 1);
      qa[kk][x] = row < G && c < dh && n_tiles > 0
                      ? __ldg(reinterpret_cast<const unsigned int*>(qh + row * dh + c))
                      : 0u;
    }
  }

  float o[F::kNt][4];
#pragma unroll
  for (int nt = 0; nt < F::kNt; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  // this lane's ldmatrix rows: K (non-transposed: keys l&7 and +8 by l>>4,
  // columns +8 by (l>>3)&1) and V (transposed: keys l&7 and +8 by (l>>3)&1,
  // columns +8 by l>>4)
  const int k_off = (wk * 16 + (lane & 7) + ((lane >> 4) << 3)) * F::kRs + ((lane >> 3) & 1) * 16;
  const int v_off = F::kTk * F::kRs + (wk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * F::kRs +
                    (wc * F::kCols + (lane >> 4) * 8) * 2;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kFusedStages - 2>();
    __syncthreads();  // tile i in every thread's view; the buffer of tile i - 1 free
    const int ahead = i + kFusedStages - 1;
    if (ahead < n_tiles) stage(ahead, ahead % kFusedStages);
    else cp_async_commit();
    const unsigned char* tile = fsmem + (size_t)(i % kFusedStages) * 2 * F::kTk * F::kRs;

    // S = Q . K^T over this warp's 16 keys: two n-tiles of 8
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < F::kKs; ++kk) {
      if (16 * kk < dh) {
        uint32_t bk[4];
        ldmatrix_x4(bk, tile + k_off + 32 * kk);
        mma_bf16_16816(s[0], qa[kk], bk[0], bk[1]);
        mma_bf16_16816(s[1], qa[kk], bk[2], bk[3]);
      }
    }
    // keys past the split (in the last tile only)
    const int key0 = key_lo + i * F::kTk + wk * 16 + col;
    if (key0 - col + 15 > key_hi) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * nt + (e & 1) > key_hi) s[nt][e] = -INFINITY;
    }
    // online softmax of rows g0 (x 0) and g0 + 8 (x 1), in log2 units
    float alpha[2], m_use[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float mx = fmaxf(fmaxf(s[0][2 * x], s[0][2 * x + 1]), fmaxf(s[1][2 * x], s[1][2 * x + 1]));
      const float m_new = fmaxf(m_run[x], quad_max(mx) * sc);
      // a row that has seen no key yet keeps m = -inf, l = 0, O = 0
      m_use[x] = m_new == -INFINITY ? 0.f : m_new;
      alpha[x] = fast_exp2(m_run[x] - m_use[x]);
      m_run[x] = m_new;
      l_run[x] *= alpha[x];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[nt][e] * sc - m_use[e >> 1]);
        l_run[e >> 1] += p;
        s[nt][e] = p;
      }
#pragma unroll
    for (int nt = 0; nt < F::kNt; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    // O += P . V, P in bf16 (the reference's cast of the probabilities) as
    // the A fragment: the accumulators of the two n-tiles are the A layout
    // of one 16-key k-step
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int np = 0; np < F::kNt / 2; ++np) {
      if (wc * F::kCols + 16 * np < dh) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, tile + v_off + 32 * np);
        mma_bf16_16816(o[2 * np], pa, bv[0], bv[1]);
        mma_bf16_16816(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }

  // the warps' partials into the ring, then the block's, in warp order
#pragma unroll
  for (int x = 0; x < 2; ++x) l_run[x] = quad_sum(l_run[x]);
  constexpr int kLd = 64 * DC;  // fp32 row stride of a partial O
  float* wo = reinterpret_cast<float*>(fsmem);  // [kWk][16][kLd]
  float* wm = wo + F::kWk * 16 * kLd;           // [kWk][16]
  float* wl = wm + F::kWk * 16;
  float* part_m = wl + F::kWk * 16;             // [16]
  float* part_l = part_m + 16;
  float* part_acc = part_l + 16;                // [G][dh]
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int nt = 0; nt < F::kNt; ++nt) {
    const int c = wc * F::kCols + 8 * nt + col;
#pragma unroll
    for (int x = 0; x < 2; ++x)
      *reinterpret_cast<float2*>(wo + (wk * 16 + g0 + 8 * x) * kLd + c) =
          make_float2(o[nt][2 * x], o[nt][2 * x + 1]);
  }
  if (wc == 0 && (lane & 3) == 0) {  // the column warps hold the same m and l
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      wm[wk * 16 + g0 + 8 * x] = m_run[x];
      wl[wk * 16 + g0 + 8 * x] = l_run[x];
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int it = 0; it < kFusedRows; ++it) {  // G * dh / 2 <= kFusedThreads * 16 pairs
    const int pi = tid + kFusedThreads * it;
    if (pi >= G * dh / 2) continue;
    const int g = 2 * pi / dh, d = 2 * pi - g * dh;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < F::kWk; ++w) M = fmaxf(M, wm[w * 16 + g]);
    float L = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < F::kWk; ++w) {
      const float mw = wm[w * 16 + g];
      if (mw == -INFINITY) continue;  // a warp that saw no key
      const float f = fast_exp2(mw - M);
      const float2 a = *reinterpret_cast<const float2*>(wo + (w * 16 + g) * kLd + d);
      L = fmaf(wl[w * 16 + g], f, L);
      a0 = fmaf(a.x, f, a0);
      a1 = fmaf(a.y, f, a1);
    }
    *reinterpret_cast<float2*>(part_acc + 2 * pi) = make_float2(a0, a1);
    if (d == 0) {
      part_m[g] = M;
      part_l[g] = L;
    }
  }
  fused_combine<__nv_bfloat16, true>(part_m, part_l, part_acc, G, dh, bh, n_clusters,
                                     out + (size_t)bh * G * dh, ws, tickets);
}

template <typename K, typename... Args>
cudaError_t fused_launch(K kernel, size_t smem, int n_splits, int cluster, int BH,
                         cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, BH, 1);
  cfg.blockDim = dim3(kFusedThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int TK, int GMAX>
size_t fused_f32_max_smem() {
  // the largest block over the key tiles the kernel takes: at tk keys the
  // widest row plan_fused gives is 16 KB / tk (at most 256 elements)
  size_t most = 0;
  for (int tk = 16; tk <= 128; tk *= 2) {
    if (TK > 0 && tk != TK) continue;
    const int widest = (16384 / tk) / 4;
    const size_t bytes = fused_f32_smem_bytes(widest < 256 ? widest : 256, tk, GMAX);
    most = bytes > most ? bytes : most;
  }
  return most;
}

template <int TK, int GMAX>
cudaError_t fused_f32_init_one() {
  return cudaFuncSetAttribute(decode_attention_fused_f32_kernel<TK, GMAX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)fused_f32_max_smem<TK, GMAX>());
}

template <int DC>
cudaError_t fused_mma_init_one() {
  return cudaFuncSetAttribute(decode_attention_fused_mma_kernel<DC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, FusedMma<DC>::kRing);
}

template <int TK, int GMAX>
cudaError_t fused_f32_launch(const void* q, const void* kn, const void* vn, void* k, void* v,
                             const int32_t* qs, void* out, float* ws, int* tickets, int B,
                             int Hkv, int G, int Tlen, int dh, int window, int n_splits,
                             int cluster, int tk, cudaStream_t st) {
  return fused_launch(decode_attention_fused_f32_kernel<TK, GMAX>,
                      fused_f32_smem_bytes(dh, tk, GMAX), n_splits, cluster, B * Hkv, st,
                      static_cast<const float*>(q), static_cast<const float*>(kn),
                      static_cast<const float*>(vn), static_cast<float*>(k),
                      static_cast<float*>(v), qs, static_cast<float*>(out), ws, tickets, Hkv, G,
                      Tlen, dh, window, n_splits / cluster, tk);
}

// 128-key tiles (rows of at most 128 bytes: dh <= 32 in fp32, the smoke
// models' decode) take a kernel built for them; other tiles share one
// kernel that reads tk at run time.
template <int TK>
cudaError_t fused_f32_launch_g(const void* q, const void* kn, const void* vn, void* k, void* v,
                               const int32_t* qs, void* out, float* ws, int* tickets, int B,
                               int Hkv, int G, int Tlen, int dh, int window, int n_splits,
                               int cluster, int tk, cudaStream_t st) {
  if (G <= 4)
    return fused_f32_launch<TK, 4>(q, kn, vn, k, v, qs, out, ws, tickets, B, Hkv, G, Tlen, dh, window, n_splits, cluster, tk, st);
  if (G <= 8)
    return fused_f32_launch<TK, 8>(q, kn, vn, k, v, qs, out, ws, tickets, B, Hkv, G, Tlen, dh, window, n_splits, cluster, tk, st);
  return fused_f32_launch<TK, 16>(q, kn, vn, k, v, qs, out, ws, tickets, B, Hkv, G, Tlen, dh, window, n_splits, cluster, tk, st);
}

template <int DC>
cudaError_t fused_mma_launch(const void* q, const void* kn, const void* vn, void* k, void* v,
                             const int32_t* qs, void* out, float* ws, int* tickets, int B,
                             int Hkv, int G, int Tlen, int dh, int window, int n_splits,
                             int cluster, cudaStream_t st) {
  using bf = __nv_bfloat16;
  return fused_launch(decode_attention_fused_mma_kernel<DC>, FusedMma<DC>::kRing, n_splits,
                      cluster, B * Hkv, st, static_cast<const bf*>(q),
                      static_cast<const bf*>(kn), static_cast<const bf*>(vn),
                      static_cast<bf*>(k), static_cast<bf*>(v), qs, static_cast<bf*>(out), ws,
                      tickets, Hkv, G, Tlen, dh, window, n_splits / cluster,
                      kLog2e / sqrtf((float)dh));
}

// ---------------------------------------------------------------------------
// Chunk variant
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kChunkThreads = 128;  // one warpgroup
// warpgroups of a block at DC column chunks: two at DC 4, over the same 64
// rows, each owning half of O's column chunks (see the header)
__host__ __device__ constexpr int chunk_wgs(int DC) { return DC == 4 ? 2 : 1; }
constexpr int kChunkRows = 64;      // query rows of a block: one wgmma M tile
constexpr int kChunkKeys = 64;      // keys of a tile: one wgmma N tile

constexpr int kChunkMaxSplits = 8;  // the portable cluster size

// Q and two buffers each of K and V: DC column chunks of [64][64] bf16 each,
// under the 128-byte swizzle (DC = 1 up to dh 64, 2 up to 128, 3 up to 192,
// 4 up to 256).  After the key loop the K buffers hold the block's partial O
// ([64][64 * DC] fp32) and part_m / part_l its rows' m and l, for the
// cluster's combine.
template <int DC>
struct ChunkSmem {
  alignas(1024) bf16 q[DC][kChunkRows * 64];
  alignas(1024) bf16 k[2][DC][kChunkKeys * 64];
  alignas(1024) bf16 v[2][DC][kChunkKeys * 64];
  float part_m[kChunkRows], part_l[kChunkRows];
};

template <int DC> constexpr size_t chunk_smem_bytes() { return sizeof(ChunkSmem<DC>) + 1024; }

constexpr size_t kChunkSmemMax = 232448;  // dynamic shared memory a block may have
template <int DC> constexpr bool chunk_layout_fits() {
  static_assert(sizeof(ChunkSmem<DC>::k) == sizeof(float) * kChunkRows * 64 * DC,
                "the partial O must fill the two K buffers exactly");
  static_assert(chunk_smem_bytes<DC>() <= kChunkSmemMax, "chunk layout over 227 KB");
  return true;
}
static_assert(chunk_layout_fits<1>() && chunk_layout_fits<2>() && chunk_layout_fits<3>() &&
              chunk_layout_fits<4>(), "chunk layouts");

__device__ __forceinline__ void zero_chunk(bf16* tile, int row, int c) {
  *reinterpret_cast<uint4*>(reinterpret_cast<char*>(tile) + swizzle128(row, c)) =
      make_uint4(0u, 0u, 0u, 0u);
}

// grid: (n_split, ceil(S*G / 64), B * Hkv), cluster (n_split, 1, 1): the
// n_split blocks of a row tile share its key tiles; block: chunk_wgs(DC)
// warpgroups.
template <int DC>
__global__ void __launch_bounds__(kChunkThreads * chunk_wgs(DC))
decode_attention_chunk_kernel(const bf16* __restrict__ q,      // [B,S,Hq,dh]
                              const bf16* __restrict__ k_new,  // [B,S,Hkv,dh]
                              const bf16* __restrict__ v_new,
                              bf16* __restrict__ k,            // [B,Tlen,Hkv,dh]
                              bf16* __restrict__ v,
                              const int32_t* __restrict__ q_start,  // [B]
                              bf16* __restrict__ out,          // [B,S,Hq,dh]
                              int S, int Hkv, int G, int Tlen, int dh, int window,
                              float scale) {
  constexpr int kCpr = DC * 8;  // 16-byte chunks of a padded row
  constexpr int kThreads = kChunkThreads * chunk_wgs(DC);
  constexpr int kOc = DC / chunk_wgs(DC);  // O's column chunks a warpgroup owns
  // chunks of a [64][64 * DC] tile a thread: every loop over a tile's (row,
  // chunk) pairs runs this count with a predicate
  constexpr int kIters = kChunkRows * kCpr / kThreads;
  extern __shared__ char smem_raw[];
  ChunkSmem<DC>& sm = smem_layout<ChunkSmem<DC>>(smem_raw);
  const int R = S * G;
  const int Hq = Hkv * G;
  const int n_split = gridDim.x;
  const int rank = blockIdx.x;  // the block's rank in its cluster
  const int r0 = blockIdx.y * kChunkRows;
  const int bh = blockIdx.z;
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  const int tid = threadIdx.x;
  const int warp = tid % kChunkThreads / 32, lane = tid % 32;  // warp of its warpgroup
  // the warpgroup's first column chunk of O (a constant with one warpgroup)
  const int c0 = chunk_wgs(DC) == 1 ? 0 : tid / kChunkThreads * kOc;
  const int cpr = dh / 8;  // 16-byte chunks of a row
  const int qs0 = q_start[b];
  const size_t pos_stride = (size_t)Hkv * dh;  // elements from one position to the next
  bf16* kc = k + (size_t)b * Tlen * pos_stride + (size_t)kvh * dh;  // position t at t * pos_stride
  bf16* vc = v + (size_t)b * Tlen * pos_stride + (size_t)kvh * dh;
  const bf16* kn = k_new + (size_t)b * S * pos_stride + (size_t)kvh * dh;  // chunk row s
  const bf16* vn = v_new + (size_t)b * S * pos_stride + (size_t)kvh * dh;

  // this block's rows r0..r1 sit at positions qs0 + s_lo .. qs0 + s_hi; the
  // keys some row sees: [key_lo, key_hi]
  const int r1 = min(R, r0 + kChunkRows) - 1;
  const int s_lo = r0 / G, s_hi = r1 / G;
  const int p_lo = qs0 + s_lo, p_hi = qs0 + s_hi;
  const int key_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int key_hi = min(Tlen - 1, p_hi);
  const int n_all = key_hi >= key_lo ? key_hi / kChunkKeys - key_lo / kChunkKeys + 1 : 0;
  // this block's share: contiguous key tiles from t_first, n_tiles of them
  const int per = (n_all + n_split - 1) / n_split;
  const int t_first = key_lo / kChunkKeys + rank * per;
  const int n_tiles = max(0, min(per, n_all - rank * per));

  // the chunk's K/V rows at the row tile's positions go into the cache,
  // shared out over the cluster's blocks
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int idx = tid + kThreads * it;
    const int i = idx / kCpr, c = idx % kCpr;
    const int s = s_lo + i;
    if (it % n_split == rank && c < cpr && s <= s_hi && qs0 + s < Tlen) {
      const size_t src = (size_t)s * pos_stride + c * 8;
      const size_t dst = (size_t)(qs0 + s) * pos_stride + c * 8;
      *reinterpret_cast<uint4*>(kc + dst) = __ldg(reinterpret_cast<const uint4*>(kn + src));
      *reinterpret_cast<uint4*>(vc + dst) = __ldg(reinterpret_cast<const uint4*>(vn + src));
    }
  }
  // head columns dh..64*DC-1 are zeros in every tile, written once
  if (n_tiles > 0 && cpr < kCpr) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int idx = tid + kThreads * it;
      const int i = idx / kCpr, c = idx % kCpr;
      if (c >= cpr) {
        zero_chunk(sm.q[c / 8], i, c % 8);
#pragma unroll
        for (int buf = 0; buf < 2; ++buf) {
          zero_chunk(sm.k[buf][c / 8], i, c % 8);
          zero_chunk(sm.v[buf][c / 8], i, c % 8);
        }
      }
    }
  }
  // this block's query rows (zeros past R)
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int idx = tid + kThreads * it;
    const int i = idx / kCpr, c = idx % kCpr;
    const int r = r0 + i;
    if (n_tiles > 0 && c < cpr) {
      if (r < R) {
        const int s = r / G;
        const bf16* src = q + (((size_t)b * S + s) * Hq + kvh * G + (r - s * G)) * dh + c * 8;
        cp_async_16(reinterpret_cast<char*>(sm.q[c / 8]) + swizzle128(i, c % 8), src);
      } else {
        zero_chunk(sm.q[c / 8], i, c % 8);
      }
    }
  }
  // copies of key tile `tile` into buffer `buf`: each row from the cache
  // below q_start, from the chunk's own rows at or above it, zeros where no
  // row of the block sees the key
  auto stage = [&](int tile, int buf) {
    const int t0 = (t_first + tile) * kChunkKeys;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int idx = tid + kThreads * it;
      const int j = idx / kCpr, c = idx % kCpr;
      const int kp = t0 + j;
      if (c >= cpr) continue;
      if (kp < key_lo || kp > key_hi) {
        zero_chunk(sm.k[buf][c / 8], j, c % 8);
        zero_chunk(sm.v[buf][c / 8], j, c % 8);
      } else {
        const size_t row = kp < qs0 ? (size_t)kp * pos_stride : (size_t)(kp - qs0) * pos_stride;
        const bf16* ks = (kp < qs0 ? kc : kn) + row + c * 8;
        const bf16* vs = (kp < qs0 ? vc : vn) + row + c * 8;
        const uint32_t off = swizzle128(j, c % 8);
        cp_async_16(reinterpret_cast<char*>(sm.k[buf][c / 8]) + off, ks);
        cp_async_16(reinterpret_cast<char*>(sm.v[buf][c / 8]) + off, vs);
      }
    }
    cp_async_commit();
  };
  if (n_tiles > 0) stage(0, 0);  // one group with the query rows

  const int rl = 16 * warp + lane / 4;  // this thread's rows of the tile: rl and rl + 8
  int pos[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) pos[x] = qs0 + (r0 + rl + 8 * x) / G;
  const int col = 2 * (lane % 4);
  const float sc = scale * kLog2e;  // exp(x * scale) = exp2(x * sc)
  float oacc[kOc][32];  // O's column chunks c0 .. c0 + kOc - 1
#pragma unroll
  for (int c = 0; c < kOc; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) oacc[c][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    const int t0 = (t_first + i) * kChunkKeys;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // tile i (and the query rows) in; the other buffer's products done
    if (i + 1 < n_tiles) stage(i + 1, buf ^ 1);

    // S = Q . K^T: 64 rows x 64 keys
    float sacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DC * 4; ++kk)
      wgmma_ss_64x64(sacc, wgmma_desc(sm.q[kk / 4]) + 2 * (kk % 4),
                     wgmma_desc(sm.k[buf][kk / 4]) + 2 * (kk % 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // masks, unless every (row, key) pair of the tile is visible
    if (t0 + kChunkKeys - 1 > p_lo || t0 + kChunkKeys > Tlen ||
        (window > 0 && t0 <= p_hi - window)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = t0 + 8 * (e / 4) + col + (e & 1);
        const int p = pos[(e >> 1) & 1];
        if (!(key <= p && key < Tlen && (window <= 0 || key > p - window))) sacc[e] = -INFINITY;
      }
    }
    // online softmax over the quad's two rows
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sacc[e]);
    float m_use[2], alpha[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float m_new = fmaxf(m_run[x], quad_max(mx[x]) * sc);
      // a row that has seen no key yet keeps m = -inf, l = 0, O = 0
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
    for (int c = 0; c < kOc; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[c][e] *= alpha[(e >> 1) & 1];
    // O += P . V, P in bf16 (the reference's cast of the probabilities)
    uint32_t pa[kChunkKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kChunkKeys / 16; ++kk) to_a_frag(&sacc[8 * kk], pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunkKeys / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kOc; ++c)
        wgmma_rs_64x64(oacc[c], pa[kk], wgmma_desc(sm.v[buf][c0 + c]) + kk * 16 * 128 / 16);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kOc; ++c) fence_regs(oacc[c]);
  }

  float l_row[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) l_row[x] = quad_sum(l_run[x]);
  if (n_split == 1) {  // one block a row tile: out from the registers
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r0 + rl + 8 * x;
      if (r >= R) continue;  // rows past the chunk write nothing
      const float inv = l_row[x] > 0.f ? 1.f / l_row[x] : 0.f;
      const int s = r / G;
      bf16* o = out + (((size_t)b * S + s) * Hq + kvh * G + (r - s * G)) * dh;
#pragma unroll
      for (int c = 0; c < kOc; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cc = 64 * (c0 + c) + 8 * j + col;
          if (cc < dh)
            *reinterpret_cast<__nv_bfloat162*>(o + cc) = __floats2bfloat162_rn(
                oacc[c][4 * j + 2 * x] * inv, oacc[c][4 * j + 2 * x + 1] * inv);
        }
    }
    return;
  }

  // this block's partial (m, l, unnormalised O) into its shared memory; a
  // block with no key tile leaves an empty one (m = -inf, l = 0, O = 0)
  constexpr int kLd = 64 * DC;  // fp32 row stride of the partial O
  float* part_o = reinterpret_cast<float*>(&sm.k[0][0][0]);
  __syncthreads();  // every product of the block has read the K buffers
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = rl + 8 * x;
#pragma unroll
    for (int c = 0; c < kOc; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(part_o + row * kLd + 64 * (c0 + c) + 8 * j + col) =
            make_float2(oacc[c][4 * j + 2 * x], oacc[c][4 * j + 2 * x + 1]);
    if (lane % 4 == 0 && c0 == 0) {  // both warpgroups hold the same m and l
      sm.part_m[row] = m_run[x];
      sm.part_l[row] = l_row[x];
    }
  }
  cluster_sync();  // every rank's partial is in its shared memory

  // combine: rank `rank` takes rows [rank, rank + 1) * 64 / n_split and
  // reads every rank's partial of them through distributed shared memory,
  // all loads in flight at once, summed in rank order (reruns are equal bit
  // for bit); the most a rank takes is at two splits
  const int rows_per = kChunkRows / n_split;
#pragma unroll 1
  for (int it = 0; it < kChunkRows / 2 * 32 * DC / kThreads; ++it) {
    const int idx = tid + kThreads * it;
    const int row = rank * rows_per + idx / (32 * DC);
    const int cc = 2 * (idx % (32 * DC));
    const int r = r0 + row;
    if (idx >= rows_per * 32 * DC || cc >= dh || r >= R) continue;
    float mr[kChunkMaxSplits], lr[kChunkMaxSplits];
    float2 ar[kChunkMaxSplits];
#pragma unroll
    for (int q_ = 0; q_ < kChunkMaxSplits; ++q_) {
      if (q_ < n_split) {
        mr[q_] = ld_cluster_f32(cluster_map(sm.part_m + row, q_));
        lr[q_] = ld_cluster_f32(cluster_map(sm.part_l + row, q_));
        ar[q_] = ld_cluster_f32x2(cluster_map(part_o + row * kLd + cc, q_));
      }
    }
    float M = -INFINITY;
#pragma unroll
    for (int q_ = 0; q_ < kChunkMaxSplits; ++q_)
      if (q_ < n_split) M = fmaxf(M, mr[q_]);
    float L = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int q_ = 0; q_ < kChunkMaxSplits; ++q_) {
      if (q_ < n_split && mr[q_] != -INFINITY) {  // skip empty partials
        const float w = fast_exp2(mr[q_] - M);  // m is in the log2 domain
        L = fmaf(lr[q_], w, L);
        a0 = fmaf(ar[q_].x, w, a0);
        a1 = fmaf(ar[q_].y, w, a1);
      }
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
    const int s = r / G;
    bf16* o = out + (((size_t)b * S + s) * Hq + kvh * G + (r - s * G)) * dh;
    *reinterpret_cast<__nv_bfloat162*>(o + cc) = __floats2bfloat162_rn(a0 * inv, a1 * inv);
  }
  cluster_sync();  // every rank's shared memory stays until all have read it
}

template <int DC>
cudaError_t chunk_launch_typed(const void* q, const void* kn, const void* vn, void* k, void* v,
                               const int32_t* qs, void* out, int B, int S, int Hkv, int G,
                               int Tlen, int dh, int window, int n_split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, (S * G + kChunkRows - 1) / kChunkRows, B * Hkv);
  cfg.blockDim = dim3(kChunkThreads * chunk_wgs(DC), 1, 1);
  cfg.dynamicSmemBytes = chunk_smem_bytes<DC>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_attention_chunk_kernel<DC>, static_cast<const bf16*>(q),
      static_cast<const bf16*>(kn), static_cast<const bf16*>(vn), static_cast<bf16*>(k),
      static_cast<bf16*>(v), qs, static_cast<bf16*>(out), S, Hkv, G, Tlen, dh, window,
      1.f / sqrtf((float)dh));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  dtype: 0 = fp32, 1 = bf16.  window <= 0
// means no window.  split_len is a multiple of tk; n_splits = ceil(T / split_len).
// Scratch: m_part, l_part [B*Hkv*S*G*n_splits] fp32, acc_part [... * dh] fp32.
// Returns cudaGetLastError() after both launches (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* q_start, void* out, void* m_part,
                                       void* l_part, void* acc_part, int B, int S, int Hq,
                                       int Hkv, int Tlen, int dh, int window, int n_splits,
                                       int split_len, int tk, int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || dh <= 0 || dh > 32 * kMaxDPL || n_splits <= 0 ||
      split_len <= 0 || split_len % tk != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto qs = static_cast<const int32_t*>(q_start);
  auto m = static_cast<float*>(m_part);
  auto l = static_cast<float*>(l_part);
  auto a = static_cast<float*>(acc_part);
  cudaError_t e;
  if (dtype == 0)
    e = launch_tk<float>(tk, q, k, v, qs, out, m, l, a, B, S, Hq, Hkv, Tlen, dh, window, n_splits, split_len, st);
  else if (dtype == 1)
    e = launch_tk<__nv_bfloat16>(tk, q, k, v, qs, out, m, l, a, B, S, Hq, Hkv, Tlen, dh, window, n_splits, split_len, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

// Sets the dynamic shared-memory limit of every fused kernel; called once,
// when the library is loaded, so that no launch (or graph capture) does it.
extern "C" int decode_attention_fused_init() {
  const cudaError_t errs[] = {
      fused_f32_init_one<128, 4>(), fused_f32_init_one<128, 8>(), fused_f32_init_one<128, 16>(),
      fused_f32_init_one<0, 4>(),   fused_f32_init_one<0, 8>(),   fused_f32_init_one<0, 16>(),
      fused_mma_init_one<1>(),      fused_mma_init_one<2>(),      fused_mma_init_one<3>(),
      fused_mma_init_one<4>(),
  };
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

// Blocks of the bf16 fused kernel at head dim dh that one SM of this device
// holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its shared memory,
// after decode_attention_fused_init), or -1: what ops.fused_blocks_per_sm
// reckons for the plan.
extern "C" int decode_attention_fused_blocks_per_sm(int dh) {
  int n = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (dh > 0 && dh <= 64)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, decode_attention_fused_mma_kernel<1>, kFusedThreads, FusedMma<1>::kRing);
  else if (dh <= 128)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, decode_attention_fused_mma_kernel<2>, kFusedThreads, FusedMma<2>::kRing);
  else if (dh <= 192)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, decode_attention_fused_mma_kernel<3>, kFusedThreads, FusedMma<3>::kRing);
  else if (dh <= 256)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, decode_attention_fused_mma_kernel<4>, kFusedThreads, FusedMma<4>::kRing);
  return e == cudaSuccess ? n : -1;
}

// C entry point of the fused variant (bound with ctypes).  q [B,1,Hq,dh],
// k_new/v_new [B,1,Hkv,dh], k/v caches [B,T,Hkv,dh] (row q_start[b] written
// in place), out [B,1,Hq,dh]; every pointer 16-byte aligned.  dtype: 0 =
// fp32 (CUDA-core products; tk keys a tile: 128, 64, 32 or 16, with dh * 4 *
// tk <= 16 KB), 1 = bf16 (mma.sync; tk 64 up to dh 128, else 32).  window
// <= 0 means no window.  n_splits blocks a (b, KV head) in clusters of
// `cluster` (1 to 8, dividing n_splits); with more than one cluster, ws
// holds the clusters' sums (fp32, n_splits / cluster * B * Hkv * (2 * 16 +
// G * dh)) and tickets B * Hkv ints, 0 before the launch and after it.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int decode_attention_fused_launch(const void* q, const void* k_new, const void* v_new,
                                             void* k, void* v, const void* q_start, void* out,
                                             void* ws, void* tickets, int B, int Hq, int Hkv,
                                             int Tlen, int dh, int window, int n_splits,
                                             int cluster, int tk, int dtype, void* stream) {
  if (B <= 0 || Tlen <= 0 || Hkv <= 0 || Hq < Hkv || Hq % Hkv != 0 || Hq / Hkv > kFusedRows ||
      B * Hkv > 65535 || dh <= 0 || dh > 256 || dh % 8 != 0 || cluster < 1 ||
      cluster > kFusedMaxCluster || n_splits < cluster || n_splits % cluster != 0 ||
      (n_splits > cluster && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto qs = static_cast<const int32_t*>(q_start);
  auto w = static_cast<float*>(ws);
  auto t = static_cast<int*>(tickets);
  const int G = Hq / Hkv;
  if (dtype == 0) {
    if ((tk != 128 && tk != 64 && tk != 32 && tk != 16) || dh * 4 * tk > 16384)
      return (int)cudaErrorInvalidValue;
    if (tk == 128)
      return (int)fused_f32_launch_g<128>(q, k_new, v_new, k, v, qs, out, w, t, B, Hkv, G, Tlen,
                                          dh, window, n_splits, cluster, tk, st);
    return (int)fused_f32_launch_g<0>(q, k_new, v_new, k, v, qs, out, w, t, B, Hkv, G, Tlen, dh,
                                      window, n_splits, cluster, tk, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int dc = (dh + 63) / 64;  // the padded width's column chunks of 64
  if (tk != (dc <= 2 ? FusedMma<1>::kTk : FusedMma<3>::kTk)) return (int)cudaErrorInvalidValue;
  switch (dc) {
    case 1: return (int)fused_mma_launch<1>(q, k_new, v_new, k, v, qs, out, w, t, B, Hkv, G, Tlen, dh, window, n_splits, cluster, st);
    case 2: return (int)fused_mma_launch<2>(q, k_new, v_new, k, v, qs, out, w, t, B, Hkv, G, Tlen, dh, window, n_splits, cluster, st);
    case 3: return (int)fused_mma_launch<3>(q, k_new, v_new, k, v, qs, out, w, t, B, Hkv, G, Tlen, dh, window, n_splits, cluster, st);
    default: return (int)fused_mma_launch<4>(q, k_new, v_new, k, v, qs, out, w, t, B, Hkv, G, Tlen, dh, window, n_splits, cluster, st);
  }
}

namespace {

constexpr int kChunkUnplaceable = -1;

// Sets the dynamic shared-memory limit of the chunk kernel at DC column
// chunks, then asks whether a cluster of kChunkMaxSplits blocks of that size
// can be placed on this device: kChunkUnplaceable if not.
template <int DC>
int chunk_init_one() {
  cudaError_t e = cudaFuncSetAttribute(decode_attention_chunk_kernel<DC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)chunk_smem_bytes<DC>());
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kChunkMaxSplits, 1, 1);
  cfg.blockDim = dim3(kChunkThreads * chunk_wgs(DC), 1, 1);
  cfg.dynamicSmemBytes = chunk_smem_bytes<DC>();
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kChunkMaxSplits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, decode_attention_chunk_kernel<DC>, &cfg);
  if (e != cudaSuccess) return (int)e;
  return clusters >= 1 ? 0 : kChunkUnplaceable;
}

}  // namespace

// Sets the dynamic shared-memory limit of the chunk kernels and checks that
// a cluster of 8 blocks can be placed at each one's shared memory (160 KB a
// block at DC 4); called once, when the library is loaded, so that no launch
// (or graph capture) does it.  Returns 0, a CUDA error, or -1 where a cluster
// of 8 cannot be placed.
extern "C" int decode_attention_chunk_init() {
  const int errs[] = {chunk_init_one<1>(), chunk_init_one<2>(), chunk_init_one<3>(),
                      chunk_init_one<4>()};
  for (int e : errs)
    if (e != 0) return e;
  return 0;
}

// C entry point of the chunk variant (bound with ctypes), bf16 only.
// q [B,S,Hq,dh], k_new/v_new [B,S,Hkv,dh], k/v caches [B,T,Hkv,dh] (rows
// q_start[b] .. q_start[b]+S-1 below T written in place), out [B,S,Hq,dh];
// every pointer 16-byte aligned.  dh a multiple of 8 from 16 to 256
// (padded to 16 at most 256), G = Hq / Hkv dividing 64.  window <= 0 means
// no window.  n_split (1, 2, 4 or 8) blocks of a cluster share each row
// tile's key tiles.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int decode_attention_chunk_launch(const void* q, const void* k_new, const void* v_new,
                                             void* k, void* v, const void* q_start, void* out,
                                             int B, int S, int Hq, int Hkv, int Tlen, int dh,
                                             int window, int n_split, void* stream) {
  if (B <= 0 || S <= 0 || Tlen <= 0 || Hkv <= 0 || Hq < Hkv || Hq % Hkv != 0 ||
      64 % (Hq / Hkv) != 0 || B * Hkv > 65535 || dh < 16 || dh % 8 != 0 ||
      (dh + 15) / 16 * 16 > 256 || n_split < 1 || n_split > kChunkMaxSplits ||
      (n_split & (n_split - 1)) != 0 || ((long long)S * (Hq / Hkv) + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto qs = static_cast<const int32_t*>(q_start);
  const int G = Hq / Hkv;
  // the padded width's column chunks of 64
  if (dh <= 64)
    return (int)chunk_launch_typed<1>(q, k_new, v_new, k, v, qs, out, B, S, Hkv, G, Tlen, dh,
                                      window, n_split, st);
  if (dh <= 128)
    return (int)chunk_launch_typed<2>(q, k_new, v_new, k, v, qs, out, B, S, Hkv, G, Tlen, dh,
                                      window, n_split, st);
  if (dh <= 192)
    return (int)chunk_launch_typed<3>(q, k_new, v_new, k, v, qs, out, B, S, Hkv, G, Tlen, dh,
                                      window, n_split, st);
  return (int)chunk_launch_typed<4>(q, k_new, v_new, k, v, qs, out, B, S, Hkv, G, Tlen, dh,
                                    window, n_split, st);
}
