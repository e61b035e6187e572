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
// (S = 1, decode_step) and G <= 16 rows per KV head.  At decode the split
// variant's time is all fixed cost: two launches, a round trip of the
// partials through device memory, scalar loads with an integer division per
// element, serial FMA chains, and two more launches before it for the cache
// inserts.  This variant is one launch that does all of it:
//  * Grid (n_splits, B*Hkv), a cluster of the n_splits <= 8 blocks of one
//    (b, KV head) along x; n_splits comes from the static T (plan_fused), so
//    q_start stays on the device and the launch can be captured in a CUDA
//    graph.
//  * The block whose split holds position q_start[b] writes k_new/v_new into
//    the cache there, and puts the same 16-byte chunks in its shared tile in
//    place of the cache row, so the cache is never read back.
//  * K/V tiles of tk keys (a power of two from 16 to 128 and 16 KB of K at
//    most: 128 keys at dh 64 in bf16, one tile a split at TinyLlama's decode;
//    a kernel built for 128-key tiles and one that reads tk at run time)
//    come in through 16-byte cp.async
//    copies in their own dtype, double-buffered: the next tile's copies fly
//    while this tile is scored.  Only rows of visible keys are copied.
//  * Scores: 128 threads a block, 128/tk per key, each over interleaved
//    16-byte chunks of the row (the K tile's row stride is padded so that a
//    quarter-warp's chunks fall in distinct banks), all query rows from fp32
//    shared memory (G padded with zero rows to GMAX, so no row loop
//    branches); 32/(128/tk) keys per warp in flight.  Per-row maxima are
//    reduced across warps in shared memory, the online softmax (m, l) runs
//    in fp32.
//  * P·V: each thread owns pairs of output elements and walks the whole
//    tile, eight keys in flight (rows that are not visible are zero-filled
//    and have probability 0, so the loop has a fixed count); V pairs are
//    read as one 4- or 8-byte access.
//  * Combine: each block leaves (m, l, acc) in its own shared memory; after a
//    cluster barrier every rank takes 1/n_splits of the head's outputs and
//    reads all ranks' partials for them through distributed shared memory,
//    every load in flight at once, summed in split order (reruns are equal
//    bit for bit), and writes out in q's dtype; a second cluster barrier
//    keeps every rank's shared memory alive until all have read it.  A block
//    with no visible key leaves an empty partial (m = -inf, l = 0) and still
//    reaches both barriers.
//  * No scratch in device memory; the shared-memory limit is set once, at
//    load (decode_attention_fused_init).
//  * Every loop over chunks, rows or keys runs a fixed count with a
//    predicate.  An earlier form, with loops bounded by the visible range,
//    gave wrong sums and staged rows past the tile in the G <= 4 kernels on
//    the card, and was right when built with -Xptxas -O0.  Whether that was a
//    fault of nvcc 12.9 at -O3 or undefined behaviour in that form is not
//    known: no reduced reproducer or SASS comparison was kept.
//  * Positions at or past T write nothing (the engine refuses such requests).
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
constexpr int kFusedMaxSplits = 8;  // the portable cluster size
// 16-byte chunks of the largest tile the launch takes (16 KB of K), of a
// G x dh query block (16 x 256 fp32) and of a row's score pass, per thread:
// every loop over them runs a fixed count with a predicate
constexpr int kFusedChunkIters = (16384 / 16) / kFusedThreads;

// Row stride (bytes) of a K tile: a row of dh elements padded so that the
// 16-byte chunks of a quarter-warp in the score pass ((key, sub) lanes, key
// stride `stride`, chunk `sub`) fall in distinct banks.
__host__ __device__ inline int fused_kstride(int row_bytes, int tpk) {
  const int want = (tpk * 16) & 127;
  return row_bytes + ((want - (row_bytes & 127)) & 127);
}

// Dynamic shared memory of one block: q (later the partial acc) [GMAX][dh] fp32,
// two K and two V tiles, probabilities [GMAX][tk + 1], per-warp row values
// [warps][GMAX], alpha, m and l [GMAX].
__host__ __device__ inline size_t fused_smem_bytes(int dh, int isz, int tk, int gmax) {
  const int row = dh * isz;
  const int tpk = kFusedThreads / tk;
  return (size_t)gmax * dh * 4 + 2 * (size_t)tk * fused_kstride(row, tpk) + 2 * (size_t)tk * row +
         4 * ((size_t)gmax * (tk + 1) + (size_t)kFusedWarps * gmax + 3 * (size_t)gmax);
}

template <typename T>
__device__ __forceinline__ void chunk_to_f32(const uint4& raw, float (&x)[16 / sizeof(T)]) {
  T e[16 / sizeof(T)];
  memcpy(e, &raw, 16);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) x[i] = to_f32(e[i]);
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// grid: (n_splits, B * Hkv), cluster (n_splits, 1, 1); block: kFusedThreads.
// tk (16, 32, 64 or 128) keys per tile: TK if it is set at build, else the
// tk_arg of the launch.  GMAX >= G query rows per KV head.
template <typename T, int TK, int GMAX>
__global__ void __launch_bounds__(kFusedThreads)
decode_attention_fused_kernel(const T* __restrict__ q,      // [B,1,Hq,dh]
                              const T* __restrict__ k_new,  // [B,1,Hkv,dh]
                              const T* __restrict__ v_new,
                              T* __restrict__ k,            // [B,Tlen,Hkv,dh]
                              T* __restrict__ v,
                              const int32_t* __restrict__ q_start,  // [B]
                              T* __restrict__ out,          // [B,1,Hq,dh]
                              int Hkv, int G, int Tlen, int dh, int window, int split_len,
                              int tk_arg) {
  const int tk = TK > 0 ? TK : tk_arg;
  const int tpk = kFusedThreads / tk;  // threads per key in the score pass
  constexpr int EPC = 16 / sizeof(T);      // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char fsmem[];
  const int row_bytes = dh * (int)sizeof(T);
  const int cpr = row_bytes / 16;  // chunks per K/V row
  const int kstride = fused_kstride(row_bytes, tpk);
  float* q_s = reinterpret_cast<float*>(fsmem);  // [GMAX][dh]; after the loop: the partial acc
  unsigned char* kb = fsmem + (size_t)GMAX * dh * 4;  // 2 x [tk][kstride]
  unsigned char* vb = kb + 2 * tk * kstride;      // 2 x [tk][row_bytes]
  float* p_s = reinterpret_cast<float*>(vb + 2 * tk * row_bytes);  // [GMAX][tk + 1]
  float* red = p_s + GMAX * (tk + 1);   // [warps][GMAX]
  float* alpha_s = red + kFusedWarps * GMAX;
  float* part_m = alpha_s + GMAX;
  float* part_l = part_m + GMAX;

  const int split = blockIdx.x;  // the block's rank in its cluster
  const int bh = blockIdx.y;
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // this split's visible keys [key_lo, key_hi]
  const int qpos = q_start[b];
  const int vis_lo = window > 0 ? max(0, qpos - window + 1) : 0;
  const int vis_hi = min(Tlen - 1, qpos);
  const int split_lo = split * split_len;
  const int split_hi = min(Tlen, split_lo + split_len) - 1;
  const int key_lo = max(vis_lo, split_lo);
  const int key_hi = min(vis_hi, split_hi);
  const size_t pos_stride = (size_t)Hkv * dh;  // elements from one position to the next
  T* krows = k + (size_t)b * Tlen * pos_stride + (size_t)kvh * dh;  // position t at t * pos_stride
  T* vrows = v + (size_t)b * Tlen * pos_stride + (size_t)kvh * dh;
  const uint4* kn = reinterpret_cast<const uint4*>(k_new + (size_t)bh * dh);
  const uint4* vn = reinterpret_cast<const uint4*>(v_new + (size_t)bh * dh);

  // the split that holds q_start writes the new row into the cache
  if (qpos >= split_lo && qpos <= split_hi) {
    for (int c = tid; c < cpr; c += kFusedThreads) {
      reinterpret_cast<uint4*>(krows + (size_t)qpos * pos_stride)[c] = __ldg(kn + c);
      reinterpret_cast<uint4*>(vrows + (size_t)qpos * pos_stride)[c] = __ldg(vn + c);
    }
  }

  // copies of the visible rows of the tile at t0 into buffer `buf`; the new
  // row comes from k_new/v_new, never from the cache
  auto stage = [&](int t0, int buf) {
    const int r_lo = max(key_lo, t0) - t0;
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
      if (r < r_lo || r > r_hi) {  // not visible: its probability is 0, its V row zeros
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

  const int n_tiles = key_lo <= key_hi ? key_hi / tk - key_lo / tk + 1 : 0;
  const int t_first = (key_lo / tk) * tk;
  if (n_tiles > 0) {
    stage(t_first, 0);
    // this head's G query rows are contiguous: G * dh elements, fp32 in shared
    // memory, and rows G..GMAX-1 zeros (every row loop then runs GMAX rows
    // without a branch; those rows are never written out)
    const uint4* qg = reinterpret_cast<const uint4*>(q + (size_t)bh * G * dh);
#pragma unroll
    for (int it = 0; it < kFusedChunkIters; ++it) {  // GMAX * cpr <= 16 * 64 chunks
      const int c = tid + kFusedThreads * it;
      if (c >= GMAX * cpr) break;
      float x[EPC];
      chunk_to_f32<T>(c < G * cpr ? __ldg(qg + c) : make_uint4(0u, 0u, 0u, 0u), x);
#pragma unroll
      for (int e = 0; e < EPC; e += 4)
        *reinterpret_cast<float4*>(q_s + c * EPC + e) = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
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
    const int t0 = t_first + it * tk;
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile `it` (and q) visible; the other buffer fully consumed
    if (it + 1 < n_tiles) stage(t0 + tk, buf ^ 1);

    // scores of key j for every row
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    const unsigned char* krow = kb + buf * tk * kstride + j * kstride;
#pragma unroll
    for (int it = 0; it < kFusedChunkIters; ++it) {  // cpr / tpk = tk * cpr / kFusedThreads chunks
      const int ch = sub + tpk * it;
      if (ch >= cpr) break;
      float kx[EPC];
      chunk_to_f32<T>(*reinterpret_cast<const uint4*>(krow + ch * 16), kx);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + g * dh + ch * EPC + e);
          s[g] = fmaf(qv.x, kx[e], s[g]);
          s[g] = fmaf(qv.y, kx[e + 1], s[g]);
          s[g] = fmaf(qv.z, kx[e + 2], s[g]);
          s[g] = fmaf(qv.w, kx[e + 3], s[g]);
        }
      }
    }
    const int kp = t0 + j;
    const bool visible = kp >= key_lo && kp <= key_hi;
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

    // acc = acc * alpha + P·V over the whole tile (a key that is not visible
    // has probability 0 and a zero V row), eight keys in flight
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
      const T* vrow = reinterpret_cast<const T*>(vt + jj * row_bytes);
#pragma unroll
      for (int i = 0; i < GMAX; ++i) {
        if (tid + kFusedThreads * i < n_pairs) {
          const float p = p_s[pg[i] * (tk + 1) + jj];
          const float2 vv = load_pair(vrow + pd[i]);
          acc[i][0] = fmaf(p, vv.x, acc[i][0]);
          acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        }
      }
    }
  }

  // this block's partial: l summed over threads, acc into q's place
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
  cluster_sync();  // every rank's partial is in its shared memory

  // combine: each rank takes a slice of this head's output pairs and reads
  // every rank's (m, l, acc) for it through distributed shared memory, all
  // loads in flight at once, summed in split order (reruns are bit-equal)
  {
    const int n_splits = gridDim.x;
    const int per_rank = (n_pairs + n_splits - 1) / n_splits;
    const int p_end = min(n_pairs, (split + 1) * per_rank);
    T* o = out + (size_t)bh * G * dh;  // this head's G rows are contiguous
#pragma unroll 1
    for (int it = 0; it < GMAX; ++it) {  // per_rank <= n_pairs <= kFusedThreads * GMAX
      const int pi = split * per_rank + tid + kFusedThreads * it;
      if (pi >= p_end) continue;
      const int g = 2 * pi / dh;
      float mr[kFusedMaxSplits], lr[kFusedMaxSplits];
      float2 ar[kFusedMaxSplits];
#pragma unroll
      for (int r = 0; r < kFusedMaxSplits; ++r) {
        if (r < n_splits) {
          mr[r] = ld_cluster_f32(cluster_map(part_m + g, r));
          lr[r] = ld_cluster_f32(cluster_map(part_l + g, r));
          ar[r] = ld_cluster_f32x2(cluster_map(part_acc + 2 * pi, r));
        }
      }
      float M = -INFINITY;
#pragma unroll
      for (int r = 0; r < kFusedMaxSplits; ++r)
        if (r < n_splits) M = fmaxf(M, mr[r]);
      float L = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int r = 0; r < kFusedMaxSplits; ++r) {
        if (r < n_splits && mr[r] != -INFINITY) {  // skip empty splits
          const float w = expf(mr[r] - M);
          L = fmaf(lr[r], w, L);
          a0 = fmaf(ar[r].x, w, a0);
          a1 = fmaf(ar[r].y, w, a1);
        }
      }
      const float inv = L > 0.f ? 1.f / L : 0.f;
      store_pair(o + 2 * pi, a0 * inv, a1 * inv);
    }
  }
  cluster_sync();  // every rank's shared memory stays until all have read it
}

template <typename T, int TK, int GMAX>
size_t fused_max_smem() {
  // the largest block over the key tiles the kernel takes: at tk keys the
  // widest row plan_fused gives is 16 KB / tk (at most 256 elements)
  size_t most = 0;
  for (int tk = 16; tk <= 128; tk *= 2) {
    if (TK > 0 && tk != TK) continue;
    const int widest = (16384 / tk) / (int)sizeof(T);
    const size_t bytes = fused_smem_bytes(widest < 256 ? widest : 256, sizeof(T), tk, GMAX);
    most = bytes > most ? bytes : most;
  }
  return most;
}

template <typename T, int TK, int GMAX>
cudaError_t fused_init_one() {
  return cudaFuncSetAttribute(decode_attention_fused_kernel<T, TK, GMAX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)fused_max_smem<T, TK, GMAX>());
}

template <typename T, int TK, int GMAX>
cudaError_t fused_launch_typed(const void* q, const void* kn, const void* vn, void* k, void* v,
                               const int32_t* qs, void* out, int B, int Hkv, int G, int Tlen,
                               int dh, int window, int n_splits, int split_len, int tk,
                               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, B * Hkv, 1);
  cfg.blockDim = dim3(kFusedThreads, 1, 1);
  cfg.dynamicSmemBytes = fused_smem_bytes(dh, sizeof(T), tk, GMAX);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_attention_fused_kernel<T, TK, GMAX>, static_cast<const T*>(q),
      static_cast<const T*>(kn), static_cast<const T*>(vn), static_cast<T*>(k),
      static_cast<T*>(v), qs, static_cast<T*>(out), Hkv, G, Tlen, dh, window, split_len, tk);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int TK>
cudaError_t fused_launch_g(const void* q, const void* kn, const void* vn, void* k, void* v,
                           const int32_t* qs, void* out, int B, int Hkv, int G, int Tlen, int dh,
                           int window, int n_splits, int split_len, int tk, cudaStream_t st) {
  if (G <= 4)
    return fused_launch_typed<T, TK, 4>(q, kn, vn, k, v, qs, out, B, Hkv, G, Tlen, dh, window, n_splits, split_len, tk, st);
  if (G <= 8)
    return fused_launch_typed<T, TK, 8>(q, kn, vn, k, v, qs, out, B, Hkv, G, Tlen, dh, window, n_splits, split_len, tk, st);
  return fused_launch_typed<T, TK, 16>(q, kn, vn, k, v, qs, out, B, Hkv, G, Tlen, dh, window, n_splits, split_len, tk, st);
}

// 128-key tiles (rows of at most 128 bytes: dh <= 64 in bf16, the decode
// shapes of the smaller models) take a kernel built for them: with the tile
// read at run time the TinyLlama decode shape took 0.0189 ms instead of
// 0.0155 on an H100.  Other tiles share one kernel that reads tk at run time.
template <typename T>
cudaError_t fused_launch_tk(const void* q, const void* kn, const void* vn, void* k, void* v,
                            const int32_t* qs, void* out, int B, int Hkv, int G, int Tlen, int dh,
                            int window, int n_splits, int split_len, int tk, cudaStream_t st) {
  if (tk == 128)
    return fused_launch_g<T, 128>(q, kn, vn, k, v, qs, out, B, Hkv, G, Tlen, dh, window, n_splits, split_len, tk, st);
  return fused_launch_g<T, 0>(q, kn, vn, k, v, qs, out, B, Hkv, G, Tlen, dh, window, n_splits, split_len, tk, st);
}

template <typename T>
cudaError_t fused_init_typed() {
  const cudaError_t errs[] = {
      fused_init_one<T, 128, 4>(), fused_init_one<T, 128, 8>(), fused_init_one<T, 128, 16>(),
      fused_init_one<T, 0, 4>(), fused_init_one<T, 0, 8>(), fused_init_one<T, 0, 16>(),
  };
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
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
  cudaError_t e = fused_init_typed<float>();
  if (e == cudaSuccess) e = fused_init_typed<__nv_bfloat16>();
  return (int)e;
}

// C entry point of the fused variant (bound with ctypes).  q [B,1,Hq,dh],
// k_new/v_new [B,1,Hkv,dh], k/v caches [B,T,Hkv,dh] (row q_start[b] written
// in place), out [B,1,Hq,dh]; every pointer 16-byte aligned.  dtype: 0 = fp32,
// 1 = bf16.  window <= 0 means no window.  tk keys per tile (128, 64, 32 or 16,
// with dh * itemsize * tk <= 16 KB); split_len a multiple of tk, and
// n_splits = ceil(T / split_len) <= 8.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int decode_attention_fused_launch(const void* q, const void* k_new, const void* v_new,
                                             void* k, void* v, const void* q_start, void* out,
                                             int B, int Hq, int Hkv, int Tlen, int dh, int window,
                                             int n_splits, int split_len, int tk, int dtype,
                                             void* stream) {
  const int isz = dtype == 0 ? 4 : 2;
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 16 || B * Hkv > 65535 || dh <= 0 ||
      dh > 256 || dh % 8 != 0 || (tk != 128 && tk != 64 && tk != 32 && tk != 16) ||
      dh * isz * tk > 16384 || split_len <= 0 || split_len % tk != 0 || n_splits <= 0 ||
      n_splits > kFusedMaxSplits || (n_splits - 1) * split_len >= Tlen ||
      n_splits * split_len < Tlen)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto qs = static_cast<const int32_t*>(q_start);
  const int G = Hq / Hkv;
  if (dtype == 0)
    return (int)fused_launch_tk<float>(q, k_new, v_new, k, v, qs, out, B, Hkv, G, Tlen, dh,
                                       window, n_splits, split_len, tk, st);
  if (dtype == 1)
    return (int)fused_launch_tk<__nv_bfloat16>(q, k_new, v_new, k, v, qs, out, B, Hkv, G, Tlen,
                                               dh, window, n_splits, split_len, tk, st);
  return (int)cudaErrorInvalidValue;
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
