// Full-sequence GQA flash attention for Hopper (sm_90a): forward, and a
// FlashAttention-2 style backward in two deterministic kernels.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
//   (pallas_call at :114, body _flash_kernel at :23; wrapper ops.py:26)
// and computes what its oracle computes
//   src/repro/kernels/flash_attention/ref.py::attention_ref
// q [B,Sq,Hq,dh], k/v [B,Sk,Hkv,dh]; query position s of head h attends key
// position t when t < Sk, and (causal) t <= s, and (window) t > s - window.
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
//  * wmma: bf16 with G not dividing 64: mma.sync through WMMA 16x16x16
//    tiles of 32 rows, products through shared memory.
//  * fma: fp32 on the CUDA cores (67 TFLOP/s peak), since TF32 would round
//    the inputs: the exact parity path.
// What the design does, in all three:
//  * The TPU grid (B, Hq, n_q, n_k) walks the KV axis in order and carries
//    m/l/acc in VMEM.  Here one block owns a tile of query rows and loops
//    over key tiles itself, carrying m/l/acc on the chip.  A block's rows
//    are (position, head) pairs of one KV head, r = s*G + g, so the G query
//    heads of a GQA group share every K/V tile the block stages.
//  * Key tiles wholly outside the rows' causal/window range are never read
//    (the TPU kernel computes them and lets alpha wash them out); the ragged
//    edge t >= Sk is masked here, so the wrapper pads nothing.
//  * Backward: one block per (b, kv head, key tile) accumulates dK and dV over
//    every query row of the G heads that sees the tile; one block per (b, kv
//    head, row tile) accumulates dQ over key tiles.  Both recompute P from Q,
//    K and the saved logsumexp.  No atomics: the gradients are the same from
//    run to run.
//  * fp32: register tiling over a 16 x 8 grid of 128 threads; a thread owns
//    TM rows (strided by 16) and 8 keys or dh/8 head columns (strided by 8),
//    so every product reads shared memory without bank conflicts (tiles are
//    stored with an odd row stride) and does TM*8 FMAs per 8+TM loads.  Tiles
//    shrink as dh grows (TM 4 -> 2 or 1) so that accumulators stay in
//    registers and tiles fit the 227 KB of dynamic shared memory at dh 256.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "vec_io.cuh"

namespace {

constexpr int kThreads = 128;  // a 16 x 8 grid of threads
constexpr int kRowGroups = 16;
constexpr int kColGroups = 8;
constexpr int kKeyTile = 64;   // keys per tile in the forward and dQ kernels
constexpr int kRowTileBwd = 32;  // query rows per tile in the dK/dV kernel

// x rounded to T and back: the cast of P to V's type
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
// reductions over the 8 lanes (tn = 0..7) that hold one row
__device__ __forceinline__ float group8_max(float x) {
  for (int o = 4; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group8_sum(float x) {
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
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

// Stage `n` rows starting at row r0 of a [B,S,Hq,dh] tensor into dst[n][ld]
// (zeros past Rtot).
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, int n, int r0,
                                           int Rtot, int b, int G, int kvh, int S, int Hq,
                                           int dh, int ld) {
  for (int idx = threadIdx.x; idx < n * dh; idx += kThreads) {
    const int i = idx / dh, d = idx - (idx / dh) * dh;
    const int r = r0 + i;
    dst[i * ld + d] = r < Rtot ? to_f32(src[row_offset(b, r, G, kvh, S, Hq, dh) + d]) : 0.f;
  }
}

// Stage `n` keys starting at t0 of a [B,Sk,Hkv,dh] tensor into dst[n][ld]
// (zeros past Sk).
template <typename T>
__device__ __forceinline__ void stage_keys(float* dst, const T* __restrict__ src, int n, int t0,
                                           int b, int kvh, int Sk, int Hkv, int dh, int ld) {
  for (int idx = threadIdx.x; idx < n * dh; idx += kThreads) {
    const int j = idx / dh, d = idx - (idx / dh) * dh;
    const int kp = t0 + j;
    dst[j * ld + d] =
        kp < Sk ? to_f32(src[(((size_t)b * Sk + kp) * Hkv + kvh) * dh + d]) : 0.f;
  }
}

// D[i] = sum_d dO[r0+i, d] * O[r0+i, d] for n rows, one warp per row.
template <typename T>
__device__ __forceinline__ void stage_delta(float* D, const T* __restrict__ o,
                                            const T* __restrict__ dout, int n, int r0, int Rtot,
                                            int b, int G, int kvh, int S, int Hq, int dh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += kThreads / 32) {
    const int r = r0 + i;
    float acc = 0.f;
    if (r < Rtot) {
      const size_t off = row_offset(b, r, G, kvh, S, Hq, dh);
      for (int d = lane; d < dh; d += 32) acc = fmaf(to_f32(dout[off + d]), to_f32(o[off + d]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) D[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// forward
// grid: (ceil(Sq*G / R), B*Hkv); R = 16*TM rows; key tiles of 64.
// smem: Qs[R][dh+1], Ks[64][dh+1], Vs[64][dh+1], Ps[R][65]
// ---------------------------------------------------------------------------
template <typename T, int TM, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                 int dh, int causal, int window, float scale) {
  constexpr int R = kRowGroups * TM;
  constexpr int TK = kKeyTile;
  constexpr int TN = TK / kColGroups;  // keys per thread
  constexpr int ldp = TK + 1;
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* Qs = smem;
  float* Ks = Qs + R * ld;
  float* Vs = Ks + TK * ld;
  float* Ps = Vs + TK * ld;

  const int G = Hq / Hkv;
  const int Rtot = Sq * G;
  const int r0 = blockIdx.x * R;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tm = warp * 4 + (lane >> 3);
  const int tn = lane & 7;
  const int dpt = dh / kColGroups;

  const int p_lo = r0 / G, p_hi = (min(Rtot, r0 + R) - 1) / G;
  const int key_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int key_hi = causal ? min(Sk - 1, p_hi) : Sk - 1;

  stage_rows(Qs, q, R, r0, Rtot, b, G, kvh, Sq, Hq, dh, ld);

  int qpos[TM];
  bool row_ok[TM];
  float m_run[TM], l_run[TM], acc[TM][DPT];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + tm + kRowGroups * i;
    row_ok[i] = r < Rtot;
    qpos[i] = r / G;
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = (key_lo / TK) * TK; t0 <= key_hi; t0 += TK) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    stage_keys(Ks, k, TK, t0, b, kvh, Sk, Hkv, dh, ld);
    stage_keys(Vs, v, TK, t0, b, kvh, Sk, Hkv, dh, ld);
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float a[TM], bk[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Qs[(tm + kRowGroups * i) * ld + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) bk[j] = Ks[(tn + kColGroups * j) * ld + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kp = t0 + tn + kColGroups * j;
        const bool ok = row_ok[i] && visible(kp, qpos[i], Sk, causal, window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = group8_max(mt);
      const float m_new = fmaxf(m_run[i], mt);
      // rows that have seen no visible key yet keep m = -inf, l = 0, acc = 0;
      // subtracting 0 instead of -inf keeps exp() away from NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_run[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_use);
        psum += p;
        Ps[(tm + kRowGroups * i) * ldp + tn + kColGroups * j] = round_to<T>(p);
      }
      psum = group8_sum(psum);
      l_run[i] = l_run[i] * alpha + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < TK; ++j) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Ps[(tm + kRowGroups * i) * ldp + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        if (c < dpt) {
          const float bv = Vs[j * ld + tn + kColGroups * c];
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][c] = fmaf(a[i], bv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (!row_ok[i]) continue;  // rows past Sq write nothing
    const int r = r0 + tm + kRowGroups * i;
    const size_t off = row_offset(b, r, G, kvh, Sq, Hq, dh);
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      if (c < dpt) o[off + tn + kColGroups * c] = from_f32<T>(acc[i][c] * inv);
    if (tn == 0) {
      const int s = r / G, h = kvh * G + (r - s * G);
      lse[((size_t)b * Hq + h) * Sq + s] =
          l_run[i] > 0.f ? m_run[i] + logf(l_run[i]) : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV
// grid: (ceil(Sk / TKB), B*Hkv); TKB = 16*TM keys; row tiles of 32.
// smem: Ks[TKB][dh+1], Vs[TKB][dh+1], Qs[32][dh+1], dOs[32][dh+1],
//       Ps[32][TKB+1], dSs[32][TKB+1], lse_s[32], D_s[32]
// ---------------------------------------------------------------------------
template <typename T, int TM, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ o,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
                      int dh, int causal, int window, float scale) {
  constexpr int TKB = kRowGroups * TM;
  constexpr int RB = kRowTileBwd;
  constexpr int TN = RB / kColGroups;  // rows per thread
  constexpr int ldp = TKB + 1;
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* Ks = smem;
  float* Vs = Ks + TKB * ld;
  float* Qs = Vs + TKB * ld;
  float* dOs = Qs + RB * ld;
  float* Ps = dOs + RB * ld;
  float* dSs = Ps + RB * ldp;
  float* lse_s = dSs + RB * ldp;
  float* D_s = lse_s + RB;

  const int G = Hq / Hkv;
  const int Rtot = Sq * G;
  const int k0 = blockIdx.x * TKB;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tm = warp * 4 + (lane >> 3);
  const int tn = lane & 7;
  const int dpt = dh / kColGroups;

  // query positions that can see a key of this tile
  const int k_last = min(Sk, k0 + TKB) - 1;
  const int p_min = causal ? k0 : 0;
  const int p_max = window > 0 ? min(Sq - 1, k_last + window - 1) : Sq - 1;

  stage_keys(Ks, k, TKB, k0, b, kvh, Sk, Hkv, dh, ld);
  stage_keys(Vs, v, TKB, k0, b, kvh, Sk, Hkv, dh, ld);

  int kpos[TM];
  float dk_acc[TM][DPT], dv_acc[TM][DPT];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    kpos[i] = k0 + tm + kRowGroups * i;
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  const int row_end = min(Rtot, (p_max + 1) * G);
  for (int rt0 = ((p_min * G) / RB) * RB; rt0 < row_end; rt0 += RB) {
    __syncthreads();  // the previous row tile is consumed (and K/V are staged)
    stage_rows(Qs, q, RB, rt0, Rtot, b, G, kvh, Sq, Hq, dh, ld);
    stage_rows(dOs, dout, RB, rt0, Rtot, b, G, kvh, Sq, Hq, dh, ld);
    stage_delta(D_s, o, dout, RB, rt0, Rtot, b, G, kvh, Sq, Hq, dh);
    for (int i = threadIdx.x; i < RB; i += kThreads) {
      const int r = rt0 + i;
      float x = 0.f;
      if (r < Rtot) {
        const int s = r / G, h = kvh * G + (r - s * G);
        x = lse[((size_t)b * Hq + h) * Sq + s];
      }
      lse_s[i] = x;
    }
    __syncthreads();

    // S^T and dP^T for this thread's keys x rows
    float st[TM][TN], dps[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) st[i][j] = dps[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float ak[TM], av[TM], bq[TN], bdo[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ak[i] = Ks[(tm + kRowGroups * i) * ld + d];
        av[i] = Vs[(tm + kRowGroups * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bq[j] = Qs[(tn + kColGroups * j) * ld + d];
        bdo[j] = dOs[(tn + kColGroups * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          st[i][j] = fmaf(ak[i], bq[j], st[i][j]);
          dps[i][j] = fmaf(av[i], bdo[j], dps[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int rl = tn + kColGroups * j;
        const int r = rt0 + rl;
        const bool ok = r < Rtot && visible(kpos[i], r / G, Sk, causal, window);
        const float p = ok ? expf(st[i][j] * scale - lse_s[rl]) : 0.f;
        const int kl = tm + kRowGroups * i;
        Ps[rl * ldp + kl] = round_to<T>(p);
        dSs[rl * ldp + kl] = p * (dps[i][j] - D_s[rl]);
      }
    __syncthreads();

    for (int rl = 0; rl < RB; ++rl) {
      float pa[TM], da[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        pa[i] = Ps[rl * ldp + tm + kRowGroups * i];
        da[i] = dSs[rl * ldp + tm + kRowGroups * i];
      }
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        if (c < dpt) {
          const float bdo = dOs[rl * ld + tn + kColGroups * c];
          const float bq = Qs[rl * ld + tn + kColGroups * c];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            dv_acc[i][c] = fmaf(pa[i], bdo, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(da[i], bq, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (kpos[i] >= Sk) continue;
    const size_t off = (((size_t)b * Sk + kpos[i]) * Hkv + kvh) * dh;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      if (c < dpt) {
        dk[off + tn + kColGroups * c] = from_f32<T>(dk_acc[i][c] * scale);
        dv[off + tn + kColGroups * c] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dQ
// grid: (ceil(Sq*G / R), B*Hkv); R = 16*TM rows; key tiles of 64.
// smem: Qs[R][dh+1], dOs[R][dh+1], Ks[64][dh+1], Vs[64][dh+1], dSs[R][65],
//       lse_s[R], D_s[R]
// ---------------------------------------------------------------------------
template <typename T, int TM, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq, int Sq, int Sk, int Hq,
                    int Hkv, int dh, int causal, int window, float scale) {
  constexpr int R = kRowGroups * TM;
  constexpr int TK = kKeyTile;
  constexpr int TN = TK / kColGroups;
  constexpr int ldp = TK + 1;
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* Qs = smem;
  float* dOs = Qs + R * ld;
  float* Ks = dOs + R * ld;
  float* Vs = Ks + TK * ld;
  float* dSs = Vs + TK * ld;
  float* lse_s = dSs + R * ldp;
  float* D_s = lse_s + R;

  const int G = Hq / Hkv;
  const int Rtot = Sq * G;
  const int r0 = blockIdx.x * R;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tm = warp * 4 + (lane >> 3);
  const int tn = lane & 7;
  const int dpt = dh / kColGroups;

  const int p_lo = r0 / G, p_hi = (min(Rtot, r0 + R) - 1) / G;
  const int key_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int key_hi = causal ? min(Sk - 1, p_hi) : Sk - 1;

  stage_rows(Qs, q, R, r0, Rtot, b, G, kvh, Sq, Hq, dh, ld);
  stage_rows(dOs, dout, R, r0, Rtot, b, G, kvh, Sq, Hq, dh, ld);
  stage_delta(D_s, o, dout, R, r0, Rtot, b, G, kvh, Sq, Hq, dh);
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const int r = r0 + i;
    float x = 0.f;
    if (r < Rtot) {
      const int s = r / G, h = kvh * G + (r - s * G);
      x = lse[((size_t)b * Hq + h) * Sq + s];
    }
    lse_s[i] = x;
  }

  int qpos[TM];
  bool row_ok[TM];
  float dq_acc[TM][DPT];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + tm + kRowGroups * i;
    row_ok[i] = r < Rtot;
    qpos[i] = r / G;
#pragma unroll
    for (int c = 0; c < DPT; ++c) dq_acc[i][c] = 0.f;
  }

  for (int t0 = (key_lo / TK) * TK; t0 <= key_hi; t0 += TK) {
    __syncthreads();  // the previous tile is consumed (and Q, dO, lse, D are staged)
    stage_keys(Ks, k, TK, t0, b, kvh, Sk, Hkv, dh, ld);
    stage_keys(Vs, v, TK, t0, b, kvh, Sk, Hkv, dh, ld);
    __syncthreads();

    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float aq[TM], ado[TM], bk[TN], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        aq[i] = Qs[(tm + kRowGroups * i) * ld + d];
        ado[i] = dOs[(tm + kRowGroups * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bk[j] = Ks[(tn + kColGroups * j) * ld + d];
        bv[j] = Vs[(tn + kColGroups * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(ado[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int rl = tm + kRowGroups * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kl = tn + kColGroups * j;
        const bool ok = row_ok[i] && visible(t0 + kl, qpos[i], Sk, causal, window);
        const float p = ok ? expf(s[i][j] * scale - lse_s[rl]) : 0.f;
        dSs[rl * ldp + kl] = p * (dp[i][j] - D_s[rl]);
      }
    }
    __syncthreads();

    for (int j = 0; j < TK; ++j) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = dSs[(tm + kRowGroups * i) * ldp + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        if (c < dpt) {
          const float bk = Ks[j * ld + tn + kColGroups * c];
#pragma unroll
          for (int i = 0; i < TM; ++i) dq_acc[i][c] = fmaf(a[i], bk, dq_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (!row_ok[i]) continue;
    const size_t off = row_offset(b, r0 + tm + kRowGroups * i, G, kvh, Sq, Hq, dh);
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      if (c < dpt) dq[off + tn + kColGroups * c] = from_f32<T>(dq_acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync through WMMA, 16x16x16, fp32 sums)
//
// The same three kernels for bf16 inputs, with every tile product on the
// tensor cores.  Tiles stay bf16 in shared memory (dh padded to a multiple of
// 16 with zeros, so dh 8 works); each product writes or accumulates an fp32
// tile in shared memory, and the 16 x 8 thread grid does the softmax, the
// masks and the rescaling on those tiles as the fp32 kernels do.  S and dP
// are exact products of the bf16 inputs summed in fp32, as above; P is
// rounded to bf16 for P.V and dV (the cast of _flash_kernel:76), and dS is
// rounded to bf16 for dQ and dK, as FlashAttention-2 does.  TILE is both the
// row tile and the key tile, 32 so that tiles fit at dh 256.  These kernels
// serve the bf16 shapes the wgmma kernels below do not take: padded dh above
// 128, and GQA groups G that do not divide 64.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kBfPad = 8;  // bf16 row padding: ld stays a multiple of 8
constexpr int kF32Pad = 4;  // fp32 row padding: ld stays a multiple of 4

__host__ __device__ constexpr int pad16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

constexpr int TILE = 32;  // row and key tile of the WMMA kernels

// C[M x N] (fp32, row-major, ldc) = (kAccumulate ? C : 0) + A[M x K] . B[K x N]
// on the tensor cores; A and B are bf16 in shared memory, each row- or
// column-major.  M, N, K are multiples of 16; the block's 4 warps share the
// 16 x 16 output tiles.
template <typename ALayout, typename BLayout, bool kAccumulate>
__device__ __forceinline__ void tc_gemm(float* C, int ldc, const bf16* A, int lda,
                                        const bf16* B, int ldb, int M, int N, int K) {
  using namespace nvcuda;
  constexpr bool a_row = std::is_same<ALayout, wmma::row_major>::value;
  constexpr bool b_row = std::is_same<BLayout, wmma::row_major>::value;
  const int tiles_n = N / 16;
  for (int t = threadIdx.x >> 5; t < (M / 16) * tiles_n; t += kThreads / 32) {
    const int m0 = (t / tiles_n) * 16, n0 = (t % tiles_n) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (kAccumulate)
      wmma::load_matrix_sync(acc, C + m0 * ldc + n0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
      wmma::load_matrix_sync(a, a_row ? A + m0 * lda + k0 : A + k0 * lda + m0, lda);
      wmma::load_matrix_sync(b, b_row ? B + k0 * ldb + n0 : B + n0 * ldb + k0, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + m0 * ldc + n0, acc, ldc, wmma::mem_row_major);
  }
}

// Stage n rows from r0 of a [B,S,Hq,dh] bf16 tensor into dst[n][ld], 16 bytes
// at a time; columns dh..dhp-1 and rows past Rtot are zeros.
__device__ __forceinline__ void stage_rows_tc(bf16* dst, int ld, const bf16* __restrict__ src,
                                              int n, int r0, int Rtot, int b, int G, int kvh,
                                              int S, int Hq, int dh, int dhp) {
  const int chunks = dhp / 8;
  for (int idx = threadIdx.x; idx < n * chunks; idx += kThreads) {
    const int i = idx / chunks, d = (idx - (idx / chunks) * chunks) * 8;
    const int r = r0 + i;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < Rtot && d < dh)
      val = *reinterpret_cast<const uint4*>(src + row_offset(b, r, G, kvh, S, Hq, dh) + d);
    *reinterpret_cast<uint4*>(dst + i * ld + d) = val;
  }
}

// Stage n keys from t0 of a [B,Sk,Hkv,dh] bf16 tensor into dst[n][ld].
__device__ __forceinline__ void stage_keys_tc(bf16* dst, int ld, const bf16* __restrict__ src,
                                              int n, int t0, int b, int kvh, int Sk, int Hkv,
                                              int dh, int dhp) {
  const int chunks = dhp / 8;
  for (int idx = threadIdx.x; idx < n * chunks; idx += kThreads) {
    const int j = idx / chunks, d = (idx - (idx / chunks) * chunks) * 8;
    const int kp = t0 + j;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (kp < Sk && d < dh)
      val = *reinterpret_cast<const uint4*>(src + (((size_t)b * Sk + kp) * Hkv + kvh) * dh + d);
    *reinterpret_cast<uint4*>(dst + j * ld + d) = val;
  }
}

// Carves consecutive 128-byte aligned buffers out of dynamic shared memory;
// the launchers size it with the same calls on a null base.
struct SmemCarver {
  char* base;
  size_t off = 0;
  template <typename X> __host__ __device__ X* take(size_t count) {
    X* p = reinterpret_cast<X*>(reinterpret_cast<uintptr_t>(base) + off);
    off = align128(off + count * sizeof(X));
    return p;
  }
};

// forward, tensor cores.  grid: (ceil(Sq*G / TILE), B*Hkv)
struct FwdTcSmem {
  bf16 *Qs, *Ks, *Vs, *Ps;
  float *Ss, *Os;
  __host__ __device__ size_t carve(char* base, int dhp) {
    SmemCarver c{base};
    const int ldb = dhp + kBfPad;
    Qs = c.take<bf16>(TILE * ldb);
    Ks = c.take<bf16>(TILE * ldb);
    Vs = c.take<bf16>(TILE * ldb);
    Ss = c.take<float>(TILE * (TILE + kF32Pad));
    Ps = c.take<bf16>(TILE * (TILE + kBfPad));
    Os = c.take<float>(TILE * (dhp + kF32Pad));
    return c.off;
  }
};

__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int Sq, int Sk, int Hq, int Hkv, int dh, int causal, int window,
                    float scale) {
  using namespace nvcuda;
  constexpr int TM = TILE / kRowGroups;  // rows per thread
  constexpr int TN = TILE / kColGroups;  // keys per thread
  extern __shared__ __align__(128) char smem_raw[];
  const int dhp = pad16(dh);
  const int ldb = dhp + kBfPad, lds = TILE + kF32Pad, ldp = TILE + kBfPad, ldo = dhp + kF32Pad;
  FwdTcSmem sm;
  sm.carve(smem_raw, dhp);

  const int G = Hq / Hkv;
  const int Rtot = Sq * G;
  const int r0 = blockIdx.x * TILE;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tm = warp * 4 + (lane >> 3);
  const int tn = lane & 7;

  const int p_lo = r0 / G, p_hi = (min(Rtot, r0 + TILE) - 1) / G;
  const int key_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int key_hi = causal ? min(Sk - 1, p_hi) : Sk - 1;

  stage_rows_tc(sm.Qs, ldb, q, TILE, r0, Rtot, b, G, kvh, Sq, Hq, dh, dhp);
  for (int idx = threadIdx.x; idx < TILE * ldo; idx += kThreads) sm.Os[idx] = 0.f;

  int qpos[TM];
  bool row_ok[TM];
  float m_run[TM], l_run[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + tm + kRowGroups * i;
    row_ok[i] = r < Rtot;
    qpos[i] = r / G;
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  for (int t0 = (key_lo / TILE) * TILE; t0 <= key_hi; t0 += TILE) {
    __syncthreads();  // the previous tile is consumed (and Q, O are staged)
    stage_keys_tc(sm.Ks, ldb, k, TILE, t0, b, kvh, Sk, Hkv, dh, dhp);
    stage_keys_tc(sm.Vs, ldb, v, TILE, t0, b, kvh, Sk, Hkv, dh, dhp);
    __syncthreads();
    tc_gemm<wmma::row_major, wmma::col_major, false>(sm.Ss, lds, sm.Qs, ldb, sm.Ks, ldb, TILE,
                                                     TILE, dhp);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int rl = tm + kRowGroups * i;
      float s[TN];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kl = tn + kColGroups * j;
        const bool ok = row_ok[i] && visible(t0 + kl, qpos[i], Sk, causal, window);
        s[j] = ok ? sm.Ss[rl * lds + kl] * scale : -INFINITY;
        mt = fmaxf(mt, s[j]);
      }
      mt = group8_max(mt);
      const float m_new = fmaxf(m_run[i], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_run[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m_use);
        psum += p;
        sm.Ps[rl * ldp + tn + kColGroups * j] = __float2bfloat16(p);
      }
      psum = group8_sum(psum);
      l_run[i] = l_run[i] * alpha + psum;
      m_run[i] = m_new;
      for (int c = tn; c < dhp; c += kColGroups) sm.Os[rl * ldo + c] *= alpha;
    }
    __syncthreads();
    tc_gemm<wmma::row_major, wmma::row_major, true>(sm.Os, ldo, sm.Ps, ldp, sm.Vs, ldb, TILE,
                                                    dhp, TILE);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (!row_ok[i]) continue;  // rows past Sq write nothing
    const int rl = tm + kRowGroups * i;
    const int r = r0 + rl;
    const size_t off = row_offset(b, r, G, kvh, Sq, Hq, dh);
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
    for (int c = tn; c < dh; c += kColGroups) o[off + c] = __float2bfloat16(sm.Os[rl * ldo + c] * inv);
    if (tn == 0) {
      const int s = r / G, h = kvh * G + (r - s * G);
      lse[((size_t)b * Hq + h) * Sq + s] =
          l_run[i] > 0.f ? m_run[i] + logf(l_run[i]) : -INFINITY;
    }
  }
}

// rows r0..r0+n-1 of lse into lse_s (0 past Rtot)
__device__ __forceinline__ void stage_lse(float* lse_s, const float* __restrict__ lse, int n,
                                          int r0, int Rtot, int b, int G, int kvh, int Sq,
                                          int Hq) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = r0 + i;
    float x = 0.f;
    if (r < Rtot) {
      const int s = r / G, h = kvh * G + (r - s * G);
      x = lse[((size_t)b * Hq + h) * Sq + s];
    }
    lse_s[i] = x;
  }
}

// dQ, tensor cores.  grid: (ceil(Sq*G / TILE), B*Hkv)
struct DqTcSmem {
  bf16 *Qs, *dOs, *Ks, *Vs, *dSs;
  float *Ss, *dPs, *dQs, *lse_s, *D_s;
  __host__ __device__ size_t carve(char* base, int dhp) {
    SmemCarver c{base};
    const int ldb = dhp + kBfPad;
    Qs = c.take<bf16>(TILE * ldb);
    dOs = c.take<bf16>(TILE * ldb);
    Ks = c.take<bf16>(TILE * ldb);
    Vs = c.take<bf16>(TILE * ldb);
    Ss = c.take<float>(TILE * (TILE + kF32Pad));
    dPs = c.take<float>(TILE * (TILE + kF32Pad));
    dSs = c.take<bf16>(TILE * (TILE + kBfPad));
    dQs = c.take<float>(TILE * (dhp + kF32Pad));
    lse_s = c.take<float>(TILE);
    D_s = c.take<float>(TILE);
    return c.off;
  }
};

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       bf16* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int dh,
                       int causal, int window, float scale) {
  using namespace nvcuda;
  constexpr int TM = TILE / kRowGroups;
  constexpr int TN = TILE / kColGroups;
  extern __shared__ __align__(128) char smem_raw[];
  const int dhp = pad16(dh);
  const int ldb = dhp + kBfPad, lds = TILE + kF32Pad, ldp = TILE + kBfPad, ldo = dhp + kF32Pad;
  DqTcSmem sm;
  sm.carve(smem_raw, dhp);

  const int G = Hq / Hkv;
  const int Rtot = Sq * G;
  const int r0 = blockIdx.x * TILE;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tm = warp * 4 + (lane >> 3);
  const int tn = lane & 7;

  const int p_lo = r0 / G, p_hi = (min(Rtot, r0 + TILE) - 1) / G;
  const int key_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int key_hi = causal ? min(Sk - 1, p_hi) : Sk - 1;

  stage_rows_tc(sm.Qs, ldb, q, TILE, r0, Rtot, b, G, kvh, Sq, Hq, dh, dhp);
  stage_rows_tc(sm.dOs, ldb, dout, TILE, r0, Rtot, b, G, kvh, Sq, Hq, dh, dhp);
  stage_delta(sm.D_s, o, dout, TILE, r0, Rtot, b, G, kvh, Sq, Hq, dh);
  stage_lse(sm.lse_s, lse, TILE, r0, Rtot, b, G, kvh, Sq, Hq);
  for (int idx = threadIdx.x; idx < TILE * ldo; idx += kThreads) sm.dQs[idx] = 0.f;

  for (int t0 = (key_lo / TILE) * TILE; t0 <= key_hi; t0 += TILE) {
    __syncthreads();  // the previous tile is consumed (and the rows are staged)
    stage_keys_tc(sm.Ks, ldb, k, TILE, t0, b, kvh, Sk, Hkv, dh, dhp);
    stage_keys_tc(sm.Vs, ldb, v, TILE, t0, b, kvh, Sk, Hkv, dh, dhp);
    __syncthreads();
    tc_gemm<wmma::row_major, wmma::col_major, false>(sm.Ss, lds, sm.Qs, ldb, sm.Ks, ldb, TILE,
                                                     TILE, dhp);
    tc_gemm<wmma::row_major, wmma::col_major, false>(sm.dPs, lds, sm.dOs, ldb, sm.Vs, ldb,
                                                     TILE, TILE, dhp);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int rl = tm + kRowGroups * i;
      const int r = r0 + rl;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kl = tn + kColGroups * j;
        const bool ok = r < Rtot && visible(t0 + kl, r / G, Sk, causal, window);
        const float p = ok ? expf(sm.Ss[rl * lds + kl] * scale - sm.lse_s[rl]) : 0.f;
        sm.dSs[rl * ldp + kl] = __float2bfloat16(p * (sm.dPs[rl * lds + kl] - sm.D_s[rl]));
      }
    }
    __syncthreads();
    tc_gemm<wmma::row_major, wmma::row_major, true>(sm.dQs, ldo, sm.dSs, ldp, sm.Ks, ldb, TILE,
                                                    dhp, TILE);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rl = tm + kRowGroups * i;
    const int r = r0 + rl;
    if (r >= Rtot) continue;
    const size_t off = row_offset(b, r, G, kvh, Sq, Hq, dh);
    for (int c = tn; c < dh; c += kColGroups)
      dq[off + c] = __float2bfloat16(sm.dQs[rl * ldo + c] * scale);
  }
}

// dK and dV, tensor cores.  grid: (ceil(Sk / TILE), B*Hkv)
struct DkdvTcSmem {
  bf16 *Ks, *Vs, *Qs, *dOs, *Ps, *dSs;
  float *Ss, *dPs, *dKs, *dVs, *lse_s, *D_s;
  __host__ __device__ size_t carve(char* base, int dhp) {
    SmemCarver c{base};
    const int ldb = dhp + kBfPad;
    Ks = c.take<bf16>(TILE * ldb);
    Vs = c.take<bf16>(TILE * ldb);
    Qs = c.take<bf16>(TILE * ldb);
    dOs = c.take<bf16>(TILE * ldb);
    Ss = c.take<float>(TILE * (TILE + kF32Pad));
    dPs = c.take<float>(TILE * (TILE + kF32Pad));
    Ps = c.take<bf16>(TILE * (TILE + kBfPad));
    dSs = c.take<bf16>(TILE * (TILE + kBfPad));
    dKs = c.take<float>(TILE * (dhp + kF32Pad));
    dVs = c.take<float>(TILE * (dhp + kF32Pad));
    lse_s = c.take<float>(TILE);
    D_s = c.take<float>(TILE);
    return c.off;
  }
};

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ o,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int Hq,
                         int Hkv, int dh, int causal, int window, float scale) {
  using namespace nvcuda;
  constexpr int TM = TILE / kRowGroups;  // query rows per thread
  constexpr int TN = TILE / kColGroups;  // keys per thread
  extern __shared__ __align__(128) char smem_raw[];
  const int dhp = pad16(dh);
  const int ldb = dhp + kBfPad, lds = TILE + kF32Pad, ldp = TILE + kBfPad, ldo = dhp + kF32Pad;
  DkdvTcSmem sm;
  sm.carve(smem_raw, dhp);

  const int G = Hq / Hkv;
  const int Rtot = Sq * G;
  const int k0 = blockIdx.x * TILE;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tm = warp * 4 + (lane >> 3);
  const int tn = lane & 7;

  // query positions that can see a key of this tile
  const int k_last = min(Sk, k0 + TILE) - 1;
  const int p_min = causal ? k0 : 0;
  const int p_max = window > 0 ? min(Sq - 1, k_last + window - 1) : Sq - 1;

  stage_keys_tc(sm.Ks, ldb, k, TILE, k0, b, kvh, Sk, Hkv, dh, dhp);
  stage_keys_tc(sm.Vs, ldb, v, TILE, k0, b, kvh, Sk, Hkv, dh, dhp);
  for (int idx = threadIdx.x; idx < TILE * ldo; idx += kThreads) sm.dKs[idx] = sm.dVs[idx] = 0.f;

  const int row_end = min(Rtot, (p_max + 1) * G);
  for (int rt0 = ((p_min * G) / TILE) * TILE; rt0 < row_end; rt0 += TILE) {
    __syncthreads();  // the previous row tile is consumed (and K/V are staged)
    stage_rows_tc(sm.Qs, ldb, q, TILE, rt0, Rtot, b, G, kvh, Sq, Hq, dh, dhp);
    stage_rows_tc(sm.dOs, ldb, dout, TILE, rt0, Rtot, b, G, kvh, Sq, Hq, dh, dhp);
    stage_delta(sm.D_s, o, dout, TILE, rt0, Rtot, b, G, kvh, Sq, Hq, dh);
    stage_lse(sm.lse_s, lse, TILE, rt0, Rtot, b, G, kvh, Sq, Hq);
    __syncthreads();
    // S and dP as [rows x keys]
    tc_gemm<wmma::row_major, wmma::col_major, false>(sm.Ss, lds, sm.Qs, ldb, sm.Ks, ldb, TILE,
                                                     TILE, dhp);
    tc_gemm<wmma::row_major, wmma::col_major, false>(sm.dPs, lds, sm.dOs, ldb, sm.Vs, ldb,
                                                     TILE, TILE, dhp);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int rl = tm + kRowGroups * i;
      const int r = rt0 + rl;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kl = tn + kColGroups * j;
        const bool ok = r < Rtot && visible(k0 + kl, r / G, Sk, causal, window);
        const float p = ok ? expf(sm.Ss[rl * lds + kl] * scale - sm.lse_s[rl]) : 0.f;
        sm.Ps[rl * ldp + kl] = __float2bfloat16(p);
        sm.dSs[rl * ldp + kl] = __float2bfloat16(p * (sm.dPs[rl * lds + kl] - sm.D_s[rl]));
      }
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q: [keys x dh], P and dS read column-major
    tc_gemm<wmma::col_major, wmma::row_major, true>(sm.dVs, ldo, sm.Ps, ldp, sm.dOs, ldb, TILE,
                                                    dhp, TILE);
    tc_gemm<wmma::col_major, wmma::row_major, true>(sm.dKs, ldo, sm.dSs, ldp, sm.Qs, ldb, TILE,
                                                    dhp, TILE);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int kl = tm + kRowGroups * i;
    const int kp = k0 + kl;
    if (kp >= Sk) continue;
    const size_t off = (((size_t)b * Sk + kp) * Hkv + kvh) * dh;
    for (int c = tn; c < dh; c += kColGroups) {
      dk[off + c] = __float2bfloat16(sm.dKs[kl * ldo + c] * scale);
      dv[off + c] = __float2bfloat16(sm.dVs[kl * ldo + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: wgmma fed by TMA (G dividing 64)
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
//  * dK/dV: a thread would hold dK and dV for its keys, 2 x DC x 32
//    registers: 256 at DC 4, more than a thread has.  At DC <= 2 the two
//    consumer warpgroups own 64 keys each.  At DC 3 and 4 both own the same
//    64 keys and split the head columns: warpgroup w accumulates dK and dV
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
// Every sum keeps a fixed order: dK/dV over row tiles, dQ over key tiles,
// with no float atomics, so the backward gives equal bits from run to run.
//
// Q (and dO) come through a 4-D tensor map (dh, Hq, S, B) with boxes of
// (64, G, 64/G, 1): the box is the 64 rows r = s*G + g of one kv head, and
// a box past S reads zeros instead of the next batch's rows.  K and V come
// through a map (dh, Hkv, Sk, B).
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
// The plan at DC column chunks (see above).
__host__ __device__ constexpr int fwd_keys(int DC) { return DC <= 2 ? 128 : 64; }
__host__ __device__ constexpr int dq_consumers(int DC) { return DC <= 3 ? 2 : 1; }
__host__ __device__ constexpr int kv_keys(int DC) { return DC <= 2 ? 128 : 64; }
__host__ __device__ constexpr int kv_stages(int DC) { return DC <= 3 ? 3 : 2; }
// dK/dV column chunks a consumer warpgroup accumulates
__host__ __device__ constexpr int kv_chunks(int DC) { return DC <= 2 ? DC : (DC + 1) / 2; }

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

template <int DC>
struct FwdWgSmem {
  alignas(1024) bf16 q[kConsumers][DC][kWgRows * kChunk];
  alignas(1024) bf16 k[kStages][DC][fwd_keys(DC) * kChunk];
  alignas(1024) bf16 v[kStages][DC][fwd_keys(DC) * kChunk];
  uint64_t q_full, full[kStages], empty[kStages];
};

// forward.  grid: (B*Hkv, ceil(Sq*G / 128)), heaviest row tiles first
template <int DC>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int dh,
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
          tma_load_4d(sm.q[w][c], &q_map, &sm.q_full, kChunk * c, kvh * G,
                      (r0 + w * kWgRows) / G, b);
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
      const size_t off = row_offset(b, r, G, kvh, Sq, Hq, dh);
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cc = kChunk * c + 8 * j + col;
          if (cc < dh)
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

template <int DC>
struct DqWgSmem {
  alignas(1024) bf16 q[dq_consumers(DC)][DC][kWgRows * kChunk];
  alignas(1024) bf16 dout[dq_consumers(DC)][DC][kWgRows * kChunk];
  alignas(1024) bf16 k[kStages][DC][kDqKeys * kChunk];
  alignas(1024) bf16 v[kStages][DC][kDqKeys * kChunk];
  float delta[dq_consumers(DC)][kWgRows];
  uint64_t q_full, full[kStages], empty[kStages];
};

// backward, dQ; also writes D = rowsum(dO * O) into delta [B,Hq,Sq] for
// the dK/dV kernel.  grid: (B*Hkv, ceil(Sq*G / (64 * dq_consumers(DC)))),
// heaviest first
template <int DC>
__global__ void __launch_bounds__(128 * (1 + dq_consumers(DC)), 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const bf16* __restrict__ o, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, float* __restrict__ delta,
                          bf16* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int dh,
                          int causal, int window, float scale) {
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
      mbar_arrive_expect_tx(&sm.q_full, 2 * NC * DC * tile_bytes(kWgRows));
      for (int w = 0; w < NC; ++w)
        for (int c = 0; c < DC; ++c) {
          const int s0 = (r0 + w * kWgRows) / G;
          tma_load_4d(sm.q[w][c], &q_map, &sm.q_full, kChunk * c, kvh * G, s0, b);
          tma_load_4d(sm.dout[w][c], &do_map, &sm.q_full, kChunk * c, kvh * G, s0, b);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&sm.empty[s], (i / kStages - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[s], 2 * DC * tile_bytes(kDqKeys));
        const int t0 = (t_first + i) * kDqKeys;
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

    // D = rowsum(dO * O), once per row: two threads a row, 16 bytes a load
    {
      const int i = tid / 2, r = rw0 + i;
      float acc = 0.f;
      if (r < Rtot) {
        const size_t off = row_offset(b, r, G, kvh, Sq, Hq, dh);
        for (int d = (tid % 2) * 8; d < dh; d += 16) {
          const uint4 a = *reinterpret_cast<const uint4*>(o + off + d);
          const uint4 g = *reinterpret_cast<const uint4*>(dout + off + d);
          const bf16* av = reinterpret_cast<const bf16*>(&a);
          const bf16* gv = reinterpret_cast<const bf16*>(&g);
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = fmaf(__bfloat162float(gv[u]), __bfloat162float(av[u]), acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (tid % 2 == 0) {
        sm.delta[cw][i] = acc;
        if (r < Rtot) {
          const int sp = r / G, h = kvh * G + (r - sp * G);
          delta[((size_t)b * Hq + h) * Sq + sp] = acc;
        }
      }
    }
    named_barrier(1 + cw, 128);
    float D[2], L[2];  // D and lse * log2(e) of this thread's two rows
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r_lo + 8 * x;
      D[x] = sm.delta[cw][r - rw0];
      L[x] = 0.f;
      if (r < Rtot) {
        const int sp = r / G, h = kvh * G + (r - sp * G);
        L[x] = lse[((size_t)b * Hq + h) * Sq + sp] * kLog2e;
      }
    }

    float dqacc[DC][32];
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) dqacc[c][e] = 0.f;
    mbar_wait(&sm.q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int t0 = (t_first + i) * kDqKeys;
      mbar_wait(&sm.full[s], (i / kStages) & 1);
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
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int x = (e >> 1) & 1;
          const int key = t0 + 8 * (e / 4) + col + (e & 1);
          const bool ok = !masked || visible(key, pos[x], Sk, causal, window);
          sacc[e] = ok ? fast_exp2(sacc[e] * sc - L[x]) : 0.f;  // P
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
// hand each other at DC 3 and 4 (P^T, then dP^T): 8 float4 a thread each,
// thread-major, so that a warp's accesses touch every bank once.
template <int N> struct Handoff { float4 v[N][128]; };
template <> struct Handoff<0> {};
__host__ __device__ constexpr int kv_handoff(int DC) { return DC <= 2 ? 0 : 16; }

template <int DC>
struct DkdvWgSmem {
  alignas(1024) bf16 k[DC][kv_keys(DC) * kChunk];
  alignas(1024) bf16 v[DC][kv_keys(DC) * kChunk];
  alignas(1024) bf16 q[kv_stages(DC)][DC][kBwdRows * kChunk];
  alignas(1024) bf16 dout[kv_stages(DC)][DC][kBwdRows * kChunk];
  float lse2[kv_stages(DC)][kBwdRows];   // lse * log2(e) of the tile's rows
  float delta[kv_stages(DC)][kBwdRows];  // D of the tile's rows
  uint64_t kv_full, full[kv_stages(DC)], empty[kv_stages(DC)];
  Handoff<kv_handoff(DC)> handoff;
};

// backward, dK and dV, after the dQ kernel has written delta.  Keys are the
// M dimension: S^T = K . Q^T and dP^T = V . dO^T, then dV += P^T . dO and
// dK += dS^T . Q with P^T and dS^T as register A operands.  grid: (B*Hkv,
// ceil(Sk / kv_keys(DC))); the first key tiles, which see the most rows
// under causal, launch first.  At DC <= 2 consumer warpgroup w owns keys
// 64w..64w+63 of the block and every head column; at DC 3 and 4 both own
// the block's 64 keys and w the column chunks from w * kv_chunks(DC).
template <int DC>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
                            int Hq, int Hkv, int dh, int causal, int window, float scale) {
  constexpr int kKvKeys = kv_keys(DC), kBwdStages = kv_stages(DC), CH = kv_chunks(DC);
  constexpr bool kSplit = kKvKeys == kWgRows;  // the warpgroups split the head columns
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
            tma_load_4d(sm.q[s][c], &q_map, &sm.full[s], kChunk * c, kvh * G, rt0 / G, b);
            tma_load_4d(sm.dout[s][c], &do_map, &sm.full[s], kChunk * c, kvh * G, rt0 / G, b);
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
    const int cw = wg - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int kw0 = k0 + (kSplit ? 0 : cw * kWgRows);  // this warpgroup's first key
    const int key_lo = kw0 + 16 * warp + lane / 4;  // this thread's keys: key_lo, key_lo + 8
    const int col = 2 * (lane % 4);
    const float sc = scale * kLog2e;
    const int c0 = kSplit ? cw * CH : 0;  // dK/dV accumulator j holds column chunk c0 + j

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
      if constexpr (kSplit) {
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
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int rl = 8 * (e / 4) + col + (e & 1);  // the row, within the tile
              const int r = rt0 + rl;
              const int key = key_lo + 8 * ((e >> 1) & 1);
              const bool ok = !masked || (r < Rtot && visible(key, r / G, Sk, causal, window));
              mine[e] = ok ? fast_exp2(mine[e] * sc - sm.lse2[s][rl]) : 0.f;  // P^T
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
          uint32_t pa[kBwdRows / 16][4], dsa[kBwdRows / 16][4];
#pragma unroll
          for (int kk = 0; kk < kBwdRows / 16; ++kk) {
            to_a_frag(&mine[8 * kk], pa[kk]);
            to_a_frag(&other[8 * kk], dsa[kk]);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBwdRows / 16; ++kk)
#pragma unroll
            for (int j = 0; j < CH; ++j)
              if (c0 + j < DC) {
                wgmma_rs_64x64(dvacc[j], pa[kk],
                               wgmma_desc(sm.dout[s][c0 + j]) + kk * 16 * 128 / 16);
                wgmma_rs_64x64(dkacc[j], dsa[kk],
                               wgmma_desc(sm.q[s][c0 + j]) + kk * 16 * 128 / 16);
              }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int kk = 0; kk < kBwdRows / 16; ++kk) {
            fence_regs(pa[kk]);
            fence_regs(dsa[kk]);
          }
#pragma unroll
          for (int j = 0; j < CH; ++j) {
            fence_regs(dkacc[j]);
            fence_regs(dvacc[j]);
          }
        }
      } else if (!skip) {
        // three commit groups: S^T, dP^T, then dV += P^T . dO runs while
        // dS^T is formed, and dK += dS^T . Q last
        float st[32], dpt[32];  // S^T = K . Q^T and dP^T = V . dO^T: 64 keys x 64 rows
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < DC * 4; ++kc) {
          const int c = kc / 4, kb = 2 * (kc % 4);
          wgmma_ss_64x64(st, wgmma_desc(sm.k[c] + cw * kWgRows * kChunk) + kb,
                         wgmma_desc(sm.q[s][c]) + kb, kc > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kc = 0; kc < DC * 4; ++kc) {
          const int c = kc / 4, kb = 2 * (kc % 4);
          wgmma_ss_64x64(dpt, wgmma_desc(sm.v[c] + cw * kWgRows * kChunk) + kb,
                         wgmma_desc(sm.dout[s][c]) + kb, kc > 0);
        }
        wgmma_commit();
        const bool masked = rt0 + kBwdRows > Rtot || kw0 + kWgRows > Sk ||
                            (causal && tp_lo < kw0 + kWgRows - 1) ||
                            (window > 0 && tp_hi - window + 1 > kw0);
        wgmma_wait<1>();  // S^T is done
        fence_regs(st);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int rl = 8 * (e / 4) + col + (e & 1);  // the row, within the tile
          const int r = rt0 + rl;
          const int key = key_lo + 8 * ((e >> 1) & 1);
          const bool ok = !masked || (r < Rtot && visible(key, r / G, Sk, causal, window));
          st[e] = ok ? fast_exp2(st[e] * sc - sm.lse2[s][rl]) : 0.f;  // P^T
        }
        uint32_t pa[kBwdRows / 16][4], dsa[kBwdRows / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBwdRows / 16; ++kk) to_a_frag(&st[8 * kk], pa[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBwdRows / 16; ++kk)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            wgmma_rs_64x64(dvacc[c], pa[kk], wgmma_desc(sm.dout[s][c]) + kk * 16 * 128 / 16);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is done (dV may still run)
        fence_regs(dpt);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int rl = 8 * (e / 4) + col + (e & 1);
          dpt[e] = st[e] * (dpt[e] - sm.delta[s][rl]);  // dS^T, rounded to bf16 below
        }
#pragma unroll
        for (int kk = 0; kk < kBwdRows / 16; ++kk) to_a_frag(&dpt[8 * kk], dsa[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBwdRows / 16; ++kk)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            wgmma_rs_64x64(dkacc[c], dsa[kk], wgmma_desc(sm.q[s][c]) + kk * 16 * 128 / 16);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int kk = 0; kk < kBwdRows / 16; ++kk) fence_regs(pa[kk]);  // read by the dV group
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          fence_regs(dkacc[c]);
          fence_regs(dvacc[c]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int key = key_lo + 8 * x;
      if (key >= Sk) continue;
      const size_t off = (((size_t)b * Sk + key) * Hkv + kvh) * dh;
#pragma unroll
      for (int j = 0; j < CH; ++j)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int cc = kChunk * (c0 + j) + 8 * jj + col;  // past dh for a chunk past DC
          if (cc < dh) {
            const int e = 4 * jj + 2 * x;
            *reinterpret_cast<__nv_bfloat162*>(dk + off + cc) =
                __floats2bfloat162_rn(dkacc[j][e] * scale, dkacc[j][e + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dv + off + cc) =
                __floats2bfloat162_rn(dvacc[j][e], dvacc[j][e + 1]);
          }
        }
    }
  }
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------
struct Shape {
  int B, Sq, Sk, Hq, Hkv, dh, causal, window;
  float scale;
};

// rows (or keys) per thread: fewer as dh grows, so accumulators stay in registers
constexpr int fwd_tm(int dpt) { return dpt <= 16 ? 4 : 2; }
constexpr int dkdv_tm(int dpt) { return dpt <= 8 ? 4 : dpt <= 16 ? 2 : 1; }

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DPT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Shape& s, cudaStream_t st) {
  constexpr int TM = fwd_tm(DPT);
  constexpr int R = kRowGroups * TM;
  const int ld = s.dh + 1;
  const size_t smem =
      sizeof(float) * ((size_t)R * ld + 2 * (size_t)kKeyTile * ld + (size_t)R * (kKeyTile + 1));
  auto kern = flash_fwd_kernel<T, TM, DPT>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int G = s.Hq / s.Hkv;
  dim3 grid((s.Sq * G + R - 1) / R, s.B * s.Hkv);
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), static_cast<T*>(o), lse, s.Sq,
                                     s.Sk, s.Hq, s.Hkv, s.dh, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, void* dk, void* dv, const Shape& s,
                        cudaStream_t st) {
  constexpr int TM = dkdv_tm(DPT);
  constexpr int TKB = kRowGroups * TM;
  constexpr int RB = kRowTileBwd;
  const int ld = s.dh + 1;
  const size_t smem = sizeof(float) * (2 * (size_t)TKB * ld + 2 * (size_t)RB * ld +
                                       2 * (size_t)RB * (TKB + 1) + 2 * (size_t)RB);
  auto kern = flash_bwd_dkdv_kernel<T, TM, DPT>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((s.Sk + TKB - 1) / TKB, s.B * s.Hkv);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dk),
      static_cast<T*>(dv), s.Sq, s.Sk, s.Hq, s.Hkv, s.dh, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, void* dq, const Shape& s,
                      cudaStream_t st) {
  constexpr int TM = fwd_tm(DPT);
  constexpr int R = kRowGroups * TM;
  const int ld = s.dh + 1;
  const size_t smem = sizeof(float) * (2 * (size_t)R * ld + 2 * (size_t)kKeyTile * ld +
                                       (size_t)R * (kKeyTile + 1) + 2 * (size_t)R);
  auto kern = flash_bwd_dq_kernel<T, TM, DPT>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int G = s.Hq / s.Hkv;
  dim3 grid((s.Sq * G + R - 1) / R, s.B * s.Hkv);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq), s.Sq,
      s.Sk, s.Hq, s.Hkv, s.dh, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

// head-dim columns per thread (dh / 8), rounded up to the compiled bucket
#define FLASH_DISPATCH_DPT(dh, F, T, ...)                       \
  do {                                                          \
    const int dpt_ = (dh) / kColGroups;                         \
    if (dpt_ <= 1) return F<T, 1>(__VA_ARGS__);                 \
    if (dpt_ <= 2) return F<T, 2>(__VA_ARGS__);                 \
    if (dpt_ <= 4) return F<T, 4>(__VA_ARGS__);                 \
    if (dpt_ <= 8) return F<T, 8>(__VA_ARGS__);                 \
    if (dpt_ <= 16) return F<T, 16>(__VA_ARGS__);               \
    return F<T, 32>(__VA_ARGS__);                               \
  } while (0)

// bf16: the tensor-core kernels, with tiles of 64 (32 when dh > 128)
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse,
                          const Shape& s, cudaStream_t st) {
  const size_t smem = FwdTcSmem().carve(nullptr, pad16(s.dh));
  auto kern = flash_fwd_tc_kernel;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int G = s.Hq / s.Hkv;
  dim3 grid((s.Sq * G + TILE - 1) / TILE, s.B * s.Hkv);
  kern<<<grid, kThreads, smem, st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                     static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
                                     s.Sq, s.Sk, s.Hq, s.Hkv, s.dh, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

cudaError_t launch_dkdv_tc(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, void* dk, void* dv,
                           const Shape& s, cudaStream_t st) {
  const size_t smem = DkdvTcSmem().carve(nullptr, pad16(s.dh));
  auto kern = flash_bwd_dkdv_tc_kernel;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((s.Sk + TILE - 1) / TILE, s.B * s.Hkv);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s.Sq, s.Sk, s.Hq, s.Hkv, s.dh, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

cudaError_t launch_dq_tc(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, void* dq, const Shape& s,
                         cudaStream_t st) {
  const size_t smem = DqTcSmem().carve(nullptr, pad16(s.dh));
  auto kern = flash_bwd_dq_tc_kernel;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int G = s.Hq / s.Hkv;
  dim3 grid((s.Sq * G + TILE - 1) / TILE, s.B * s.Hkv);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq),
      s.Sq, s.Sk, s.Hq, s.Hkv, s.dh, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_typed(const void* q, const void* k, const void* v, void* o, float* lse,
                      const Shape& s, cudaStream_t st) {
  FLASH_DISPATCH_DPT(s.dh, launch_fwd, T, q, k, v, o, lse, s, st);
}
template <typename T>
cudaError_t dkdv_typed(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, void* dk, void* dv, const Shape& s,
                       cudaStream_t st) {
  FLASH_DISPATCH_DPT(s.dh, launch_dkdv, T, q, k, v, o, dout, lse, dk, dv, s, st);
}
template <typename T>
cudaError_t dq_typed(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, void* dq, const Shape& s,
                     cudaStream_t st) {
  FLASH_DISPATCH_DPT(s.dh, launch_dq, T, q, k, v, o, dout, lse, dq, s, st);
}

// bf16 through wgmma: tensor maps, shared memory and grids

// the maps of the row tensors (q, out, dout: boxes of 64 rows r = s*G + g)
// and of the key tensors (k, v: boxes of `keys` keys)
bool row_map(CUtensorMap* m, const void* p, const Shape& s) {
  const int G = s.Hq / s.Hkv;
  return make_map_bf16_4d(m, p, s.dh, s.Hq, s.Sq, s.B, G, kWgRows / G);
}
bool key_map(CUtensorMap* m, const void* p, const Shape& s, int keys) {
  return make_map_bf16_4d(m, p, s.dh, s.Hkv, s.Sk, s.B, 1, keys);
}

// 64-column chunks of the padded head dim
int wgmma_chunks(int dh) { return (pad16(dh) + kChunk - 1) / kChunk; }

// a grid over row blocks of `rows` rows
dim3 row_grid(const Shape& s, int rows) {
  const int G = s.Hq / s.Hkv;
  return dim3(s.B * s.Hkv, (s.Sq * G + rows - 1) / rows);
}

template <int DC>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                             const Shape& s, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  if (!row_map(&qm, q, s) || !key_map(&km, k, s, fwd_keys(DC)) ||
      !key_map(&vm, v, s, fwd_keys(DC)))
    return cudaErrorInvalidValue;
  static_assert(sizeof(FwdWgSmem<DC>) + 1024 <= kSmemPerBlock, "forward layout over 227 KB");
  const size_t smem = sizeof(FwdWgSmem<DC>) + 1024;
  auto kern = flash_fwd_wgmma_kernel<DC>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<row_grid(s, kBlockRows), kWsThreads, smem, st>>>(
      qm, km, vm, static_cast<bf16*>(o), lse, s.Sq, s.Sk, s.Hq, s.Hkv, s.dh, s.causal, s.window,
      s.scale);
  return cudaGetLastError();
}

template <int DC>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* delta, void* dq,
                             void* dk, void* dv, const Shape& s, cudaStream_t st) {
  CUtensorMap qm, dom, km, vm;
  if (!row_map(&qm, q, s) || !row_map(&dom, dout, s) || !key_map(&km, k, s, kDqKeys) ||
      !key_map(&vm, v, s, kDqKeys))
    return cudaErrorInvalidValue;
  static_assert(sizeof(DqWgSmem<DC>) + 1024 <= kSmemPerBlock, "dQ layout over 227 KB");
  static_assert(sizeof(DkdvWgSmem<DC>) + 1024 <= kSmemPerBlock, "dK/dV layout over 227 KB");
  size_t smem = sizeof(DqWgSmem<DC>) + 1024;
  auto dq_kern = flash_bwd_dq_wgmma_kernel<DC>;
  cudaError_t e = allow_smem(dq_kern, smem);
  if (e != cudaSuccess) return e;
  constexpr int nc = dq_consumers(DC);
  dq_kern<<<row_grid(s, nc * kWgRows), 128 * (1 + nc), smem, st>>>(
      qm, km, vm, dom, static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), s.Sq, s.Sk, s.Hq, s.Hkv, s.dh, s.causal, s.window, s.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  constexpr int keys = kv_keys(DC);
  if (!key_map(&km, k, s, keys) || !key_map(&vm, v, s, keys)) return cudaErrorInvalidValue;
  smem = sizeof(DkdvWgSmem<DC>) + 1024;
  auto kv_kern = flash_bwd_dkdv_wgmma_kernel<DC>;
  e = allow_smem(kv_kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(s.B * s.Hkv, (s.Sk + keys - 1) / keys);
  kv_kern<<<grid, kWsThreads, smem, st>>>(qm, km, vm, dom, lse, delta, static_cast<bf16*>(dk),
                                          static_cast<bf16*>(dv), s.Sq, s.Sk, s.Hq, s.Hkv, s.dh,
                                          s.causal, s.window, s.scale);
  return cudaGetLastError();
}

// The variants: 0 the fp32 FMA kernels, 1 the bf16 WMMA kernels, 2 the bf16
// wgmma kernels.  The wrapper's variant() chooses one from the shape; a
// launch refuses a variant that cannot take the shape.
enum Variant { kFma = 0, kWmma = 1, kWgmma = 2 };

bool bad_shape(const Shape& s) {
  return s.B <= 0 || s.Sq <= 0 || s.Sk <= 0 || s.Hkv <= 0 || s.Hq % s.Hkv != 0 ||
         s.dh <= 0 || s.dh > 256 || s.dh % 8 != 0;
}

bool bad_variant(const Shape& s, int dtype, int variant) {
  if (bad_shape(s)) return true;
  if (variant == kFma) return dtype != 0;
  if (variant == kWmma) return dtype != 1;
  if (variant != kWgmma || dtype != 1) return true;
  // whole positions per 64-row box, and the grids' second dimension (the
  // dQ kernel's row blocks are the smallest, the dK/dV kernel's key blocks)
  const int G = s.Hq / s.Hkv;
  const int dc = wgmma_chunks(s.dh);
  const long long rows = dq_consumers(dc) * kWgRows;
  return kWgRows % G != 0 || ((long long)s.Sq * G + rows - 1) / rows > 65535 ||
         (s.Sk + kv_keys(dc) - 1) / kv_keys(dc) > 65535;
}

}  // namespace

// C entry points (bound with ctypes).  dtype: 0 = fp32, 1 = bf16.  variant:
// see Variant.  causal: 0/1.  window <= 0 means no window.  lse is fp32
// [B,Hq,Sq].  Each returns cudaGetLastError() after its launch (0 on
// success), or cudaErrorInvalidValue for a shape or variant it refuses.

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int Sq, int Sk, int Hq, int Hkv, int dh,
                                   int causal, int window, float scale, int dtype, int variant,
                                   void* stream) {
  const Shape s{B, Sq, Sk, Hq, Hkv, dh, causal, window, scale};
  if (bad_variant(s, dtype, variant)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  if (variant == kFma) return (int)fwd_typed<float>(q, k, v, o, l, s, st);
  if (variant == kWmma) return (int)launch_fwd_tc(q, k, v, o, l, s, st);
  switch (wgmma_chunks(dh)) {
    case 1: return (int)launch_fwd_wgmma<1>(q, k, v, o, l, s, st);
    case 2: return (int)launch_fwd_wgmma<2>(q, k, v, o, l, s, st);
    case 3: return (int)launch_fwd_wgmma<3>(q, k, v, o, l, s, st);
    default: return (int)launch_fwd_wgmma<4>(q, k, v, o, l, s, st);
  }
}

// Both backward kernels: dK/dV then dQ (fma, wmma), or dQ, which also writes
// delta (fp32 [B,Hq,Sq] scratch, used by the wgmma variant alone), then
// dK/dV (wgmma).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
                                   int dh, int causal, int window, float scale, int dtype,
                                   int variant, void* stream) {
  const Shape s{B, Sq, Sk, Hq, Hkv, dh, causal, window, scale};
  if (bad_variant(s, dtype, variant)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  cudaError_t e;
  if (variant == kFma) {
    e = dkdv_typed<float>(q, k, v, o, dout, l, dk, dv, s, st);
    return (int)(e != cudaSuccess ? e : dq_typed<float>(q, k, v, o, dout, l, dq, s, st));
  }
  if (variant == kWmma) {
    e = launch_dkdv_tc(q, k, v, o, dout, l, dk, dv, s, st);
    return (int)(e != cudaSuccess ? e : launch_dq_tc(q, k, v, o, dout, l, dq, s, st));
  }
  auto d = static_cast<float*>(delta);
  switch (wgmma_chunks(dh)) {
    case 1: return (int)launch_bwd_wgmma<1>(q, k, v, o, dout, l, d, dq, dk, dv, s, st);
    case 2: return (int)launch_bwd_wgmma<2>(q, k, v, o, dout, l, d, dq, dk, dv, s, st);
    case 3: return (int)launch_bwd_wgmma<3>(q, k, v, o, dout, l, d, dq, dk, dv, s, st);
    default: return (int)launch_bwd_wgmma<4>(q, k, v, o, dout, l, d, dq, dk, dv, s, st);
  }
}
