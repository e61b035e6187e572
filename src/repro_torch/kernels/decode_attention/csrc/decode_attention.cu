// Cached GQA decode attention for Hopper (sm_90a), flash-decoding style.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::decode_attention_kernel
//   (pallas_call at :106, body _decode_kernel at :22)
// and computes what the model function computes
//   src/repro/models/attention.py::decode_attention
// S >= 1 query rows per sequence start at a per-sequence q_start (read on the
// device: it stands in for the TPU's scalar prefetch), are causal, and may
// carry a sliding window (local layers).  At S = 1 with lens = q_start + 1 it
// computes what the TPU kernel computes.
//
// What bounds it on this card: the bytes of the visible K/V.  At decode the
// work per key is a few FMAs per query row, far below the ~295 operations a
// byte that would make the H100 compute-bound, so the least time is the
// visible K/V over the memory rate (at serving sizes that is well under a
// microsecond per layer, so in practice launch latency sets the time).
//
// What the design does about it:
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
//    is taken.  wgmma, TMA and fusing the cache insert are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;           // warps per block
constexpr int kRowsPerWarp = 4;     // query rows each warp owns
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kMaxDPL = 8;          // head-dim elements per lane: 256 / 32

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
