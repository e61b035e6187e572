// Fixed-size embedding bag for Hopper (sm_90a): per bag, the weighted sum of
// gathered table rows, divided by the bag size for "mean".
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/embedding_bag/kernel.py::embedding_bag_kernel
//   (pallas_call at :70, body _bag_kernel at :21)
// and computes what its oracle computes
//   src/repro/kernels/embedding_bag/ref.py::embedding_bag_ref
// out[b, :] = sum_j w[b, j] * table[ids[b, j], :]   (fp32 sum, j in order),
// then / bag_size for "mean" (a division by the bag size, not by a count of
// ids), rounded once to the table's type.
//
// What bounds it on this card: bytes.  Each gathered row is used once, with
// one multiply-add per element, so the least time is the rows the bags touch
// (plus ids, weights and the output) over the memory rate.  The rows are
// short (10 to 50 elements at the recsys configs' widths) and scattered over
// tables of up to 2.16 GB, so every row read is its own random access.
//
// What the design does about it:
//  * The TPU grid (n_bags, bag_size) DMAs one row per step into VMEM and
//    accumulates in scratch.  Here a group of G lanes owns one bag and walks
//    its ids in order, so the fp32 sum runs in the oracle's order; G is the
//    power of two that covers the row's vector chunks, capped at 32, so a
//    warp serves 32 / G bags at once (16 bags of one at width 4, two at width
//    10 or 16) and short rows do not leave most lanes idle.
//  * Loads are as wide as the row allows: the wrapper picks the widest vector
//    (up to 16 bytes) that divides the width and the row pointers' alignment;
//    width 10 in fp32 reads 8-byte pairs, width 16 reads 16-byte quads.  The
//    j loop is unrolled so several rows are in flight per lane.
//  * Addresses are 64-bit: the DCN-v2 table (33,762,591 x 16 fp32) spans more
//    than 2^31 bytes.  Ids index as jnp.take and torch indexing do: a negative
//    id in [-V, 0) counts from the end, and an id outside [-V, V) reads
//    nothing and makes its bag's row NaN (jnp.take's fill); the kernel never
//    reads outside the table.
//  * Products and sums are rounded separately (no fused multiply-add), as the
//    oracle's rows * weights then sum.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
           const float* __restrict__ weights, T* __restrict__ out, int64_t V, int dim,
           int64_t n_bags, int bag, int mean, int group) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t b = warp * (32 / group) + lane / group;
  if (b >= n_bags) return;
  const int chunks = dim / VEC;
  const int32_t* bag_ids = ids + b * bag;
  const float* bag_w = weights ? weights + b * bag : nullptr;
  T* orow = out + b * dim;
  const float nan = __int_as_float(0x7fc00000);
  for (int c = lane % group; c < chunks; c += group) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < bag; ++j) {
      const int32_t id = __ldg(bag_ids + j);
      const int64_t r = id < 0 ? id + V : id;
      float x[VEC];
      if (r >= 0 && r < V) {
        load_vec<T, VEC>(table + r * dim + c * VEC, x);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) x[i] = nan;
      }
      if (bag_w) {
        const float w = __ldg(bag_w + j);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(x[i], w));
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], x[i]);
      }
    }
    if (mean) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = __fdiv_rn(acc[i], static_cast<float>(bag));
    }
    store_vec<T, VEC>(orow + c * VEC, acc);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* table, const int32_t* ids, const float* weights, void* out,
                   int64_t V, int dim, int64_t n_bags, int bag, int mean, cudaStream_t st) {
  const int chunks = dim / VEC;
  int group = 1;
  while (group < chunks && group < 32) group <<= 1;
  const int64_t warps = (n_bags + 32 / group - 1) / (32 / group);
  const int64_t blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  bag_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(table), ids, weights, static_cast<T*>(out), V, dim, n_bags, bag,
      mean, group);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: fp32, 1: bf16.  vec: elements per load (a power of two that
// divides dim, at most 16 bytes, chosen by the wrapper from the pointers'
// alignment).  weights may be null (every weight 1).  Returns a CUDA error
// code (0 on success).
extern "C" int embedding_bag_launch(const void* table, const void* ids, const void* weights,
                                    void* out, long long V, int dim, long long n_bags, int bag,
                                    int mean, int vec, int dtype, void* stream) {
  if (V <= 0 || dim <= 0 || n_bags <= 0 || bag < 0 || vec <= 0 || dim % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(ids);
  auto w = static_cast<const float*>(weights);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    if (vec == 1) e = launch<float, 1>(table, i, w, out, V, dim, n_bags, bag, mean, st);
    else if (vec == 2) e = launch<float, 2>(table, i, w, out, V, dim, n_bags, bag, mean, st);
    else if (vec == 4) e = launch<float, 4>(table, i, w, out, V, dim, n_bags, bag, mean, st);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    if (vec == 1) e = launch<bf, 1>(table, i, w, out, V, dim, n_bags, bag, mean, st);
    else if (vec == 2) e = launch<bf, 2>(table, i, w, out, V, dim, n_bags, bag, mean, st);
    else if (vec == 4) e = launch<bf, 4>(table, i, w, out, V, dim, n_bags, bag, mean, st);
    else if (vec == 8) e = launch<bf, 8>(table, i, w, out, V, dim, n_bags, bag, mean, st);
  }
  return static_cast<int>(e);
}
