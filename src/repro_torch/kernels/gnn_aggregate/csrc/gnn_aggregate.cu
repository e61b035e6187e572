// Gated neighbour aggregation (GatedGCN's inner loop) for Hopper (sm_90a),
// forward and backward, over a padded-ELL neighbour table.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gnn_aggregate/kernel.py::gnn_aggregate_kernel
//   (pallas_call at :59, body _agg_kernel at :23)
// and computes what its oracle computes
//   src/repro/kernels/gnn_aggregate/ref.py::gnn_aggregate_ref
// forward:   out[n, :] = sum_j gates[n, j, :] * h[nbr[n, j], :]
//            (fp32 sum, j in slot order, rounded once to h's type);
// backward:  dgates[n, j, :] = dout[n, :] * h[nbr[n, j], :]
//            dh[m, :] = sum over the real slots (n, j) with nbr[n, j] = m of
//                       gates[n, j, :] * dout[n, :]
// The JAX package has no backward for this kernel (XLA differentiates the
// reference's segment_sum); the plain version here is gnn_aggregate_ref
// under autograd.
//
// What bounds it on this card: bytes.  Every gate element is read once (and
// its gradient written once) for one multiply-add, so the least time is the
// ELL gates plus the rows of h and the outputs over the memory rate; at the
// minibatch_lg block (169,984 nodes x 15 slots x 70 fp32) the gates alone are
// 714 MB a call.
//
// What the design does about it:
//  * The TPU grid (N, max_deg) walks the slots of a node in order and
//    accumulates in VMEM scratch.  Here a group of G lanes owns one node
//    (G the power of two covering the row's vector chunks, capped at 32) and
//    walks its slots in order, so the fp32 sum runs in the oracle's order and
//    the CPU and the card agree.  Loads are as wide as the width and the
//    pointers' alignment allow (the wrapper picks the vector).
//  * Padding slots point at row 0 with zero gates; the forward reads them
//    like any slot (0 * h[0] adds nothing), so it needs no degree array.
//  * The backward is deterministic, with no atomics: dgates is one write per
//    slot; dh is a gather per source node over a source-sorted list of the
//    real slots (rev_ptr / rev_slot, built on the host with the ELL), summed
//    in increasing slot order, the order in which autograd's index_add sums
//    them on the CPU.  Two runs give equal bits.
//  * Addresses are 64-bit.  Neighbour ids index as jnp.take does: a negative
//    id in [-N_h, 0) counts from the end, and an id outside [-N_h, N_h) reads
//    nothing and makes the row NaN (jnp.take's fill).
//  * Products and sums are rounded separately (no fused multiply-add), as the
//    oracle's rows * gates then sum.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

constexpr int kThreads = 256;

// the row of h at `id` (negative ids count from the end), or NaN where the
// id lies outside [-n_rows, n_rows)
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* h, int32_t id, int64_t n_rows, int dim,
                                         int off, float (&x)[VEC]) {
  const int64_t r = id < 0 ? id + n_rows : id;
  if (r >= 0 && r < n_rows) {
    load_vec<T, VEC>(h + r * dim + off, x);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = __int_as_float(0x7fc00000);
  }
}

// the node (or source row) this lane's group owns, or -1
__device__ __forceinline__ int64_t group_row(int group, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t r = warp * (32 / group) + lane / group;
  return r < n ? r : -1;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
agg_fwd_kernel(const T* __restrict__ h, const int32_t* __restrict__ nbr,
               const T* __restrict__ gates, T* __restrict__ out, int64_t N, int64_t Nh,
               int dim, int deg, int group) {
  const int64_t n = group_row(group, N);
  if (n < 0) return;
  const int32_t* ids = nbr + n * deg;
  const T* g = gates + n * deg * dim;
  for (int c = (threadIdx.x & 31) % group; c < dim / VEC; c += group) {
    const int off = c * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < deg; ++j) {
      float x[VEC], w[VEC];
      load_row<T, VEC>(h, __ldg(ids + j), Nh, dim, off, x);
      load_vec<T, VEC>(g + static_cast<int64_t>(j) * dim + off, w);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(x[i], w[i]));
    }
    store_vec<T, VEC>(out + n * dim + off, acc);
  }
}

// dgates[n, j, :] = dout[n, :] * h[nbr[n, j], :], every slot (padding too)
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
agg_bwd_gates_kernel(const T* __restrict__ h, const int32_t* __restrict__ nbr,
                     const T* __restrict__ dout, T* __restrict__ dgates, int64_t N,
                     int64_t Nh, int dim, int deg, int group) {
  const int64_t n = group_row(group, N);
  if (n < 0) return;
  const int32_t* ids = nbr + n * deg;
  T* dg = dgates + n * deg * dim;
  for (int c = (threadIdx.x & 31) % group; c < dim / VEC; c += group) {
    const int off = c * VEC;
    float d[VEC];
    load_vec<T, VEC>(dout + n * dim + off, d);
#pragma unroll 4
    for (int j = 0; j < deg; ++j) {
      float x[VEC], y[VEC];
      load_row<T, VEC>(h, __ldg(ids + j), Nh, dim, off, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) y[i] = __fmul_rn(d[i], x[i]);
      store_vec<T, VEC>(dg + static_cast<int64_t>(j) * dim + off, y);
    }
  }
}

// dh[m, :] = sum_{k in [rev_ptr[m], rev_ptr[m+1])} gates[slot_k, :] * dout[slot_k / deg, :]
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
agg_bwd_h_kernel(const T* __restrict__ gates, const T* __restrict__ dout,
                 const int32_t* __restrict__ rev_ptr, const int32_t* __restrict__ rev_slot,
                 T* __restrict__ dh, int64_t Nh, int dim, int deg, int group) {
  const int64_t m = group_row(group, Nh);
  if (m < 0) return;
  const int32_t lo = __ldg(rev_ptr + m), hi = __ldg(rev_ptr + m + 1);
  for (int c = (threadIdx.x & 31) % group; c < dim / VEC; c += group) {
    const int off = c * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int32_t k = lo; k < hi; ++k) {
      const int64_t slot = __ldg(rev_slot + k);
      float w[VEC], d[VEC];
      load_vec<T, VEC>(gates + slot * dim + off, w);
      load_vec<T, VEC>(dout + (slot / deg) * dim + off, d);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w[i], d[i]));
    }
    store_vec<T, VEC>(dh + m * dim + off, acc);
  }
}

int group_for(int dim, int vec) {
  int group = 1;
  while (group < dim / vec && group < 32) group <<= 1;
  return group;
}

int64_t blocks_for(int64_t rows, int group) {
  const int64_t warps = (rows + 32 / group - 1) / (32 / group);
  return (warps + kThreads / 32 - 1) / (kThreads / 32);
}

struct Args {
  const void *h, *nbr, *gates, *dout, *rev_ptr, *rev_slot;
  void *out, *dgates, *dh;
  int64_t N, Nh;
  int dim, deg;
  cudaStream_t st;
};

template <typename T, int VEC>
cudaError_t run_fwd(const Args& a) {
  const int group = group_for(a.dim, VEC);
  const int64_t blocks = blocks_for(a.N, group);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  agg_fwd_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, a.st>>>(
      static_cast<const T*>(a.h), static_cast<const int32_t*>(a.nbr),
      static_cast<const T*>(a.gates), static_cast<T*>(a.out), a.N, a.Nh, a.dim, a.deg, group);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t run_bwd(const Args& a) {
  const int group = group_for(a.dim, VEC);
  if (a.dgates) {
    const int64_t blocks = blocks_for(a.N, group);
    if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
    agg_bwd_gates_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, a.st>>>(
        static_cast<const T*>(a.h), static_cast<const int32_t*>(a.nbr),
        static_cast<const T*>(a.dout), static_cast<T*>(a.dgates), a.N, a.Nh, a.dim, a.deg,
        group);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (a.dh) {
    const int64_t blocks = blocks_for(a.Nh, group);
    if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
    agg_bwd_h_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, a.st>>>(
        static_cast<const T*>(a.gates), static_cast<const T*>(a.dout),
        static_cast<const int32_t*>(a.rev_ptr), static_cast<const int32_t*>(a.rev_slot),
        static_cast<T*>(a.dh), a.Nh, a.dim, a.deg, group);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <bool BWD>
cudaError_t dispatch(const Args& a, int vec, int dtype) {
  using bf = __nv_bfloat16;
  if (dtype == 0) {
    if (vec == 1) return BWD ? run_bwd<float, 1>(a) : run_fwd<float, 1>(a);
    if (vec == 2) return BWD ? run_bwd<float, 2>(a) : run_fwd<float, 2>(a);
    if (vec == 4) return BWD ? run_bwd<float, 4>(a) : run_fwd<float, 4>(a);
  } else if (dtype == 1) {
    if (vec == 1) return BWD ? run_bwd<bf, 1>(a) : run_fwd<bf, 1>(a);
    if (vec == 2) return BWD ? run_bwd<bf, 2>(a) : run_fwd<bf, 2>(a);
    if (vec == 4) return BWD ? run_bwd<bf, 4>(a) : run_fwd<bf, 4>(a);
    if (vec == 8) return BWD ? run_bwd<bf, 8>(a) : run_fwd<bf, 8>(a);
  }
  return cudaErrorInvalidValue;
}

bool bad_shape(long long N, long long Nh, int dim, int deg, int vec) {
  return N <= 0 || Nh <= 0 || dim <= 0 || deg < 0 || vec <= 0 || dim % vec != 0;
}

}  // namespace

// dtype 0: fp32, 1: bf16.  vec: elements per load (a power of two that
// divides dim, at most 16 bytes, chosen by the wrapper from the pointers'
// alignment).  Each returns a CUDA error code (0 on success).
extern "C" int gnn_aggregate_fwd(const void* h, const void* nbr, const void* gates, void* out,
                                 long long N, long long Nh, int dim, int deg, int vec,
                                 int dtype, void* stream) {
  if (bad_shape(N, Nh, dim, deg, vec)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{h, nbr, gates, nullptr, nullptr, nullptr, out, nullptr, nullptr,
         N, Nh, dim, deg, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<false>(a, vec, dtype));
}

// dgates and dh may each be null (that gradient is not wanted).
extern "C" int gnn_aggregate_bwd(const void* h, const void* nbr, const void* gates,
                                 const void* dout, const void* rev_ptr, const void* rev_slot,
                                 void* dgates, void* dh, long long N, long long Nh, int dim,
                                 int deg, int vec, int dtype, void* stream) {
  if (bad_shape(N, Nh, dim, deg, vec)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{h, nbr, gates, dout, rev_ptr, rev_slot, nullptr, dgates, dh,
         N, Nh, dim, deg, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<true>(a, vec, dtype));
}
