// Gated neighbour aggregation (GatedGCN's inner loop) for Hopper (sm_90a),
// forward and backward, over a row-pointer (CSR) index of the edges.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gnn_aggregate/kernel.py::gnn_aggregate_kernel
//   (pallas_call at :59, body _agg_kernel at :23)
// and computes what the reference model's two segment_sums compute
// (src/repro/models/gnn.py::_gated_layer, num and den):
// forward:  num[n, :] = sum_{k in [row_ptr[n], row_ptr[n+1])} gates[k, :] * h[col[k], :]
//           den[n, :] = sum_{k in the same slots} gates[k, :]       (when asked)
//           (fp32 sums, rounded once to h's type; a row with no slot is 0);
// backward: dgates[k, :] = dnum[n, :] * h[col[k], :] (+ dden[n, :]) for the slots k of row n
//           dh[m, :] = sum over the slots k whose source col[k] is m of
//                      gates[k, :] * dnum[row of k, :]
// The Pallas contract, over a padded-ELL table nbr [N, max_deg] and gates
// [N, max_deg, dim], is the case row_ptr[n] = n * max_deg, col = nbr,
// gates [N * max_deg, dim]: the wrapper passes it so, and every ELL slot,
// padding included, gets its dgates.  The JAX package has no backward for
// this kernel (XLA differentiates segment_sum); the plain version here is
// gnn_aggregate_csr_ref under autograd.
//
// What bounds it on this card: bytes.  Each gate element is read once for one
// multiply-add (and its gradient written once), so the least time is the
// index, the gates, the distinct rows of h and the outputs over the memory
// rate.  Over the real edges only, the minibatch_lg block moves about 190 MB
// a forward with den; its padded ELL held 714 MB of gates alone.  Where h is
// larger than the 50 MB L2 (the power-law graph's 65 MB), the gathers of h
// rows, one a slot, are what the bound does not count.
//
// What the design does about it:
//  * A warp owns a row (kWarps rows a block).  Its lanes own the row's vector
//    chunks (at most 2 a lane, NC; wider rows take more passes, "panels"), so
//    each slot's gate row and h row are read as whole coalesced rows.  The
//    slot ids are read 32 at a time, one a lane, and passed round the warp, so
//    no gather waits on the load of its own id, and the loads of kBatch slots
//    are issued before any is used, with no branch around them.  Loads are as
//    wide as the width and the pointers' alignment allow (the wrapper picks
//    the vector).
//  * A row with more than kLong slots (a hub of a power-law graph) is split
//    over all the block's warps in contiguous pieces after the block's other
//    rows; the pieces' fp32 partials meet in shared memory and are summed in
//    warp order.  So no row serialises a warp for long, and the result is the
//    same on every run.
//  * The forward gives den from the gates already in registers.
//  * The backward is one launch, deterministic, with no atomics: the first
//    blocks walk the rows and write each slot's dgates once; the others walk a
//    source-sorted list of the slots (rev_ptr / rev_slot, with each slot's row
//    in rev_row) and sum dh per source in increasing slot order, long sources
//    split as long rows are.  Two runs give equal bits.
//  * Addresses are 64-bit.  Source ids index as jnp.take does: a negative id
//    in [-N_h, 0) counts from the end, and an id outside [-N_h, N_h) reads
//    nothing and makes its row NaN (jnp.take's fill).
//  * Products and sums are rounded separately (no fused multiply-add), as the
//    plain version's rows * gates then sum.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

constexpr int kWarps = 16;               // rows a block owns, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kLong = 64;                // a row with more slots is split over the block
constexpr unsigned kAll = 0xffffffffu;

// the element offset of this lane's chunk s of the panel at `base`; a lane
// past the row's end reads the row's last chunk (never stored), so that no
// load sits under a branch
template <int VEC>
__device__ __forceinline__ int chunk_off(int base, int s, int dim) {
  const int off = base + ((threadIdx.x & 31) + 32 * s) * VEC;
  return off < dim ? off : dim - VEC;
}

template <int NC, int VEC>
__device__ __forceinline__ void zero(float (&a)[NC][VEC]) {
#pragma unroll
  for (int s = 0; s < NC; ++s)
#pragma unroll
    for (int i = 0; i < VEC; ++i) a[s][i] = 0.f;
}

template <typename T, int VEC, int NC>
__device__ __forceinline__ void store_chunks(T* row, int dim, int base, const float (&a)[NC][VEC]) {
#pragma unroll
  for (int s = 0; s < NC; ++s) {
    const int off = base + ((threadIdx.x & 31) + 32 * s) * VEC;
    if (off < dim) store_vec<T, VEC>(row + off, a[s]);
  }
}

// this lane's chunks of the row of h at `id` (negative ids count from the
// end), or NaN where the id lies outside [-n_rows, n_rows): the load reads
// row 0 then, and a select fills the NaN
template <typename T, int VEC, int NC>
__device__ __forceinline__ void load_row(const T* h, int32_t id, int64_t n_rows, int dim,
                                         int base, float (&x)[NC][VEC]) {
  const int64_t r = id < 0 ? id + n_rows : id;
  const bool valid = r >= 0 && r < n_rows;
  const T* row = h + (valid ? r : 0) * dim;
#pragma unroll
  for (int s = 0; s < NC; ++s) {
    load_vec<T, VEC>(row + chunk_off<VEC>(base, s, dim), x[s]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[s][i] = valid ? x[s][i] : __int_as_float(0x7fc00000);
  }
}

template <typename T, int VEC, int NC>
__device__ __forceinline__ void load_chunks(const T* row, int dim, int base,
                                            float (&x)[NC][VEC]) {
#pragma unroll
  for (int s = 0; s < NC; ++s) load_vec<T, VEC>(row + chunk_off<VEC>(base, s, dim), x[s]);
}

// The walks below take a warp's slots 32 at a time: each lane reads one
// slot's ids and passes them round the warp.  Within a batch, kBatch slots'
// loads are issued before any of them is used (past the batch's end the
// loads repeat a live slot and are not used), so a warp keeps kBatch gathers
// in flight.  Two, not four: at four the minibatch_lg instantiation (fp32,
// 8-byte vectors, two chunks a lane) needs so many registers that one
// 512-thread block fits an SM, which read slower on every shape timed.
constexpr int kBatch = 2;

// num and den over the slots [lo, hi), for this lane's chunks of a panel
template <typename T, int VEC, int NC>
__device__ __forceinline__ void fwd_piece(const T* __restrict__ h, const int32_t* __restrict__ col,
                                          const T* __restrict__ gates, int64_t Nh, int dim,
                                          int base, int64_t lo, int64_t hi,
                                          float (&num)[NC][VEC], float (&den)[NC][VEC]) {
  const int lane = threadIdx.x & 31;
  zero(num);
  zero(den);
  for (int64_t k0 = lo; k0 < hi; k0 += 32) {
    const int n = static_cast<int>(hi - k0 < 32 ? hi - k0 : 32);
    const int32_t mine = __ldg(col + k0 + (lane < n ? lane : 0));
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      float x[kBatch][NC][VEC], w[kBatch][NC][VEC];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u < n ? j0 + u : j0;
        load_row<T, VEC, NC>(h, __shfl_sync(kAll, mine, j), Nh, dim, base, x[u]);
        load_chunks<T, VEC, NC>(gates + (k0 + j) * dim, dim, base, w[u]);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j0 + u >= n) break;  // uniform over the warp
#pragma unroll
        for (int s = 0; s < NC; ++s)
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            num[s][i] = __fadd_rn(num[s][i], __fmul_rn(x[u][s][i], w[u][s][i]));
            den[s][i] = __fadd_rn(den[s][i], w[u][s][i]);
          }
      }
    }
  }
}

// dgates of the slots [lo, hi) of row r, for this lane's chunks of a panel
template <typename T, int VEC, int NC>
__device__ __forceinline__ void dgates_piece(const T* __restrict__ h,
                                             const int32_t* __restrict__ col,
                                             const T* __restrict__ dnum,
                                             const T* __restrict__ dden, T* __restrict__ dgates,
                                             int64_t Nh, int dim, int base, int64_t r,
                                             int64_t lo, int64_t hi) {
  if (lo >= hi) return;
  const int lane = threadIdx.x & 31;
  float d[NC][VEC], dd[NC][VEC];
  load_chunks<T, VEC, NC>(dnum + r * dim, dim, base, d);
  if (dden) {
    load_chunks<T, VEC, NC>(dden + r * dim, dim, base, dd);
  } else {
    zero(dd);
  }
  for (int64_t k0 = lo; k0 < hi; k0 += 32) {
    const int n = static_cast<int>(hi - k0 < 32 ? hi - k0 : 32);
    const int32_t mine = __ldg(col + k0 + (lane < n ? lane : 0));
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      float x[kBatch][NC][VEC];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u < n ? j0 + u : j0;
        load_row<T, VEC, NC>(h, __shfl_sync(kAll, mine, j), Nh, dim, base, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j0 + u >= n) break;  // uniform over the warp
        T* dg = dgates + (k0 + j0 + u) * dim;
#pragma unroll
        for (int s = 0; s < NC; ++s) {
          const int off = base + (lane + 32 * s) * VEC;
          float y[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            y[i] = __fmul_rn(d[s][i], x[u][s][i]);
            if (dden) y[i] = __fadd_rn(y[i], dd[s][i]);
          }
          if (off < dim) store_vec<T, VEC>(dg + off, y);
        }
      }
    }
  }
}

// dh of one source over its list entries [lo, hi), for this lane's chunks of
// a panel: sum of gates[slot] * dnum[row]
template <typename T, int VEC, int NC>
__device__ __forceinline__ void dh_piece(const T* __restrict__ gates, const T* __restrict__ dnum,
                                         const int32_t* __restrict__ rev_slot,
                                         const int32_t* __restrict__ rev_row, int dim, int base,
                                         int64_t lo, int64_t hi, float (&acc)[NC][VEC]) {
  const int lane = threadIdx.x & 31;
  zero(acc);
  for (int64_t k0 = lo; k0 < hi; k0 += 32) {
    const int n = static_cast<int>(hi - k0 < 32 ? hi - k0 : 32);
    const int64_t mine = k0 + (lane < n ? lane : 0);
    const int32_t my_slot = __ldg(rev_slot + mine), my_row = __ldg(rev_row + mine);
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      float w[kBatch][NC][VEC], d[kBatch][NC][VEC];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u < n ? j0 + u : j0;
        const int64_t slot = __shfl_sync(kAll, my_slot, j);
        const int64_t row = __shfl_sync(kAll, my_row, j);
        load_chunks<T, VEC, NC>(gates + slot * dim, dim, base, w[u]);
        load_chunks<T, VEC, NC>(dnum + row * dim, dim, base, d[u]);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j0 + u >= n) break;  // uniform over the warp
#pragma unroll
        for (int s = 0; s < NC; ++s)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[s][i] = __fadd_rn(acc[s][i], __fmul_rn(w[u][s][i], d[u][s][i]));
      }
    }
  }
}

// the piece of a long row [lo, hi) that warp `warp` takes: kWarps contiguous
// pieces, in warp order
__device__ __forceinline__ void piece_of(int64_t lo, int64_t hi, int64_t& plo, int64_t& phi) {
  const int64_t step = (hi - lo + kWarps - 1) / kWarps;
  const int64_t warp = threadIdx.x >> 5;
  plo = lo + warp * step < hi ? lo + warp * step : hi;
  phi = plo + step < hi ? plo + step : hi;
}

// sum the block's partials of one long row in warp order and write element
// base + threadIdx.x of it; part[q][thread] holds the thread's value q
// (q = s * VEC + i of its chunk s, element i)
template <typename T, int VEC, int NC>
__device__ __forceinline__ void combine(const float (*part)[kThreads], T* row, int dim, int base) {
  const int t = threadIdx.x;
  if (t >= 32 * NC * VEC || base + t >= dim) return;
  const int lane = (t / VEC) % 32, q = (t / VEC / 32) * VEC + t % VEC;
  float acc = 0.f;
#pragma unroll 4
  for (int w = 0; w < kWarps; ++w) acc = __fadd_rn(acc, part[q][w * 32 + lane]);
  row[base + t] = from_f32<T>(acc);
}

template <int VEC, int NC>
__device__ __forceinline__ void stage(float (*part)[kThreads], const float (&a)[NC][VEC]) {
#pragma unroll
  for (int s = 0; s < NC; ++s)
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[s * VEC + i][threadIdx.x] = a[s][i];
}

template <typename T, int VEC, int NC>
__global__ void __launch_bounds__(kThreads)
agg_fwd_kernel(const T* __restrict__ h, const int32_t* __restrict__ row_ptr,
               const int32_t* __restrict__ col, const T* __restrict__ gates, T* __restrict__ num,
               T* __restrict__ den, int64_t N, int64_t Nh, int dim) {
  __shared__ float part[2][NC * VEC][kThreads];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps;
  const int64_t r = first + (threadIdx.x >> 5);
  const int64_t lo = r < N ? __ldg(row_ptr + r) : 0, hi = r < N ? __ldg(row_ptr + r + 1) : 0;
  const bool mine = r < N && hi - lo <= kLong;
  const bool any_long = __syncthreads_or(r < N && hi - lo > kLong);
  for (int base = 0; base < dim; base += 32 * NC * VEC) {
    float a[NC][VEC], b[NC][VEC];
    if (mine) {
      fwd_piece<T, VEC, NC>(h, col, gates, Nh, dim, base, lo, hi, a, b);
      store_chunks<T, VEC, NC>(num + r * dim, dim, base, a);
      if (den) store_chunks<T, VEC, NC>(den + r * dim, dim, base, b);
    }
    if (!any_long) continue;
    for (int i = 0; i < kWarps && first + i < N; ++i) {  // uniform over the block
      const int64_t rr = first + i;
      const int64_t rlo = __ldg(row_ptr + rr), rhi = __ldg(row_ptr + rr + 1);
      if (rhi - rlo <= kLong) continue;
      int64_t plo, phi;
      piece_of(rlo, rhi, plo, phi);
      fwd_piece<T, VEC, NC>(h, col, gates, Nh, dim, base, plo, phi, a, b);
      stage<VEC, NC>(part[0], a);
      stage<VEC, NC>(part[1], b);
      __syncthreads();
      combine<T, VEC, NC>(part[0], num + rr * dim, dim, base);
      if (den) combine<T, VEC, NC>(part[1], den + rr * dim, dim, base);
      __syncthreads();
    }
  }
}

// blocks [0, gate_blocks) write dgates row by row; the rest sum dh source by
// source
template <typename T, int VEC, int NC>
__global__ void __launch_bounds__(kThreads)
agg_bwd_kernel(const T* __restrict__ h, const int32_t* __restrict__ row_ptr,
               const int32_t* __restrict__ col, const T* __restrict__ gates,
               const T* __restrict__ dnum, const T* __restrict__ dden,
               const int32_t* __restrict__ rev_ptr, const int32_t* __restrict__ rev_slot,
               const int32_t* __restrict__ rev_row, T* __restrict__ dgates, T* __restrict__ dh,
               int64_t N, int64_t Nh, int dim, int64_t gate_blocks) {
  __shared__ float part[NC * VEC][kThreads];
  const bool rows = blockIdx.x < gate_blocks;  // uniform over the block
  const int32_t* ptr = rows ? row_ptr : rev_ptr;
  const int64_t n_own = rows ? N : Nh;
  const int64_t block = rows ? int64_t{blockIdx.x} : blockIdx.x - gate_blocks;
  const int64_t first = block * kWarps;
  const int64_t r = first + (threadIdx.x >> 5);
  const int64_t lo = r < n_own ? __ldg(ptr + r) : 0, hi = r < n_own ? __ldg(ptr + r + 1) : 0;
  const bool mine = r < n_own && hi - lo <= kLong;
  const bool any_long = __syncthreads_or(r < n_own && hi - lo > kLong);
  for (int base = 0; base < dim; base += 32 * NC * VEC) {
    float a[NC][VEC];
    if (mine) {
      if (rows) {
        dgates_piece<T, VEC, NC>(h, col, dnum, dden, dgates, Nh, dim, base, r, lo, hi);
      } else {
        dh_piece<T, VEC, NC>(gates, dnum, rev_slot, rev_row, dim, base, lo, hi, a);
        store_chunks<T, VEC, NC>(dh + r * dim, dim, base, a);
      }
    }
    if (!any_long) continue;
    for (int i = 0; i < kWarps && first + i < n_own; ++i) {  // uniform over the block
      const int64_t rr = first + i;
      const int64_t rlo = __ldg(ptr + rr), rhi = __ldg(ptr + rr + 1);
      if (rhi - rlo <= kLong) continue;
      int64_t plo, phi;
      piece_of(rlo, rhi, plo, phi);
      if (rows) {  // no sum across the pieces: each slot's dgates is its own
        dgates_piece<T, VEC, NC>(h, col, dnum, dden, dgates, Nh, dim, base, rr, plo, phi);
        continue;
      }
      dh_piece<T, VEC, NC>(gates, dnum, rev_slot, rev_row, dim, base, plo, phi, a);
      stage<VEC, NC>(part, a);
      __syncthreads();
      combine<T, VEC, NC>(part, dh + rr * dim, dim, base);
      __syncthreads();
    }
  }
}

struct Args {
  const void *h, *row_ptr, *col, *gates, *dnum, *dden, *rev_ptr, *rev_slot, *rev_row;
  void *num, *den, *dgates, *dh;
  int64_t N, Nh;
  int dim;
  cudaStream_t st;
};

int64_t blocks_for(int64_t rows) { return (rows + kWarps - 1) / kWarps; }

template <typename T, int VEC, int NC>
cudaError_t run_fwd(const Args& a) {
  const int64_t blocks = blocks_for(a.N);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  agg_fwd_kernel<T, VEC, NC><<<static_cast<unsigned>(blocks), kThreads, 0, a.st>>>(
      static_cast<const T*>(a.h), static_cast<const int32_t*>(a.row_ptr),
      static_cast<const int32_t*>(a.col), static_cast<const T*>(a.gates), static_cast<T*>(a.num),
      static_cast<T*>(a.den), a.N, a.Nh, a.dim);
  return cudaGetLastError();
}

template <typename T, int VEC, int NC>
cudaError_t run_bwd(const Args& a) {
  const int64_t gate_blocks = a.dgates ? blocks_for(a.N) : 0;
  const int64_t blocks = gate_blocks + (a.dh ? blocks_for(a.Nh) : 0);
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  agg_bwd_kernel<T, VEC, NC><<<static_cast<unsigned>(blocks), kThreads, 0, a.st>>>(
      static_cast<const T*>(a.h), static_cast<const int32_t*>(a.row_ptr),
      static_cast<const int32_t*>(a.col), static_cast<const T*>(a.gates),
      static_cast<const T*>(a.dnum), static_cast<const T*>(a.dden),
      static_cast<const int32_t*>(a.rev_ptr), static_cast<const int32_t*>(a.rev_slot),
      static_cast<const int32_t*>(a.rev_row), static_cast<T*>(a.dgates), static_cast<T*>(a.dh),
      a.N, a.Nh, a.dim, gate_blocks);
  return cudaGetLastError();
}

// two chunks a lane where the row has more than 32 and the lane's values stay
// at most 8 floats (so a block's partials fit 32 KB of shared memory)
template <bool BWD, typename T, int VEC>
cudaError_t run(const Args& a) {
  if constexpr (VEC <= 4) {
    if (a.dim / VEC > 32) return BWD ? run_bwd<T, VEC, 2>(a) : run_fwd<T, VEC, 2>(a);
  }
  return BWD ? run_bwd<T, VEC, 1>(a) : run_fwd<T, VEC, 1>(a);
}

template <bool BWD>
cudaError_t dispatch(const Args& a, int vec, int dtype) {
  using bf = __nv_bfloat16;
  if (dtype == 0) {
    if (vec == 1) return run<BWD, float, 1>(a);
    if (vec == 2) return run<BWD, float, 2>(a);
    if (vec == 4) return run<BWD, float, 4>(a);
  } else if (dtype == 1) {
    if (vec == 1) return run<BWD, bf, 1>(a);
    if (vec == 2) return run<BWD, bf, 2>(a);
    if (vec == 4) return run<BWD, bf, 4>(a);
    if (vec == 8) return run<BWD, bf, 8>(a);
  }
  return cudaErrorInvalidValue;
}

bool bad_shape(long long N, long long Nh, int dim, int vec) {
  return N <= 0 || Nh <= 0 || dim <= 0 || vec <= 0 || dim % vec != 0;
}

}  // namespace

// dtype 0: fp32, 1: bf16.  vec: elements per load (a power of two that
// divides dim, at most 16 bytes, chosen by the wrapper from the pointers'
// alignment).  row_ptr [N+1], col and the reverse list are int32; h [Nh, dim],
// gates [slots, dim] and the outputs are contiguous rows.  den (forward) and
// dden, dgates, dh (backward) may each be null: not wanted, or no gradient.
// Each returns a CUDA error code (0 on success).
extern "C" int gnn_aggregate_fwd(const void* h, const void* row_ptr, const void* col,
                                 const void* gates, void* num, void* den, long long N,
                                 long long Nh, int dim, int vec, int dtype, void* stream) {
  if (bad_shape(N, Nh, dim, vec)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{h, row_ptr, col, gates, nullptr, nullptr, nullptr, nullptr, nullptr,
         num, den, nullptr, nullptr, N, Nh, dim, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<false>(a, vec, dtype));
}

extern "C" int gnn_aggregate_bwd(const void* h, const void* row_ptr, const void* col,
                                 const void* gates, const void* dnum, const void* dden,
                                 const void* rev_ptr, const void* rev_slot, const void* rev_row,
                                 void* dgates, void* dh, long long N, long long Nh, int dim,
                                 int vec, int dtype, void* stream) {
  if (bad_shape(N, Nh, dim, vec)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{h, row_ptr, col, gates, dnum, dden, rev_ptr, rev_slot, rev_row,
         nullptr, nullptr, dgates, dh, N, Nh, dim, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<true>(a, vec, dtype));
}
