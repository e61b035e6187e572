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
// ids), rounded once to the table's type.  The arithmetic is, bit for bit,
// ref.py::embedding_bag_seq_ref: products and sums rounded separately (no
// fused multiply-add), j in order, one division.
//
// What bounds it on this card: bytes.  Each gathered row is used once, with
// one multiply-add per element, so the least time is the distinct rows the
// bags touch (plus ids, weights and the output) over the memory rate.  The
// rows are short (4 to 200 bytes at the recsys configs' widths) and scattered
// over tables of up to 2.16 GB, so every row read is its own random access;
// the bags of one that every plain lookup sends here (ids [n, 1]) also write
// as many bytes as they read.  What keeps a gather from that bound is
// latency: 3.35 TB/s times about a microsecond is some 25 KB that each SM
// must keep in flight, far more than one dependent row load per thread.
//
// What the design does about it:
//  * The TPU grid (n_bags, bag_size) DMAs one row per step into VMEM with
//    the ids scalar-prefetched.  Here the wrapper's static plan
//    (ops.py::plan) cuts the bags into tiles of `tb` consecutive bags and
//    each bag's ids into `k` chunks of `ic`; a unit of work is one chunk of
//    one tile, `tb * ic` rows.  Persistent blocks (at most the SMs times the
//    blocks that fit on one) walk their tiles and, inside a tile, the chunks
//    in j order.
//  * Ids (and weights) are contiguous in ids [n_bags, bag]: a unit's ids are
//    copied into shared memory with 16-byte cp.async (4-byte copies only at
//    the array's end or for an unaligned base), kStages - 1 units before its
//    rows, in the same commit group as the rows of the unit kStages - 1
//    ahead of it, so one wait covers both.
//  * Rows are gathered into a ring of kStages shared-memory stages with
//    cp.async of the widest piece the row's alignment allows (4, 8 or 16
//    bytes, from build.vector_width).  A warp resolves 32 ids, a lane each,
//    and copies their rows' pieces in order, the addresses passed by
//    shuffles: one id read a row, and each cp.async of the warp covers
//    consecutive bytes (as few cache lines and shared-memory banks as the
//    rows allow).  Every row copy goes through the L1 (cp.async.ca, the
//    16-byte ones too): a small field's few rows are read by nearly every
//    bag, and read past the L1 each would queue at the one L2 slice that
//    holds it (DCN-v2's bf16 bags of one ran 1.6 times slower so; PERF.md,
//    PR 22).
//    While one stage is summed, every row of the next is in flight at once:
//    up to 32 KB a block, three blocks an SM.  A row slot of
//    an id outside the table is written with NaN and no copy is issued (the
//    kernel never reads outside the table; its bag is NaN, jnp.take's fill).
//    bf16 rows below 4-byte alignment (an odd width) are copied into the same
//    stage by plain 2-byte loads.
//  * Every division is done once a launch: a thread steps its place in the
//    walk (units, slots, pairs) by additions.
//  * Sums in the oracle's order, from shared memory: one thread per (bag,
//    vector chunk) pair of the tile, so no lane is idle but the tile's last
//    (the plan fills `tb * dim / vec` up to the block's threads); it reads
//    its bag's rows of the stage in j order (the stage is laid out j-major,
//    so a warp reads consecutive bytes) and carries its sum in registers
//    across the tile's chunks, however long the bag.  A row of more pieces
//    than the block has threads (a tile of one bag: fp32 above 1,024
//    columns, or a table whose pointer allows only narrow pieces) makes a
//    "wide" tile: the threads loop over its pairs, and a sum carried across
//    chunks waits in fp32 in shared memory.
//  * Bags of one without weights (the ONE instantiation) have no sum: the
//    staged rows are the output tile as they stand.
//  * The output tile is assembled in shared memory and written with 16-byte
//    coalesced stores where it is 16-byte aligned (the plan sizes tiles so
//    that it is).
//  * Addresses are 64-bit: the DCN-v2 table (33,762,591 x 16 fp32) spans more
//    than 2^31 bytes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "vec_io.cuh"

namespace {

constexpr int kThreads = 256;
// Stages in the ring: one summed while the next one's rows arrive.  On the
// H100 a third or fourth stage bought nothing at the recsys bag shapes
// (PERF.md, PR 22); the walk below is written for any count.
constexpr int kStages = 2;
constexpr int kMinBlocks = 3;  // blocks per SM the registers must allow
constexpr int kSmemPerSm = 233472;  // 228 KB

__host__ __device__ constexpr int align_up(int x, int a) { return (x + a - 1) / a * a; }

// The static plan, as ops.py::plan computes it.
struct Plan {
  int64_t V;       // table rows
  int64_t n_bags;
  int64_t n_ids;   // n_bags * bag
  int64_t tiles;   // ceil(n_bags / tb)
  int dim;
  int row_bytes;   // dim * sizeof(T)
  int bag;
  int tb;          // bags per tile
  int ic;          // ids of each bag per unit (0 for bags of 0)
  int k;           // units per tile: ceil(bag / ic), 1 for bags of 0
  int rows;        // row slots per stage: tb * ic
  int icp;         // ints per bag's id segment when k > 1: room for a 16-byte misalignment
  int idp;         // ints per id slot
  int stage_bytes; // align_up(rows * row_bytes, 16)
  int ppb;         // (bag, vector chunk) pairs per bag: dim / vec
  int weighted;
  int one;
  int wide;        // tb * ppb > kThreads: each thread loops over pairs
  int mean;
};

// Byte offsets of the shared-memory regions, every one 16-byte aligned: the
// ring of row stages, 2 * kStages - 1 id slots (and as many weight slots),
// the output tile (not for bags of one), and a wide tile's fp32 sums carried
// across chunks.
struct Carve {
  int stage, ids, wts, out, carry, total;
};

__host__ __device__ inline Carve carve(const Plan& p) {
  Carve c;
  int at = 0;
  c.stage = at;
  at += kStages * p.stage_bytes;
  c.ids = at;
  at += (2 * kStages - 1) * p.idp * 4;
  c.wts = at;
  if (p.weighted) at += (2 * kStages - 1) * p.idp * 4;
  c.out = at;
  if (!p.one) at += align_up(p.tb * p.row_bytes, 16);
  c.carry = at;
  if (p.wide && p.k > 1) at += align_up(p.tb * p.dim * 4, 16);
  c.total = at;
  return c;
}

// One unit of a block's walk: tile t (bags t*tb ..), chunk kk of its ids.
struct Unit {
  int64_t t;
  int kk;
  int nb;      // bags in the tile (tb but for the last tile)
  int n;       // ids of each bag in the chunk (ic but for the last chunk)
  int o;       // the unit's first id's place in its 16-byte chunk of the ids array
  uint32_t g;  // the low bits of that id's index (k > 1: a bag's is g + lb * bag)
  bool valid;
};

// A position in a block's walk, stepped one unit at a time (no division):
// unit u is chunk kk of tile t = blockIdx.x + (u / k) * gridDim.x.
struct Cursor {
  int u;
  int kk;
  int64_t t;

  __device__ __forceinline__ void start() {
    u = 0;
    kk = 0;
    t = blockIdx.x;
  }
  __device__ __forceinline__ void step(const Plan& p) {
    ++u;
    if (++kk == p.k) {
      kk = 0;
      t += gridDim.x;
    }
  }
  __device__ __forceinline__ Unit unit(const Plan& p, int n_units) const {
    Unit x;
    x.valid = u < n_units;
    x.t = t;
    x.kk = kk;
    const int64_t left = p.n_bags - t * p.tb;
    x.nb = left < p.tb ? static_cast<int>(left) : p.tb;
    x.n = p.bag - kk * p.ic < p.ic ? p.bag - kk * p.ic : p.ic;
    const int64_t g = t * p.tb * p.bag + static_cast<int64_t>(kk) * p.ic;
    x.o = static_cast<int>(g & 3);
    x.g = static_cast<uint32_t>(g);
    return x;
  }
};

// i + 1 modulo n, for 0 <= i < n
__device__ __forceinline__ int next_slot(int i, int n) { return i + 1 == n ? 0 : i + 1; }

// i = a * d + b for i = first, first + stride, ...: the quotient and
// remainder stepped along with i, divided once per launch.
struct Split {
  int a, b, da, db, d;

  __device__ __forceinline__ void init(int first, int divisor, int stride) {
    d = divisor;
    a = first / d;
    b = first - a * d;
    da = stride / d;
    db = stride - da * d;
  }
  __device__ __forceinline__ void step() {
    a += da;
    b += db;
    if (b >= d) {
      b -= d;
      ++a;
    }
  }
};

// Where id j (of the unit's chunk) of bag lb of the tile sits in an id slot.
// A unit of k == 1 is one contiguous run of the ids array, placed so that its
// 16-byte chunks land on 16-byte boundaries; for k > 1 each bag's run has its
// own segment of icp ints, placed the same way.
__device__ __forceinline__ int seg_base(const Plan& p, const Unit& x, int lb) {
  if (p.k == 1) return x.o + lb * p.bag;
  return lb * p.icp + static_cast<int>((x.g + static_cast<uint32_t>(lb * p.bag)) & 3u);
}

__device__ __forceinline__ void cp_async_4(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem_dst)),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_8(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(smem_dst)),
               "l"(gmem_src)
               : "memory");
}

// Elements [ge, ge + 4) of a 4-byte array (ge a multiple of 4) into dst,
// whose first element is 16-byte aligned: one 16-byte copy, or 4-byte copies
// of the elements in [lo, hi) where the 16 bytes would pass the array's end
// or the array is not 16-byte aligned.
__device__ __forceinline__ void copy_quad(void* dst, const void* src, int64_t ge, int64_t lo,
                                          int64_t hi, int64_t total, bool a16) {
  const char* s = static_cast<const char*>(src) + ge * 4;
  if (a16 && ge + 4 <= total) {
    cp_async_16(dst, s);
  } else {
    for (int e = 0; e < 4; ++e)
      if (ge + e >= lo && ge + e < hi) cp_async_4(static_cast<char*>(dst) + 4 * e, s + 4 * e);
  }
}

// The unit's ids (and weights) into their slots.  sq: items of icp / 4
// 16-byte chunks a bag (k > 1).
__device__ void stage_ids(const Plan& p, const Unit& x, const int32_t* ids, const float* w,
                          int* sid, float* sw, bool a16i, bool a16w, const Split& sq) {
  if (!x.valid) return;
  if (p.k == 1) {
    const int64_t g = x.t * p.tb * p.bag;
    const int64_t n = static_cast<int64_t>(x.nb) * p.bag;
    const int quads = static_cast<int>((x.o + n + 3) >> 2);
    for (int q = threadIdx.x; q < quads; q += kThreads) {
      const int64_t ge = g - x.o + 4 * q;
      copy_quad(sid + 4 * q, ids, ge, g, g + n, p.n_ids, a16i);
      if (w) copy_quad(sw + 4 * q, w, ge, g, g + n, p.n_ids, a16w);
    }
  } else {
    const int items = x.nb * (p.icp >> 2);
    Split it = sq;
    for (int i = threadIdx.x; i < items; i += kThreads, it.step()) {
      const int lb = it.a, q = it.b;
      const int o = static_cast<int>((x.g + static_cast<uint32_t>(lb * p.bag)) & 3u);
      if (4 * q >= o + x.n) continue;
      const int64_t g = (x.t * p.tb + lb) * p.bag + static_cast<int64_t>(x.kk) * p.ic;
      const int64_t ge = g - o + 4 * q;
      copy_quad(sid + lb * p.icp + 4 * q, ids, ge, g, g + x.n, p.n_ids, a16i);
      if (w) copy_quad(sw + lb * p.icp + 4 * q, w, ge, g, g + x.n, p.n_ids, a16w);
    }
  }
}

// A row piece through the L1 (cp.async.ca, every width): the rows that many
// bags share (the small fields' few rows) are served there, not each time by
// the one L2 slice that holds them.
__device__ __forceinline__ void cp_async_16_ca(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem_dst)),
               "l"(gmem_src)
               : "memory");
}

template <typename T, int CWB>
__device__ __forceinline__ void copy_piece(unsigned char* dst, const unsigned char* src) {
  if constexpr (CWB == 16) {
    cp_async_16_ca(dst, src);
  } else if constexpr (CWB == 8) {
    cp_async_8(dst, src);
  } else if constexpr (CWB == 4) {
    cp_async_4(dst, src);
  } else {  // bf16 rows at an odd width: 2-byte alignment, below cp.async's 4
    *reinterpret_cast<unsigned short*>(dst) = __ldg(reinterpret_cast<const unsigned short*>(src));
  }
}

template <typename T, int CWB>
__device__ __forceinline__ void fill_nan(unsigned char* dst) {
  constexpr int VEC = CWB / static_cast<int>(sizeof(T));
  T v[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = from_f32<T>(__int_as_float(0x7fc00000));
  typename Raw<CWB>::type raw;
  memcpy(&raw, v, CWB);
  *reinterpret_cast<typename Raw<CWB>::type*>(dst) = raw;
}

// The unit's rows into its stage (slot s = j * tb + lb), CWB bytes a piece.
// A warp takes 32 slots at a time: each lane reads one slot's id and works
// out its row (a negative id in [-V, 0) counts from the end; an id outside
// [-V, V) marks the slot for NaN; a slot past the tile's bags or the chunk's
// ids is skipped), then the warp copies the 32 rows' pieces in order, lane l
// of copy i taking piece 32 i + l with the row's address from its owner by a
// shuffle.  So a thread reads an id once, and every cp.async of a warp covers
// consecutive bytes: whole rows of the table and of the stage.  sr: the
// thread's slots split by tb; sq: piece 32 i + lane split by the row's pieces.
template <typename T, int CWB>
__device__ void copy_rows(const Plan& p, const Unit& x, const unsigned char* table,
                          const int* sid, unsigned char* stage, const Split& sr,
                          const Split& sq) {
  if (!x.valid) return;
  const int lane = threadIdx.x & 31, pieces = p.row_bytes / CWB;
  Split s = sr;
  for (int base = threadIdx.x - lane; base < p.rows; base += kThreads, s.step()) {
    int row = -2;  // the slot's table row; -1: NaN; -2: no copy
    if (base + lane < p.rows && s.b < x.nb && s.a < x.n) {
      const int id = sid[seg_base(p, x, s.b) + s.a];
      const int64_t r = id < 0 ? static_cast<int64_t>(id) + p.V : static_cast<int64_t>(id);
      row = (r >= 0 && r < p.V) ? static_cast<int>(r) : -1;
    }
    // the 32 rows are consecutive in the stage: piece q of them sits q * CWB
    // bytes on, and is piece q.b of row q.a
    unsigned char* dst = stage + base * p.row_bytes + lane * CWB;
    Split q = sq;
#pragma unroll 2
    for (int i = 0; i < pieces; ++i, q.step(), dst += 32 * CWB) {
      const int at = __shfl_sync(0xffffffffu, row, q.a);
      if (at >= 0) {
        copy_piece<T, CWB>(dst, table + static_cast<int64_t>(at) * p.row_bytes + q.b * CWB);
      } else if (at == -1) {
        fill_nan<T, CWB>(dst);
      }
    }
  }
}

template <typename T, int CWB>
__device__ __forceinline__ void load_smem(const unsigned char* src,
                                          float (&x)[CWB / sizeof(T)]) {
  constexpr int VEC = CWB / static_cast<int>(sizeof(T));
  const auto raw = *reinterpret_cast<const typename Raw<CWB>::type*>(src);
  T v[VEC];
  memcpy(v, &raw, CWB);
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = to_f32(v[i]);
}

// nbytes of a tile in shared memory (16-byte aligned) to dst in device
// memory: 16-byte stores where dst is 16-byte aligned, CWB-byte ones for the
// rest.
template <int CWB>
__device__ void store_tile(unsigned char* dst, const unsigned char* src, int nbytes) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n16 = nbytes >> 4;
    for (int i = threadIdx.x; i < n16; i += kThreads)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = n16 << 4;
  }
  using R = typename Raw<CWB>::type;
  for (int i = done / CWB + threadIdx.x; i < nbytes / CWB; i += kThreads)
    reinterpret_cast<R*>(dst)[i] = reinterpret_cast<const R*>(src)[i];
}

// Adds the unit's rows of one (bag, vector chunk) pair (bag lb of the tile,
// chunk c of its row) to acc, j in order.
template <typename T, int CWB>
__device__ __forceinline__ void add_rows(const Plan& p, const Unit& x, const unsigned char* stage,
                                         const float* sw, int lb, int c,
                                         float (&acc)[CWB / sizeof(T)]) {
  constexpr int VEC = CWB / static_cast<int>(sizeof(T));
  const int step = p.tb * p.row_bytes;
  const unsigned char* src = stage + lb * p.row_bytes + c * CWB;
  float v[VEC];
  if (sw) {
    const float* wv = sw + seg_base(p, x, lb);
    for (int j = 0; j < x.n; ++j) {
      load_smem<T, CWB>(src + j * step, v);
      const float wj = wv[j];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], wj));
    }
  } else {
    for (int j = 0; j < x.n; ++j) {
      load_smem<T, CWB>(src + j * step, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], v[i]);
    }
  }
}

// A pair's finished sum (divided once by the bag for "mean"), rounded to T,
// into its place dst in the output tile.
template <typename T, int CWB>
__device__ __forceinline__ void finish(const Plan& p, float (&acc)[CWB / sizeof(T)],
                                       unsigned char* dst) {
  constexpr int VEC = CWB / static_cast<int>(sizeof(T));
  if (p.mean) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = __fdiv_rn(acc[i], static_cast<float>(p.bag));
  }
  T o[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) o[i] = from_f32<T>(acc[i]);
  typename Raw<CWB>::type raw;
  memcpy(&raw, o, CWB);
  *reinterpret_cast<typename Raw<CWB>::type*>(dst) = raw;
}

// The unit's share of the tile's sums.  A tile of at most kThreads pairs:
// this thread's pair (bag lb, chunk c; pair threadIdx.x) carries its sum in
// acc across the tile's chunks.  A wide tile: the thread takes pairs
// threadIdx.x, + kThreads, ... (sp: their split by ppb), each sum carried
// across chunks in carry.  At the tile's last chunk every sum goes to the
// output tile.
template <typename T, int CWB>
__device__ __forceinline__ void sum_unit(const Plan& p, const Unit& x, const unsigned char* stage,
                                         const float* sw, int lb, int c, const Split& sp,
                                         float (&acc)[CWB / sizeof(T)], float* carry,
                                         unsigned char* otile) {
  constexpr int VEC = CWB / static_cast<int>(sizeof(T));
  const bool first = x.kk == 0, last = x.kk == p.k - 1;
  if (!p.wide) {
    if (lb >= x.nb) return;
    if (first) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    }
    add_rows<T, CWB>(p, x, stage, sw, lb, c, acc);
    if (last) finish<T, CWB>(p, acc, otile + threadIdx.x * CWB);
    return;
  }
  Split s = sp;
  for (int pair = threadIdx.x; pair < x.nb * p.ppb; pair += kThreads, s.step()) {
    float a[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) a[i] = first ? 0.f : carry[pair * VEC + i];
    add_rows<T, CWB>(p, x, stage, sw, s.a, s.b, a);
    if (last) {
      finish<T, CWB>(p, a, otile + pair * CWB);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) carry[pair * VEC + i] = a[i];
    }
  }
}

// One block walks units u = 0 .. of its tiles, with one barrier a unit and
// one more before a tile's output is stored.
template <typename T, int CWB, bool ONE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
embedding_bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                     const float* __restrict__ weights, T* __restrict__ out, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VEC = CWB / static_cast<int>(sizeof(T));
  const Carve cv = carve(p);
  constexpr int ns = kStages, slots = 2 * kStages - 1;
  auto stage = [&](int i) { return smem + cv.stage + i * p.stage_bytes; };
  auto sid = [&](int i) { return reinterpret_cast<int*>(smem + cv.ids) + i * p.idp; };
  auto sw = [&](int i) {
    return weights ? reinterpret_cast<float*>(smem + cv.wts) + i * p.idp : nullptr;
  };
  const unsigned char* tab = reinterpret_cast<const unsigned char*>(table);
  unsigned char* outb = reinterpret_cast<unsigned char*>(out);
  const bool a16i = (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
  const bool a16w = (reinterpret_cast<uintptr_t>(weights) & 15) == 0;
  const int n_units =
      static_cast<int>((p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x) * p.k;

  // this thread's stage slots by bag; its pieces of a warp's 32 rows by the
  // pieces of a row; its id chunks by bag (k > 1); (wide tiles) its pairs by
  // the pairs of a bag
  Split sr, sp, sq, spair;
  sr.init(threadIdx.x, p.tb, kThreads);
  sp.init(threadIdx.x & 31, p.row_bytes / CWB, 32);
  sq.init(threadIdx.x, p.icp >> 2, kThreads);
  spair.init(threadIdx.x, p.ppb, kThreads);
  const int lb = threadIdx.x / p.ppb, c = threadIdx.x - lb * p.ppb;  // its pair
  float* carry = reinterpret_cast<float*>(smem + cv.carry);
  // Cursors: ci the unit whose ids are staged next, cc whose rows are copied
  // next, cu summed next.  prologue: the ids of units 0 .. 2 ns - 3, then
  // the rows of units 0 .. ns - 2.
  Cursor ci, cc, cu;
  ci.start();
  cc.start();
  cu.start();
  for (int v = 0; v < 2 * ns - 2; ++v, ci.step(p))
    stage_ids(p, ci.unit(p, n_units), ids, weights, sid(v), sw(v), a16i, a16w, sq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int v = 0; v < ns - 1; ++v, cc.step(p)) {
    copy_rows<T, CWB>(p, cc.unit(p, n_units), tab, sid(v), stage(v), sr, sp);
    cp_async_commit();
  }
  // Iteration u: wait for unit u's rows (and unit u + ns - 1's ids, staged
  // in the same group); copy unit u + ns - 1's rows; stage unit u + 2 ns -
  // 2's ids; sum unit u (bags of one: store its stage).
  int s_cur = 0, s_copy = ns - 1;                     // stages of units u, u + ns - 1
  int i_cur = 0, i_copy = ns - 1, i_ids = 2 * ns - 2;  // their id slots, and u + 2 ns - 2's

  float acc[VEC];
  for (int u = 0; u < n_units; ++u) {
    cp_async_wait<ns - 2>();  // the newest ns - 2 groups may stay in flight
    __syncthreads();
    copy_rows<T, CWB>(p, cc.unit(p, n_units), tab, sid(i_copy), stage(s_copy), sr, sp);
    stage_ids(p, ci.unit(p, n_units), ids, weights, sid(i_ids), sw(i_ids), a16i, a16w, sq);
    cp_async_commit();
    const Unit x = cu.unit(p, n_units);
    unsigned char* dst = outb + x.t * p.tb * p.row_bytes;
    if constexpr (ONE) {
      store_tile<CWB>(dst, stage(s_cur), x.nb * p.row_bytes);
    } else {
      sum_unit<T, CWB>(p, x, stage(s_cur), sw(i_cur), lb, c, spair, acc, carry, smem + cv.out);
      if (x.kk == p.k - 1) {
        __syncthreads();
        store_tile<CWB>(dst, smem + cv.out, x.nb * p.row_bytes);
      }
    }
    cu.step(p);
    cc.step(p);
    ci.step(p);
    s_cur = next_slot(s_cur, ns);
    s_copy = next_slot(s_copy, ns);
    i_cur = next_slot(i_cur, slots);
    i_copy = next_slot(i_copy, slots);
    i_ids = next_slot(i_ids, slots);
  }
  cp_async_wait<0>();
}

// The shared memory a launch needs, and the share of the SM's 228 KB the L1
// gives up for it (the plan's blocks an SM, 1 KB the runtime's own each): the
// rest stays L1, which holds the rows that many bags share.
template <typename T, int CWB, bool ONE>
cudaError_t launch(const void* table, const int32_t* ids, const float* weights, void* out,
                   const Plan& p, int grid, int smem, int blocks_per_sm, cudaStream_t st) {
  auto kernel = embedding_bag_kernel<T, CWB, ONE>;
  static int smem_allowed = 48 * 1024;  // the default; raised once to what a plan needs
  static int carveout = -1;
  if (smem > smem_allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  const int share = static_cast<int>(
      (100LL * blocks_per_sm * (smem + 1024) + kSmemPerSm - 1) / kSmemPerSm);
  if (share != carveout) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, share < 100 ? share : 100);
    if (e != cudaSuccess) return e;
    carveout = share;
  }
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const T*>(table), ids, weights,
                                       static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <typename T, int CWB>
cudaError_t launch_one(bool one, const void* table, const int32_t* ids, const float* weights,
                       void* out, const Plan& p, int grid, int smem, int bps, cudaStream_t st) {
  return one ? launch<T, CWB, true>(table, ids, weights, out, p, grid, smem, bps, st)
             : launch<T, CWB, false>(table, ids, weights, out, p, grid, smem, bps, st);
}

}  // namespace

// dtype 0: fp32, 1: bf16.  vec: elements per copied piece (a power of two
// that divides dim, at most 16 bytes, chosen by the wrapper from the
// pointers' alignment).  weights may be null (every weight 1).  The plan's
// numbers (tile_bags .. smem_bytes) are ops.py::plan's; the shared-memory
// bytes it gives must be the ones this file carves.  Returns a CUDA error
// code (0 on success).
extern "C" int embedding_bag_launch(const void* table, const void* ids, const void* weights,
                                    void* out, long long V, int dim, long long n_bags, int bag,
                                    int mean, int vec, int dtype, int tile_bags,
                                    int ids_per_chunk, int one,
                                    int grid, int blocks_per_sm, int smem_bytes,
                                    void* stream) {
  const int isz = dtype == 0 ? 4 : 2;
  if (V <= 0 || V > 0x7fffffffLL || dim <= 0 || n_bags <= 0 || bag < 0 || vec <= 0 ||
      dim % vec != 0 || tile_bags <= 0 || grid <= 0 || blocks_per_sm <= 0 ||
      blocks_per_sm > kMinBlocks || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bag == 0 ? ids_per_chunk != 0 : (ids_per_chunk <= 0 || ids_per_chunk > bag))
    return static_cast<int>(cudaErrorInvalidValue);
  if (one && (bag != 1 || weights != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  p.V = V;
  p.n_bags = n_bags;
  p.n_ids = n_bags * bag;
  p.tiles = (n_bags + tile_bags - 1) / tile_bags;
  p.dim = dim;
  p.row_bytes = dim * isz;
  p.bag = bag;
  p.tb = tile_bags;
  p.ic = ids_per_chunk;
  p.k = bag == 0 ? 1 : (bag + ids_per_chunk - 1) / ids_per_chunk;
  p.rows = tile_bags * ids_per_chunk;
  p.icp = align_up(ids_per_chunk + 3, 4);
  p.idp = p.k == 1 ? align_up(tile_bags * bag + 3, 4) : tile_bags * p.icp;
  p.stage_bytes = align_up(p.rows * p.row_bytes, 16);
  p.ppb = dim / vec;
  p.weighted = weights != nullptr;
  p.one = one;
  p.wide = !one && static_cast<int64_t>(tile_bags) * p.ppb > kThreads;
  p.mean = mean;
  if (grid > p.tiles || carve(p).total != smem_bytes ||
      (p.tiles + grid - 1) / grid * p.k > 0x7fffffffLL)  // a block counts its units in 32 bits
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(ids);
  auto w = static_cast<const float*>(weights);
  const int cwb = vec * isz, bps = blocks_per_sm, sm = smem_bytes;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    if (cwb == 4) e = launch_one<float, 4>(one, table, i, w, out, p, grid, sm, bps, st);
    else if (cwb == 8) e = launch_one<float, 8>(one, table, i, w, out, p, grid, sm, bps, st);
    else if (cwb == 16) e = launch_one<float, 16>(one, table, i, w, out, p, grid, sm, bps, st);
  } else {
    using bf = __nv_bfloat16;
    if (cwb == 2) e = launch_one<bf, 2>(one, table, i, w, out, p, grid, sm, bps, st);
    else if (cwb == 4) e = launch_one<bf, 4>(one, table, i, w, out, p, grid, sm, bps, st);
    else if (cwb == 8) e = launch_one<bf, 8>(one, table, i, w, out, p, grid, sm, bps, st);
    else if (cwb == 16) e = launch_one<bf, 16>(one, table, i, w, out, p, grid, sm, bps, st);
  }
  return static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// Backward: the table's gradient.
//
// Replaces no Pallas kernel: the reference has no backward of its own
// (jax.grad transposes jnp.take into a scatter-add, which XLA emits).  It
// computes what autograd of ref.py::embedding_bag_ref gives the table
//   dtable[v] = sum over (b, j) with ids[b, j] = v of w[b, j] * dout[b]
// (dout[b] / bag for "mean"; an id in [-V, 0) counts from the end, one
// outside [-V, V) adds nothing), and its arithmetic is, bit for bit,
// ref.py::embedding_bag_bwd_seq_ref.  The weights are constants: they get no
// gradient.
//
// What bounds it on this card: bytes.  Each position reads its index entry
// and its bag's dout row and adds one product per element; each row that an
// id reads is written once.  The dense zero fill of dtable (V x dim, up to
// 2.16 GB at DCN-v2) is the wrapper's, and larger than all of that.  What
// the kernel must not do is let a hub serialise: at FM's train batch one row
// of a field of 4 values takes 16,384 positions.
//
// What the design does about it:
//  * The wrapper sorts the flat positions b * bag + j stably by the row they
//    read (ref.py::bwd_index, on the card); an invalid id sorts last with key
//    V.  The kernel walks that list in fixed chunks of `chunk` positions,
//    one block a chunk, so a hub is spread over as many blocks as it has
//    chunks, whatever its size.
//  * A block loads its chunk's keys and positions (one a thread, coalesced),
//    gathers each position's dout row into shared memory as fp32 terms
//    (divided by the bag for "mean", times its weight), and finds the runs
//    of one key in the chunk by a ballot scan.  One thread a (run, vector
//    chunk) pair sums the run in position order and writes the row, or, for
//    a run that continues into the chunk before or after, writes an fp32
//    partial into scratch: slot 1 of its chunk where the row's first
//    position lies in the chunk, slot 0 otherwise.
//  * A row whose positions span chunks c0 .. c1 is finished by the last of
//    those blocks to arrive: each writes its partial, fences, and takes a
//    ticket (an integer atomicAdd on the counter of c0); the block that
//    draws the last ticket adds partial[c0][1] + partial[c0+1][0] + ... +
//    partial[c1][0] in chunk order, writes the row, and puts the counter
//    back to 0.  c0 and c1 come from a warp search over the keys at chunk
//    edges (32 probes a step).  No float atomics, no block waits on another:
//    the sums' order is fixed, and two runs give equal bits.
//  * Products and sums are rounded separately (no fused multiply-add).
//    Addresses are 64-bit.
namespace {

constexpr int kBwdThreads = 256;  // and the most positions a chunk
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

struct BwdPlan {
  int64_t V;
  int64_t n;         // positions: n_bags * bag
  int64_t n_chunks;  // ceil(n / chunk)
  int bag;
  int dim;
  int chunk;         // positions a block takes (<= kBwdThreads)
  int mean;
  int weighted;
};

// Byte offsets of the shared-memory regions: the chunk's fp32 terms [chunk,
// dim], its keys, bags and weights [chunk], and the first position of each
// run [chunk + 1].
struct BwdCarve {
  int terms, keys, bags, wts, first, total;
};

__host__ __device__ inline BwdCarve bwd_carve(int chunk, int dim) {
  BwdCarve c;
  c.terms = 0;
  c.keys = chunk * dim * 4;
  c.bags = c.keys + chunk * 4;
  c.wts = c.bags + chunk * 4;
  c.first = c.wts + chunk * 4;
  c.total = align_up(c.first + (chunk + 1) * 4, 16);
  return c;
}

// The first k in (lo, hi] with pred(k), for a pred that is false and then
// true as k grows, and true at hi (lo may be a bound never probed).  The warp
// probes 32 points a step, so a range shrinks 32-fold a step.
template <class Pred>
__device__ __forceinline__ int64_t warp_first_true(int64_t lo, int64_t hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 1) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t k = lo + step * (lane + 1) < hi ? lo + step * (lane + 1) : hi;
    const unsigned m = __ballot_sync(kAll, k == hi || pred(k));
    const int l = __ffs(m) - 1;  // lane 31 probes hi, so m is not 0
    const int64_t nhi = lo + step * (l + 1) < hi ? lo + step * (l + 1) : hi;
    if (l > 0) lo += step * l;
    hi = nhi;
  }
  return hi;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
embedding_bag_bwd_kernel(const int32_t* __restrict__ skey, const int32_t* __restrict__ spos,
                         const T* __restrict__ dout, const float* __restrict__ weights,
                         T* __restrict__ dtable, float* __restrict__ partial,
                         int32_t* __restrict__ tickets, const BwdPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdCarve cv = bwd_carve(p.chunk, p.dim);
  float* terms = reinterpret_cast<float*>(smem + cv.terms);
  int* keys = reinterpret_cast<int*>(smem + cv.keys);
  int* bags = reinterpret_cast<int*>(smem + cv.bags);
  float* wts = reinterpret_cast<float*>(smem + cv.wts);
  int* first = reinterpret_cast<int*>(smem + cv.first);
  __shared__ int warp_runs[kBwdWarps], warp_live[kBwdWarps];
  __shared__ int key_prev, key_next;

  const int64_t c = blockIdx.x;
  const int64_t i0 = c * p.chunk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ppr = p.dim / VEC;  // vector chunks of a row

  // this thread's position: its key (-1 past the list's end or for an
  // invalid id, which sort last), bag and weight
  int key = -1;
  if (t < p.chunk && i0 + t < p.n) {
    const int k = __ldg(skey + i0 + t);
    if (k < p.V) {
      key = k;
      const int pos = __ldg(spos + i0 + t);
      const int b = pos / p.bag;
      bags[t] = b;
      wts[t] = weights ? __ldg(weights + pos) : 1.f;
    }
  }
  if (t < p.chunk) keys[t] = key;
  if (t == 0) key_prev = i0 > 0 ? __ldg(skey + i0 - 1) : -1;
  if (t == 32) key_next = i0 + p.chunk < p.n ? __ldg(skey + i0 + p.chunk) : -1;
  __syncthreads();

  // runs: a live position whose key differs from the one before it in the
  // chunk starts one; live positions are a prefix of the chunk
  const bool live = key >= 0;
  const bool starts = live && (t == 0 || keys[t - 1] != key);
  const unsigned ms = __ballot_sync(kAll, starts), ml = __ballot_sync(kAll, live);
  if (lane == 0) {
    warp_runs[warp] = __popc(ms);
    warp_live[warp] = __popc(ml);
  }
  __syncthreads();
  int before = 0, runs = 0, n_live = 0;
#pragma unroll
  for (int w = 0; w < kBwdWarps; ++w) {
    if (w < warp) before += warp_runs[w];
    runs += warp_runs[w];
    n_live += warp_live[w];
  }
  if (starts) first[before + __popc(ms & ((1u << lane) - 1u))] = t;
  if (t == 0) first[runs] = n_live;

  // the terms: dout[b] in fp32, / bag ("mean"), * w (weighted)
  const float fbag = static_cast<float>(p.bag);
  for (int item = t; item < n_live * ppr; item += kBwdThreads) {
    const int j = item / ppr, q = item - j * ppr;
    float x[VEC];
    load_vec<T, VEC>(dout + static_cast<int64_t>(bags[j]) * p.dim + q * VEC, x);
    const float wj = wts[j];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float v = x[i];
      if (p.mean) v = __fdiv_rn(v, fbag);
      if (p.weighted) v = __fmul_rn(v, wj);
      terms[j * p.dim + q * VEC + i] = v;
    }
  }
  __syncthreads();

  // head: the chunk's first run continues the chunk before; tail: its last
  // run continues into the chunk after
  const bool head = n_live > 0 && key_prev == keys[0];
  const bool tail = n_live == p.chunk && key_next == keys[p.chunk - 1];
  for (int item = t; item < runs * ppr; item += kBwdThreads) {
    const int r = item / ppr, q = item - r * ppr;
    const int lo = first[r], hi = first[r + 1];
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int j = lo; j < hi; ++j) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], terms[j * p.dim + q * VEC + i]);
    }
    const bool h = r == 0 && head, tl = r == runs - 1 && tail;
    if (!h && !tl) {
      store_vec<T, VEC>(dtable + static_cast<int64_t>(keys[lo]) * p.dim + q * VEC, acc);
    } else {
      float* dst = partial + (c * 2 + (h ? 0 : 1)) * p.dim + q * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[i] = acc[i];
    }
  }
  if (!head && !tail) return;  // uniform over the block
  __threadfence();
  __syncthreads();

  // warp 0 takes the head run's ticket, warp 1 the tail run's (one run that
  // is both is warp 0's)
  const bool one = runs == 1 && head;
  int slot;
  if (warp == 0 && head) {
    slot = 0;
  } else if (warp == 1 && tail && !one) {
    slot = 1;
  } else {
    return;
  }
  const int v = slot == 0 ? keys[0] : keys[n_live - 1];
  int64_t c0 = c, c1 = c;
  if (slot == 0)  // the first chunk whose last key is v
    c0 = warp_first_true(-1, c - 1, [&](int64_t k) {
      return __ldg(skey + (k + 1) * p.chunk - 1) == v;
    });
  if (tail && (slot == 1 || one))  // the last chunk whose first key is v
    c1 = warp_first_true(c, p.n_chunks, [&](int64_t k) {
      return __ldg(skey + k * p.chunk) != v;
    }) - 1;
  int drawn = 0;
  if (lane == 0) drawn = atomicAdd(tickets + c0, 1);
  drawn = __shfl_sync(kAll, drawn, 0);
  if (drawn != c1 - c0) return;  // another piece is still to come
  __threadfence();
  for (int e = lane; e < p.dim; e += 32) {
    float acc = __ldcg(partial + (c0 * 2 + 1) * p.dim + e);
    for (int64_t k = c0 + 1; k <= c1; ++k)
      acc = __fadd_rn(acc, __ldcg(partial + k * 2 * p.dim + e));
    dtable[static_cast<int64_t>(v) * p.dim + e] = from_f32<T>(acc);
  }
  if (lane == 0) tickets[c0] = 0;  // ready for the next launch
}

template <typename T, int VEC>
cudaError_t launch_bwd(const int32_t* skey, const int32_t* spos, const void* dout,
                       const float* w, void* dtable, float* partial, int32_t* tickets,
                       const BwdPlan& p, int smem, cudaStream_t st) {
  auto kernel = embedding_bag_bwd_kernel<T, VEC>;
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  kernel<<<static_cast<unsigned>(p.n_chunks), kBwdThreads, smem, st>>>(
      skey, spos, static_cast<const T*>(dout), w, static_cast<T*>(dtable), partial, tickets, p);
  return cudaGetLastError();
}

}  // namespace

// The table's gradient over the reverse index (skey, spos) of n positions
// (ref.py::bwd_index): writes each row of dtable [V, dim] that an id reads.
// partial: 2 * dim fp32 of scratch a chunk; tickets: one int32 a chunk, 0 on
// entry and on exit.  dtype 0: fp32, 1: bf16 (dout and dtable); vec:
// elements per load and store (a power of two that divides dim, at most 16
// bytes, from the wrapper); weights may be null.  chunk and smem_bytes are
// ops.py::bwd_chunk and bwd_smem_bytes.  Returns a CUDA error code.
extern "C" int embedding_bag_bwd_launch(const void* skey, const void* spos, const void* dout,
                                        const void* weights, void* dtable, void* partial,
                                        void* tickets, long long V, long long n, int bag,
                                        int dim, int mean, int vec, int dtype, int chunk,
                                        int smem_bytes, void* stream) {
  const int isz = dtype == 0 ? 4 : 2;
  if (V <= 0 || V > 0x7fffffffLL || n <= 0 || n > 0x7fffffffLL || bag <= 0 || dim <= 0 ||
      vec <= 0 || dim % vec != 0 || vec * isz > 16 || (dtype != 0 && dtype != 1) ||
      chunk <= 0 || chunk > kBwdThreads || chunk % 32 != 0 ||
      bwd_carve(chunk, dim).total != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdPlan p;
  p.V = V;
  p.n = n;
  p.n_chunks = (n + chunk - 1) / chunk;
  p.bag = bag;
  p.dim = dim;
  p.chunk = chunk;
  p.mean = mean;
  p.weighted = weights != nullptr;
  if (p.n_chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const int32_t*>(skey);
  auto s = static_cast<const int32_t*>(spos);
  auto w = static_cast<const float*>(weights);
  auto part = static_cast<float*>(partial);
  auto tk = static_cast<int32_t*>(tickets);
  const int sm = smem_bytes;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    if (vec == 1) e = launch_bwd<float, 1>(k, s, dout, w, dtable, part, tk, p, sm, st);
    else if (vec == 2) e = launch_bwd<float, 2>(k, s, dout, w, dtable, part, tk, p, sm, st);
    else if (vec == 4) e = launch_bwd<float, 4>(k, s, dout, w, dtable, part, tk, p, sm, st);
  } else {
    using bf = __nv_bfloat16;
    if (vec == 1) e = launch_bwd<bf, 1>(k, s, dout, w, dtable, part, tk, p, sm, st);
    else if (vec == 2) e = launch_bwd<bf, 2>(k, s, dout, w, dtable, part, tk, p, sm, st);
    else if (vec == 4) e = launch_bwd<bf, 4>(k, s, dout, w, dtable, part, tk, p, sm, st);
    else if (vec == 8) e = launch_bwd<bf, 8>(k, s, dout, w, dtable, part, tk, p, sm, st);
  }
  return static_cast<int>(e);
}
