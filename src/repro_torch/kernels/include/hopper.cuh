// Hopper (sm_90a) building blocks in inline PTX, shared by the port's CUDA
// sources: mbarriers, cp.async copies, cluster barriers and distributed
// shared memory, TMA tile loads through a tensor map, wgmma with its
// shared-memory descriptors and the register work around its accumulators,
// warpgroup register rebalancing, and the host call that encodes a tensor
// map without linking libcuda.
//
// Every shared-memory tile used here is a stack of rows of 128 bytes (64
// bf16, or 32 fp32 read as tf32) under the 128-byte swizzle (written by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B, or chunk by chunk at swizzle128), starting on a
// 1024-byte boundary.  The same bytes serve wgmma as a K-major operand (the
// 64 elements of a row run along K) or as an MN-major one (they run along M
// or N, and successive rows along K); either way 8 rows form one 1024-byte
// swizzle atom.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Makes this thread's earlier writes to shared memory through the generic
// proxy (stores, cp.async) visible to the async proxy, which reads wgmma's
// shared-memory operands; a barrier after it publishes them to the block.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's current phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// cp.async (16-byte asynchronous copies, completed per group)
// ---------------------------------------------------------------------------
// Byte offset of the 16-byte chunk `c` (0..7) of row `row` in a tile of
// 128-byte rows under the 128-byte swizzle (the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and wgmma_desc reads), for copies that fill the
// tile by hand.
__device__ __forceinline__ uint32_t swizzle128(int row, int c) {
  return (uint32_t)(row * 128 + ((c ^ (row & 7)) << 4));
}

__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem_dst)),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Thread-block clusters and distributed shared memory
// ---------------------------------------------------------------------------
// Every thread of every block of the cluster arrives and waits; shared-memory
// writes before it are visible to the cluster's blocks after it.  Not the
// .aligned form: a warp may reach it diverged.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address of `p` (in this block's shared memory) in the
// shared memory of block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_map(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

__device__ __forceinline__ float2 ld_cluster_f32x2(uint32_t addr) {
  float2 x;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x.x), "=f"(x.y)
               : "r"(addr)
               : "memory");
  return x;
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------
// A 4-D box of the tensor `map` at coordinates (c0 innermost .. c3) into
// shared memory at `dst`; its bytes complete on `bar`.  Out-of-bounds
// elements arrive as zeros and count towards the bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory; its bytes complete on `bar`, as a TMA load's do.
__device__ __forceinline__ void bulk_load(void* sdst, const void* gsrc, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(sdst)),
      "l"(gsrc), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Bulk copies from shared to global memory (16-byte aligned, sizes a
// multiple of 16): a plain copy, or an fp32 add into what global memory
// holds (done in the L2, element by element); each completes with the
// thread's bulk group (bulk_commit, bulk_wait).
__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gdst),
               "r"(smem_u32(ssrc)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_reduce_add_f32(float* gdst, const void* ssrc,
                                                    uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
                   gdst),
               "r"(smem_u32(ssrc)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of the thread's bulk groups are pending, their
// writes to global memory done.
template <int N> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's global accesses through the generic proxy with those
// of the async proxy (the bulk copies).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// A counter in global memory read with acquire, and raised with release, at
// the scope of the whole device: what a block wrote before raising it is
// seen by a block that read the raised value.
__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release_gpu_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// ---------------------------------------------------------------------------
// warpgroups
// ---------------------------------------------------------------------------
template <int N> __device__ __forceinline__ void warpgroup_reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void warpgroup_reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// A barrier over the `threads` threads that use barrier `id` (1..15; 0 is
// __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// This thread's arrival at barrier `id` without waiting for it: the
// threads that named_barrier on it wait until `threads` have come.
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// warp-level mma.sync and ldmatrix
// ---------------------------------------------------------------------------
// Four 8x8 bf16 matrices from shared memory: lanes 8j..8j+7 give the
// addresses of matrix j's eight 16-byte rows, and r[j] receives its
// fragment (lane l: row l/4, elements 2(l%4) and 2(l%4)+1; with .trans the
// same two elements of column l/4, rows 2(l%4) and 2(l%4)+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// d[16 x 8] (fp32) += A[16 x 16] . B[16 x 8], bf16, one warp.  A: a[0] rows
// l/4, columns 2(l%4)+{0,1}; a[1] the same 8 rows down; a[2], a[3] the same
// 8 columns right.  B: b0 rows (k) 2(l%4)+{0,1}, column l/4; b1 8 rows down.
// d: d[0], d[1] row l/4, columns 2(l%4)+{0,1}; d[2], d[3] 8 rows down.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Shared-memory matrix descriptor of a tile of 128-byte rows under the
// 128-byte swizzle: 8-row groups 1024 bytes apart (the stride byte offset).
// The leading byte offset is ignored for a K-major operand; for an MN-major
// operand of 64 elements along MN it is set to the same 1024 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  const uint32_t addr = smem_u32(tile);
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)(1024 >> 4) << 16;  // leading byte offset
  d |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

// The same for an MN-major operand wider than 64 elements along MN: its
// 64-element column blocks (each a tile of 128-byte rows) lie `lbo` bytes
// apart, the leading byte offset.
__device__ __forceinline__ uint64_t wgmma_desc_mn(const void* tile, uint32_t lbo) {
  return (wgmma_desc(tile) & ~(uint64_t)(0x3FFF << 16)) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d[64 x 64] (fp32) += A[64 x 16] . B[16 x 64], A and B bf16 in shared
// memory, both K-major (A's rows and B's columns run along K); with
// accumulate 0, d = A . B.
// Accumulator layout: warp w of the warpgroup holds rows 16w + lane/4 (d[4j],
// d[4j+1]) and 16w + lane/4 + 8 (d[4j+2], d[4j+3]), columns 8j + 2*(lane%4)
// and one more, for j = 0..7.
__device__ __forceinline__ void wgmma_ss_64x64(float (&d)[32], uint64_t a, uint64_t b,
                                               int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] (fp32) += A[64 x 16] . B[16 x 64], A and B bf16 in shared
// memory, both MN-major (a 128-byte row holds 64 elements along M, or N;
// successive rows run along K); with accumulate 0, d = A . B.
__device__ __forceinline__ void wgmma_ss_64x64_mn(float (&d)[32], uint64_t a, uint64_t b,
                                                  int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] (fp32) += A[64 x 16] . B[16 x 64], A bf16 in registers (four
// 32-bit registers of bf16 pairs, in the accumulator's row/column pattern:
// a[0] rows lane/4, columns 2*(lane%4)+{0,1}; a[1] the same 8 rows down;
// a[2], a[3] the same 8 columns right), B bf16 in shared memory, MN-major
// (its rows run along K, the 64 elements of a row along N).
__device__ __forceinline__ void wgmma_rs_64x64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The N = 128 shapes: one instruction where two of N = 64 would read the
// A operand twice.  The accumulator's layout is wgmma_ss_64x64's over 128
// columns: d[4j..4j+3] at columns 8j + 2*(lane%4) and one more, j = 0..15.
#define REPRO_WGMMA_D128                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                        \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                                 \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                                 \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                                 \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                                 \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                                 \
  "%56, %57, %58, %59, %60, %61, %62, %63}, "
#define REPRO_WGMMA_D128_OUT                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64 x 128] (fp32) += A[64 x 16] . B[16 x 128], A and B bf16 in shared
// memory, both K-major (B's 128 rows 1024 bytes an 8-row group apart, as
// wgmma_desc says); with accumulate 0, d = A . B.
__device__ __forceinline__ void wgmma_ss_64x128(float (&d)[64], uint64_t a, uint64_t b,
                                                int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_WGMMA_D128
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : REPRO_WGMMA_D128_OUT
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] (fp32) += A[64 x 16] . B[16 x 128], A bf16 in registers (as
// wgmma_rs_64x64), B bf16 in shared memory, MN-major, its two 64-column
// blocks apart by the descriptor's leading byte offset (wgmma_desc_mn).
__device__ __forceinline__ void wgmma_rs_64x128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_WGMMA_D128
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : REPRO_WGMMA_D128_OUT
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
#undef REPRO_WGMMA_D128
#undef REPRO_WGMMA_D128_OUT

// d[64 x 64] (fp32) += A[64 x 8] . B[8 x 64], A and B tf32 (32-bit values
// whose low 13 mantissa bits are zero) in shared memory, both K-major: a
// row of a 128-byte swizzled tile holds 32 values, four k-steps of 32 bytes.
// tf32 takes no transpose, so an operand that is MN-major as stored has to be
// written transposed.  With accumulate 0, d = A . B.
__device__ __forceinline__ void wgmma_tf32_ss_64x64(float (&d)[32], uint64_t a, uint64_t b,
                                                    int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// x rounded to tf32 (10 explicit mantissa bits, the low 13 bits zero), to
// nearest with ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Two fp32 values as a bf16 pair in one register (x in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %2, %1;\n" : "=r"(r) : "f"(x), "f"(y));
  return r;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Eight accumulator values s[0..7], the 8-column blocks 2q and 2q+1 of a
// 64-row accumulator, as the bf16 A fragment of one 16-deep k-step (its
// columns 0-7 and 8-15).
__device__ __forceinline__ void to_a_frag(const float* s, uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[0], s[1]);
  a[1] = pack_bf16(s[2], s[3]);
  a[2] = pack_bf16(s[4], s[5]);
  a[3] = pack_bf16(s[6], s[7]);
}

// Quad reductions over a wgmma accumulator: the four lanes that hold the
// same two rows.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The dynamic shared memory rounded up to the 1024 bytes the swizzle needs
// (the launchers ask for 1024 bytes more than the layout).
template <typename S> __device__ __forceinline__ S& smem_layout(char* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<S*>(raw + pad);
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      p = nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 4-D bf16 tensor map over a contiguous [d3][d2][d1][d0] array, with boxes
// of (64, box1, box2, 1) elements under the 128-byte swizzle; elements
// outside the array read as zeros.  False if the driver refuses it.
inline bool make_map_bf16_4d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                             uint64_t d2, uint64_t d3, uint32_t box1, uint32_t box2) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {d0 * 2, d0 * d1 * 2, d0 * d1 * d2 * 2};  // bytes, dims 1..3
  const cuuint32_t box[4] = {64, box1, box2, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D fp32 tensor map over a contiguous [d3][d2][d1][d0] array, with boxes
// of (32, box1, 1, 1) elements (one 128-byte row of 32 values a box row)
// under the 128-byte swizzle; elements outside the array read as zeros.
// False if cuTensorMapEncodeTiled refuses it.
inline bool make_map_f32_4d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                            uint64_t d2, uint64_t d3, uint32_t box1) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {d0 * 4, d0 * d1 * 4, d0 * d1 * d2 * 4};  // bytes, dims 1..3
  const cuuint32_t box[4] = {32, box1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides, box,
            estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
