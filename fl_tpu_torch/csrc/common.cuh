// Shared device helpers of the port's CUDA sources: conversions between the
// compute dtype T (float or __nv_bfloat16) and f32, four-wide loads into and
// out of shared memory, the 4x4 register-tile product the CUDA-core
// GEMM-shaped kernels are built on, the tensor-core tiles (mma.sync fed by
// ldmatrix, wgmma, cp.async staging) of the bf16 ones, the blocks of a
// warp-specialized pipeline (mbarrier ring, TMA loads and stores, setmaxnreg,
// tensor maps), and the fixed-order reduction of per-block partial sums.
//
// Everything sits in an anonymous namespace: each source compiles on its own
// and gets its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round an f32 value to T's precision (round to nearest even) and back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

__host__ __device__ __forceinline__ int round_up4(int n) { return (n + 3) & ~3; }

// Four consecutive T values as f32 in one load. p must be aligned to
// 4 * sizeof(T): every shared-memory row the callers lay out starts at a
// multiple of four elements from a 16-byte aligned base.
template <typename T> __device__ __forceinline__ void load4(const T* p, float v[4]);
template <> __device__ __forceinline__ void load4<float>(const float* p, float v[4]) {
  float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, float v[4]) {
  // a bf16 value is the upper half of the f32 with the same value
  uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// Copy four consecutive T values from global memory into a shared-memory
// slot aligned to 4 * sizeof(T), with zeros from element `valid` on (valid
// <= 0 reads nothing). `vec` says that src is aligned like the slot, so that
// four valid values move in one load.
template <typename T>
__device__ __forceinline__ void stage4(T* dst, const T* src, int valid, bool vec) {
  if (vec && valid >= 4) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    else
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = i < valid ? src[i] : from_f<T>(0.f);
  }
}

// true when rows of `row_len` elements starting at p all begin on a
// 4 * sizeof(T) boundary
template <typename T> __device__ __forceinline__ bool rows_aligned4(const T* p, int row_len) {
  return row_len % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// acc[j][n] += sum_k a_j[k] * b[k * ldb + n] for four rows a_0..a_3 and four
// columns n, over k in [0, K) in ascending order, K a multiple of 4. Eight
// four-wide shared-memory loads feed 64 FMAs. Rows past the end of a tile
// are passed as any valid row and dropped by the caller's store mask.
template <typename T>
__device__ __forceinline__ void fma_rows4x4(const T* a0, const T* a1, const T* a2,
                                            const T* a3, const T* b, int ldb, int K,
                                            float acc[4][4]) {
  for (int k = 0; k < K; k += 4) {
    float av[4][4], bv[4][4];
    load4<T>(a0 + k, av[0]);
    load4<T>(a1 + k, av[1]);
    load4<T>(a2 + k, av[2]);
    load4<T>(a3 + k, av[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) load4<T>(b + (size_t)(k + i) * ldb, bv[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[j][n] = fmaf(av[j][i], bv[i][n], acc[j][n]);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core tile: bf16 x bf16 -> f32 with the sum in registers, as
// mma.sync.m16n8k16 fed from shared memory by ldmatrix. A warp owns tiles of
// 16 rows x 8 columns (four f32 a thread); one k16 step multiplies a 16 x 16
// A fragment into up to NT of them. Every ldmatrix row is 16 bytes at an
// address of the lane's own, so an A row may be any gathered 16-byte vector
// (a pixel's channels at a tap's offset) and ragged row counts cost nothing:
// a row that does not exist points at a row of zeros. Shared-memory rows are
// laid out with a stride of an odd number of 16-byte chunks (kSkew elements
// past a multiple of 16), so the eight rows of one 8 x 8 matrix fall into
// eight different bank groups.
// ---------------------------------------------------------------------------

constexpr int kSkew = 8;  // bf16 elements (one 16-byte chunk) added to a row's stride

__host__ __device__ __forceinline__ int round_up8(int n) { return (n + 7) & ~7; }
__host__ __device__ __forceinline__ int round_up16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices of 16-bit values: lanes 8j..8j+7 give the row addresses
// of matrix j; thread T receives elements (2 * (T % 4), +1) of row T / 4 of
// each matrix in r[j].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same with each matrix transposed: thread T receives rows (2 * (T % 4),
// +1) of column T / 4. Turns an operand that lies [k][m] or [k][n] in shared
// memory into the fragment mma wants.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col). Thread
// T = 4 * g + t holds c[g][2t], c[g][2t+1], c[g+8][2t], c[g+8][2t+1].
__device__ __forceinline__ void mma_bf16_m16n8k16(float (&c)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragments of one k16 step for n_tiles (<= NT) column tiles, from B
// laid out [k][n] in shared memory. b_addr is the lane's own address: row
// (lane & 15) of the step, column (lane >> 4) * 8 of the first tile. Tiles go
// in pairs, so the row must hold n_tiles rounded up to even.
template <int NT>
__device__ __forceinline__ void load_b_k16(uint32_t (&b)[NT][2], uint32_t b_addr, int n_tiles) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    if (2 * np < n_tiles) {  // uniform across the warp
      uint32_t r[4];
      ldmatrix_x4_trans(r, b_addr + np * 32);
      b[2 * np][0] = r[0], b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2], b[2 * np + 1][1] = r[3];
    }
  }
}

// acc[nt] += a * b[nt] for nt < n_tiles
template <int NT>
__device__ __forceinline__ void mma_k16(float (&acc)[NT][4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[NT][2], int n_tiles) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < n_tiles) mma_bf16_m16n8k16(acc[nt], a, b[nt][0], b[nt][1]);
}

// ---------------------------------------------------------------------------
// The second rung: wgmma. The four warps of a warpgroup multiply a 64-row A
// tile (16 rows a warp, in registers, the fragment of mma.m16n8k16: so the
// same ldmatrix gather feeds it) into B read by the tensor cores straight
// from shared memory, asynchronously; the f32 sums stay in registers, laid
// out as mma.sync's (tile j of 8 columns in d[j][0..3]). B (16 x N, bf16)
// lies "MN-major, no swizzle": core matrices of 8 k-rows x 8 columns, 128
// contiguous bytes each (a k-row is 16 bytes), the next 8 columns
// `sbo_bytes` on, the next 8 k-rows `lbo_bytes` on.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32);
}

// orders the warpgroup's register writes (A fragments, sums) before wgmma reads them
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 8*NT, f32) += a (64 x 16, bf16, registers) * b (16 x 8*NT, bf16,
// shared memory through `desc`), for NT = 1, 2, 4, 8
template <int NT>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[NT][4], const uint32_t (&a)[4],
                                             uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_m64k16<1>(float (&d)[1][4], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16<2>(float (&d)[2][4], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16<4>(float (&d)[4][4], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16<8>(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// 16 bytes from global to shared memory without passing through registers;
// both addresses aligned to 16.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage `n_slots` rows of `len` bf16 values, rows q0 .. q0 + n_slots - 1 of
// src (R rows in all), into dst[slot][0 .. LP) with LP = round_up16(len) and a
// row stride of LP + kSkew: zeros from element len on and in rows outside
// [0, R). Whole 16-byte chunks go by cp.async where `vec` says src's rows are
// aligned to 16 bytes (the caller commits and waits); the rest by plain
// stores.
__device__ __forceinline__ void stage_rows_bf16(__nv_bfloat16* dst,
                                                const __nv_bfloat16* __restrict__ src, int q0,
                                                int n_slots, int R, int len, bool vec) {
  const int LP = round_up16(len), per_row = LP / 8, ld = LP + kSkew;
  for (int e = threadIdx.x; e < n_slots * per_row; e += blockDim.x) {
    const int slot = e / per_row, ch = (e - slot * per_row) * 8, q = q0 + slot;
    __nv_bfloat16* d = dst + slot * ld + ch;
    if (q < 0 || q >= R || ch >= len) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec && ch + 8 <= len) {
      cp_async16(d, src + (size_t)q * len + ch);
    } else {
      const __nv_bfloat16* s = src + (size_t)q * len + ch;
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = ch + i < len ? s[i] : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ bool rows_aligned16(const __nv_bfloat16* p, int row_len) {
  return row_len % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---------------------------------------------------------------------------
// The third rung: a warp-specialized pipeline. One producer warp keeps TMA
// loads (cp.async.bulk.tensor) of tiles in flight into a ring of shared-memory
// stages; consumer warpgroups wait for a stage on its `full` mbarrier, take
// what they need from it and give it back on its `empty` mbarrier, so that
// the warps that multiply never issue a load. setmaxnreg moves registers from
// the producer's warpgroup to the consumers'. Results leave by TMA stores
// (shared -> global, bulk groups) that run under the next tile's products.
// A tensor map is made on the host per call (cuTensorMapEncodeTiled, looked
// up in the driver library at run time) and passed as a __grid_constant__
// kernel parameter.
// ---------------------------------------------------------------------------

// mbarrier waits give up after this many clocks (several seconds) and trap:
// a pipeline fault then ends the kernel with an error instead of a hang
constexpr long long kHangClocks = 1LL << 34;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// arrive, and expect `bytes` more of transactions before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// wait until the phase of parity `parity` has completed; on a barrier that
// was never completed, parity 1 counts as done (a ring's stages start empty)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kHangClocks) __trap();
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads of them (wgmma operands, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15) over `count` threads, a multiple of 32
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// arrive at barrier `id` without waiting: threads that bar.sync on it go on
// once `count` threads in all have arrived or synced
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// box (c0, c1, c2) of a 3-D tensor map into shared memory; completion is
// counted on `bar` in bytes
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}
// box (c0, c1, c2, c3) of a 4-D tensor map; coordinates may be negative, and
// what lies outside the tensor arrives as zeros (and counts as bytes)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}
// shared memory into box (c0, c1, c2); what lies outside the tensor is not
// written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of this thread's bulk groups still read shared memory
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// until at most N of them are still in flight at all
template <int N> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows written with the 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B, tile
// base aligned to 1024): the chunk index is XORed with the row's index mod 8,
// so the eight rows of one ldmatrix fall into eight bank groups.
__host__ __device__ __forceinline__ uint32_t swizzle128(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// The same for rows of `span` bytes (32, 64 or 128: CU_TENSOR_MAP_SWIZZLE_32B,
// _64B, _128B), as a byte offset from a base aligned to 1024: the 16-byte
// chunk index (bits 4 and up) is XORed with as many bits of the offset from
// bit 7 on as a row has chunks' bits. swizzle_span(off, 128) is swizzle128.
__host__ __device__ __forceinline__ uint32_t swizzle_span(uint32_t off, int span) {
  return off ^ (((off >> 7) & (uint32_t)(span / 16 - 1)) << 4);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the runtime already loaded,
// so the kernel library links against no driver stub
EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr) fn = reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A 3-D bf16 tensor (d0 innermost, d0 * 2 and d0 * d1 * 2 bytes the strides
// of the outer two, multiples of 16) cut into boxes of b0 x b1 x 1; elements
// outside the tensor read as zeros and are not written. Returns a
// cudaError_t.
int make_map_bf16_3d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint32_t b0, uint32_t b1, bool swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 4-D bf16 tensor (d0 innermost, each outer stride the product of the
// inner dimensions times 2 bytes, multiples of 16) cut into boxes of
// b0 x b1 x b2 x 1, b0 * 2 bytes a row under the swizzle of that span (32,
// 64 or 128 bytes); elements outside the tensor read as zeros. Returns a
// cudaError_t.
int make_map_bf16_4d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint64_t d3, uint32_t b0, uint32_t b1, uint32_t b2) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const CUtensorMapSwizzle swizzle = b0 * 2 == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : b0 * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : b0 * 2 == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (swizzle == CU_TENSOR_MAP_SWIZZLE_NONE) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {d0 * 2, d0 * d1 * 2, d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {b0, b1, b2, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// out[c][p] = sum over the client's NG block slots, in slot order
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int C, int NG, int P) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)C * P) return;
  size_t c = i / P, p = i - c * P;
  const float* src = partial + c * NG * P + p;
  float s = 0.f;
  for (int j = 0; j < NG; ++j) s += src[(size_t)j * P];
  out[i] = s;
}

int launch_reduce_partials(const float* partial, float* out, int C, int NG, int P,
                           cudaStream_t stream) {
  const size_t n = (size_t)C * P;
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, out, C, NG,
                                                                         P);
  return (int)cudaGetLastError();
}

}  // namespace
