// The two probe kernels of the conv-formulations measurement for Hopper
// (sm_90a): a bare batched GEMM and a 3x3 SAME convolution forward written
// as a loop over the nine taps.
//
// Replaces the TPU kernels K8 of scripts/probe_pallas_pipelined.py:
//   K8a _gemm_kernel, launched by pallas_batched_gemm: (C, M, K) @ (C, K, N)
//       -> (C, M, N) in a's dtype with f32 sums, one grid cell per client;
//   K8b _taploop_kernel, launched by pallas_taploop_conv: the convolution as
//       nine K = I products on shifted rows of the flat padded image, summed
//       into one f32 accumulator; no patch matrix is formed.
// The probe asks what a convolution costs beside the same product on a
// patch matrix that already exists (K8a) and beside the implicit GEMM that
// builds one (conv_patch.cu): so K8b is a kernel of its own, not an alias of
// the patch GEMM. Not kept, because it is TPU layout: the collapse to
// (B * Hp * Wp, I) rows with a halo of 2 * Wp + 2 rows, the per-client
// BlockSpecs and the VMEM accumulator.
//
// The batched GEMM takes one of three routes, fixed by the dtype and the
// shape (ops/conv_probe.py launch_plan):
//   gemm_tma_wgmma_kernel     bfloat16 where rows of K and N are whole 16-byte
//       pieces: a persistent block an SM walks (client, pass, 128-row tile)
//       items client-major, one producer warp streams A by TMA through a
//       ring of 16 KB stages, two consumer warpgroups multiply on wgmma
//       against the client's B held in shared memory, and the rounded tile
//       leaves by a TMA store under the next tile's products (common.cuh's
//       pipeline blocks);
//   gemm_staged_wgmma_kernel  the other bfloat16 shapes: the same wgmma
//       products on a tile's rows staged by cp.async, one tile at a time,
//       stores masked to M and N;
//   batched_gemm_kernel       float32 (TF32 would break the contract): grid
//       (N tiles, M tiles, C), a 64 x 64 output tile per block, K walked in
//       chunks of 32 through shared memory, a 4 x 4 register tile per thread
//       on the CUDA cores.
// The tap loop takes one of two routes, fixed by the dtype and the shape
// (ops/conv_probe.py taploop_launch_plan):
//   taploop_tma_wgmma_kernel  bfloat16 where a pixel's channels and outputs
//       are whole 16-byte pieces and the ring fits: a persistent block an SM
//       walks (client, pass, 128-row tile) items client-major, one producer
//       warp streams whole images with their one-pixel halo by TMA (the
//       halo's zeros are TMA's out-of-bounds fill), two consumer warpgroups
//       take the tiles in turn, gather each tap's rows from the staged
//       images by ldmatrix and multiply them on wgmma against the client's
//       nine taps held in shared memory, and the rounded tile leaves by a TMA
//       store;
//   taploop_conv_kernel       float32 (TF32 would break the contract) and the
//       bfloat16 shapes TMA cannot take: grid (image groups, C), a block
//       stages a band of an image with its one-pixel halo (zeros outside the
//       image) and the client's weights in shared memory; a thread owns four
//       output positions x four channels in registers and makes nine passes
//       over the staged rows, one K = I product each.
//
// What bounds them on the H100: at the probe shapes (512 clients, M = 8192,
// K = 288, N = 64, bf16) the GEMM is 77 G FMA on 2.97 GB, the convolution
// (512 x 32 images, 14x14, 32 -> 64) 59 G FMA on 0.64 GB: both bound by
// bytes by the card's numbers. The TMA routes answer for that. The GEMM's A
// (81% of its bytes) is read once, in whole boxes, by a warp that does
// nothing else, so the products and stores hide under its stream; what is
// left is the card's copy rate. K = 288 is 4.5 swizzle boxes of 64: the fifth
// box's columns past K are zero-filled by TMA in shared memory only (K padded
// to 320 there), which costs shared-memory bandwidth and no device memory.
// The tap loop's x is read once and y written once, and its products (9 x
// 2 x 2 wgmma m64n64k16 a 128-row tile) run on the tensor cores; what holds
// it above its bytes is the consumers' own work a tile (addresses, waits,
// the epilogue) and the latency of wgmma with A from registers, which lets
// only a few products be in flight (PERF.md).

#include "common.cuh"

namespace {

constexpr int kGemmThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kLda = kBK + 4;  // rows 4 apart miss each other's banks
constexpr int kMaxThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
batched_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                    int M, int K, int N) {
  __shared__ __align__(16) T s_a[kBM * kLda];  // [m][k]
  __shared__ __align__(16) T s_b[kBK * kBN];   // [k][n]
  const int c = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const T* ac = a + (size_t)c * M * K;
  const T* bc = b + (size_t)c * K * N;
  const bool vec_a = rows_aligned4<T>(ac, K), vec_b = rows_aligned4<T>(bc, N);
  const int og = threadIdx.x % (kBN / 4), rg = threadIdx.x / (kBN / 4);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBM * (kBK / 4); e += kGemmThreads) {
      int m = e / (kBK / 4), k = (e % (kBK / 4)) * 4;
      int valid = m0 + m < M ? K - (k0 + k) : 0;
      stage4<T>(s_a + m * kLda + k, ac + (size_t)(m0 + m) * K + k0 + k, valid, vec_a);
    }
    for (int e = threadIdx.x; e < kBK * (kBN / 4); e += kGemmThreads) {
      int k = e / (kBN / 4), n = (e % (kBN / 4)) * 4;
      int valid = k0 + k < K ? N - (n0 + n) : 0;
      stage4<T>(s_b + k * kBN + n, bc + (size_t)(k0 + k) * N + n0 + n, valid, vec_b);
    }
    __syncthreads();
    const T* ar = s_a + rg * 4 * kLda;
    fma_rows4x4<T>(ar, ar + kLda, ar + 2 * kLda, ar + 3 * kLda, s_b + og * 4, kBN, kBK, acc);
  }
  T* oc = out + (size_t)c * M * N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + rg * 4 + j;
    if (m >= M) break;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = n0 + og * 4 + n;
      if (col < N) oc[(size_t)m * N + col] = from_f<T>(acc[j][n]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core GEMMs
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTmaRows = 128;     // rows of a tile: 64 for each of two consumer warpgroups
constexpr int kTmaThreads = 384;  // the producer's warpgroup and two consumer warpgroups
constexpr int kKBox = 64;         // K columns of one TMA box: 128 bytes, the swizzle's span
constexpr int kStageBytes = kTmaRows * kKBox * 2;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kStagedMaxThreads = 256;
constexpr int kHandTap = 4;  // the tap loop's turns pass after this tap's products

// 8-column tiles a column pass covers: 64 columns where N reaches beyond 32,
// else the next of 8, 16, 32
int gemm_pass_tiles(int N) {
  const int n = round_up8(N) / 8;
  return n > 4 ? 8 : n > 2 ? 4 : n;
}

// The TMA route's shared memory: the slack to align to 1024, the stages
// ([128 rows][64 k], 128-byte swizzle), two warpgroups' output tiles, B's
// pass as core matrices, the full and empty barriers.
size_t tma_gemm_smem_bytes(int K, int N, int stages) {
  const size_t NP = 8 * gemm_pass_tiles(N);
  return 1024 + (size_t)stages * kStageBytes + 2 * 64 * NP * 2 + (size_t)round_up16(K) * NP * 2 +
         (size_t)2 * stages * 8;
}

// The staged route's: B's pass, the tile's rows [row][k] with the skewed
// stride, a 16-row output buffer a warp.
size_t staged_gemm_smem_bytes(int K, int N, int rows) {
  const size_t NP = 8 * gemm_pass_tiles(N), KP = round_up16(K);
  return 2 * (KP * NP + (size_t)rows * (KP + kSkew) + (size_t)rows * (NP + kSkew));
}

// Columns n0 .. n0 + 8 * NT of the client's B (K x N) as the core matrices
// wgmma reads, [k / 8][n / 8][k % 8][n % 8] over round_up16(K) rows, zeros
// past K and N; eight threads fill one core matrix. The caller commits and
// waits for the cp.async part.
template <int NT>
__device__ void load_b_pass(bf16* s_b, const bf16* __restrict__ bc, int K, int N, int n0,
                            bool vec, int tid, int nthreads) {
  const int KP = round_up16(K);
  for (int e = tid; e < KP * NT; e += nthreads) {
    const int k0 = e & 7, nb = (e >> 3) % NT, kb = (e >> 3) / NT;
    const int k = kb * 8 + k0, o = n0 + nb * 8;
    bf16* d = s_b + ((size_t)(kb * NT + nb) * 8 + k0) * 8;
    const bf16* src = bc + (size_t)k * N + o;
    if (k >= K || o >= N) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec && o + 8 <= N) {
      cp_async16(d, src);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = o + i < N ? src[i] : __float2bfloat16(0.f);
    }
  }
}

// A work item is (client, column pass, 128-row tile), numbered client-major,
// then pass, then tile; a block takes items_per_block consecutive ones, so B
// is loaded again only where the client or the pass changes.
struct GemmItem {
  int c, p, t;
};
__device__ __forceinline__ GemmItem gemm_item(long long it, int passes, int m_tiles) {
  const int per_client = passes * m_tiles;
  const int c = (int)(it / per_client), rem = (int)(it - (long long)c * per_client);
  return {c, rem / m_tiles, rem % m_tiles};
}

// The TMA route: K * 2 and N * 2 multiples of 16, the operands 16-byte
// aligned. Warpgroup 0 is the producer: after giving up registers, one thread
// walks the block's items and streams A in boxes of 128 rows x 64 k through
// the ring of stages (K beyond the tensor reads as zeros, so K = 288 takes
// five boxes). Warpgroups 1 and 2 consume: each owns 64 rows of the tile,
// gathers its A fragments from a stage by ldmatrix (the 128-byte swizzle
// makes the eight rows of a matrix miss each other's banks), hands the stage
// back at once and multiplies on wgmma m64nNk16 against B, which sits in
// shared memory as core matrices for the whole client and pass. The sums
// stay in registers over all of K, are rounded once, written to the
// warpgroup's output tile and stored by TMA while the next tile multiplies.
template <int NT>
__global__ void __launch_bounds__(kTmaThreads, 1)
gemm_tma_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_out, const bf16* __restrict__ b,
                      int C, int M, int K, int N, int stages, int items_per_block) {
  extern __shared__ unsigned char smem_tma[];
  constexpr int NP = 8 * NT;
  unsigned char* s_a = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_tma) + 1023) & ~(uintptr_t)1023);
  bf16* s_out = reinterpret_cast<bf16*>(s_a + (size_t)stages * kStageBytes);  // 2 x [64][NP]
  bf16* s_b = s_out + 2 * 64 * NP;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_b + (size_t)round_up16(K) * NP);
  uint64_t* empty = full + stages;

  const int m_tiles = (M + kTmaRows - 1) / kTmaRows, passes = (N + NP - 1) / NP;
  const long long item0 = (long long)blockIdx.x * items_per_block;
  const long long item1 = min((long long)C * passes * m_tiles, item0 + items_per_block);
  const int nkb = (K + kKBox - 1) / kKBox, n_steps = (K + 15) / 16;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (item0 >= item1) return;  // uniform across the block

  if (wg == 0) {
    // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int u = 0;
      for (long long it = item0; it < item1; ++it) {
        const GemmItem w = gemm_item(it, passes, m_tiles);
        for (int kb = 0; kb < nkb; ++kb, ++u) {
          const int s = u % stages;
          mbar_wait(&empty[s], ((u / stages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          tma_load_3d(s_a + (size_t)s * kStageBytes, &map_a, &full[s], kb * kKBox,
                      w.t * kTmaRows, w.c);
        }
      }
    }
    return;
  }

  // the consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int a_row = cw * 64 + warp * 16 + (lane & 15), a_chunk = lane >> 4;
  const uint32_t a_lane = smem_addr(s_a) + a_row * 128;
  const uint32_t lbo = NT * 128, sbo = 128;  // bytes between k-blocks, between column blocks
  const uint64_t desc0 = wgmma_desc(smem_addr(s_b), lbo, sbo);
  unsigned char* my_out = reinterpret_cast<unsigned char*>(s_out + cw * 64 * NP);
  const bool issuer = (threadIdx.x & 127) == 0;
  const int g = lane >> 2, t4 = lane & 3;

  long long cur = -1;
  int u = 0;
  for (long long it = item0; it < item1; ++it) {
    const GemmItem w = gemm_item(it, passes, m_tiles);
    const long long key = (long long)w.c * passes + w.p;
    if (key != cur) {
      named_barrier(1, 256);  // every consumer is done with the last pass's B
      load_b_pass<NT>(s_b, b + (size_t)w.c * K * N, K, N, w.p * NP, true, threadIdx.x - 128, 256);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      named_barrier(1, 256);
      cur = key;
    }

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[n][v] = 0.f;

    // box kb: wait for its stage, take the A fragments of its (up to) four
    // k16 steps into registers and hand the stage back
    auto gather = [&](uint32_t (&a)[4][4], int kb) {
      const int s = u % stages;
      mbar_wait(&full[s], (u / stages) & 1);
      const uint32_t row = a_lane + s * kStageBytes;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kb * 4 + j < n_steps)
          ldmatrix_x4(a[j], row + ((((2 * j + a_chunk) ^ (a_row & 7))) << 4));
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      ++u;
    };
    auto multiply = [&](const uint32_t (&a)[4][4], int kb) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kb * 4 + j < n_steps)
          wgmma_m64k16<NT>(acc, a[j], desc0 + (uint64_t)((2 * (kb * 4 + j) * lbo) >> 4));
      wgmma_commit();
    };
    uint32_t a0[4][4], a1[4][4];
    for (int kb = 0; kb < nkb; kb += 2) {
      gather(a0, kb);
      multiply(a0, kb);
      wgmma_wait<1>();  // box kb - 1 is done with a1
      if (kb + 1 < nkb) {
        gather(a1, kb + 1);
        multiply(a1, kb + 1);
        wgmma_wait<1>();  // box kb is done with a0
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) asm volatile("" : "+f"(acc[n][v])::"memory");

    // one rounding; the warpgroup's tile goes out by one TMA store, which
    // the next epilogue waits for before it writes the tile again
    if (issuer) bulk_wait_read<0>();
    named_barrier(2 + cw, 128);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + g + 8 * half;
        const uint32_t off = NP == 64 ? swizzle128(r, n) + 4 * t4 : r * NP * 2 + n * 16 + 4 * t4;
        *reinterpret_cast<__nv_bfloat162*>(my_out + off) =
            __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
      }
    fence_proxy_async();
    named_barrier(2 + cw, 128);
    if (issuer) {
      tma_store_3d(&map_out, my_out, w.p * NP, w.t * kTmaRows + cw * 64, w.c);
      bulk_commit();
    }
  }
  if (issuer) bulk_wait<0>();
}

// The staged route, for what TMA cannot take (rows of K or N not whole
// 16-byte pieces, operands not 16-byte aligned): the same products on wgmma,
// with a tile's rows staged by cp.async (scalar loads where a row is not
// aligned) into rows of the skewed stride, one tile at a time, and stores
// masked to M and N through a row buffer a warp. blockDim.x / 2 rows a tile
// (one or two warpgroups).
template <int NT>
__global__ void __launch_bounds__(kStagedMaxThreads)
gemm_staged_wgmma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                         bf16* __restrict__ out, int C, int M, int K, int N,
                         int items_per_block) {
  extern __shared__ __align__(128) unsigned char smem_st[];
  constexpr int NP = 8 * NT, kOutLd = NP + kSkew;
  const int KP = round_up16(K), LD = KP + kSkew, rows = blockDim.x / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* s_b = reinterpret_cast<bf16*>(smem_st);  // core matrices, KP x NP
  bf16* s_a = s_b + (size_t)KP * NP;             // [row][k], stride LD
  bf16* s_out = s_a + (size_t)rows * LD + warp * 16 * kOutLd;

  const int m_tiles = (M + rows - 1) / rows, passes = (N + NP - 1) / NP;
  const long long item0 = (long long)blockIdx.x * items_per_block;
  const long long item1 = min((long long)C * passes * m_tiles, item0 + items_per_block);
  const int n_steps = KP / 16, N8 = round_up8(N);
  const int row0 = (warp >> 2) * 64 + (warp & 3) * 16;  // the warp's rows of its warpgroup's product
  const uint32_t a_lane = smem_addr(s_a + (size_t)(row0 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t lbo = NT * 128, sbo = 128;
  const uint64_t desc0 = wgmma_desc(smem_addr(s_b), lbo, sbo);
  const int g = lane >> 2, t4 = lane & 3;

  long long cur = -1;
  for (long long it = item0; it < item1; ++it) {
    const GemmItem w = gemm_item(it, passes, m_tiles);
    const bf16* ac = a + (size_t)w.c * M * K;
    const bf16* bc = b + (size_t)w.c * K * N;
    bf16* oc = out + (size_t)w.c * M * N;
    __syncthreads();  // every warp is done with the last tile (and B)
    const long long key = (long long)w.c * passes + w.p;
    if (key != cur) {
      load_b_pass<NT>(s_b, bc, K, N, w.p * NP, rows_aligned16(bc, N), threadIdx.x, blockDim.x);
      cur = key;
    }
    stage_rows_bf16(s_a, ac, w.t * rows, rows, M, K, rows_aligned16(ac, K));
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[n][v] = 0.f;
    auto multiply = [&](int step, const uint32_t (&fa)[4]) {
      wgmma_fence();
      wgmma_m64k16<NT>(acc, fa, desc0 + (uint64_t)((2 * step * lbo) >> 4));
      wgmma_commit();
    };
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, a_lane);
    int step = 0;
    for (; step + 1 < n_steps; step += 2) {
      multiply(step, a0);
      wgmma_wait<1>();  // step - 1 is done with a1
      ldmatrix_x4(a1, a_lane + (step + 1) * 32);
      multiply(step + 1, a1);
      wgmma_wait<1>();  // step is done with a0
      if (step + 2 < n_steps) ldmatrix_x4(a0, a_lane + (step + 2) * 32);
    }
    if (step < n_steps) multiply(step, a0);
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) asm volatile("" : "+f"(acc[n][v])::"memory");

    // one rounding, then the warp's 16 rows through its row buffer
    const int n0 = w.p * NP, nt = min(NT, (N8 - n0) / 8);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(s_out + g * kOutLd + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(s_out + (g + 8) * kOutLd + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
    }
    __syncwarp();
    const bool vec_o = rows_aligned16(oc, N);
    for (int e = lane; e < 16 * nt; e += 32) {
      const int row = e / nt, ch = e - row * nt, r = w.t * rows + row0 + row, o = n0 + ch * 8;
      if (r >= M) continue;
      const bf16* src = s_out + row * kOutLd + ch * 8;
      bf16* dst = oc + (size_t)r * N + o;
      if (vec_o && o + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int i = 0; i < 8 && o + i < N; ++i) dst[i] = src[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tap loop on TMA + wgmma
// ---------------------------------------------------------------------------

// Channels of one staged TMA box: 16, 32 or 64, so that a staged pixel is one
// row of 32, 64 or 128 bytes, the span of the box's swizzle. I is padded to a
// whole number of boxes; TMA reads the channels past I as zeros.
__host__ __device__ __forceinline__ int taploop_chunk(int I) {
  return I <= 16 ? 16 : I <= 32 ? 32 : 64;
}

// Bytes of one box: a whole image with its one-pixel halo, (H + 2) x (W + 2)
// pixels of KC channels, rounded up to 1024 so that every box starts where
// its swizzle's pattern does.
__host__ __device__ __forceinline__ uint32_t taploop_box_bytes(int H, int W, int KC) {
  return (uint32_t)(((size_t)(H + 2) * (W + 2) * KC * 2 + 1023) & ~(size_t)1023);
}

// Images two tiles, 256 consecutive output rows, can touch (HW rows an
// image): the two consumer warpgroups hold at most that many at once.
__host__ __device__ __forceinline__ int taploop_span(int B, int HW) {
  const int n = (2 * kTmaRows - 2) / HW + 2;
  return n < B ? n : B;
}

// The TMA route's shared memory: the slack to align to 1024, the stages (one
// halo'd image each, I / KC boxes rounded up), two warpgroups' output
// tiles, the client's nine taps of one column pass as core matrices, the
// full and empty barriers.
size_t taploop_tma_smem_bytes(int H, int W, int I, int O, int stages) {
  const int KC = taploop_chunk(I), KP = (I + KC - 1) / KC * KC;
  const size_t NP = 8 * gemm_pass_tiles(O);
  return 1024 + (size_t)stages * (KP / KC) * taploop_box_bytes(H, W, KC) +
         2 * kTmaRows * NP * 2 + (size_t)9 * KP * NP * 2 + (size_t)2 * stages * 8;
}

// Columns n0 .. n0 + 8 * NT of the client's nine taps (wc: [tap][I][O]) as
// the core matrices wgmma reads, [k / 8][n / 8][k % 8][n % 8], tap t's
// channels at rows t * KP .. t * KP + KP, zeros past I and past O (O a
// multiple of 8 and wc 16-byte aligned on this route). The caller commits
// and waits.
template <int NT>
__device__ void load_b_taps(bf16* s_b, const bf16* __restrict__ wc, int I, int O, int KP,
                            int n0, int tid, int nthreads) {
  for (int e = tid; e < 9 * KP * NT; e += nthreads) {
    const int k0 = e & 7, nb = (e >> 3) % NT, kb = (e >> 3) / NT;
    const int k = kb * 8 + k0, tap = k / KP, ci = k - tap * KP, o = n0 + nb * 8;
    bf16* d = s_b + ((size_t)(kb * NT + nb) * 8 + k0) * 8;
    if (ci >= I || o >= O)
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    else
      cp_async16(d, wc + ((size_t)tap * I + ci) * O + o);
  }
}

// n / d for 0 <= n < 2^24 (so that n is exact as a float): the quotient by
// d's float reciprocal, off by at most one, then corrected
struct FastDiv {
  int d;
  float inv;
  __device__ __forceinline__ FastDiv(int d_) : d(d_), inv(1.f / (float)d_) {}
  __device__ __forceinline__ int operator()(int n) const {
    int q = __float2int_rz(__int2float_rz(n) * inv);
    q += (q + 1) * d <= n;
    q -= q * d > n;
    return q;
  }
};

// A tap-loop work item (client, column pass, tile); a block walks its items
// in order, and next() steps to the following one without a division.
struct TapItem {
  int c, p, t;
  __device__ __forceinline__ void next(int passes, int m_tiles) {
    if (++t == m_tiles) {
      t = 0;
      if (++p == passes) p = 0, ++c;
    }
  }
};

// The ring positions of the images each item reads, as the producer fills
// them: a (client, pass) starts where the last one's images end, at its
// first image (tile t of the client's M output rows reads images
// t * 128 / HW .. ((t + 1) * 128 - 1) / HW); positions only grow.
struct TapRing {
  int u_key = 0, b0_key = 0, u_end = 0;
  int b_lo = 0, first = 0, last = 0;  // of the item stepped last
  __device__ __forceinline__ void step(bool fresh, int t, int M, const FastDiv& hw) {
    b_lo = hw(t * kTmaRows);
    const int b_hi = hw(min(M, (t + 1) * kTmaRows) - 1);
    if (fresh) u_key = u_end, b0_key = b_lo;
    first = u_key + b_lo - b0_key;
    last = u_key + b_hi - b0_key;
    u_end = last + 1;
  }
};

// The TMA route of the tap loop: I * 2 and O * 2 multiples of 16, x, w and y
// 16-byte aligned, W + 2 and H + 2 at most 256, `stages` a power of two.
// Work items are (client, column pass, 128-row tile of the client's B * H *
// W output rows), walked client-major by a persistent block an SM, as the
// GEMM's. Warpgroup 0 is the producer: one thread streams the images the
// block's tiles read, each once per (client, pass), in order, through the
// ring of stages. An image arrives whole with its one-pixel halo: a 4-D
// tensor map over x seen as (I, W, H, C * B), boxes of (KC, W + 2, H + 2,
// 1) at (kc * KC, -1, -1, image), so TMA writes the halo's zeros and no
// padded copy of x exists. Warpgroups 1 and 2 take the items in turn (0, 2,
// 4, ... and 1, 3, 5, ...), each a whole tile as two 64-row halves: for
// each tap, each box of its channels and each half, a lane gathers its
// row's 16-byte pieces from its image's stage at the tap's offset by
// ldmatrix (the swizzle's XOR applied to the address) and the warpgroup
// multiplies them on wgmma m64nNk16 against the nine taps held in shared
// memory for the client and pass, into the half's f32 accumulator, tap-major
// and channel-minor; a half's gather runs while the other half multiplies.
// A stage is handed back by both warpgroups, in ring order, once neither's
// next tile reads it. The rounded tile leaves by a TMA store of y seen as
// (O, B * H * W, C), clipped at the client's last row, while the other
// warpgroup's products run. Where a (client, pass) starts, the warpgroup
// whose tile it is reloads the taps once the other's products on the old
// ones have retired, and the other waits for the reload.
template <int NT, int KC>
__global__ void __launch_bounds__(kTmaThreads, 1)
taploop_tma_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_y, const bf16* __restrict__ w,
                         int C, int B, int H, int W, int I, int O, int stages,
                         int items_per_block) {
  extern __shared__ unsigned char smem_tap[];
  constexpr int NP = 8 * NT, SPC = KC / 16, CB = 2 * KC;  // k16 steps and bytes of a staged row
  constexpr int kParts = kTmaRows / 64;  // a tile: two 64-row parts
  const int IC = (I + KC - 1) / KC, KP = IC * KC;
  const int WP = W + 2, HW = H * W, M = B * HW;
  const uint32_t box_bytes = taploop_box_bytes(H, W, KC), stage_bytes = IC * box_bytes;
  const int smask = stages - 1, sshift = __ffs(stages) - 1;
  unsigned char* s_x = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_tap) + 1023) & ~(uintptr_t)1023);
  bf16* s_out = reinterpret_cast<bf16*>(s_x + (size_t)stages * stage_bytes);  // 2 x [128][NP]
  bf16* s_b = s_out + 2 * kTmaRows * NP;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_b + (size_t)9 * KP * NP);
  uint64_t* empty = full + stages;

  const int m_tiles = (M + kTmaRows - 1) / kTmaRows, passes = (O + NP - 1) / NP;
  const long long item0 = (long long)blockIdx.x * items_per_block;
  const int n_items = (int)min((long long)C * passes * m_tiles - item0, (long long)items_per_block);
  const int wg = threadIdx.x >> 7;
  const FastDiv div_hw(HW), div_w(W);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (n_items <= 0) return;  // uniform across the block
  const GemmItem g0 = gemm_item(item0, passes, m_tiles);

  if (wg == 0) {
    // the producer: image after image, each once per (client, pass)
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const uint32_t tx = (uint32_t)IC * (H + 2) * WP * KC * 2;
      TapItem q = {g0.c, g0.p, g0.t};
      TapRing ring;
      int u = 0;
      for (int i = 0; i < n_items; ++i, q.next(passes, m_tiles)) {
        ring.step(i == 0 || q.t == 0, q.t, M, div_hw);
        for (; u <= ring.last; ++u) {
          const int s = u & smask;
          mbar_wait(&empty[s], ((u >> sshift) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], tx);
          for (int kc = 0; kc < IC; ++kc)
            tma_load_4d(s_x + (size_t)s * stage_bytes + kc * box_bytes, &map_x, &full[s],
                        kc * KC, -1, -1, q.c * B + ring.b_lo + u - ring.first);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup cw takes items cw, cw + 2, ...
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int a_row = warp * 16 + (lane & 15);
  const uint32_t lbo = NT * 128, sbo = 128;  // bytes between k-blocks, between column blocks
  const uint64_t desc0 = wgmma_desc(smem_addr(s_b), lbo, sbo);
  const uint32_t x_base = smem_addr(s_x);
  unsigned char* my_out = reinterpret_cast<unsigned char*>(s_out + cw * kTmaRows * NP);
  const bool issuer = (threadIdx.x & 127) == 0;
  const int g = lane >> 2, t4 = lane & 3;
  const int my_turn = 3 + cw, their_turn = 4 - cw;  // named barriers of the hand-overs
  uint32_t chunk[SPC];  // the lane's 16-byte piece of each k16 step in a staged row
#pragma unroll
  for (int j = 0; j < SPC; ++j) chunk[j] = (2 * j + (lane >> 4)) << 4;

  // ring: stepped through the item before this warpgroup's next one
  TapItem q = {g0.c, g0.p, g0.t};
  TapRing ring;
  ring.step(true, q.t, M, div_hw);
  if (cw == 1) {
    if (n_items < 2) return;
    q.next(passes, m_tiles);
    ring.step(q.t == 0, q.t, M, div_hw);
  }
  int u_rel = 0;  // the first ring position this warpgroup has not handed back
  for (int i = cw; i < n_items; i += 2) {
    const bool fresh = i == 0 || q.t == 0;
    const int first = ring.first, b_lo = ring.b_lo, last = ring.last;
    const TapItem cur = q;
    // the next two items: this warpgroup's next tile reads nothing before
    // `keep`
    int keep = ring.u_end;
    if (i + 1 < n_items) {
      q.next(passes, m_tiles);
      ring.step(q.t == 0, q.t, M, div_hw);
      keep = ring.u_end;
      if (i + 2 < n_items) {
        q.next(passes, m_tiles);
        ring.step(q.t == 0, q.t, M, div_hw);
        keep = ring.first;
      }
    }
    // The warpgroups take turns: item i + 1 starts once item i has issued
    // the products of its first kHandTap + 1 taps, so that their epilogues
    // fall apart and each runs under the other's products. Where item i + 1
    // starts a (client, pass) and reloads the taps, the turn passes only
    // once item i's products have retired.
    const bool next_fresh = i + 1 < n_items && cur.t + 1 == m_tiles;
    const bool hand_mid = i + 1 < n_items && !next_fresh;

    // each part's lane row (rows past the client's last read its last row,
    // and the store drops them): the shared-memory address of its image's
    // stage, and the byte offset in the halo'd image of its pixel under tap
    // (0, 0), row r and column c at r * (W + 2) + c = hw + 2 r
    uint32_t x_lane[kParts], p_off[kParts];
#pragma unroll
    for (int h = 0; h < kParts; ++h) {
      const int m = min(cur.t * kTmaRows + h * 64 + a_row, M - 1);
      const int b = div_hw(m), hw = m - b * HW;
      p_off[h] = (uint32_t)(hw + 2 * div_w(hw)) * CB;
      x_lane[h] = x_base + (uint32_t)((first + b - b_lo) & smask) * stage_bytes;
    }

    if (i > 0) named_barrier(my_turn, 256);
    if (fresh) {
      load_b_taps<NT>(s_b, w + (size_t)cur.c * 9 * I * O, I, O, KP, cur.p * NP,
                      threadIdx.x & 127, 128);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      named_barrier(1 + cw, 128);
    }
    for (int u = first; u <= last; ++u) mbar_wait(&full[u & smask], (u >> sshift) & 1);

    // zeroed before the first fence: a write to a sum between a wgmma's
    // fence and its retirement makes ptxas serialize the products
    float acc[kParts][NT][4];
#pragma unroll
    for (int h = 0; h < kParts; ++h)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[h][n][v] = 0.f;
          asm volatile("" : "+f"(acc[h][n][v])::"memory");
        }

    // one part's k16 steps of box kc at the tap `toff` bytes on: gather the
    // A fragments, then multiply them into the part's sums. The descriptors
    // are in registers before the fence: an instruction that writes a
    // wgmma's input between fence and commit makes ptxas serialize the
    // group.
    auto unit = [&](uint32_t (&a)[SPC][4], float (&d)[NT][4], int h, uint32_t toff, int kc,
                    uint64_t dgrp) {
      const uint32_t off = p_off[h] + toff;  // a multiple of CB: the row's XOR alone
      const uint32_t row = x_lane[h] + kc * box_bytes + off, flip = swizzle_span(off, CB) ^ off;
#pragma unroll
      for (int j = 0; j < SPC; ++j) ldmatrix_x4(a[j], row + (chunk[j] ^ flip));
      uint64_t desc[SPC];
#pragma unroll
      for (int j = 0; j < SPC; ++j) {
        desc[j] = dgrp + (uint64_t)((j * 2 * lbo) >> 4);
        asm volatile("" : "+l"(desc[j]));
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < SPC; ++j) wgmma_m64k16<NT>(d, a[j], desc[j]);
      wgmma_commit();
    };
    // Two sets of A buffers, one a part each, so that three units are in
    // flight while the next gathers: a buffer's registers are fenced once
    // the wait that retires its last unit has passed, so the compiler keeps
    // them to themselves until then (ptxas would serialize the products
    // otherwise). Groups are (tap, box) pairs, tap-major; the group's tap
    // lies toff bytes on.
    uint32_t a_set[2][kParts][SPC][4] = {};
    auto fence_a = [](uint32_t (&a)[SPC][4]) {
#pragma unroll
      for (int j = 0; j < SPC; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[j][k])::"memory");
    };
    uint32_t toff = 0;
    int dw = 0, kc = 0;
    const int n_groups = 9 * IC, hand_group = (kHandTap + 1) * IC - 1;
    auto group = [&](uint32_t (&as)[kParts][SPC][4], int grp) {
      const uint64_t dgrp = desc0 + (uint64_t)((grp * SPC * 2 * lbo) >> 4);
#pragma unroll
      for (int h = 0; h < kParts; ++h) {
        fence_a(as[h]);
        unit(as[h], acc[h], h, toff, kc, dgrp);
        wgmma_wait<3>();
      }
      if (grp == hand_group && hand_mid) named_barrier_arrive(their_turn, 256);
      if (++kc == IC) {
        kc = 0;
        toff += CB;
        if (++dw == 3) {
          dw = 0;
          toff += (WP - 3) * CB;
        }
      }
    };
    // no branch between two groups: ptxas then sees which wait retires
    // which buffer
    int grp = 0;
    for (; grp + 1 < n_groups; grp += 2) {
      group(a_set[0], grp);
      group(a_set[1], grp + 1);
    }
    if (grp < n_groups) group(a_set[0], grp);

    // hand back, in ring order, what this warpgroup's next tile does not read
    __syncwarp();
    for (; u_rel < keep; ++u_rel)
      if (lane == 0) mbar_arrive(&empty[u_rel & smask]);
    wgmma_wait<0>();
    if (next_fresh) named_barrier_arrive(their_turn, 256);
#pragma unroll
    for (int h = 0; h < kParts; ++h)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int v = 0; v < 4; ++v) asm volatile("" : "+f"(acc[h][n][v])::"memory");

    // one rounding; the warpgroup's tile goes out by one TMA store, which
    // its next epilogue waits for before it writes the tile again
    if (issuer) bulk_wait_read<0>();
    named_barrier(1 + cw, 128);
#pragma unroll
    for (int h = 0; h < kParts; ++h)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = h * 64 + warp * 16 + g + 8 * half;
          const uint32_t off =
              NP == 64 ? swizzle128(r, n) + 4 * t4 : r * NP * 2 + n * 16 + 4 * t4;
          *reinterpret_cast<__nv_bfloat162*>(my_out + off) =
              __floats2bfloat162_rn(acc[h][n][2 * half], acc[h][n][2 * half + 1]);
        }
    fence_proxy_async();
    named_barrier(1 + cw, 128);
    if (issuer) {
      tma_store_3d(&map_y, my_out, cur.p * NP, cur.t * kTmaRows, cur.c);
      bulk_commit();
    }
  }
  if (issuer) bulk_wait<0>();
}

size_t taploop_smem_bytes(int W, int I, int O, int TH, size_t tsize) {
  const int IP = round_up4(I), OP = round_up4(O);
  return ((size_t)9 * IP * OP + (size_t)(TH + 2) * (W + 2) * IP) * tsize;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
taploop_conv_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int B,
                    int H, int W, int I, int O, int TH, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int IP = round_up4(I), OP = round_up4(O), O4 = OP / 4, WP = W + 2;
  const int c = blockIdx.y;
  T* s_w = reinterpret_cast<T*>(smem);  // [tap][ci][o], pad rows and columns zero
  T* s_x = s_w + (size_t)9 * IP * OP;   // [row h0 - 1 + rr][col cc - 1][ci]

  const T* wc = w + (size_t)c * 9 * I * O;
  const bool vec_w = rows_aligned4<T>(wc, O);
  for (int e = threadIdx.x; e < 9 * IP * O4; e += blockDim.x) {
    int kk = e / O4, o = (e - kk * O4) * 4;
    int tap = kk / IP, ci = kk - tap * IP;
    stage4<T>(s_w + kk * OP + o, wc + (size_t)(tap * I + ci) * O + o, ci < I ? O - o : 0,
              vec_w);
  }

  const int I4 = IP / 4;
  for (int j = 0; j < G; ++j) {
    const int b = blockIdx.x * G + j;
    if (b >= B) break;  // uniform across the block
    const T* xb = x + ((size_t)c * B + b) * H * W * I;
    T* yb = y + ((size_t)c * B + b) * H * W * O;
    const bool vec_x = rows_aligned4<T>(xb, I);
    for (int h0 = 0; h0 < H; h0 += TH) {
      const int rows = min(TH, H - h0), n_pos = rows * W;
      __syncthreads();  // the last band's readers are done
      for (int e = threadIdx.x; e < (rows + 2) * WP * I4; e += blockDim.x) {
        int ci = (e % I4) * 4, px = e / I4;
        int rr = px / WP, cc = px - rr * WP;
        int h = h0 - 1 + rr, col = cc - 1;
        bool in = h >= 0 && h < H && col >= 0 && col < W;
        const T* src = in ? xb + ((size_t)h * W + col) * I + ci : xb;
        stage4<T>(s_x + (size_t)px * IP + ci, src, in ? I - ci : 0, vec_x);
      }
      __syncthreads();
      for (int task = threadIdx.x; task < ((n_pos + 3) / 4) * O4; task += blockDim.x) {
        const int og = task % O4, p0 = (task / O4) * 4;
        // the staged pixel under tap (0, 0) of each of the four positions;
        // positions past the band read position 0 and are not stored
        const T* a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int p = p0 + q < n_pos ? p0 + q : 0;
          a[q] = s_x + (size_t)((p / W) * WP + p % W) * IP;
        }
        float acc[4][4] = {};
        for (int tap = 0; tap < 9; ++tap) {
          const int off = ((tap / 3) * WP + tap % 3) * IP;
          fma_rows4x4<T>(a[0] + off, a[1] + off, a[2] + off, a[3] + off,
                         s_w + (size_t)tap * IP * OP + og * 4, OP, IP, acc);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (p0 + q >= n_pos) break;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int o = og * 4 + n;
            if (o < O) yb[((size_t)h0 * W + p0 + q) * O + o] = from_f<T>(acc[q][n]);
          }
        }
      }
    }
  }
}

int launch_gemm_f32(const void* a, const void* b, void* out, int C, int M, int K, int N,
                    cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, C);
  batched_gemm_kernel<float><<<grid, kGemmThreads, 0, stream>>>(
      (const float*)a, (const float*)b, (float*)out, M, K, N);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_gemm_tma_nt(const bf16* a, const bf16* b, bf16* out, int C, int M, int K, int N,
                       int stages, int blocks, int items_per_block, cudaStream_t stream) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, gemm_tma_wgmma_kernel<NT>);
  if (e != cudaSuccess) return (int)e;
  // setmaxnreg hands the consumers registers that the launch must have
  // given the block: refuse rather than wait on them forever
  if (attr.numRegs * kTmaThreads < kProducerRegs * 128 + kConsumerRegs * 256)
    return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map_a, map_out;
  int rc = make_map_bf16_3d(&map_a, a, K, M, C, kKBox, kTmaRows, true);
  if (rc) return rc;
  rc = make_map_bf16_3d(&map_out, out, N, M, C, 8 * NT, 64, NT == 8);
  if (rc) return rc;
  const size_t smem = tma_gemm_smem_bytes(K, N, stages);
  e = cudaFuncSetAttribute(gemm_tma_wgmma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  gemm_tma_wgmma_kernel<NT><<<blocks, kTmaThreads, smem, stream>>>(map_a, map_out, b, C, M, K, N,
                                                                   stages, items_per_block);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_gemm_staged_nt(const bf16* a, const bf16* b, bf16* out, int C, int M, int K, int N,
                          int rows, int blocks, int items_per_block, cudaStream_t stream) {
  const size_t smem = staged_gemm_smem_bytes(K, N, rows);
  cudaError_t e = cudaFuncSetAttribute(gemm_staged_wgmma_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  gemm_staged_wgmma_kernel<NT><<<blocks, 2 * rows, smem, stream>>>(a, b, out, C, M, K, N,
                                                                   items_per_block);
  return (int)cudaGetLastError();
}

// route 1: TMA, route 2: staged
int launch_gemm_bf16(int route, const void* a, const void* b, void* out, int C, int M, int K,
                     int N, int rows, int stages, int blocks, int items_per_block,
                     cudaStream_t stream) {
  const bf16 *ab = (const bf16*)a, *bb = (const bf16*)b;
  bf16* ob = (bf16*)out;
  if (route == 1) {
    const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (K % 8 || N % 8 || !aligned || rows != kTmaRows || stages < 2)
      return (int)cudaErrorInvalidValue;
    switch (gemm_pass_tiles(N)) {
      case 1: return launch_gemm_tma_nt<1>(ab, bb, ob, C, M, K, N, stages, blocks, items_per_block, stream);
      case 2: return launch_gemm_tma_nt<2>(ab, bb, ob, C, M, K, N, stages, blocks, items_per_block, stream);
      case 4: return launch_gemm_tma_nt<4>(ab, bb, ob, C, M, K, N, stages, blocks, items_per_block, stream);
      default: return launch_gemm_tma_nt<8>(ab, bb, ob, C, M, K, N, stages, blocks, items_per_block, stream);
    }
  }
  if (route != 2 || (rows != 64 && rows != 128)) return (int)cudaErrorInvalidValue;
  switch (gemm_pass_tiles(N)) {
    case 1: return launch_gemm_staged_nt<1>(ab, bb, ob, C, M, K, N, rows, blocks, items_per_block, stream);
    case 2: return launch_gemm_staged_nt<2>(ab, bb, ob, C, M, K, N, rows, blocks, items_per_block, stream);
    case 4: return launch_gemm_staged_nt<4>(ab, bb, ob, C, M, K, N, rows, blocks, items_per_block, stream);
    default: return launch_gemm_staged_nt<8>(ab, bb, ob, C, M, K, N, rows, blocks, items_per_block, stream);
  }
}
template <int NT, int KC>
int launch_taploop_tma_nt(const bf16* x, const bf16* w, bf16* y, int C, int B, int H, int W,
                          int I, int O, int stages, int blocks, int items_per_block,
                          cudaStream_t stream) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, taploop_tma_wgmma_kernel<NT, KC>);
  if (e != cudaSuccess) return (int)e;
  // as the GEMM's: refuse rather than wait on registers setmaxnreg cannot get
  if (attr.numRegs * kTmaThreads < kProducerRegs * 128 + kConsumerRegs * 256)
    return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map_x, map_y;
  int rc = make_map_bf16_4d(&map_x, x, I, W, H, (uint64_t)C * B, KC, W + 2, H + 2);
  if (rc) return rc;
  rc = make_map_bf16_3d(&map_y, y, O, (uint64_t)B * H * W, C, 8 * NT, kTmaRows, NT == 8);
  if (rc) return rc;
  const size_t smem = taploop_tma_smem_bytes(H, W, I, O, stages);
  e = cudaFuncSetAttribute(taploop_tma_wgmma_kernel<NT, KC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  taploop_tma_wgmma_kernel<NT, KC><<<blocks, kTmaThreads, smem, stream>>>(
      map_x, map_y, w, C, B, H, W, I, O, stages, items_per_block);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_taploop_tma_kc(const bf16* x, const bf16* w, bf16* y, int C, int B, int H, int W,
                          int I, int O, int stages, int blocks, int items_per_block,
                          cudaStream_t stream) {
  switch (taploop_chunk(I)) {
    case 16: return launch_taploop_tma_nt<NT, 16>(x, w, y, C, B, H, W, I, O, stages, blocks, items_per_block, stream);
    case 32: return launch_taploop_tma_nt<NT, 32>(x, w, y, C, B, H, W, I, O, stages, blocks, items_per_block, stream);
    default: return launch_taploop_tma_nt<NT, 64>(x, w, y, C, B, H, W, I, O, stages, blocks, items_per_block, stream);
  }
}

int launch_taploop_tma(const void* x, const void* w, void* y, int C, int B, int H, int W, int I,
                       int O, int stages, int blocks, int items_per_block, cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  // a ring shorter than a tile's images would wait forever
  if (I % 8 || O % 8 || !aligned || W + 2 > 256 || H + 2 > 256 || stages < 2 ||
      (stages & (stages - 1)) ||
      stages < taploop_span(B, H * W) || (long long)B * H * W + kTmaRows >= (1 << 24) ||
      blocks < 1 || items_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const bf16 *xb = (const bf16*)x, *wb = (const bf16*)w;
  bf16* yb = (bf16*)y;
  switch (gemm_pass_tiles(O)) {
    case 1: return launch_taploop_tma_kc<1>(xb, wb, yb, C, B, H, W, I, O, stages, blocks, items_per_block, stream);
    case 2: return launch_taploop_tma_kc<2>(xb, wb, yb, C, B, H, W, I, O, stages, blocks, items_per_block, stream);
    case 4: return launch_taploop_tma_kc<4>(xb, wb, yb, C, B, H, W, I, O, stages, blocks, items_per_block, stream);
    default: return launch_taploop_tma_kc<8>(xb, wb, yb, C, B, H, W, I, O, stages, blocks, items_per_block, stream);
  }
}

template <typename T>
int launch_taploop(const void* x, const void* w, void* y, int C, int B, int H, int W, int I,
                   int O, int TH, int G, int threads, cudaStream_t stream) {
  const size_t smem = taploop_smem_bytes(W, I, O, TH, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(taploop_conv_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + G - 1) / G, C);
  taploop_conv_kernel<T><<<grid, threads, smem, stream>>>((const T*)x, (const T*)w, (T*)y, B, H,
                                                          W, I, O, TH, G);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer is device memory; the
// return value is the cudaError_t of the launch (0 = success).

// out (C, M, N) = a (C, M, K) @ b (C, K, N), in a's dtype, on route 0 (the
// CUDA cores; float32 only, the other arguments unused) or, for bfloat16, 1
// (TMA + wgmma, tiles of 128 rows, `stages` >= 2) or 2 (staged + wgmma, tiles
// of 64 or 128 rows); `blocks` persistent blocks of `items_per_block` work
// items each.
extern "C" int fl_batched_gemm(int dtype, int route, const void* a, const void* b, void* out,
                               int C, int M, int K, int N, int rows, int stages, int blocks,
                               int items_per_block, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && route == 0) return launch_gemm_f32(a, b, out, C, M, K, N, s);
  if (dtype == 1 && (route == 1 || route == 2) && blocks >= 1 && items_per_block >= 1)
    return launch_gemm_bf16(route, a, b, out, C, M, K, N, rows, stages, blocks, items_per_block,
                            s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one block of route `route` needs (route 0: the static
// buffers of the float32 kernel).
extern "C" size_t fl_batched_gemm_smem_bytes(int route, int K, int N, int rows, int stages) {
  if (route == 1) return tma_gemm_smem_bytes(K, N, stages);
  if (route == 2) return staged_gemm_smem_bytes(K, N, rows);
  return sizeof(float) * (kBM * kLda + kBK * kBN);
}

// y (C, B, H, W, O) = conv3x3_same(x (C, B, H, W, I), w (C, 3, 3, I, O)), in
// x's dtype, on route 0 (the CUDA cores: bands of TH image rows, G images a
// block, `threads` a block) or, for bfloat16, 1 (TMA + wgmma: a ring of
// `stages` halo'd images, `blocks` persistent blocks of `items_per_block`
// work items each); the other route's arguments are unused.
extern "C" int fl_taploop_conv(int dtype, int route, const void* x, const void* w, void* y,
                               int C, int B, int H, int W, int I, int O, int TH, int G,
                               int threads, int stages, int blocks, int items_per_block,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1 && dtype == 1)
    return launch_taploop_tma(x, w, y, C, B, H, W, I, O, stages, blocks, items_per_block, s);
  if (route != 0 || threads < 32 || threads > kMaxThreads || threads % 32 || TH < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_taploop<float>(x, w, y, C, B, H, W, I, O, TH, G, threads, s);
  if (dtype == 1)
    return launch_taploop<__nv_bfloat16>(x, w, y, C, B, H, W, I, O, TH, G, threads, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one block of the tap-loop convolution needs: route 0 with
// bands of TH rows, route 1 (bfloat16) with a ring of `stages` images.
extern "C" size_t fl_taploop_smem_bytes(int route, int dtype, int H, int W, int I, int O, int TH,
                                        int stages) {
  if (route == 1) return taploop_tma_smem_bytes(H, W, I, O, stages);
  return taploop_smem_bytes(W, I, O, TH, dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16));
}
