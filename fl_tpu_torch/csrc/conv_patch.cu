// 3x3 stride-1 SAME convolution as an implicit GEMM for Hopper (sm_90a), over
// stacked clients with their own weights: forward, input gradient and weight
// gradient.
//
// Replaces the TPU kernel K7 of fl_tpu/ops/conv_pallas.py: _patch_kernel,
// launched by _patch_gemm, reached from conv3x3_pallas (forward, and the
// input gradient with mirrored taps and per-tap transposed weights) and,
// with contract_rows=True, from its weight gradient; conv_stem_s2d runs the
// same kernels on the space-to-depth stem.
//
// The contract kept from the TPU kernel: the patch matrix, whose row r holds
// the nine shifted pixels of output position r side by side (K = 9 * I
// columns, tap outer, channel inner), never exists in device memory; ONE
// product over all of K follows, summed in f32, and the result is rounded
// once, to x's dtype (forward, input gradient), or stays f32 (weight
// gradient). Not kept, because it is TPU layout: the collapse of the padded
// image to rows of a width rounded to 16 with a zero halo, the VMEM budget
// and its batch chunks.
//
// A client's output positions are its R = B * H * W rows (b, h, w) in NHWC
// order, and a tile is M consecutive rows, which may run across images. The
// route is fixed by the dtype:
//
// bfloat16 -> the tensor cores, f32 sums in registers (the tiles live in
// common.cuh). The patch matrix is not written out, not even in shared
// memory: a tile stages the pixels r0 - W - 1 .. r0 + M + W of the flat image
// ONCE, as [pixel][channel] rows, and tap (dh, dw) of output row r is pixel
// r + (dh - 1) * W + (dw - 1) of that range where the tap lies inside r's
// image, else one shared row of zeros: every ldmatrix row address is the
// lane's own, so the gather is free. Channels are padded to 16 (one k16 step
// never spans taps) and outputs to 8, in shared memory only; row strides are
// an odd number of 16-byte chunks, so the eight rows of an ldmatrix miss each
// other's banks. Staging is cp.async, the next tile's under this tile's
// products where two buffers fit.
//   patch_gemm_wgmma_kernel  y[r, :] = patch(x)[r, :] @ w2, on wgmma
//       (m64nNk16): grid (blocks, C); a block loads its client's weights
//       (9*I x O) once, as the core matrices the tensor cores read straight
//       from shared memory, and walks tiles_per_block tiles. A warpgroup owns
//       128 rows x up to 64 columns (64 f32 a thread): A comes from registers,
//       gathered by ldmatrix one k16 step ahead of the asynchronous products;
//       the sums are rounded once and leave through a shared-memory row buffer
//       in 16-byte pieces. The input gradient is this kernel on dy with
//       w2[(dh, dw, o), i] = w[2 - dh, 2 - dw, i, o], which the Python wrapper
//       prepares.
//   patch_wgrad_mma_kernel  dW[tap] (I x O) = sum over pixels of
//       x_shifted[pixel, :]^T dy[pixel, :], on mma.sync (m16n8k16), the pixel
//       being the k of the mma: both operands lie [k][m] / [k][n] and
//       ldmatrix.trans turns them. grid (slots, chunks, C). A warp owns two
//       (tap, 16 channels, 64 outputs) blocks of dW in registers across all
//       tiles of its thread block; a block writes its sum to its own slot and
//       reduce_partials_kernel adds a client's slots in slot order (one slot
//       is written straight to dW): deterministic, no float atomics. Where dW
//       has more such blocks than one thread block holds, `chunks` thread
//       blocks split them.
//
// float32 -> the CUDA cores (TF32 would break the f32 contract):
//   patch_gemm_kernel, patch_wgrad_kernel: the patch tile (M x 9*IP, IP = I
//       rounded up to 4) and the weights in shared memory, a 4 x 4 register
//       tile a thread (fma_rows4x4), sums in ascending k; the same grids.
//
// What bounds it on the H100: at the bench shapes (512 clients x 32 images,
// 14x14, 32 -> 64, bf16) each direction is 59 G FMA on ~0.6 GB of operands,
// so by the card's numbers it is bound by bytes (0.19 ms; the operations
// take 0.12 ms at the tensor cores' peak). The design answers with one pass
// over x, dy and y in 16-byte pieces, no patch tile, and sums that never
// leave registers. As written the kernels run at two to four times the
// bound: a thread block alternates between staging, products and stores, and
// two blocks an SM do not hide one phase under the other's (a warp stalls on
// its stores while the memory drains a tile's burst); a producer/consumer
// split with asynchronous bulk stores is what is left to do.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernels (templates instantiated for float alone)
// ---------------------------------------------------------------------------

constexpr int kWgradTasks = 3;  // 4x4 blocks of dW a thread may own
constexpr int kPatchPad = 4;    // elements between patch rows: rows 4 apart miss each other's banks

__host__ __device__ inline int patch_ld(int IP) { return 9 * IP + kPatchPad; }

size_t gemm_smem_bytes(int I, int O, int M, size_t tsize) {
  const int IP = round_up4(I), OP = round_up4(O);
  return ((size_t)9 * IP * OP + (size_t)M * patch_ld(IP)) * tsize;
}

size_t wgrad_smem_bytes(int I, int O, int M, size_t tsize) {
  const int IP = round_up4(I), OP = round_up4(O);
  return ((size_t)M * patch_ld(IP) + (size_t)M * OP) * tsize;
}

// s_patch[m][tap * IP + ci] = x[b, h + dh - 1, w + dw - 1, ci] for row
// r0 + m = (b, h, w) of the client whose image block starts at xc; zero where
// the tap leaves the image, where ci >= I and where r0 + m >= R.
template <typename T>
__device__ void build_patch_tile(T* s_patch, const T* __restrict__ xc, int r0, int M, int R,
                                 int H, int W, int I, int IP) {
  const int I4 = IP / 4, per_row = 9 * I4, ldp = patch_ld(IP);
  const bool vec = rows_aligned4<T>(xc, I);
  for (int e = threadIdx.x; e < M * per_row; e += blockDim.x) {
    int m = e / per_row, q = e - m * per_row;
    int tap = q / I4, ci = (q - tap * I4) * 4;
    int r = r0 + m, valid = 0;
    const T* src = xc;
    if (r < R) {
      int b = r / (H * W), rem = r - b * H * W;
      int h = rem / W + tap / 3 - 1, w = rem % W + tap % 3 - 1;
      if (h >= 0 && h < H && w >= 0 && w < W) {
        src = xc + ((size_t)(b * H + h) * W + w) * I + ci;
        valid = I - ci;
      }
    }
    stage4<T>(s_patch + m * ldp + tap * IP + ci, src, valid, vec);
  }
}

// s_rows[m][0..OP) = src[r0 + m][0..O), zero beyond O and beyond row R.
template <typename T>
__device__ void stage_rows(T* s_rows, const T* __restrict__ src, int r0, int M, int R, int O,
                           int OP) {
  const int O4 = OP / 4;
  const bool vec = rows_aligned4<T>(src, O);
  for (int e = threadIdx.x; e < M * O4; e += blockDim.x) {
    int m = e / O4, o = (e - m * O4) * 4;
    int r = r0 + m;
    stage4<T>(s_rows + m * OP + o, src + (size_t)r * O + o, r < R ? O - o : 0, vec);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
patch_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w2, T* __restrict__ y, int B,
                  int H, int W, int I, int O, int M, int tiles_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int IP = round_up4(I), OP = round_up4(O), KP = 9 * IP, ldp = patch_ld(IP);
  const int R = B * H * W, O4 = OP / 4;
  const int c = blockIdx.y;
  T* s_w = reinterpret_cast<T*>(smem);  // [tap * IP + ci][o], pad rows and columns zero
  T* s_patch = s_w + (size_t)KP * OP;   // [m][tap * IP + ci]

  const T* wc = w2 + (size_t)c * 9 * I * O;
  const bool vec_w = rows_aligned4<T>(wc, O);
  for (int e = threadIdx.x; e < KP * O4; e += blockDim.x) {
    int kk = e / O4, o = (e - kk * O4) * 4;
    int tap = kk / IP, ci = kk - tap * IP;
    stage4<T>(s_w + kk * OP + o, wc + (size_t)(tap * I + ci) * O + o, ci < I ? O - o : 0,
              vec_w);
  }

  const T* xc = x + (size_t)c * R * I;
  T* yc = y + (size_t)c * R * O;
  const int tile0 = blockIdx.x * tiles_per_block;
  for (int t = 0; t < tiles_per_block; ++t) {
    const int r0 = (tile0 + t) * M;
    if (r0 >= R) break;  // uniform across the block
    __syncthreads();     // the last tile's readers are done (and s_w is complete)
    build_patch_tile<T>(s_patch, xc, r0, M, R, H, W, I, IP);
    __syncthreads();
    for (int task = threadIdx.x; task < (M / 4) * O4; task += blockDim.x) {
      const int og = task % O4, rg = task / O4;
      const T* a = s_patch + (size_t)rg * 4 * ldp;
      float acc[4][4] = {};
      fma_rows4x4<T>(a, a + ldp, a + 2 * ldp, a + 3 * ldp, s_w + og * 4, OP, KP, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + rg * 4 + j;
        if (r >= R) break;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int o = og * 4 + n;
          if (o < O) yc[(size_t)r * O + o] = from_f<T>(acc[j][n]);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
patch_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   float* __restrict__ partial, int B, int H, int W, int I, int O, int M,
                   int tiles_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int IP = round_up4(I), OP = round_up4(O), KP = 9 * IP, ldp = patch_ld(IP);
  const int R = B * H * W, O4 = OP / 4, n_tasks = (KP / 4) * O4;
  const int c = blockIdx.z;
  T* s_patch = reinterpret_cast<T*>(smem);  // [m][tap * IP + ci]
  T* s_g = s_patch + (size_t)M * ldp;       // [m][o]

  // this thread's 4x4 blocks of dW: (kg, og) = rows kg*4.., columns og*4..
  int task[kWgradTasks];
  float acc[kWgradTasks][4][4] = {};
#pragma unroll
  for (int i = 0; i < kWgradTasks; ++i)
    task[i] = (blockIdx.y * kWgradTasks + i) * blockDim.x + threadIdx.x;

  const T* xc = x + (size_t)c * R * I;
  const T* gc = g + (size_t)c * R * O;
  const int tile0 = blockIdx.x * tiles_per_block;
  for (int t = 0; t < tiles_per_block; ++t) {
    const int r0 = (tile0 + t) * M;
    if (r0 >= R) break;  // uniform across the block
    __syncthreads();
    build_patch_tile<T>(s_patch, xc, r0, M, R, H, W, I, IP);
    stage_rows<T>(s_g, gc, r0, M, R, O, OP);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kWgradTasks; ++i) {
      if (task[i] >= n_tasks) continue;
      const T* pa = s_patch + (task[i] / O4) * 4;
      const T* pg = s_g + (task[i] % O4) * 4;
      for (int m = 0; m < M; ++m) {  // rows past R are zero in both tiles
        float pv[4], gv[4];
        load4<T>(pa + (size_t)m * ldp, pv);
        load4<T>(pg + (size_t)m * OP, gv);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[i][a][n] = fmaf(pv[a], gv[n], acc[i][a][n]);
      }
    }
  }

  // every element of the block's slot is written, also by a block that had
  // no tile
  float* slot = partial + ((size_t)c * gridDim.x + blockIdx.x) * 9 * I * O;
#pragma unroll
  for (int i = 0; i < kWgradTasks; ++i) {
    if (task[i] >= n_tasks) continue;
    const int kg = task[i] / O4, og = task[i] % O4;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int kk = kg * 4 + a, tap = kk / IP, ci = kk - tap * IP;
      if (ci >= I) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int o = og * 4 + n;
        if (o < O) slot[(size_t)(tap * I + ci) * O + o] = acc[i][a][n];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcMT = 2;                     // 16-row tiles a warp of the patch GEMM owns
constexpr int kTcNT = 8;                     // 8-column tiles one warp pass covers
constexpr int kTcRows = 16 * kTcMT;          // rows of a tile a warp
constexpr int kTcCols = 8 * kTcNT;           // columns a warp pass covers
constexpr int kWgradItems = 2;               // (tap, 16 channels, 64 outputs) blocks of dW a warp owns
constexpr int kWgradMaxThreads = 288;        // nine warps: conv2's 18 blocks of dW; two thread blocks an SM

size_t tc_wgrad_smem_bytes(int W, int I, int O, int M, int stages) {
  const int XS = round_up16(I) + kSkew, GS = round_up16(O) + kSkew;
  return sizeof(bf16) * (XS + (size_t)stages * ((size_t)(M + 2 * W + 2) * XS + (size_t)M * GS)) +
         sizeof(uint16_t) * stages * M;
}

// Bit dh * 3 + dw is set where tap (dh, dw) of output row r = (b, h, w) lies
// inside the image; no bit for a row past R.
__device__ __forceinline__ uint32_t tap_mask(int r, int R, int H, int W) {
  if (r >= R) return 0u;
  const int rem = r % (H * W), h = rem / W, w = rem - h * W;
  const uint32_t cols = (w > 0 ? 1u : 0u) | 2u | (w < W - 1 ? 4u : 0u);
  return (h > 0 ? cols : 0u) | (cols << 3) | (h < H - 1 ? cols << 6 : 0u);
}

// pixels from the tile's first row to tap (dh, dw) = tap
__device__ __forceinline__ int tap_offset(int tap, int W) {
  return (tap / 3 - 1) * W + (tap % 3 - 1);
}

// Shared memory of the wgmma patch GEMM: the weights as core matrices
// [k / 8][n / 8][k % 8][n % 8] over 9 * IP rows and NW columns, the zero row,
// the tile buffers, a row buffer of 16 rows a warp for the epilogue.
size_t wg_gemm_smem_bytes(int W, int I, int NW, int NT, int M, int warps, int stages) {
  const int IP = round_up16(I), XS = IP + kSkew;
  return sizeof(bf16) * ((size_t)9 * IP * NW + XS + (size_t)stages * (M + 2 * W + 2) * XS +
                         (size_t)warps * 16 * (8 * NT + kSkew));
}

// The patch GEMM on wgmma: a warpgroup owns 128 rows of the tile as two
// 64-row products (warp w of it rows 16w.. of each), 8 * NT columns a pass.
template <int NT>
__global__ void __launch_bounds__(kMaxThreads)
patch_gemm_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w2,
                        bf16* __restrict__ y, int B, int H, int W, int I, int O,
                        int tiles_per_block, int stages) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  constexpr int kCols = 8 * NT, kOutLd = kCols + kSkew;
  const int IP = round_up16(I), XS = IP + kSkew, KP = 9 * IP;
  const int N8 = round_up8(O), NW = (N8 + kCols - 1) / kCols * kCols;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int M = warps * kTcRows, R = B * H * W, n_slots = M + 2 * W + 2;
  const int c = blockIdx.y;
  bf16* s_w = reinterpret_cast<bf16*>(smem_wg);  // core matrices, see above
  bf16* s_zero = s_w + (size_t)KP * NW;          // [XS] zeros
  bf16* s_x = s_zero + XS;                       // stages x [slot][ci], stride XS
  bf16* s_out = s_x + (size_t)stages * n_slots * XS + (size_t)warp * 16 * kOutLd;

  const bf16* xc = x + (size_t)c * R * I;
  const bf16* wc = w2 + (size_t)c * 9 * I * O;
  bf16* yc = y + (size_t)c * R * O;
  const bool vec_x = rows_aligned16(xc, I), vec_w = rows_aligned16(wc, O);
  const bool vec_y = rows_aligned16(yc, O);

  const int n_tiles = (R + M - 1) / M, tile0 = blockIdx.x * tiles_per_block;
  const int n_mine = min(tiles_per_block, n_tiles - tile0);
  if (n_mine <= 0) return;  // uniform across the block

  // the weights: chunk (k, nb) of eight columns goes to core matrix
  // (k / 8, nb), row k % 8; eight threads fill one core matrix
  const int NB = NW / 8;
  for (int e = threadIdx.x; e < KP * NB; e += blockDim.x) {
    const int k0 = e & 7, nb = (e >> 3) % NB, kb = (e >> 3) / NB;
    const int k = kb * 8 + k0, tap = k / IP, ci = k - tap * IP, o = nb * 8;
    bf16* d = s_w + ((size_t)(kb * NB + nb) * 8 + k0) * 8;
    const bf16* src = wc + (size_t)(tap * I + ci) * O + o;
    if (ci >= I || o >= O) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec_w && o + 8 <= O) {
      cp_async16(d, src);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = o + i < O ? src[i] : __float2bfloat16(0.f);
    }
  }
  for (int e = threadIdx.x; e < XS; e += blockDim.x) s_zero[e] = __float2bfloat16(0.f);
  if (stages == 2) {
    stage_rows_bf16(s_x, xc, tile0 * M - W - 1, n_slots, R, I, vec_x);
    cp_async_commit();
  }

  const uint32_t zero_addr = smem_addr(s_zero + (lane >> 4) * 8);
  const uint32_t lbo = NB * 128, sbo = 128;  // bytes between k-blocks, between column blocks
  const int g = lane >> 2, t4 = lane & 3;
  // the warp's 16 rows of its warpgroup's product j start at row0 + 64 j of the tile
  const int row0 = (warp >> 2) * (4 * kTcRows) + (warp & 3) * 16;

  for (int t = 0; t < n_mine; ++t) {
    const int r0 = (tile0 + t) * M;
    const int buf = stages == 2 ? (t & 1) : 0;
    if (stages == 2) {
      // the next tile's pixels travel under this tile's products
      if (t + 1 < n_mine) {
        stage_rows_bf16(s_x + (size_t)(buf ^ 1) * n_slots * XS, xc, r0 + M - W - 1, n_slots, R,
                        I, vec_x);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      stage_rows_bf16(s_x, xc, r0 - W - 1, n_slots, R, I, vec_x);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();

    const bf16* sx = s_x + (size_t)buf * n_slots * XS;
    uint32_t a_base[kTcMT], mask[kTcMT];
#pragma unroll
    for (int j = 0; j < kTcMT; ++j) {
      const int row = row0 + j * 64 + (lane & 15);
      mask[j] = tap_mask(r0 + row, R, H, W);
      a_base[j] = smem_addr(sx + (size_t)(row + W + 1) * XS + (lane >> 4) * 8);
    }

    for (int n0 = 0; n0 < N8; n0 += kCols) {
      float acc[kTcMT][NT][4];
#pragma unroll
      for (int j = 0; j < kTcMT; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[j][n][v] = 0.f;

      // k16 steps in (tap, channel) order; step s reads B at desc0 + s * two
      // k-blocks. The A fragments of step s + 1 are gathered while the
      // products of step s run, into the other of two register sets.
      const uint64_t desc0 = wgmma_desc(smem_addr(s_w) + (n0 / 8) * sbo, lbo, sbo);
      const int n_steps = KP / 16;
      int ld_tap = 0, ld_kc = 0;  // the next step to gather
      auto gather = [&](uint32_t (&a)[kTcMT][4]) {
        const int off = tap_offset(ld_tap, W) * XS * (int)sizeof(bf16);
#pragma unroll
        for (int j = 0; j < kTcMT; ++j)
          ldmatrix_x4(a[j], (((mask[j] >> ld_tap) & 1u) ? a_base[j] + off : zero_addr) +
                                ld_kc * (int)sizeof(bf16));
        ld_kc += 16;
        if (ld_kc == IP) ld_kc = 0, ++ld_tap;
      };
      auto multiply = [&](int step, const uint32_t (&a)[kTcMT][4]) {
        const uint64_t desc = desc0 + (uint64_t)((2 * step * lbo) >> 4);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kTcMT; ++j) wgmma_m64k16<NT>(acc[j], a[j], desc);
        wgmma_commit();
      };
      uint32_t a0[kTcMT][4], a1[kTcMT][4];
      gather(a0);
      int step = 0;
      for (; step + 1 < n_steps; step += 2) {
        multiply(step, a0);
        wgmma_wait<1>();  // step - 1 is done with a1
        gather(a1);
        multiply(step + 1, a1);
        wgmma_wait<1>();  // step is done with a0
        if (step + 2 < n_steps) gather(a0);
      }
      if (step < n_steps) multiply(step, a0);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < kTcMT; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int v = 0; v < 4; ++v) asm volatile("" : "+f"(acc[j][n][v])::"memory");

      // one rounding, then 16 rows at a time through the warp's row buffer so
      // that y leaves in 16-byte pieces (the sums past wgmma_wait are final)
      const int nt = min(NT, (N8 - n0) / 8);
#pragma unroll
      for (int j = 0; j < kTcMT; ++j) {
        __syncwarp();
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(s_out + g * kOutLd + n * 8 + 2 * t4) =
              __floats2bfloat162_rn(acc[j][n][0], acc[j][n][1]);
          *reinterpret_cast<__nv_bfloat162*>(s_out + (g + 8) * kOutLd + n * 8 + 2 * t4) =
              __floats2bfloat162_rn(acc[j][n][2], acc[j][n][3]);
        }
        __syncwarp();
        const int rbase = r0 + row0 + j * 64;
        for (int e = lane; e < 16 * nt; e += 32) {
          const int row = e / nt, ch = e - row * nt, r = rbase + row, o = n0 + ch * 8;
          if (r >= R) continue;
          const bf16* src = s_out + row * kOutLd + ch * 8;
          bf16* dst = yc + (size_t)r * O + o;
          if (vec_y && o + 8 <= O) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int i = 0; i < 8 && o + i < O; ++i) dst[i] = src[i];
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is staged again
  }
}

__global__ void __launch_bounds__(kWgradMaxThreads, 2)
patch_wgrad_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                       float* __restrict__ partial, int B, int H, int W, int I, int O, int M,
                       int tiles_per_block, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int IP = round_up16(I), XS = IP + kSkew, GS = round_up16(O) + kSkew;
  const int N8 = round_up8(O);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = B * H * W, n_slots = M + 2 * W + 2;
  const int c = blockIdx.z;
  bf16* s_zero = reinterpret_cast<bf16*>(smem);  // [XS] zeros
  bf16* s_x = s_zero + XS;                       // stages x [slot][ci], stride XS
  bf16* s_g = s_x + (size_t)stages * n_slots * XS;  // stages x [m][o], stride GS
  uint16_t* s_mask = reinterpret_cast<uint16_t*>(s_g + (size_t)stages * M * GS);  // stages x [m]

  // this warp's blocks of dW: item = (64-output chunk, tap, 16-channel tile)
  const int m_tiles = IP / 16, n_chunks = (N8 + kTcCols - 1) / kTcCols;
  const int n_items = n_chunks * 9 * m_tiles;
  bool has[kWgradItems];
  int nc[kWgradItems], tap[kWgradItems], ci0[kWgradItems], nt[kWgradItems], a_off[kWgradItems];
  float acc[kWgradItems][kTcNT][4];
#pragma unroll
  for (int j = 0; j < kWgradItems; ++j) {
    const int item = (blockIdx.y * warps + warp) * kWgradItems + j;
    has[j] = item < n_items;
    const int it = has[j] ? item : 0;
    nc[j] = it / (9 * m_tiles);
    tap[j] = (it - nc[j] * 9 * m_tiles) / m_tiles;
    ci0[j] = (it - (nc[j] * 9 + tap[j]) * m_tiles) * 16;
    nt[j] = min(kTcNT, N8 / 8 - nc[j] * kTcNT);
    a_off[j] = (tap_offset(tap[j], W) * XS + ci0[j]) * (int)sizeof(bf16);
#pragma unroll
    for (int n = 0; n < kTcNT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][n][v] = 0.f;
  }

  const bf16* xc = x + (size_t)c * R * I;
  const bf16* gc = g + (size_t)c * R * O;
  const bool vec_x = rows_aligned16(xc, I), vec_g = rows_aligned16(gc, O);
  const int n_tiles = (R + M - 1) / M, tile0 = blockIdx.x * tiles_per_block;
  const int n_mine = max(0, min(tiles_per_block, n_tiles - tile0));

  for (int e = threadIdx.x; e < XS; e += blockDim.x) s_zero[e] = __float2bfloat16(0.f);

  // x's pixels with their halo, dy's rows and each row's tap mask
  auto stage = [&](int r0, int buf) {
    stage_rows_bf16(s_x + (size_t)buf * n_slots * XS, xc, r0 - W - 1, n_slots, R, I, vec_x);
    stage_rows_bf16(s_g + (size_t)buf * M * GS, gc, r0, M, R, O, vec_g);
    for (int e = threadIdx.x; e < M; e += blockDim.x)
      s_mask[buf * M + e] = (uint16_t)tap_mask(r0 + e, R, H, W);
    cp_async_commit();
  };
  if (stages == 2 && n_mine > 0) stage(tile0 * M, 0);

  // the lane's row of each ldmatrix: matrix q = lane >> 3 is pixels
  // (q >> 1) * 8 .., channels (q & 1) * 8 .. of x; dy's are rows lane & 15,
  // columns (lane >> 4) * 8 ..
  const int q = lane >> 3, pix_lane = (lane & 7) + (q >> 1) * 8;
  const uint32_t zero_addr = smem_addr(s_zero + (q & 1) * 8);

  for (int t = 0; t < n_mine; ++t) {
    const int r0 = (tile0 + t) * M;
    const int buf = stages == 2 ? (t & 1) : 0;
    if (stages == 2) {
      if (t + 1 < n_mine) {
        stage(r0 + M, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      stage(r0, 0);
      cp_async_wait<0>();
    }
    __syncthreads();

    const uint32_t x_lane = smem_addr(s_x + ((size_t)buf * n_slots + pix_lane + W + 1) * XS +
                                      (q & 1) * 8);
    const uint32_t g_lane = smem_addr(s_g + ((size_t)buf * M + (lane & 15)) * GS +
                                      (lane >> 4) * 8);
    const uint16_t* sm = s_mask + buf * M + pix_lane;
    const int rows_here = min(M, R - r0);
    for (int kp = 0; kp < rows_here; kp += 16) {  // sixteen pixels: one k16 step
      const uint32_t m = sm[kp];
      uint32_t b[kTcNT][2];
#pragma unroll
      for (int j = 0; j < kWgradItems; ++j) {
        if (!has[j]) continue;  // uniform across the warp
        if (j == 0 || nc[j] != nc[0])
          load_b_k16<kTcNT>(b, g_lane + (uint32_t)((kp * GS + nc[j] * kTcCols) *
                                                   (int)sizeof(bf16)), nt[j]);
        uint32_t a[4];
        ldmatrix_x4_trans(a, ((m >> tap[j]) & 1u)
                                 ? x_lane + kp * XS * (int)sizeof(bf16) + a_off[j]
                                 : zero_addr);
        mma_k16<kTcNT>(acc[j], a, b, nt[j]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is staged again
  }

  // every element of the block's slot is written, also by a block that had
  // no tile
  float* slot = partial + ((size_t)c * gridDim.x + blockIdx.x) * 9 * I * O;
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < kWgradItems; ++j) {
    if (!has[j]) continue;
#pragma unroll
    for (int n = 0; n < kTcNT; ++n) {
      if (n >= nt[j]) continue;
      const int o = nc[j] * kTcCols + n * 8 + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = ci0[j] + gq + 8 * half;
        if (ci >= I) continue;
        float* dst = slot + (size_t)(tap[j] * I + ci) * O + o;
        if (o < O) dst[0] = acc[j][n][2 * half];
        if (o + 1 < O) dst[1] = acc[j][n][2 * half + 1];
      }
    }
  }
}

bool bad_threads(int threads) { return threads < 32 || threads > kMaxThreads || threads % 32; }

bool bad_launch(int threads, int M) { return bad_threads(threads) || M < 4 || M % 4; }

template <typename T>
int launch_gemm(const void* x, const void* w2, void* y, int C, int B, int H, int W, int I,
                int O, int M, int tiles_per_block, int threads, cudaStream_t stream) {
  const size_t smem = gemm_smem_bytes(I, O, M, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(patch_gemm_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (B * H * W + M - 1) / M;
  dim3 grid((n_tiles + tiles_per_block - 1) / tiles_per_block, C);
  patch_gemm_kernel<T><<<grid, threads, smem, stream>>>((const T*)x, (const T*)w2, (T*)y, B, H,
                                                        W, I, O, M, tiles_per_block);
  return (int)cudaGetLastError();
}

// columns a pass of the wgmma patch GEMM covers: 64 where O reaches it, else
// the next of 8, 16, 32
int wg_pass_tiles(int O) {
  const int n = round_up8(O) / 8;
  return n > 4 ? 8 : n > 2 ? 4 : n;
}

template <int NT>
int launch_gemm_wgmma_nt(const bf16* x, const bf16* w2, bf16* y, int C, int B, int H, int W,
                         int I, int O, int M, int tiles_per_block, int threads, int stages,
                         cudaStream_t stream) {
  const int NW = (round_up8(O) + 8 * NT - 1) / (8 * NT) * (8 * NT);
  const size_t smem = wg_gemm_smem_bytes(W, I, NW, NT, M, threads / 32, stages);
  cudaError_t e = cudaFuncSetAttribute(patch_gemm_wgmma_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (B * H * W + M - 1) / M;
  dim3 grid((n_tiles + tiles_per_block - 1) / tiles_per_block, C);
  patch_gemm_wgmma_kernel<NT><<<grid, threads, smem, stream>>>(x, w2, y, B, H, W, I, O,
                                                               tiles_per_block, stages);
  return (int)cudaGetLastError();
}

int launch_gemm_wgmma(const void* x, const void* w2, void* y, int C, int B, int H, int W, int I,
                      int O, int M, int tiles_per_block, int threads, int stages,
                      cudaStream_t stream) {
  // whole warpgroups, 32 rows a warp
  if (threads % 128 || M != threads / 32 * kTcRows) return (int)cudaErrorInvalidValue;
  const bf16* xb = (const bf16*)x;
  const bf16* wb = (const bf16*)w2;
  switch (wg_pass_tiles(O)) {
    case 1: return launch_gemm_wgmma_nt<1>(xb, wb, (bf16*)y, C, B, H, W, I, O, M,
                                           tiles_per_block, threads, stages, stream);
    case 2: return launch_gemm_wgmma_nt<2>(xb, wb, (bf16*)y, C, B, H, W, I, O, M,
                                           tiles_per_block, threads, stages, stream);
    case 4: return launch_gemm_wgmma_nt<4>(xb, wb, (bf16*)y, C, B, H, W, I, O, M,
                                           tiles_per_block, threads, stages, stream);
    default: return launch_gemm_wgmma_nt<8>(xb, wb, (bf16*)y, C, B, H, W, I, O, M,
                                            tiles_per_block, threads, stages, stream);
  }
}

template <typename T>
int launch_wgrad(const void* x, const void* g, float* partial, float* out, int C, int B, int H,
                 int W, int I, int O, int M, int slots, int threads, cudaStream_t stream) {
  const size_t smem = wgrad_smem_bytes(I, O, M, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(patch_wgrad_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (B * H * W + M - 1) / M;
  const int tiles_per_block = (n_tiles + slots - 1) / slots;
  const int n_tasks = (9 * round_up4(I) / 4) * (round_up4(O) / 4);
  const int per_block = threads * kWgradTasks;
  dim3 grid(slots, (n_tasks + per_block - 1) / per_block, C);
  patch_wgrad_kernel<T><<<grid, threads, smem, stream>>>((const T*)x, (const T*)g, partial, B,
                                                         H, W, I, O, M, tiles_per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_reduce_partials(partial, out, C, slots, 9 * I * O, stream);
}

int launch_wgrad_mma(const void* x, const void* g, float* partial, float* out, int C, int B,
                     int H, int W, int I, int O, int M, int slots, int threads, int stages,
                     cudaStream_t stream) {
  if (M % 16 || threads > kWgradMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = tc_wgrad_smem_bytes(W, I, O, M, stages);
  cudaError_t e = cudaFuncSetAttribute(patch_wgrad_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (B * H * W + M - 1) / M;
  const int tiles_per_block = (n_tiles + slots - 1) / slots;
  const int n_items = ((round_up8(O) + kTcCols - 1) / kTcCols) * 9 * (round_up16(I) / 16);
  const int per_block = (threads / 32) * kWgradItems;
  dim3 grid(slots, (n_items + per_block - 1) / per_block, C);
  // a single slot is the sum already
  patch_wgrad_mma_kernel<<<grid, threads, smem, stream>>>(
      (const bf16*)x, (const bf16*)g, slots == 1 ? out : partial, B, H, W, I, O, M,
      tiles_per_block, stages);
  e = cudaGetLastError();
  if (e != cudaSuccess || slots == 1) return (int)e;
  return launch_reduce_partials(partial, out, C, slots, 9 * I * O, stream);
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernels; `stages` must be 1), 1 = bfloat16
// (the tensor-core kernels; `stages` = 2 stages the next tile under the
// current one's products). Every pointer is device memory; the return value
// is the cudaError_t of the launches (0 = success).

// y (C, B, H, W, O) = patch(x (C, B, H, W, I)) @ w2 (C, 9*I, O), in x's dtype,
// in tiles of M rows; for bfloat16 whole warpgroups (128 threads) of 32 rows a warp.
extern "C" int fl_patch_gemm(int dtype, const void* x, const void* w2, void* y, int C, int B,
                             int H, int W, int I, int O, int M, int tiles_per_block,
                             int threads, int stages, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_launch(threads, M) || tiles_per_block < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && stages == 1)
    return launch_gemm<float>(x, w2, y, C, B, H, W, I, O, M, tiles_per_block, threads, s);
  if (dtype == 1 && (stages == 1 || stages == 2))
    return launch_gemm_wgmma(x, w2, y, C, B, H, W, I, O, M, tiles_per_block, threads, stages,
                             s);
  return (int)cudaErrorInvalidValue;
}

// out (C, 9*I, O) f32 = patch(x)^T @ g (C, B, H, W, O); partial is scratch of
// (C, slots, 9*I, O) f32, untouched by the bfloat16 kernel where slots is 1.
extern "C" int fl_patch_wgrad(int dtype, const void* x, const void* g, float* partial,
                              float* out, int C, int B, int H, int W, int I, int O, int M,
                              int slots, int threads, int stages, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_launch(threads, M) || slots < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && stages == 1)
    return launch_wgrad<float>(x, g, partial, out, C, B, H, W, I, O, M, slots, threads, s);
  if (dtype == 1 && (stages == 1 || stages == 2))
    return launch_wgrad_mma(x, g, partial, out, C, B, H, W, I, O, M, slots, threads, stages, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one block needs with tiles of M rows, `threads` threads and
// `stages` tile buffers on images W wide: which = 0 the patch GEMM, 1 the
// weight gradient.
extern "C" size_t fl_conv_patch_smem_bytes(int which, int dtype, int W, int I, int O, int M,
                                           int threads, int stages) {
  if (dtype == 0)
    return which ? wgrad_smem_bytes(I, O, M, sizeof(float))
                 : gemm_smem_bytes(I, O, M, sizeof(float));
  if (which) return tc_wgrad_smem_bytes(W, I, O, M, stages);
  const int NT = wg_pass_tiles(O);
  return wg_gemm_smem_bytes(W, I, (round_up8(O) + 8 * NT - 1) / (8 * NT) * (8 * NT), NT, M,
                            threads / 32, stages);
}
