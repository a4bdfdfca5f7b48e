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
// The contract kept from the TPU kernel: a patch matrix whose row r holds the
// nine shifted pixels of output position r side by side (K = 9 * I columns,
// tap outer, channel inner) is formed in fast memory and never in device
// memory; ONE product over all of K follows, summed in f32 in ascending k,
// and the result is rounded once, to x's dtype (forward, input gradient), or
// stays f32 (weight gradient). Not kept, because it is TPU layout: the
// collapse of the padded image to rows of a width rounded to 16 with a zero
// halo, the VMEM budget and its batch chunks.
//
// Layout here: a client's output positions are its R = B * H * W rows
// (b, h, w) in NHWC order. A block takes tiles of M consecutive rows, which
// may run across images: each row finds its own (b, h, w), reads its nine
// neighbours straight from the NHWC input and writes zeros where a tap falls
// outside the image. The patch tile (M x 9*IP, IP = I rounded up to 4, the
// pad columns zero) and the client's weights (9*IP x OP) sit in shared
// memory; a thread owns a 4 x 4 block of a tile's outputs and walks K with
// four-wide shared-memory loads (fma_rows4x4: 8 loads for 64 FMAs).
//
// patch_gemm_kernel   y[r, :] = patch(x)[r, :] @ w2        grid (blocks, C);
//                     a block walks `tiles_per_block` tiles with one load of
//                     the weights. The input gradient is this kernel on dy
//                     with w2[(dh, dw, o), i] = w[2 - dh, 2 - dw, i, o],
//                     which the Python wrapper prepares.
// patch_wgrad_kernel  dW = patch(x)^T @ dy  (9*I x O, f32)  grid (slots,
//                     chunks, C). A thread owns up to kWgradTasks 4 x 4
//                     blocks of dW in registers across all tiles of its
//                     block; a block writes its sum to its own slot and
//                     reduce_partials_kernel adds a client's slots in slot
//                     order: deterministic, no float atomics. Where dW has
//                     more 4 x 4 blocks than one thread block holds, `chunks`
//                     thread blocks split them (each builds the patch tile).
//
// What bounds it on the H100: at the bench shapes (512 clients x 32 images,
// 14x14, 32 -> 64, bf16) each direction is 59 G FMA on ~0.6 GB of operands,
// so by the card's numbers it is bound by bytes (0.19 ms); as written, on
// the CUDA cores out of shared memory, it is bound by FMA issue and
// shared-memory loads. Tensor cores (wgmma over the same patch tile) are
// later work.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;
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

bool bad_launch(int threads, int M) {
  return threads < 32 || threads > kMaxThreads || threads % 32 || M < 4 || M % 4;
}

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer is device memory; the
// return value is the cudaError_t of the launches (0 = success).

// y (C, B, H, W, O) = patch(x (C, B, H, W, I)) @ w2 (C, 9*I, O), in x's dtype.
extern "C" int fl_patch_gemm(int dtype, const void* x, const void* w2, void* y, int C, int B,
                             int H, int W, int I, int O, int M, int tiles_per_block,
                             int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_launch(threads, M) || tiles_per_block < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_gemm<float>(x, w2, y, C, B, H, W, I, O, M, tiles_per_block, threads, s);
  if (dtype == 1)
    return launch_gemm<__nv_bfloat16>(x, w2, y, C, B, H, W, I, O, M, tiles_per_block, threads,
                                      s);
  return (int)cudaErrorInvalidValue;
}

// out (C, 9*I, O) f32 = patch(x)^T @ g (C, B, H, W, O); partial is scratch of
// (C, slots, 9*I, O) f32.
extern "C" int fl_patch_wgrad(int dtype, const void* x, const void* g, float* partial,
                              float* out, int C, int B, int H, int W, int I, int O, int M,
                              int slots, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_launch(threads, M) || slots < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_wgrad<float>(x, g, partial, out, C, B, H, W, I, O, M, slots, threads, s);
  if (dtype == 1)
    return launch_wgrad<__nv_bfloat16>(x, g, partial, out, C, B, H, W, I, O, M, slots, threads,
                                       s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one block needs with tiles of M rows: which = 0 the patch
// GEMM, 1 the weight gradient.
extern "C" size_t fl_conv_patch_smem_bytes(int which, int dtype, int I, int O, int M) {
  const size_t tsize = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  return which ? wgrad_smem_bytes(I, O, M, tsize) : gemm_smem_bytes(I, O, M, tsize);
}
