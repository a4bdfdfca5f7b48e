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
// batched_gemm_kernel   grid (N tiles, M tiles, C): a 64 x 64 output tile per
//                       block, K walked in chunks of 32 through shared
//                       memory, a 4 x 4 register tile per thread, ragged
//                       edges zero-filled on load and masked on store.
// taploop_conv_kernel   grid (image groups, C): a block stages a band of an
//                       image with its one-pixel halo (zeros outside the
//                       image) and the client's weights in shared memory; a
//                       thread owns four output positions x four channels in
//                       registers and makes nine passes over the staged
//                       rows, one K = I product each.
//
// What bounds them on the H100: at the probe shapes (512 clients, M = 8192,
// K = 288, N = 64, bf16) the GEMM is 77 G FMA on 2.97 GB, the convolution
// (512 x 32 images, 14x14, 32 -> 64) 59 G FMA on 0.6 GB: both bound by bytes
// by the card's numbers; as written, on the CUDA cores, by FMA issue and
// shared-memory loads.

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

template <typename T>
int launch_gemm(const void* a, const void* b, void* out, int C, int M, int K, int N,
                cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, C);
  batched_gemm_kernel<T><<<grid, kGemmThreads, 0, stream>>>((const T*)a, (const T*)b, (T*)out,
                                                            M, K, N);
  return (int)cudaGetLastError();
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

// out (C, M, N) = a (C, M, K) @ b (C, K, N), in a's dtype.
extern "C" int fl_batched_gemm(int dtype, const void* a, const void* b, void* out, int C, int M,
                               int K, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_gemm<float>(a, b, out, C, M, K, N, s);
  if (dtype == 1) return launch_gemm<__nv_bfloat16>(a, b, out, C, M, K, N, s);
  return (int)cudaErrorInvalidValue;
}

// y (C, B, H, W, O) = conv3x3_same(x (C, B, H, W, I), w (C, 3, 3, I, O)), in
// x's dtype; bands of TH image rows, G images a block.
extern "C" int fl_taploop_conv(int dtype, const void* x, const void* w, void* y, int C, int B,
                               int H, int W, int I, int O, int TH, int G, int threads,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || TH < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_taploop<float>(x, w, y, C, B, H, W, I, O, TH, G, threads, s);
  if (dtype == 1)
    return launch_taploop<__nv_bfloat16>(x, w, y, C, B, H, W, I, O, TH, G, threads, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one block of the tap-loop convolution needs with bands of TH
// rows.
extern "C" size_t fl_taploop_smem_bytes(int dtype, int W, int I, int O, int TH) {
  return taploop_smem_bytes(W, I, O, TH, dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16));
}
