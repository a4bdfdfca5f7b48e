// Fused SimpleCNN conv segment for Hopper (sm_90a): forward and backward of
//   pool2(relu(conv2(pool2(relu(conv1(x) + b1))) + b2))
// over stacked clients, each with its own weights, in two formulations.
//
// Replaces the TPU kernels of fl_tpu/ops/conv_block.py:
//   K1  _fwd_kernel_res (launched by _fwd_call_impl_res), which writes the
//       pooled output and the pool2 first-match window index;
//   K2  _bwd_kernel_res (launched by _bwd_call_impl_res), which recomputes the
//       stem, routes the cotangent through both pools and returns the four
//       weight/bias gradients (the image gradient is never formed);
//   K4  _fwd_kernel / _bwd_kernel (launched by _fwd_call_impl and
//       _bwd_call_impl, also on conv_stack_packed's weights): the same
//       segment without residuals. conv_stack_fwd_kernel is K1 minus the
//       index output. conv_stack_bwd_kernel takes only the cotangent, the
//       image and the weights: it recomputes y1 -> x2 -> y2 -> a2 with the
//       forward's arithmetic (same casts, same order of the f32 sums, so
//       the relu and pool masks are the forward's bit for bit), finds the
//       first-match pool2 member and relu2' = (a2 > 0) itself, and then
//       runs K2's per-image body on what it found.
//
// The contract kept from the TPU kernels (not their block structure): f32
// accumulation; biases added in f32 before relu; values rounded to the
// compute dtype T at the reference's points (image and weights on entry, y1
// after relu1, a2 after relu2, pool maxima stay in T); first-match row-major
// tie-breaking in both pools (window position g = a*2 + b); in K2, dz2 and
// dz1 are rounded to T before the weight-gradient and dgrad products and
// kept in f32 for the bias sums. The s2d stem lift, the halo planes, the
// client lane packing and the P=2 custom_vmap of the TPU design exist for
// the TPU's (8, 128) tiles and are not carried over; nor are K4's halo
// planes, its full-plane parity-mask algebra for the tie-break and its
// multiplicative stand-ins for boolean masks, which exist for Mosaic.
//
// What bounds it on the H100: the per-image work is ~3.6 MFMA for conv2
// (forward), the same for dgrad, and a quarter of that for the sparse
// wgrad, on operands that live in shared memory. Device memory traffic is
// small (one image in, one 7x7x64 pooled map and its uint8 index out). The
// design keeps every intermediate of an image (padded image, pool1 plane,
// the pool1 argmax, dz2, dx2) in shared memory and loads the client's
// weights once per block of G images. The dtype alone fixes the route:
//   float32 (fwd_body, bwd_body): everything on the CUDA cores, bound by
//     shared-memory loads and FMA issue there; each thread takes four
//     window positions per weight load in the forward conv2. TF32 would
//     break the f32 contract.
//   bfloat16 (fwd_tc_body, bwd_tc_body): the stem stays on the CUDA cores
//     (one input channel: no product to speak of); conv2 in the forward and
//     its input and weight gradients in the backward run on mma.sync fed by
//     ldmatrix, with the f32 sums in registers. The forward's conv2 is one
//     device function, conv2_pool2_tc, called by K1, K4's forward and K4's
//     backward recompute, so their pool2 masks and window index are the same
//     bits; it sums in another order than fwd_body, so bf16 values and
//     near-tie indices may differ from the f32-route arithmetic by one ulp.
//
// K4's backward pays one more conv2 forward per image than K2 and saves the
// index and pooled residuals (2 + 1 bytes per pooled value), which K1 had
// already made small. It routes pool2 window by window as the recomputed
// conv2 outputs appear, so no a2 plane is held: only the masked cotangent
// and the window index per pooled position. In f32 it is bwd_body: one copy
// of w2 in the dgrad's [k][o][ci] order with rows padded to C1 + 1, so that
// both the recomputed forward (threads along o) and the dgrad (threads along
// ci) read it without bank conflicts, which fits the 227 KB block limit at
// the bench shapes. In bf16 it is bwd_tc_body<true>, K2's bf16 body
// (bwd_tc_body<false>) after a tensor-core recompute: from the masked
// cotangent and the window index on both run the same code, so K4's
// gradients equal K2's fed K1's residuals bit for bit in both dtypes.
//
// Block layout: grid (ceil(B / G), C), a launch-time thread count; one block = one client
// and G consecutive images. K2 sums its images' weight gradients into a
// per-block slot of a partial buffer (each element owned by one thread, so
// no atomics), and a second kernel adds the ceil(B/G) slots of each client
// in a fixed order: the result is deterministic.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

struct Geometry {
  int H, W, H1, W1, Ho, Wo;
  int HP, WP, H1P, W1P;
  __host__ __device__ Geometry(int h, int w)
      : H(h), W(w), H1(h / 2), W1(w / 2), Ho(h / 4), Wo(w / 4),
        HP(h + 2), WP(w + 2), H1P(h / 2 + 2), W1P(w / 2 + 2) {}
};

size_t fwd_smem_bytes(const Geometry& g, int C1, int C2, size_t tsize) {
  size_t floats = 9 * C1 + C1 + C2 + (size_t)g.HP * g.WP;
  size_t ts = (size_t)9 * C1 * C2 + (size_t)g.H1P * g.W1P * C1;
  return floats * 4 + ts * tsize;
}

// recompute = the residual-free backward (K4): b2, the padded w2 rows, and
// the masked cotangent and window index per pooled position come on top
size_t bwd_smem_bytes(const Geometry& g, int C1, int C2, size_t tsize, bool recompute) {
  size_t n_out = (size_t)g.Ho * g.Wo * C2;
  size_t floats = 9 * C1 + C1 + (size_t)g.HP * g.WP + (size_t)g.H1 * g.W1 * C1 +
                  (recompute ? C2 : 0);
  size_t ts = (size_t)9 * C2 * (C1 + (recompute ? 1 : 0)) +
              (size_t)g.H1P * g.W1P * (C1 + C2) + (recompute ? n_out : 0);
  size_t bytes = (size_t)g.H1 * g.W1 * C1 + (recompute ? n_out : 0);
  return floats * 4 + ts * tsize + bytes;
}

// Load image b of client c into the zero-bordered (H+2, W+2) f32 plane.
template <typename T>
__device__ void load_image(float* s_img, const T* __restrict__ xb, const Geometry& g) {
  for (int i = threadIdx.x; i < g.H * g.W; i += blockDim.x) {
    int r = i / g.W, q = i - r * g.W;
    s_img[(r + 1) * g.WP + q + 1] = to_f<T>(xb[i]);
  }
}

// conv1 -> +b1 -> relu -> round to T -> pool1 (first-match argmax).
// Writes the pool1 plane into the interior of the zero-bordered s_x2 (xs
// elements a pixel) and, when s_arg is given, the winning window position
// per (h, w, o).
template <typename T>
__device__ void stem_pool1(const float* s_img, const float* s_w1, const float* s_b1,
                           T* s_x2, uint8_t* s_arg, const Geometry& g, int C1, int xs) {
  for (int i = threadIdx.x; i < g.H1 * g.W1 * C1; i += blockDim.x) {
    int o = i % C1, p = i / C1;
    int h = p / g.W1, w = p - h * g.W1;
    float best = 0.f;
    int arg = 0;
#pragma unroll
    for (int win = 0; win < 4; ++win) {
      int r0 = 2 * h + (win >> 1), q0 = 2 * w + (win & 1);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k)
        acc = fmaf(s_img[(r0 + k / 3) * g.WP + q0 + k % 3], s_w1[k * C1 + o], acc);
      float v = round_to<T>(fmaxf(acc + s_b1[o], 0.f));
      if (win == 0 || v > best) {
        best = v;
        arg = win;
      }
    }
    s_x2[((h + 1) * g.W1P + w + 1) * xs + o] = from_f<T>(best);
    if (s_arg) s_arg[i] = (uint8_t)arg;
  }
}

// conv2 (no bias) at the four members of pool2 window (ph, pw) for output
// channel o: acc[a * 2 + b] is the f32 sum over taps k and channels ci, in
// that order, at conv2 output (2ph + a, 2pw + b). Weight (k, ci, o) sits at
// s_w[k * wk + ci * wci + o * wo], pixels of s_x2 are xs elements apart (a
// stride moves no sum: every layout gives the same f32 values).
template <typename T>
__device__ __forceinline__ void conv2_window(const T* s_x2, const T* s_w, int wk, int wci,
                                             int wo, int ph, int pw, int o,
                                             const Geometry& g, int C1, int xs, float acc[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  for (int k = 0; k < 9; ++k) {
    const T* wv_k = s_w + k * wk + o * wo;
    // tap k of output row 2ph + a reads pool1 row 2ph + a + dh - 1, which is
    // s_x2 row 2ph + a + dh
    const T* x00 = s_x2 + ((2 * ph + k / 3) * g.W1P + 2 * pw + k % 3) * xs;
    const T* x10 = x00 + g.W1P * xs;
    for (int ci = 0; ci < C1; ++ci) {
      float wv = to_f<T>(wv_k[ci * wci]);
      acc[0] = fmaf(to_f<T>(x00[ci]), wv, acc[0]);
      acc[1] = fmaf(to_f<T>(x00[xs + ci]), wv, acc[1]);
      acc[2] = fmaf(to_f<T>(x10[ci]), wv, acc[2]);
      acc[3] = fmaf(to_f<T>(x10[xs + ci]), wv, acc[3]);
    }
  }
}

// +bias -> relu -> round to T -> first-match max over the window members
template <typename T>
__device__ __forceinline__ float pool2_first(const float acc[4], float bias, int* arg) {
  float best = 0.f;
  *arg = 0;
#pragma unroll
  for (int win = 0; win < 4; ++win) {
    float v = round_to<T>(fmaxf(acc[win] + bias, 0.f));
    if (win == 0 || v > best) {
      best = v;
      *arg = win;
    }
  }
  return best;
}

// The float32 forward of one block (bfloat16: fwd_tc_body): kIdx also writes
// the pool2 window index (K1).
template <typename T, bool kIdx>
__device__ __forceinline__ void fwd_body(const T* __restrict__ x, const T* __restrict__ w1,
                                         const float* __restrict__ b1,
                                         const T* __restrict__ w2,
                                         const float* __restrict__ b2, T* __restrict__ pooled,
                                         uint8_t* __restrict__ idx, int B, int H, int W,
                                         int C1, int C2, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry g(H, W);
  const int c = blockIdx.y;
  float* s_w1 = reinterpret_cast<float*>(smem);
  float* s_b1 = s_w1 + 9 * C1;
  float* s_b2 = s_b1 + C1;
  float* s_img = s_b2 + C2;
  T* s_w2 = reinterpret_cast<T*>(s_img + g.HP * g.WP);  // [k][ci][o]
  T* s_x2 = s_w2 + 9 * C1 * C2;                         // [(h+1)][(w+1)][ci]

  const T* w1c = w1 + (size_t)c * 9 * C1;
  const T* w2c = w2 + (size_t)c * 9 * C1 * C2;
  for (int i = threadIdx.x; i < 9 * C1; i += blockDim.x) s_w1[i] = to_f<T>(w1c[i]);
  for (int i = threadIdx.x; i < C1; i += blockDim.x) s_b1[i] = b1[(size_t)c * C1 + i];
  for (int i = threadIdx.x; i < C2; i += blockDim.x) s_b2[i] = b2[(size_t)c * C2 + i];
  for (int i = threadIdx.x; i < 9 * C1 * C2; i += blockDim.x) s_w2[i] = w2c[i];
  for (int i = threadIdx.x; i < g.HP * g.WP; i += blockDim.x) s_img[i] = 0.f;
  for (int i = threadIdx.x; i < g.H1P * g.W1P * C1; i += blockDim.x) s_x2[i] = from_f<T>(0.f);
  __syncthreads();

  const int n_out = g.Ho * g.Wo * C2;
  for (int j = 0; j < G; ++j) {
    const int b = blockIdx.x * G + j;
    if (b >= B) break;  // uniform across the block
    const size_t img = (size_t)c * B + b;
    load_image<T>(s_img, x + img * H * W, g);
    __syncthreads();
    stem_pool1<T>(s_img, s_w1, s_b1, s_x2, nullptr, g, C1, C1);
    __syncthreads();

    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
      int o = i % C2, p = i / C2;
      float acc[4];
      conv2_window<T>(s_x2, s_w2, C1 * C2, C2, 1, p / g.Wo, p % g.Wo, o, g, C1, C1, acc);
      int arg;
      float best = pool2_first<T>(acc, s_b2[o], &arg);
      pooled[img * n_out + i] = from_f<T>(best);
      if (kIdx) idx[img * n_out + i] = (uint8_t)arg;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
conv_block_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const float* __restrict__ b2, T* __restrict__ pooled,
                      uint8_t* __restrict__ idx, int B, int H, int W, int C1, int C2,
                      int G) {
  fwd_body<T, true>(x, w1, b1, w2, b2, pooled, idx, B, H, W, C1, C2, G);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
conv_stack_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const float* __restrict__ b2, T* __restrict__ pooled, int B, int H,
                      int W, int C1, int C2, int G) {
  fwd_body<T, false>(x, w1, b1, w2, b2, pooled, nullptr, B, H, W, C1, C2, G);
}

// Partial-gradient slot layout (P floats per block):
//   dw1 [k][o] (9*C1) | db1 (C1) | dw2 [k][ci][o] (9*C1*C2) | db2 (C2)
//
// The float32 backward of one block (bfloat16: bwd_tc_body). Without
// kRecompute (K2) the cotangent arrives already multiplied by relu2' and the
// pool2 window index comes from the forward. With kRecompute (K4) neither
// exists: per image the block runs conv2 again on the recomputed pool1 plane
// and keeps, per pooled position, the first-match window member and the
// cotangent masked by a2 > 0 in shared memory, where the rest of the body
// reads them as K2 reads its inputs.
template <typename T, bool kRecompute>
__device__ __forceinline__ void bwd_body(const T* __restrict__ gy,
                                         const uint8_t* __restrict__ idx,
                                         const T* __restrict__ x, const T* __restrict__ w1,
                                         const float* __restrict__ b1,
                                         const T* __restrict__ w2,
                                         const float* __restrict__ b2,
                                         float* __restrict__ partial, int B, int H, int W,
                                         int C1, int C2, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry g(H, W);
  const int c = blockIdx.y;
  const int n_pool = g.Ho * g.Wo;
  const int n_x2 = g.H1 * g.W1;
  const int ldw = kRecompute ? C1 + 1 : C1;  // row stride of s_w2t
  float* s_w1 = reinterpret_cast<float*>(smem);
  float* s_b1 = s_w1 + 9 * C1;
  float* s_img = s_b1 + C1;
  float* s_dx2 = s_img + g.HP * g.WP;  // [h][w][ci], f32
  float* s_b2 = s_dx2 + n_x2 * C1;     // K4 only
  T* s_w2t = reinterpret_cast<T*>(s_b2 + (kRecompute ? C2 : 0));  // [k][o][ci]
  T* s_x2 = s_w2t + 9 * C2 * ldw;                                 // [(h+1)][(w+1)][ci]
  T* s_dz2 = s_x2 + g.H1P * g.W1P * C1;                           // [(h+1)][(w+1)][o]
  T* s_g = s_dz2 + g.H1P * g.W1P * C2;                            // K4 only: [p][o]
  uint8_t* s_arg = reinterpret_cast<uint8_t*>(s_g + (kRecompute ? n_pool * C2 : 0));
  uint8_t* s_win = s_arg + n_x2 * C1;  // K4 only: [p][o]

  const size_t P = (size_t)9 * C1 + C1 + (size_t)9 * C1 * C2 + C2;
  float* part = partial + ((size_t)c * gridDim.x + blockIdx.x) * P;
  float* p_dw1 = part;
  float* p_db1 = p_dw1 + 9 * C1;
  float* p_dw2 = p_db1 + C1;
  float* p_db2 = p_dw2 + 9 * C1 * C2;

  const T* w1c = w1 + (size_t)c * 9 * C1;
  const T* w2c = w2 + (size_t)c * 9 * C1 * C2;
  for (int i = threadIdx.x; i < 9 * C1; i += blockDim.x) s_w1[i] = to_f<T>(w1c[i]);
  for (int i = threadIdx.x; i < C1; i += blockDim.x) s_b1[i] = b1[(size_t)c * C1 + i];
  if (kRecompute)
    for (int i = threadIdx.x; i < C2; i += blockDim.x) s_b2[i] = b2[(size_t)c * C2 + i];
  for (int i = threadIdx.x; i < 9 * C1 * C2; i += blockDim.x) {
    int k = i / (C1 * C2), rem = i - k * C1 * C2;
    int ci = rem / C2, o = rem - ci * C2;
    s_w2t[(k * C2 + o) * ldw + ci] = w2c[i];
  }
  for (int i = threadIdx.x; i < g.HP * g.WP; i += blockDim.x) s_img[i] = 0.f;
  for (int i = threadIdx.x; i < g.H1P * g.W1P * C1; i += blockDim.x) s_x2[i] = from_f<T>(0.f);
  for (int i = threadIdx.x; i < g.H1P * g.W1P * C2; i += blockDim.x) s_dz2[i] = from_f<T>(0.f);
  __syncthreads();

  for (int j = 0; j < G; ++j) {
    const int b = blockIdx.x * G + j;
    if (b >= B) break;  // uniform across the block
    const bool first = (j == 0);
    const size_t img = (size_t)c * B + b;
    const T* g_b = gy + img * n_pool * C2;
    const uint8_t* idx_b = kRecompute ? s_win : idx + img * n_pool * C2;

    load_image<T>(s_img, x + img * H * W, g);
    __syncthreads();
    // stem recompute: pool1 plane and its first-match routing
    stem_pool1<T>(s_img, s_w1, s_b1, s_x2, s_arg, g, C1, C1);
    if (kRecompute) {
      __syncthreads();
      // conv2 recompute with the forward's sums: pool2's first-match member
      // and relu2' = (a2 > 0) at it, window by window
      for (int i = threadIdx.x; i < n_pool * C2; i += blockDim.x) {
        int o = i % C2, p = i / C2;
        float acc[4];
        conv2_window<T>(s_x2, s_w2t, C2 * ldw, 1, ldw, p / g.Wo, p % g.Wo, o, g, C1, C1, acc);
        int arg;
        float best = pool2_first<T>(acc, s_b2[o], &arg);
        s_g[i] = best > 0.f ? g_b[i] : from_f<T>(0.f);
        s_win[i] = (uint8_t)arg;
      }
      __syncthreads();
      g_b = s_g;
    }
    // pool2 backward: the cotangent lands on the indexed window position
    for (int i = threadIdx.x; i < n_pool * C2; i += blockDim.x) {
      int o = i % C2, p = i / C2;
      int ph = p / g.Wo, pw = p - ph * g.Wo;
      int win = idx_b[i];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        int r = 2 * ph + (a >> 1) + 1, q = 2 * pw + (a & 1) + 1;
        s_dz2[(r * g.W1P + q) * C2 + o] = a == win ? g_b[i] : from_f<T>(0.f);
      }
    }
    for (int o = threadIdx.x; o < C2; o += blockDim.x) {
      float s = 0.f;
      for (int p = 0; p < n_pool; ++p) s += to_f<T>(g_b[p * C2 + o]);
      p_db2[o] = first ? s : p_db2[o] + s;
    }
    __syncthreads();

    // conv2 wgrad, summed over the pooled positions only (dz2 is zero off
    // the routed window member): dw2[k][ci][o] += x2[pos + tap k] * g
    for (int e = threadIdx.x; e < C1 * C2; e += blockDim.x) {
      int o = e % C2, ci = e / C2;
      float acc[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) acc[k] = 0.f;
      for (int p = 0; p < n_pool; ++p) {
        float gv = to_f<T>(g_b[p * C2 + o]);
        if (gv == 0.f) continue;
        int win = idx_b[p * C2 + o];
        int ph = p / g.Wo, pw = p - ph * g.Wo;
        int r = 2 * ph + (win >> 1), q = 2 * pw + (win & 1);
        const T* xp = s_x2 + (r * g.W1P + q) * C1 + ci;
#pragma unroll
        for (int k = 0; k < 9; ++k)
          acc[k] = fmaf(to_f<T>(xp[((k / 3) * g.W1P + k % 3) * C1]), gv, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        float* d = p_dw2 + (k * C1 + ci) * C2 + o;
        *d = first ? acc[k] : *d + acc[k];
      }
    }

    // conv2 dgrad (flipped taps), masked by relu1' = (x2 > 0)
    for (int i = threadIdx.x; i < n_x2 * C1; i += blockDim.x) {
      int ci = i % C1, p = i / C1;
      int h = p / g.W1, w = p - h * g.W1;
      float acc = 0.f;
      for (int k = 0; k < 9; ++k) {
        const T* dz = s_dz2 + ((h - k / 3 + 2) * g.W1P + w - k % 3 + 2) * C2;
        const T* wt = s_w2t + k * C2 * ldw + ci;
        for (int o = 0; o < C2; ++o) acc = fmaf(to_f<T>(dz[o]), to_f<T>(wt[o * ldw]), acc);
      }
      float x2v = to_f<T>(s_x2[((h + 1) * g.W1P + w + 1) * C1 + ci]);
      s_dx2[i] = x2v > 0.f ? acc : 0.f;
    }
    __syncthreads();

    // stem backward: dz1 is dx2 at the pool1 winner, zero elsewhere
    for (int o = threadIdx.x; o < C1; o += blockDim.x) {
      float s = 0.f;
      for (int p = 0; p < n_x2; ++p) s += s_dx2[p * C1 + o];
      p_db1[o] = first ? s : p_db1[o] + s;
    }
    for (int e = threadIdx.x; e < 9 * C1; e += blockDim.x) {
      int o = e % C1, k = e / C1;
      int dh = k / 3, dw = k % 3;
      float acc = 0.f;
      for (int p = 0; p < n_x2; ++p) {
        float v = round_to<T>(s_dx2[p * C1 + o]);
        if (v == 0.f) continue;
        int win = s_arg[p * C1 + o];
        int h = p / g.W1, w = p - h * g.W1;
        int r = 2 * h + (win >> 1), q = 2 * w + (win & 1);
        acc = fmaf(s_img[(r + dh) * g.WP + q + dw], v, acc);
      }
      p_dw1[e] = first ? acc : p_dw1[e] + acc;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 routes: conv2 and its gradients on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Groups of pooled-1 positions the stem backward splits its sums into
constexpr int kStemGroups = 24;

// Channels padded to 16 for the k16 steps (zeros in shared memory only) and
// row strides of an odd number of 16-byte chunks, so that the eight rows of
// an ldmatrix miss each other's banks: x2's pixels XS apart, dz2's DS, w2's
// (tap, ci) rows LW.
struct TcLayout {
  int C1P, C2P, XS, DS, LW;
  __host__ __device__ TcLayout(int C1, int C2)
      : C1P(round_up16(C1)), C2P(round_up16(C2)), XS(round_up16(C1) + kSkew),
        DS(round_up16(C2) + kSkew), LW(round_up16(C2) + kSkew) {}
};

// (tap, 16 channels, 16 outputs) blocks of dW2
__host__ __device__ inline int tc_wgrad_units(const TcLayout& L) {
  return 9 * (L.C1P / 16) * (L.C2P / 16);
}
__host__ __device__ inline int tc_dgrad_units(const Geometry& g, const TcLayout& L) {
  return (g.H1 * g.W1 + 15) / 16 * (L.C1P / 16);
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ inline int stem_groups(const Geometry& g) {
  return min(kStemGroups, g.H1 * g.W1);
}

// w2 (tap, ci, o) of one client into the [tap][ci][o] rows of LW elements,
// channels and outputs padded to 16 with zeros
__device__ void load_w2_tc(bf16* s_w2, const bf16* __restrict__ w2c, const TcLayout& L, int C1,
                           int C2) {
  for (int i = threadIdx.x; i < 9 * L.C1P * L.C2P; i += blockDim.x) {
    const int row = i / L.C2P, o = i - row * L.C2P, tap = row / L.C1P, ci = row - tap * L.C1P;
    s_w2[row * L.LW + o] =
        ci < C1 && o < C2 ? w2c[(size_t)(tap * C1 + ci) * C2 + o] : __float2bfloat16(0.f);
  }
}

// conv2 -> +b2 -> relu -> round to bf16 -> first-match pool2 over one image,
// the conv2 sums on mma.sync m16n8k16: an implicit GEMM with M = the 4 * Ho *
// Wo conv2 outputs that pool2 reads, K = 9 * C1P, N = C2P. The M rows are
// ordered window-major (row 4 * p + a is member a of pooled position p), so
// a window's four members are the rows g, g ^ 1, g ^ 2, g ^ 3 of an m16
// tile's fragment: lanes 4 and 8 apart. A's rows are gathered by ldmatrix
// from the zero-bordered x2 plane (XS elements a pixel) at each tap's offset;
// a row past the image reads the plane's zero corner. B is w2 in its
// [tap][ci][o] rows of LW, which is [k][n]: ldmatrix.trans gives its
// fragments. A warp takes (m16 tile, 32 outputs) units. The epilogue is
// pool2_first's arithmetic on the four f32 sums (+b2, relu, round, the first
// member of the largest value) with the window gathered by two shuffles;
// epi(p * C2 + o, best, arg) gets every pooled position p and output o < C2
// once. The sums of a unit run in one fixed order whatever the thread count,
// so every caller gets the same bits.
template <typename Epilogue>
__device__ __forceinline__ void conv2_pool2_tc(const bf16* s_x2, const bf16* s_w2,
                                               const float* s_b2, const Geometry& g,
                                               const TcLayout& L, int C2, Epilogue epi) {
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3, member = gq & 3;
  const int n_pool = g.Ho * g.Wo;
  const int n_mt = (4 * n_pool + 15) / 16, n_nc = (L.C2P + 31) / 32;
  const uint32_t a_lane = smem_addr(s_x2 + (lane >> 4) * 8);
  for (int u = warp; u < n_mt * n_nc; u += warps) {
    const int mt = u / n_nc, n0 = (u - mt * n_nc) * 32;
    const int n_tiles = min(4, (L.C2P - n0) / 8);  // 2 or 4, uniform across the warp
    // this lane's A row: member a of pooled position p, conv2 output (h, w);
    // tap (dh, dw) reads pool1 pixel (h + dh - 1, w + dw - 1), plane pixel
    // (h + dh, w + dw)
    const int m = mt * 16 + (lane & 15), p = m >> 2, a = m & 3;
    const bool valid = p < n_pool;
    const int ph = valid ? p / g.Wo : 0, pw = valid ? p - ph * g.Wo : 0;
    const int base = (2 * ph + (a >> 1)) * g.W1P + 2 * pw + (a & 1);
    const uint32_t b_lane =
        smem_addr(s_w2 + (size_t)(lane & 15) * L.LW + n0 + (lane >> 4) * 8);
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[nt][v] = 0.f;
    for (int k = 0; k < 9; ++k) {
      const int pix = valid ? base + (k / 3) * g.W1P + k % 3 : 0;
      const uint32_t a_addr = a_lane + pix * L.XS * 2;
      const uint32_t b_addr = b_lane + k * L.C1P * L.LW * 2;
      for (int c0 = 0; c0 < L.C1P; c0 += 16) {
        uint32_t af[4], bf[4][2];
        ldmatrix_x4(af, a_addr + c0 * 2);
        load_b_k16<4>(bf, b_addr + c0 * L.LW * 2, n_tiles);
        mma_k16<4>(acc, af, bf, n_tiles);
      }
    }
    // rows gq and gq + 8 are member `member` of pooled positions
    // 4 * mt + (gq >> 2) and 4 * mt + 2 + (gq >> 2); the lanes of member q
    // hand on the windows of column tile q
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= n_tiles) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pp = 4 * mt + 2 * half + (gq >> 2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = n0 + nt * 8 + 2 * t4 + e;
          const float bias = o < C2 ? s_b2[o] : 0.f;
          float best = round_to<bf16>(fmaxf(acc[nt][2 * half + e] + bias, 0.f));
          int arg = member;
#pragma unroll
          for (int s = 4; s <= 8; s <<= 1) {
            const float vo = __shfl_xor_sync(0xffffffffu, best, s);
            const int ao = __shfl_xor_sync(0xffffffffu, arg, s);
            if (vo > best || (vo == best && ao < arg)) {
              best = vo;
              arg = ao;
            }
          }
          if (nt == member && pp < n_pool && o < C2) epi(pp * C2 + o, best, arg);
        }
      }
    }
  }
}

size_t tc_fwd_smem_bytes(const Geometry& g, int C1, int C2) {
  const TcLayout L(C1, C2);
  const size_t floats = 9 * C1 + C1 + C2 + (size_t)g.HP * g.WP;
  return align16(floats * 4) + 2 * ((size_t)9 * L.C1P * L.LW + (size_t)g.H1P * g.W1P * L.XS);
}

// The bfloat16 forward of one block: the stem on the CUDA cores as in
// fwd_body, conv2 and pool2 through conv2_pool2_tc; kIdx also writes the
// pool2 window index (K1).
template <bool kIdx>
__device__ __forceinline__ void fwd_tc_body(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                                            const float* __restrict__ b1,
                                            const bf16* __restrict__ w2,
                                            const float* __restrict__ b2,
                                            bf16* __restrict__ pooled, uint8_t* __restrict__ idx,
                                            int B, int H, int W, int C1, int C2, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry g(H, W);
  const TcLayout L(C1, C2);
  const int c = blockIdx.y;
  const int plane = g.H1P * g.W1P;
  float* s_w1 = reinterpret_cast<float*>(smem);
  float* s_b1 = s_w1 + 9 * C1;
  float* s_b2 = s_b1 + C1;
  float* s_img = s_b2 + C2;
  bf16* s_w2 = reinterpret_cast<bf16*>(
      smem + align16((size_t)(9 * C1 + C1 + C2 + g.HP * g.WP) * 4));  // [tap][ci][o], LW
  bf16* s_x2 = s_w2 + 9 * L.C1P * L.LW;  // [(h+1)][(w+1)][ci], XS

  const bf16* w1c = w1 + (size_t)c * 9 * C1;
  for (int i = threadIdx.x; i < 9 * C1; i += blockDim.x) s_w1[i] = to_f<bf16>(w1c[i]);
  for (int i = threadIdx.x; i < C1; i += blockDim.x) s_b1[i] = b1[(size_t)c * C1 + i];
  for (int i = threadIdx.x; i < C2; i += blockDim.x) s_b2[i] = b2[(size_t)c * C2 + i];
  load_w2_tc(s_w2, w2 + (size_t)c * 9 * C1 * C2, L, C1, C2);
  for (int i = threadIdx.x; i < g.HP * g.WP; i += blockDim.x) s_img[i] = 0.f;
  for (int i = threadIdx.x; i < plane * L.XS; i += blockDim.x) s_x2[i] = __float2bfloat16(0.f);
  __syncthreads();

  const int n_out = g.Ho * g.Wo * C2;
  for (int j = 0; j < G; ++j) {
    const int b = blockIdx.x * G + j;
    if (b >= B) break;  // uniform across the block
    const size_t img = (size_t)c * B + b;
    load_image<bf16>(s_img, x + img * H * W, g);
    __syncthreads();
    stem_pool1<bf16>(s_img, s_w1, s_b1, s_x2, nullptr, g, C1, L.XS);
    __syncthreads();
    bf16* out = pooled + img * n_out;
    uint8_t* out_idx = kIdx ? idx + img * n_out : nullptr;
    conv2_pool2_tc(s_x2, s_w2, s_b2, g, L, C2, [&](int i, float best, int arg) {
      out[i] = __float2bfloat16(best);
      if (kIdx) out_idx[i] = (uint8_t)arg;
    });
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxThreads)
conv_block_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                         const float* __restrict__ b1, const bf16* __restrict__ w2,
                         const float* __restrict__ b2, bf16* __restrict__ pooled,
                         uint8_t* __restrict__ idx, int B, int H, int W, int C1, int C2, int G) {
  fwd_tc_body<true>(x, w1, b1, w2, b2, pooled, idx, B, H, W, C1, C2, G);
}

__global__ void __launch_bounds__(kMaxThreads)
conv_stack_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                         const float* __restrict__ b1, const bf16* __restrict__ w2,
                         const float* __restrict__ b2, bf16* __restrict__ pooled, int B, int H,
                         int W, int C1, int C2, int G) {
  fwd_tc_body<false>(x, w1, b1, w2, b2, pooled, nullptr, B, H, W, C1, C2, G);
}

// recompute = K4 (b2 comes on top); K2 stages its cotangent and index where
// K4's recompute writes its own
size_t tc_bwd_smem_bytes(const Geometry& g, int C1, int C2, bool recompute) {
  const TcLayout L(C1, C2);
  const size_t n_x2 = (size_t)g.H1 * g.W1, n_pool = (size_t)g.Ho * g.Wo;
  const size_t plane = (size_t)g.H1P * g.W1P;
  const size_t floats = 9 * C1 + C1 + (size_t)g.HP * g.WP + n_x2 * C1 + (recompute ? C2 : 0) +
                        (size_t)stem_groups(g) * 10 * C1 + n_x2;
  return align16(floats * 4) + 2 * ((size_t)9 * L.C1P * L.LW + plane * L.XS + plane * L.DS) +
         2 * n_pool * C2 + n_x2 * C1 + n_pool * C2;
}

// The bfloat16 backward of one block, K2 (kRecompute = false) and K4 (true).
// K2 takes the cotangent already masked by relu2' and K1's pool2 index; K4
// takes the raw cotangent and finds both again through conv2_pool2_tc, the
// forward's own device function, so its masks are K4's forward's (and K1's)
// bit for bit. The stem (recompute, pool1 routing, dw1, db1) is bwd_body's
// CUDA-core code; the two conv2 gradient products run on mma.sync m16n8k16:
//   dx2[p, ci] = sum over (tap, o) of dz2[p - tap, o] * w2[tap, ci, o]: an
//       implicit GEMM, M = the H1 x W1 pixels in m16 tiles, K = 9 * C2P, N =
//       C1P. A's rows are gathered by ldmatrix from the zero-bordered dz2
//       plane at the mirrored tap's offset (a pixel past the plane reads its
//       zero corner); B is w2 in the forward's [tap][ci][o] layout, which is
//       [n][k] for this product, so plain ldmatrix gives its fragment and the
//       forward's product and this one read one copy. Masked by relu1' into
//       s_dx2.
//   dW2[tap] (C1 x C2) = sum over the pixels of x2 shifted by the tap,
//       transposed, times dz2: dense, with the pixel as the k of the mma and
//       both operands turned by ldmatrix.trans, a (tap, 16 channels, 16
//       outputs) block a warp at a time, added to the block's slot after
//       each image (held in registers across the images instead, the sums
//       cost the recompute registers and the kernel 1 ms more).
// A warp takes dgrad units (m16 tile, 16 channels) from the front and dW2
// blocks from the back of the warp list. Pixel p's place in the padded
// planes comes from a table, not from a division in every k step. Both
// kernels run the same code from the masked cotangent and the window index
// on, so K4's gradients equal K2's fed K1's residuals bit for bit.
template <bool kRecompute>
__device__ __forceinline__ void bwd_tc_body(const bf16* __restrict__ gy,
                                            const uint8_t* __restrict__ idx,
                                            const bf16* __restrict__ x,
                                            const bf16* __restrict__ w1,
                                            const float* __restrict__ b1,
                                            const bf16* __restrict__ w2,
                                            const float* __restrict__ b2,
                                            float* __restrict__ partial, int B, int H, int W,
                                            int C1, int C2, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry g(H, W);
  const TcLayout L(C1, C2);
  const int c = blockIdx.y;
  const int n_pool = g.Ho * g.Wo, n_x2 = g.H1 * g.W1, plane = g.H1P * g.W1P;
  const int n_b2 = kRecompute ? C2 : 0;
  float* s_w1 = reinterpret_cast<float*>(smem);
  float* s_b1 = s_w1 + 9 * C1;
  float* s_img = s_b1 + C1;
  float* s_dx2 = s_img + g.HP * g.WP;  // [p][ci], f32
  float* s_b2 = s_dx2 + n_x2 * C1;     // K4 only
  float* s_red = s_b2 + n_b2;  // [group][10][C1]: the stem backward's partial sums
  const int n_grp = stem_groups(g);
  int* s_pix = reinterpret_cast<int*>(s_red + n_grp * 10 * C1);  // [p]: (h + 1) * W1P + w + 1
  bf16* s_w2 = reinterpret_cast<bf16*>(
      smem + align16((size_t)(9 * C1 + C1 + g.HP * g.WP + n_x2 * C1 + n_b2 + n_grp * 10 * C1 +
                              n_x2) *
                     4));  // [tap][ci][o], LW
  bf16* s_x2 = s_w2 + 9 * L.C1P * L.LW;  // [(h+1)][(w+1)][ci], XS
  bf16* s_dz2 = s_x2 + plane * L.XS;     // [(h+1)][(w+1)][o], DS
  bf16* s_g = s_dz2 + plane * L.DS;      // [p][o]: the masked cotangent
  uint8_t* s_arg = reinterpret_cast<uint8_t*>(s_g + n_pool * C2);
  uint8_t* s_win = s_arg + n_x2 * C1;  // [p][o]: the pool2 window index

  const size_t P = (size_t)9 * C1 + C1 + (size_t)9 * C1 * C2 + C2;
  float* part = partial + ((size_t)c * gridDim.x + blockIdx.x) * P;
  float* p_dw1 = part;
  float* p_db1 = p_dw1 + 9 * C1;
  float* p_dw2 = p_db1 + C1;
  float* p_db2 = p_dw2 + 9 * C1 * C2;

  const bf16* w1c = w1 + (size_t)c * 9 * C1;
  for (int i = threadIdx.x; i < 9 * C1; i += blockDim.x) s_w1[i] = to_f<bf16>(w1c[i]);
  for (int i = threadIdx.x; i < C1; i += blockDim.x) s_b1[i] = b1[(size_t)c * C1 + i];
  if (kRecompute)
    for (int i = threadIdx.x; i < C2; i += blockDim.x) s_b2[i] = b2[(size_t)c * C2 + i];
  load_w2_tc(s_w2, w2 + (size_t)c * 9 * C1 * C2, L, C1, C2);
  for (int i = threadIdx.x; i < g.HP * g.WP; i += blockDim.x) s_img[i] = 0.f;
  for (int i = threadIdx.x; i < plane * L.XS; i += blockDim.x) s_x2[i] = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < plane * L.DS; i += blockDim.x) s_dz2[i] = __float2bfloat16(0.f);
  for (int p = threadIdx.x; p < n_x2; p += blockDim.x)
    s_pix[p] = (p / g.W1 + 1) * g.W1P + p % g.W1 + 1;
  __syncthreads();

  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3, q = lane >> 3;
  const int n_dg = tc_dgrad_units(g, L), n_wg = tc_wgrad_units(L);
  const int mq = L.C1P / 16, nq = L.C2P / 16;

  for (int j = 0; j < G; ++j) {
    const int b = blockIdx.x * G + j;
    if (b >= B) break;  // uniform across the block
    const bool first = (j == 0);
    const size_t img = (size_t)c * B + b;
    const bf16* g_b = gy + img * n_pool * C2;

    load_image<bf16>(s_img, x + img * H * W, g);
    // the cotangent (K4: masked in place by the recompute) and K2's index
    for (int i = threadIdx.x; i < n_pool * C2; i += blockDim.x) {
      s_g[i] = g_b[i];
      if (!kRecompute) s_win[i] = idx[img * n_pool * C2 + i];
    }
    __syncthreads();
    // stem recompute: pool1 plane and its first-match routing
    stem_pool1<bf16>(s_img, s_w1, s_b1, s_x2, s_arg, g, C1, L.XS);
    if (kRecompute) {
      __syncthreads();
      // conv2 recompute with the forward's sums: pool2's first-match member
      // and relu2' = (a2 > 0) at it
      conv2_pool2_tc(s_x2, s_w2, s_b2, g, L, C2, [&](int i, float best, int arg) {
        if (!(best > 0.f)) s_g[i] = __float2bfloat16(0.f);
        s_win[i] = (uint8_t)arg;
      });
      __syncthreads();
    }
    // pool2 backward: the cotangent lands on the indexed window position
    for (int i = threadIdx.x; i < n_pool * C2; i += blockDim.x) {
      int o = i % C2, p = i / C2;
      int ph = p / g.Wo, pw = p - ph * g.Wo;
      int win = s_win[i];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        int r = 2 * ph + (a >> 1) + 1, qq = 2 * pw + (a & 1) + 1;
        s_dz2[(r * g.W1P + qq) * L.DS + o] = a == win ? s_g[i] : __float2bfloat16(0.f);
      }
    }
    for (int o = threadIdx.x; o < C2; o += blockDim.x) {
      float sum = 0.f;
      for (int p = 0; p < n_pool; ++p) sum += to_f<bf16>(s_g[p * C2 + o]);
      p_db2[o] = first ? sum : p_db2[o] + sum;
    }
    __syncthreads();

    // conv2 dgrad on the tensor cores, masked by relu1' = (x2 > 0)
    for (int u = warp; u < n_dg; u += warps) {
      const int mt = u / mq, np = u - mt * mq;
      const int pa = mt * 16 + (lane & 15);
      const bool valid = pa < n_x2;
      // pixel pa's place in the padded plane, plus one row and column: tap
      // (dh, dw) subtracts dh * W1P + dw
      const int base = valid ? s_pix[pa] + g.W1P + 1 : 0;
      const uint32_t dz_lane = smem_addr(s_dz2 + (lane >> 4) * 8);
      const uint32_t w_lane =
          smem_addr(s_w2 + (size_t)(np * 16 + (lane & 7) + ((lane >> 4) << 3)) * L.LW +
                    ((lane >> 3) & 1) * 8);
      float acc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[nt][v] = 0.f;
      for (int k = 0; k < 9; ++k) {
        // tap k of pixel (h, w) reads dz2 at (h - dh + 1, w - dw + 1), plane
        // row h - dh + 2; a pixel past the plane reads its zero corner
        const int pix = valid ? base - (k / 3) * g.W1P - k % 3 : 0;
        const uint32_t a_addr = dz_lane + pix * L.DS * 2;
        const uint32_t b_addr = w_lane + k * L.C1P * L.LW * 2;
        for (int o0 = 0; o0 < L.C2P; o0 += 16) {
          uint32_t a[4], bf[4];
          ldmatrix_x4(a, a_addr + o0 * 2);
          ldmatrix_x4(bf, b_addr + o0 * 2);
          mma_bf16_m16n8k16(acc[0], a, bf[0], bf[1]);
          mma_bf16_m16n8k16(acc[1], a, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = mt * 16 + gq + 8 * half;
          if (p >= n_x2) continue;
          const bf16* xv = s_x2 + s_pix[p] * L.XS;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ci = np * 16 + nt * 8 + 2 * t4 + e;
            if (ci < C1)
              s_dx2[p * C1 + ci] = to_f<bf16>(xv[ci]) > 0.f ? acc[nt][2 * half + e] : 0.f;
          }
        }
    }
    // conv2 wgrad on the tensor cores, dense over the pixels (dz2 is zero off
    // the routed member), added to the slot image by image
    for (int u = warps - 1 - warp; u < n_wg; u += warps) {
      const int tap = u / (mq * nq), rem = u - tap * mq * nq, mt = rem / nq, np = rem - mt * nq;
      const int shift = (tap / 3 - 1) * g.W1P + tap % 3 - 1;
      float acc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[nt][v] = 0.f;
      for (int kp = 0; kp < n_x2; kp += 16) {
        // x2's lane rows: pixels kp + (lane & 7) + (q >> 1) * 8 shifted by
        // the tap, channels (q & 1) * 8 on; dz2's: pixel kp + (lane & 15),
        // outputs (lane >> 4) * 8 on. Pixels past the plane read a zero
        // corner.
        const int pa = kp + (lane & 7) + (q >> 1) * 8, pb = kp + (lane & 15);
        const int xa = pa < n_x2 ? s_pix[pa] + shift : 0, xb = pb < n_x2 ? s_pix[pb] : 0;
        uint32_t a[4], bq[4];
        ldmatrix_x4_trans(a, smem_addr(s_x2 + (size_t)xa * L.XS + mt * 16 + (q & 1) * 8));
        ldmatrix_x4_trans(bq, smem_addr(s_dz2 + (size_t)xb * L.DS + np * 16 + (lane >> 4) * 8));
        mma_bf16_m16n8k16(acc[0], a, bq[0], bq[1]);
        mma_bf16_m16n8k16(acc[1], a, bq[2], bq[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ci = mt * 16 + gq + 8 * half, o = np * 16 + nt * 8 + 2 * t4;
          if (ci >= C1) continue;
          float* d = p_dw2 + (size_t)(tap * C1 + ci) * C2 + o;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (o + e < C2) d[e] = first ? acc[nt][2 * half + e] : d[e] + acc[nt][2 * half + e];
        }
    }
    __syncthreads();

    // stem backward: dz1 is dx2 at the pool1 winner, zero elsewhere. A
    // thread owns a channel o and every n_grp-th pooled-1 position: it reads
    // each dx2 once for db1 and, rounded, for the nine taps of dw1; the
    // groups' partial sums are then added in group order (deterministic)
    for (int e = threadIdx.x; e < n_grp * C1; e += blockDim.x) {
      const int o = e % C1, grp = e / C1;
      float acc[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) acc[k] = 0.f;
      for (int p = grp; p < n_x2; p += n_grp) {
        const float d = s_dx2[p * C1 + o];
        acc[9] += d;
        const float v = round_to<bf16>(d);
        if (v == 0.f) continue;
        const int win = s_arg[p * C1 + o];
        const int h = p / g.W1, w = p - h * g.W1;
        const float* im = s_img + (2 * h + (win >> 1)) * g.WP + 2 * w + (win & 1);
#pragma unroll
        for (int k = 0; k < 9; ++k) acc[k] = fmaf(im[(k / 3) * g.WP + k % 3], v, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < 10; ++k) s_red[(grp * 10 + k) * C1 + o] = acc[k];
    }
    __syncthreads();
    // e = k * C1 + o: dw1 [k][o] for k < 9, db1 for k = 9
    for (int e = threadIdx.x; e < 10 * C1; e += blockDim.x) {
      float sum = 0.f;
      for (int grp = 0; grp < n_grp; ++grp) sum += s_red[grp * 10 * C1 + e];
      float* d = e < 9 * C1 ? p_dw1 + e : p_db1 + (e - 9 * C1);
      *d = first ? sum : *d + sum;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
conv_block_bwd_kernel(const T* __restrict__ gy, const uint8_t* __restrict__ idx,
                      const T* __restrict__ x, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      float* __restrict__ partial, int B, int H, int W, int C1, int C2,
                      int G) {
  bwd_body<T, false>(gy, idx, x, w1, b1, w2, nullptr, partial, B, H, W, C1, C2, G);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
conv_stack_bwd_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                      const T* __restrict__ w1, const float* __restrict__ b1,
                      const T* __restrict__ w2, const float* __restrict__ b2,
                      float* __restrict__ partial, int B, int H, int W, int C1, int C2,
                      int G) {
  bwd_body<T, true>(gy, nullptr, x, w1, b1, w2, b2, partial, B, H, W, C1, C2, G);
}

__global__ void __launch_bounds__(kMaxThreads)
conv_block_bwd_tc_kernel(const bf16* __restrict__ gy, const uint8_t* __restrict__ idx,
                         const bf16* __restrict__ x, const bf16* __restrict__ w1,
                         const float* __restrict__ b1, const bf16* __restrict__ w2,
                         float* __restrict__ partial, int B, int H, int W, int C1, int C2,
                         int G) {
  bwd_tc_body<false>(gy, idx, x, w1, b1, w2, nullptr, partial, B, H, W, C1, C2, G);
}

__global__ void __launch_bounds__(kMaxThreads)
conv_stack_bwd_tc_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ x,
                         const bf16* __restrict__ w1, const float* __restrict__ b1,
                         const bf16* __restrict__ w2, const float* __restrict__ b2,
                         float* __restrict__ partial, int B, int H, int W, int C1, int C2,
                         int G) {
  bwd_tc_body<true>(gy, nullptr, x, w1, b1, w2, b2, partial, B, H, W, C1, C2, G);
}

// Dynamic shared memory of `kernel` up to `smem`, then the launch.
template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, int threads, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// idx == nullptr launches the residual-free forward (K4), else K1. The dtype
// fixes the route: f32 fwd_body on the CUDA cores, bf16 fwd_tc_body.
template <typename T>
int launch_fwd(const void* x, const void* w1, const float* b1, const void* w2,
               const float* b2, void* pooled, uint8_t* idx, int C, int B, int H, int W,
               int C1, int C2, int G, int threads, cudaStream_t stream) {
  const Geometry g(H, W);
  const dim3 grid((B + G - 1) / G, C);
  const T *xt = (const T*)x, *w1t = (const T*)w1, *w2t = (const T*)w2;
  T* out = (T*)pooled;
  cudaError_t e;
  if constexpr (std::is_same_v<T, bf16>) {
    const size_t smem = tc_fwd_smem_bytes(g, C1, C2);
    e = idx ? launch_with_smem(conv_block_fwd_tc_kernel, grid, threads, smem, stream, xt, w1t,
                               b1, w2t, b2, out, idx, B, H, W, C1, C2, G)
            : launch_with_smem(conv_stack_fwd_tc_kernel, grid, threads, smem, stream, xt, w1t,
                               b1, w2t, b2, out, B, H, W, C1, C2, G);
  } else {
    const size_t smem = fwd_smem_bytes(g, C1, C2, sizeof(T));
    e = idx ? launch_with_smem(conv_block_fwd_kernel<T>, grid, threads, smem, stream, xt, w1t,
                               b1, w2t, b2, out, idx, B, H, W, C1, C2, G)
            : launch_with_smem(conv_stack_fwd_kernel<T>, grid, threads, smem, stream, xt, w1t,
                               b1, w2t, b2, out, B, H, W, C1, C2, G);
  }
  return (int)e;
}

// idx == nullptr launches the residual-free backward (K4, which needs b2),
// else K2; the dtype fixes the route (bf16: bwd_tc_body, the conv2 products
// on the tensor cores); both are followed by the fixed-order reduction of
// the slots.
template <typename T>
int launch_bwd(const void* gy, const uint8_t* idx, const void* x, const void* w1,
               const float* b1, const void* w2, const float* b2, float* partial, float* out,
               int C, int B, int H, int W, int C1, int C2, int G, int threads,
               cudaStream_t stream) {
  const Geometry g(H, W);
  const dim3 grid((B + G - 1) / G, C);
  const T *gyt = (const T*)gy, *xt = (const T*)x, *w1t = (const T*)w1, *w2t = (const T*)w2;
  cudaError_t e;
  if constexpr (std::is_same_v<T, bf16>) {
    const size_t smem = tc_bwd_smem_bytes(g, C1, C2, idx == nullptr);
    e = idx ? launch_with_smem(conv_block_bwd_tc_kernel, grid, threads, smem, stream, gyt, idx,
                               xt, w1t, b1, w2t, partial, B, H, W, C1, C2, G)
            : launch_with_smem(conv_stack_bwd_tc_kernel, grid, threads, smem, stream, gyt, xt,
                               w1t, b1, w2t, b2, partial, B, H, W, C1, C2, G);
  } else {
    e = idx ? launch_with_smem(conv_block_bwd_kernel<T>, grid, threads,
                               bwd_smem_bytes(g, C1, C2, sizeof(T), false), stream, gyt, idx,
                               xt, w1t, b1, w2t, partial, B, H, W, C1, C2, G)
            : launch_with_smem(conv_stack_bwd_kernel<T>, grid, threads,
                               bwd_smem_bytes(g, C1, C2, sizeof(T), true), stream, gyt, xt, w1t,
                               b1, w2t, b2, partial, B, H, W, C1, C2, G);
  }
  if (e != cudaSuccess) return (int)e;
  return launch_reduce_partials(partial, out, C, (B + G - 1) / G,
                                9 * C1 + C1 + 9 * C1 * C2 + C2, stream);
}

bool bad_threads(int threads) {
  return threads < 32 || threads > kMaxThreads || threads % 32;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer is device memory; the
// return value is the cudaError_t of the launches (0 = success).
extern "C" int fl_conv_block_fwd(int dtype, const void* x, const void* w1, const float* b1,
                                 const void* w2, const float* b2, void* pooled, uint8_t* idx,
                                 int C, int B, int H, int W, int C1, int C2, int G,
                                 int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_threads(threads) || idx == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fwd<float>(x, w1, b1, w2, b2, pooled, idx, C, B, H, W, C1, C2, G, threads,
                             s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w1, b1, w2, b2, pooled, idx, C, B, H, W, C1, C2, G,
                                     threads, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int fl_conv_block_bwd(int dtype, const void* gy, const uint8_t* idx, const void* x,
                                 const void* w1, const float* b1, const void* w2,
                                 float* partial, float* out, int C, int B, int H, int W, int C1,
                                 int C2, int G, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_threads(threads) || idx == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(gy, idx, x, w1, b1, w2, nullptr, partial, out, C, B, H, W, C1,
                             C2, G, threads, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(gy, idx, x, w1, b1, w2, nullptr, partial, out, C, B, H,
                                     W, C1, C2, G, threads, s);
  return (int)cudaErrorInvalidValue;
}

// K4: the forward writes no index, the backward takes none (and no pooled).
extern "C" int fl_conv_stack_fwd(int dtype, const void* x, const void* w1, const float* b1,
                                 const void* w2, const float* b2, void* pooled, int C, int B,
                                 int H, int W, int C1, int C2, int G, int threads,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_threads(threads)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fwd<float>(x, w1, b1, w2, b2, pooled, nullptr, C, B, H, W, C1, C2, G,
                             threads, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w1, b1, w2, b2, pooled, nullptr, C, B, H, W, C1, C2,
                                     G, threads, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int fl_conv_stack_bwd(int dtype, const void* gy, const void* x, const void* w1,
                                 const float* b1, const void* w2, const float* b2,
                                 float* partial, float* out, int C, int B, int H, int W, int C1,
                                 int C2, int G, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_threads(threads)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(gy, nullptr, x, w1, b1, w2, b2, partial, out, C, B, H, W, C1, C2,
                             G, threads, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(gy, nullptr, x, w1, b1, w2, b2, partial, out, C, B, H, W,
                                     C1, C2, G, threads, s);
  return (int)cudaErrorInvalidValue;
}

// which: 0 = either forward, 1 = K2's backward, 2 = K4's backward
extern "C" size_t fl_conv_block_smem_bytes(int which, int dtype, int H, int W, int C1,
                                           int C2) {
  const Geometry g(H, W);
  if (dtype == 1)
    return which ? tc_bwd_smem_bytes(g, C1, C2, which == 2) : tc_fwd_smem_bytes(g, C1, C2);
  return which ? bwd_smem_bytes(g, C1, C2, sizeof(float), which == 2)
               : fwd_smem_bytes(g, C1, C2, sizeof(float));
}

extern "C" const char* fl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
