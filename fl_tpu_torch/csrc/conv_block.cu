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
// wgrad, on operands that live in shared memory: the kernels are bound by
// shared-memory load bandwidth on the CUDA cores. Device memory traffic is
// small (one image in, one 7x7x64 pooled map and its uint8 index out). The
// design keeps every intermediate of an image (padded image, pool1 plane,
// the pool1 argmax, dz2, dx2) in shared memory, loads the client's weights
// once per block of IMAGES images, and gives each thread four window
// positions per weight load in the forward conv2. No tensor cores yet: that
// is later work (wgmma over the K = 9*C1 patches).
//
// K4's backward pays one more conv2 forward per image than K2 and saves the
// index and pooled residuals (2 + 1 bytes per pooled value), which K1 had
// already made small. It routes pool2 window by window as the recomputed
// conv2 outputs appear, so no a2 plane is held: only the masked cotangent
// and the window index per pooled position. It keeps one copy of w2, in
// the dgrad's [k][o][ci] order with rows padded to C1 + 1 so that both the
// recomputed forward (threads along o) and the dgrad (threads along ci)
// read it without bank conflicts; the f32 variant fits the 227 KB block
// limit at the bench shapes that way.
//
// Block layout: grid (ceil(B / G), C), a launch-time thread count; one block = one client
// and G consecutive images. K2 sums its images' weight gradients into a
// per-block slot of a partial buffer (each element owned by one thread, so
// no atomics), and a second kernel adds the ceil(B/G) slots of each client
// in a fixed order: the result is deterministic.

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
// Writes the pool1 plane into the interior of the zero-bordered s_x2 and,
// when s_arg is given, the winning window position per (h, w, o).
template <typename T>
__device__ void stem_pool1(const float* s_img, const float* s_w1, const float* s_b1,
                           T* s_x2, uint8_t* s_arg, const Geometry& g, int C1) {
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
    s_x2[((h + 1) * g.W1P + w + 1) * C1 + o] = from_f<T>(best);
    if (s_arg) s_arg[i] = (uint8_t)arg;
  }
}

// conv2 (no bias) at the four members of pool2 window (ph, pw) for output
// channel o: acc[a * 2 + b] is the f32 sum over taps k and channels ci, in
// that order, at conv2 output (2ph + a, 2pw + b). Weight (k, ci, o) sits at
// s_w[k * wk + ci * wci + o * wo].
template <typename T>
__device__ __forceinline__ void conv2_window(const T* s_x2, const T* s_w, int wk, int wci,
                                             int wo, int ph, int pw, int o,
                                             const Geometry& g, int C1, float acc[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  for (int k = 0; k < 9; ++k) {
    const T* wv_k = s_w + k * wk + o * wo;
    // tap k of output row 2ph + a reads pool1 row 2ph + a + dh - 1, which is
    // s_x2 row 2ph + a + dh
    const T* x00 = s_x2 + ((2 * ph + k / 3) * g.W1P + 2 * pw + k % 3) * C1;
    const T* x10 = x00 + g.W1P * C1;
    for (int ci = 0; ci < C1; ++ci) {
      float wv = to_f<T>(wv_k[ci * wci]);
      acc[0] = fmaf(to_f<T>(x00[ci]), wv, acc[0]);
      acc[1] = fmaf(to_f<T>(x00[C1 + ci]), wv, acc[1]);
      acc[2] = fmaf(to_f<T>(x10[ci]), wv, acc[2]);
      acc[3] = fmaf(to_f<T>(x10[C1 + ci]), wv, acc[3]);
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

// The forward of one block: kIdx also writes the pool2 window index (K1).
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
    stem_pool1<T>(s_img, s_w1, s_b1, s_x2, nullptr, g, C1);
    __syncthreads();

    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
      int o = i % C2, p = i / C2;
      float acc[4];
      conv2_window<T>(s_x2, s_w2, C1 * C2, C2, 1, p / g.Wo, p % g.Wo, o, g, C1, acc);
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
// The backward of one block. Without kRecompute (K2) the cotangent arrives
// already multiplied by relu2' and the pool2 window index comes from the
// forward. With kRecompute (K4) neither exists: per image the block runs
// conv2 again on the recomputed pool1 plane and keeps, per pooled position,
// the first-match window member and the cotangent masked by a2 > 0 in shared
// memory, where the rest of the body reads them as K2 reads its inputs.
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
    stem_pool1<T>(s_img, s_w1, s_b1, s_x2, s_arg, g, C1);
    if (kRecompute) {
      __syncthreads();
      // conv2 recompute with the forward's sums: pool2's first-match member
      // and relu2' = (a2 > 0) at it, window by window
      for (int i = threadIdx.x; i < n_pool * C2; i += blockDim.x) {
        int o = i % C2, p = i / C2;
        float acc[4];
        conv2_window<T>(s_x2, s_w2t, C2 * ldw, 1, ldw, p / g.Wo, p % g.Wo, o, g, C1, acc);
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

// idx == nullptr launches the residual-free forward (K4), else K1.
template <typename T>
int launch_fwd(const void* x, const void* w1, const float* b1, const void* w2,
               const float* b2, void* pooled, uint8_t* idx, int C, int B, int H, int W,
               int C1, int C2, int G, int threads, cudaStream_t stream) {
  const Geometry g(H, W);
  size_t smem = fwd_smem_bytes(g, C1, C2, sizeof(T));
  cudaError_t e =
      idx ? cudaFuncSetAttribute(conv_block_fwd_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
          : cudaFuncSetAttribute(conv_stack_fwd_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + G - 1) / G, C);
  if (idx)
    conv_block_fwd_kernel<T><<<grid, threads, smem, stream>>>(
        (const T*)x, (const T*)w1, b1, (const T*)w2, b2, (T*)pooled, idx, B, H, W, C1, C2, G);
  else
    conv_stack_fwd_kernel<T><<<grid, threads, smem, stream>>>(
        (const T*)x, (const T*)w1, b1, (const T*)w2, b2, (T*)pooled, B, H, W, C1, C2, G);
  return (int)cudaGetLastError();
}

// idx == nullptr launches the residual-free backward (K4, which needs b2),
// else K2; both are followed by the fixed-order reduction of the slots.
template <typename T>
int launch_bwd(const void* gy, const uint8_t* idx, const void* x, const void* w1,
               const float* b1, const void* w2, const float* b2, float* partial, float* out,
               int C, int B, int H, int W, int C1, int C2, int G, int threads,
               cudaStream_t stream) {
  const Geometry g(H, W);
  size_t smem = bwd_smem_bytes(g, C1, C2, sizeof(T), idx == nullptr);
  cudaError_t e =
      idx ? cudaFuncSetAttribute(conv_block_bwd_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
          : cudaFuncSetAttribute(conv_stack_bwd_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int NG = (B + G - 1) / G;
  dim3 grid(NG, C);
  if (idx)
    conv_block_bwd_kernel<T><<<grid, threads, smem, stream>>>(
        (const T*)gy, idx, (const T*)x, (const T*)w1, b1, (const T*)w2, partial, B, H, W, C1,
        C2, G);
  else
    conv_stack_bwd_kernel<T><<<grid, threads, smem, stream>>>(
        (const T*)gy, (const T*)x, (const T*)w1, b1, (const T*)w2, b2, partial, B, H, W, C1,
        C2, G);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_reduce_partials(partial, out, C, NG, 9 * C1 + C1 + 9 * C1 * C2 + C2, stream);
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
  size_t tsize = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  return which ? bwd_smem_bytes(g, C1, C2, tsize, which == 2)
               : fwd_smem_bytes(g, C1, C2, tsize);
}

extern "C" const char* fl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
