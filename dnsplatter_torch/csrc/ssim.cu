// The SSIM term of the photometric loss and its gradient, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's `ssim`
// (dnsplatter_tpu/models/losses.py) is plain jnp, which XLA fuses. Run
// eagerly by PyTorch, `models/losses.ssim_plain` blurs five moment maps with
// 11-tap passes of weighted shifted slices: some 220 image-size launches
// forward, and autograd's backward of three of those blurs about 300 more
// (a zero fill and a strided copy for every slice), about 25 GB of traffic a
// step at 1600x1200x3. Same function as `ssim_plain` on (H, W, C) float32
// images x, y with the window w (K taps, from `_gaussian_window`):
//
//   blur(t)  = the VALID separable blur, rows first: v(r, q) = sum_i w[i]
//              t(r + i, q), then b(r, q) = sum_j w[j] v(r, q + j), each sum
//              from 0 in tap order, each product and sum rounded apart
//   mx, my   = blur(x), blur(y); sxx, syy, sxy = blur(x x), blur(y y),
//              blur(x y)
//   vx = max(sxx - mx mx, 0), vy = max(syy - my my, 0), cxy = sxy - mx my
//   S  = (2 mx my + c1)(2 cxy + c2) / ((mx mx + my my + c1)(vx + vy + c2))
//   forward:  mean(S) over C x (H - K + 1) x (W - K + 1)
//   backward: dL/dx(q) = g / M sum_p w(p - q) [A(p) + 2 x(q) B(p) + y(q) C(p)]
//             with A, B, C the partials of S(p) in mx, sxx and sxy
//
// Rounding. The forward rounds each product and each sum where the plain
// version's elementwise ops round them, in its order (__fmul_rn, __fadd_rn,
// ...: nvcc would otherwise contract a product and a sum into one FMA), so
// the per-pixel map is the plain map bit for bit; the mean is a sum in
// float64 in a fixed order (per thread, a tree over the CTA, then over the
// CTAs), so two runs give the same bits. The backward rounds apart too, in
// its own order, and passes half the gradient where a variance ties its
// clamp at exactly 0, as autograd does for torch.maximum.
//
// What bounds it. Bytes, counted once: x and y (8 B a pixel and channel)
// forward; x, y and dx (12 B) backward. The work is larger than that: every
// blur tap is a separate multiply and add, about 300 FP32 instructions an
// output forward and 500 backward, on operands from shared memory.
//
// Design:
// 1. A CTA of 256 threads owns a tile of 16 x 32 output pixels and every
//    channel. It stages the tile's input with its halo, K - 1 rows and
//    columns, in the images' interleaved (H, W, C) layout: each staged row
//    is one contiguous run of (32 + K - 1) C floats, read by neighbouring
//    threads at neighbouring addresses, 16 bytes a thread where the row's
//    start allows. Then, a channel at a time, the vertical pass writes the
//    five maps' column sums to shared memory and the horizontal pass reads
//    them back, both with neighbouring threads on neighbouring words (a
//    channel's lanes in the staged rows are C words apart: C = 3 meets no
//    bank conflict). The window lives in registers.
// 2. Forward (`ssim_moments_kernel<false>`): each thread sums its pixels'
//    SSIM in float64; the CTA adds the 256 sums in a tree and writes one
//    partial; `ssim_mean_kernel` adds the partials in order and divides.
//    Two launches.
// 3. Backward: the same kernel (`<true>`) recomputes the moments and writes
//    A, B and C, one plane each per channel (3 C (H - K + 1)(W - K + 1)
//    floats, scratch the caller owns); `ssim_grad_kernel` blurs them back
//    with the transposed window, zero outside the valid region, a tile of
//    16 x 32 input pixels a CTA and a channel at a time, and writes dx with
//    the upstream gradient, read on the device, over M. Two launches.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssim.so ssim.cu
// The kernels allocate nothing and do not synchronise; the caller owns every
// buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 11;  // the largest window
constexpr int kMaxC = 4;  // the most channels
constexpr int kThreads = 256;
constexpr int kTileH = 16;  // output rows a CTA
constexpr int kTileW = 32;  // output columns a CTA
constexpr int kInH = kTileH + kMaxK - 1;
constexpr int kInW = kTileW + kMaxK - 1;

struct Shape {
  int k, h, w, c;
  int oh, ow;  // the valid region: h - k + 1, w - k + 1
};

// One rounding each, as PyTorch's elementwise ops round.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.maximum(v, 0): a NaN passes.
__device__ __forceinline__ float clamp0(float v) { return v < 0.0f ? 0.0f : v; }

// The share of the gradient torch.maximum(v, 0) passes to v: half at a tie,
// all of it for a NaN.
__device__ __forceinline__ float clamp0_share(float v) {
  return v < 0.0f ? 0.0f : (v == 0.0f ? 0.5f : 1.0f);
}

struct Terms {
  float mx, my, mxx, myy, rx, ry, n1, n2, d1, d2, s;
};

// The SSIM of one pixel from its five blurred moments, in ssim_plain's
// order.
__device__ __forceinline__ Terms ssim_terms(float mx, float my, float sxx,
                                            float syy, float sxy, float c1,
                                            float c2) {
  Terms t;
  t.mx = mx;
  t.my = my;
  t.mxx = mul(mx, mx);
  t.myy = mul(my, my);
  const float mxy = mul(mx, my);
  t.rx = sub(sxx, t.mxx);
  t.ry = sub(syy, t.myy);
  const float cxy = sub(sxy, mxy);
  t.n1 = add(mul(2.0f, mxy), c1);
  t.n2 = add(mul(2.0f, cxy), c2);
  t.d1 = add(add(t.mxx, t.myy), c1);
  t.d2 = add(add(clamp0(t.rx), clamp0(t.ry)), c2);
  t.s = dvd(mul(t.n1, t.n2), mul(t.d1, t.d2));
  return t;
}

// The partials of S in mx (a), sxx (b) and sxy (c), by the chain autograd
// takes through ssim_plain.
__device__ __forceinline__ void ssim_partials(const Terms& t, float* a,
                                              float* b, float* c) {
  const float den = mul(t.d1, t.d2);
  const float g_num = dvd(1.0f, den);
  const float g_den = -dvd(t.s, den);
  const float g_n1 = mul(g_num, t.n2);
  const float g_n2 = mul(g_num, t.n1);
  const float g_d1 = mul(g_den, t.d2);
  const float g_d2 = mul(g_den, t.d1);
  *c = mul(2.0f, g_n2);
  *b = mul(clamp0_share(t.rx), g_d2);
  const float g_mxx = sub(g_d1, *b);
  const float g_mxy = sub(mul(2.0f, g_n1), *c);
  *a = add(mul(mul(2.0f, g_mxx), t.mx), mul(g_mxy, t.my));
}

// Forward (kGrad false): the partial sum of S over the CTA's tile, and with
// `map` S itself, planar (C, oh, ow). Backward (kGrad true): A, B and C of
// every valid pixel, planes (3, C, oh, ow).
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
    ssim_moments_kernel(const float* __restrict__ x,
                        const float* __restrict__ y,
                        const float* __restrict__ win, Shape g, float c1,
                        float c2, double* __restrict__ partials,
                        float* __restrict__ map, float* __restrict__ abc) {
  __shared__ __align__(16) float img[2][kInH][kInW * kMaxC];
  // aligned for the CTA's float64 sums, which reuse its words
  __shared__ __align__(8) float vert[5][kTileH][kInW];
  __shared__ float wsh[kMaxK];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTileH;
  const int q0 = blockIdx.x * kTileW;
  const int k = g.k, c = g.c;
  if (tid < k) wsh[tid] = win[tid];
  // stage rows r0 .. r0 + kTileH + k - 2 and columns q0 .. q0 + kTileW + k
  // - 2, every channel, four lanes a thread (up to 3 more than the tile
  // needs, unread); zeros past the image feed only pixels outside the
  // valid region. A quad that starts on 16 bytes inside its row is one
  // 16-byte load (every quad where W C is a multiple of 4: lane0 is),
  // else four.
  const int in_h = kTileH + k - 1;
  const int in_quads = ((kTileW + k - 1) * c + 3) / 4;
  const int row_lanes = g.w * c;
  const int lane0 = q0 * c;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  for (int i = tid; i < in_h * in_quads; i += kThreads) {
    const int rr = i / in_quads, l = (i - rr * in_quads) * 4;
    const int r = r0 + rr, lane = lane0 + l;
    const size_t off = static_cast<size_t>(r) * row_lanes + lane;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
    if (r < g.h && aligned && (off & 3) == 0 && lane + 3 < row_lanes) {
      a = *reinterpret_cast<const float4*>(x + off);
      b = *reinterpret_cast<const float4*>(y + off);
    } else if (r < g.h) {
      if (lane < row_lanes) a.x = x[off], b.x = y[off];
      if (lane + 1 < row_lanes) a.y = x[off + 1], b.y = y[off + 1];
      if (lane + 2 < row_lanes) a.z = x[off + 2], b.z = y[off + 2];
      if (lane + 3 < row_lanes) a.w = x[off + 3], b.w = y[off + 3];
    }
    *reinterpret_cast<float4*>(&img[0][rr][l]) = a;
    *reinterpret_cast<float4*>(&img[1][rr][l]) = b;
  }
  __syncthreads();
  float w[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) w[j] = j < k ? wsh[j] : 0.0f;
  const int vw = kTileW + k - 1;
  const size_t plane = static_cast<size_t>(g.oh) * g.ow;
  double acc = 0.0;
  for (int ch = 0; ch < c; ++ch) {
    // vertical: kTileH rows of vw column sums of x, y, x x, y y, x y
    for (int i = tid; i < kTileH * vw; i += kThreads) {
      const int rr = i / vw, cc = i - rr * vw;
      const int l = cc * c + ch;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, s4 = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j < k) {
          const float a = img[0][rr + j][l], b = img[1][rr + j][l];
          s0 = add(s0, mul(w[j], a));
          s1 = add(s1, mul(w[j], b));
          s2 = add(s2, mul(w[j], mul(a, a)));
          s3 = add(s3, mul(w[j], mul(b, b)));
          s4 = add(s4, mul(w[j], mul(a, b)));
        }
      }
      vert[0][rr][cc] = s0;
      vert[1][rr][cc] = s1;
      vert[2][rr][cc] = s2;
      vert[3][rr][cc] = s3;
      vert[4][rr][cc] = s4;
    }
    __syncthreads();
    // horizontal, then the pixel's SSIM (or its partials)
    for (int i = tid; i < kTileH * kTileW; i += kThreads) {
      const int rr = i / kTileW, cc = i - rr * kTileW;
      const int r = r0 + rr, q = q0 + cc;
      if (r >= g.oh || q >= g.ow) continue;
      float m[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j < k) {
#pragma unroll
          for (int n = 0; n < 5; ++n)
            m[n] = add(m[n], mul(w[j], vert[n][rr][cc + j]));
        }
      }
      const Terms t = ssim_terms(m[0], m[1], m[2], m[3], m[4], c1, c2);
      const size_t o = (static_cast<size_t>(ch) * g.oh + r) * g.ow + q;
      if constexpr (kGrad) {
        float a, b, cp;
        ssim_partials(t, &a, &b, &cp);
        abc[o] = a;
        abc[o + plane * c] = b;
        abc[o + 2 * plane * c] = cp;
      } else {
        acc += static_cast<double>(t.s);
        if (map != nullptr) map[o] = t.s;
      }
    }
    __syncthreads();  // vert is rewritten by the next channel
  }
  if constexpr (kGrad) return;
  // the CTA's sum: a tree over the threads' sums, in vert's words
  double* red = reinterpret_cast<double*>(&vert[0][0][0]);
  red[tid] = acc;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

// The mean: the partials added in a fixed order, over M.
__global__ void __launch_bounds__(kThreads)
    ssim_mean_kernel(const double* __restrict__ partials, int n, double m,
                     float* __restrict__ out) {
  __shared__ double red[kThreads];
  const int tid = threadIdx.x;
  double s = 0.0;
  for (int i = tid; i < n; i += kThreads) s += partials[i];
  red[tid] = s;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  if (tid == 0) out[0] = static_cast<float>(red[0] / m);
}

// dx over a tile of kTileH x kTileW input pixels: the transposed blur of A,
// B and C (zero outside the valid region), columns first, then
// g / M (bA + 2 x bB + y bC).
__global__ void __launch_bounds__(kThreads)
    ssim_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ win, Shape g,
                     const float* __restrict__ abc,
                     const float* __restrict__ grad, float* __restrict__ dx) {
  __shared__ float src[3][kInH][kInW];
  __shared__ float hor[3][kInH][kTileW];
  __shared__ float wsh[kMaxK];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTileH;
  const int q0 = blockIdx.x * kTileW;
  const int k = g.k, c = g.c;
  if (tid < k) wsh[tid] = win[tid];
  __syncthreads();
  float w[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) w[j] = j < k ? wsh[j] : 0.0f;
  const float m_count = static_cast<float>(
      static_cast<double>(c) * g.oh * g.ow);
  const float scale = dvd(grad[0], m_count);
  const int in_h = kTileH + k - 1, in_w = kTileW + k - 1;
  const size_t plane = static_cast<size_t>(g.oh) * g.ow;
  for (int ch = 0; ch < c; ++ch) {
    // rows r0 - k + 1 .. r0 + kTileH - 1, columns q0 - k + 1 .. q0 + kTileW
    // - 1 of the three planes
    for (int i = tid; i < in_h * in_w; i += kThreads) {
      const int rr = i / in_w, cc = i - rr * in_w;
      const int r = r0 - k + 1 + rr, q = q0 - k + 1 + cc;
      float v[3] = {0.0f, 0.0f, 0.0f};
      if (r >= 0 && r < g.oh && q >= 0 && q < g.ow) {
        const size_t o = (static_cast<size_t>(ch) * g.oh + r) * g.ow + q;
#pragma unroll
        for (int n = 0; n < 3; ++n) v[n] = abc[o + n * plane * c];
      }
#pragma unroll
      for (int n = 0; n < 3; ++n) src[n][rr][cc] = v[n];
    }
    __syncthreads();
    // horizontal: hor(rr, cc) = sum_j w[j] src(rr, cc + k - 1 - j)
    for (int i = tid; i < in_h * kTileW; i += kThreads) {
      const int rr = i / kTileW, cc = i - rr * kTileW;
      float s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j < k) {
#pragma unroll
          for (int n = 0; n < 3; ++n)
            s[n] = add(s[n], mul(w[j], src[n][rr][cc + k - 1 - j]));
        }
      }
#pragma unroll
      for (int n = 0; n < 3; ++n) hor[n][rr][cc] = s[n];
    }
    __syncthreads();
    // vertical, then dx
    for (int i = tid; i < kTileH * kTileW; i += kThreads) {
      const int rr = i / kTileW, cc = i - rr * kTileW;
      const int r = r0 + rr, q = q0 + cc;
      if (r >= g.h || q >= g.w) continue;
      float s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j < k) {
#pragma unroll
          for (int n = 0; n < 3; ++n)
            s[n] = add(s[n], mul(w[j], hor[n][rr + k - 1 - j][cc]));
        }
      }
      const size_t off = (static_cast<size_t>(r) * g.w + q) * c + ch;
      const float xv = x[off], yv = y[off];
      const float sum = add(add(s[0], mul(mul(2.0f, xv), s[1])),
                            mul(yv, s[2]));
      dx[off] = mul(scale, sum);
    }
    __syncthreads();  // src and hor are rewritten by the next channel
  }
}

bool bad_shape(int k, int h, int w, int c) {
  return k < 1 || k > kMaxK || c < 1 || c > kMaxC || h < k || w < k ||
         static_cast<long long>(h) * w * c >= (1LL << 31);
}

Shape make_shape(int k, int h, int w, int c) {
  return Shape{k, h, w, c, h - k + 1, w - k + 1};
}

dim3 tiles(int rows, int cols) {
  return dim3((cols + kTileW - 1) / kTileW, (rows + kTileH - 1) / kTileH);
}

}  // namespace

// Mean SSIM of x and y, (h, w, c) float32, with the window win (k floats,
// device) and `consts`, on the host, the float32 c1 and c2: partials holds
// n_partials doubles, one a tile of the valid region (ceil((w - k + 1) / 32)
// * ceil((h - k + 1) / 16)); out is one float; map, if not null, receives
// the per-pixel SSIM, planar (c, h - k + 1, w - k + 1).
extern "C" int dns_ssim(const void* x, const void* y, const void* win, int k,
                        int h, int w, int c, const void* consts,
                        void* partials, int n_partials, void* out, void* map,
                        void* stream) {
  if (bad_shape(k, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape g = make_shape(k, h, w, c);
  const dim3 grid = tiles(g.oh, g.ow);
  if (static_cast<long long>(grid.x) * grid.y != n_partials)
    return static_cast<int>(cudaErrorInvalidValue);
  const float c1 = static_cast<const float*>(consts)[0];
  const float c2 = static_cast<const float*>(consts)[1];
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<double*>(partials);
  ssim_moments_kernel<false><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(win), g, c1, c2, p, static_cast<float*>(map),
      nullptr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssim_mean_kernel<<<1, kThreads, 0, s>>>(
      p, n_partials, static_cast<double>(c) * g.oh * g.ow,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// dx (h, w, c) of the mean SSIM for its gradient grad (one float, device):
// abc is scratch of 3 c (h - k + 1)(w - k + 1) floats.
extern "C" int dns_ssim_backward(const void* x, const void* y, const void* win,
                                 int k, int h, int w, int c,
                                 const void* consts, const void* grad,
                                 void* abc, void* dx, void* stream) {
  if (bad_shape(k, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape g = make_shape(k, h, w, c);
  const float c1 = static_cast<const float*>(consts)[0];
  const float c2 = static_cast<const float*>(consts)[1];
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto yf = static_cast<const float*>(y);
  auto wf = static_cast<const float*>(win);
  auto a = static_cast<float*>(abc);
  ssim_moments_kernel<true><<<tiles(g.oh, g.ow), kThreads, 0, s>>>(
      xf, yf, wf, g, c1, c2, nullptr, nullptr, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssim_grad_kernel<<<tiles(h, w), kThreads, 0, s>>>(
      xf, yf, wf, g, a, static_cast<const float*>(grad),
      static_cast<float*>(dx));
  return static_cast<int>(cudaGetLastError());
}
