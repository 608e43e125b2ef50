// Spherical-harmonic colours of every Gaussian and their gradient, on Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's `eval_sh`
// (dnsplatter_tpu/ops/sh.py) is plain jnp, which XLA fuses into one pass over
// the rows. Run eagerly by PyTorch, the same function concatenated the
// coefficients into a new (N, K, 3) tensor, made some 85 launches over the
// rows, and in its backward built one zero-filled (N, K, 3) tensor for each
// basis function (the backward of `coeffs[..., k, :]`) that the autograd
// engine then summed: 16 fills and 15 adds of 720 MB each at 3.75M rows.
// Same function as `ops/sh.eval_sh(degree, cat([dc[:, None], rest], 1), dirs)`:
//
//     u      = dirs / max(|dirs|, 1e-12)
//     colour = max(sum_k basis_k(u) * coeff_k + 0.5, 0)
//
// with its basis, its constants and its order of the sum (k = 0, 1, ...).
// The gradients follow the same rules as autograd's: the clamp at 0 passes
// the gradient where the sum is >= 0 (a tie passes), the norm's clamp where
// |dirs| >= 1e-12, below which the divisor is the constant 1e-12; the
// coefficients past the active degree get exact zeros.
//
// What bounds it: bytes. At degree 3 (K = 16) a row is 12 B of direction,
// 12 B of features_dc and 180 B of features_rest. The forward reads those and
// writes a 12 B colour: 216 B. The backward reads the colour's gradient, the
// direction and both coefficient sets and writes the three gradients once
// each: 420 B. 636 B a row for the pair, against about 500 FP32 operations,
// under one operation a byte where the card does 20.
//
// Design:
// 1. One thread a row, 128 rows a CTA; the degree (0-4) is a template
//    parameter, so the basis is straight-line code in registers.
// 2. A features_rest row is 180 B, not a multiple of 16 B, and a thread that
//    read its own row would make every load of a warp touch 32 rows 180 B
//    apart. The CTA's 128 rows are one contiguous slab instead: the CTA
//    copies it into shared memory with 16-byte loads, neighbouring threads
//    on neighbouring words, and each thread then reads its row there (a row
//    stride of 45 words, odd, so a warp's reads hit 32 different banks).
//    Only the active degree's coefficients are staged; where K is larger
//    than (degree + 1)^2 the rows are copied word by word, still coalesced.
// 3. The backward writes d_features_rest over the same shared rows and the
//    CTA stores the slab with 16-byte stores, zeros in the columns past the
//    active degree: each output is written once, dense.
// 4. The direction, features_dc, the colour and their gradients are 12-byte
//    rows: three 4-byte accesses a thread, a warp's three covering the same
//    384 contiguous bytes.
// 5. The backward recomputes the colour for the clamp's mask with the
//    forward's own inline code, instead of storing it. The sum rounds each
//    product and each addition apart, in eval_sh's order, so a row that
//    torch's sum puts exactly on the clamp is on it here too.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsh_colors.so sh_colors.cu
// The kernels allocate nothing and do not synchronise; the caller owns every
// buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // rows, and threads, a CTA
constexpr float kNormEps = 1e-12f;

constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
__constant__ float C2[5] = {1.0925484305920792f, -1.0925484305920792f,
                         0.31539156525252005f, -1.0925484305920792f,
                         0.5462742152960396f};
__constant__ float C3[7] = {-0.5900435899266435f, 2.890611442640554f,
                         -0.4570457994644658f, 0.3731763325901154f,
                         -0.4570457994644658f, 1.445305721320277f,
                         -0.5900435899266435f};
__constant__ float C4[9] = {2.5033429417967046f, -1.7701307697799304f,
                         0.9461746957575601f, -0.6690465435572892f,
                         0.10578554691520431f, -0.6690465435572892f,
                         0.47308734787878004f, -1.7701307697799304f,
                         0.6258357354491761f};

template <int D>
struct Shape {
  static constexpr int kBases = (D + 1) * (D + 1);
  // active words of a features_rest row, and their row stride in shared
  // memory (odd, so that a warp reading one word a row meets no conflict)
  static constexpr int kWords = 3 * (kBases - 1);
  static constexpr int kStride = kWords % 2 ? kWords : kWords + 1;
};

// The basis at a unit direction, as ops/sh.sh_basis.
template <int D>
__device__ __forceinline__ void basis(float x, float y, float z, float* b) {
  b[0] = C0;
  if constexpr (D >= 1) {
    b[1] = -C1 * y;
    b[2] = C1 * z;
    b[3] = -C1 * x;
  }
  if constexpr (D >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = C2[0] * xy;
    b[5] = C2[1] * yz;
    b[6] = C2[2] * (2.0f * zz - xx - yy);
    b[7] = C2[3] * xz;
    b[8] = C2[4] * (xx - yy);
    if constexpr (D >= 3) {
      b[9] = C3[0] * y * (3.0f * xx - yy);
      b[10] = C3[1] * xy * z;
      b[11] = C3[2] * y * (4.0f * zz - xx - yy);
      b[12] = C3[3] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = C3[4] * x * (4.0f * zz - xx - yy);
      b[14] = C3[5] * z * (xx - yy);
      b[15] = C3[6] * x * (xx - 3.0f * yy);
    }
    if constexpr (D >= 4) {
      b[16] = C4[0] * xy * (xx - yy);
      b[17] = C4[1] * yz * (3.0f * xx - yy);
      b[18] = C4[2] * xy * (7.0f * zz - 1.0f);
      b[19] = C4[3] * yz * (7.0f * zz - 3.0f);
      b[20] = C4[4] * (zz * (35.0f * zz - 30.0f) + 3.0f);
      b[21] = C4[5] * xz * (7.0f * zz - 3.0f);
      b[22] = C4[6] * (xx - yy) * (7.0f * zz - 1.0f);
      b[23] = C4[7] * xz * (xx - 3.0f * yy);
      b[24] = C4[8] * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
}

// du += sum_k db[k] * d basis_k / du at the unit direction (x, y, z).
template <int D>
__device__ __forceinline__ void basis_vjp(float x, float y, float z,
                                          const float* db, float* du) {
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if constexpr (D >= 1) {
    gy -= C1 * db[1];
    gz += C1 * db[2];
    gx -= C1 * db[3];
  }
  if constexpr (D >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    gx += C2[0] * y * db[4];
    gy += C2[0] * x * db[4];
    gy += C2[1] * z * db[5];
    gz += C2[1] * y * db[5];
    gx -= C2[2] * 2.0f * x * db[6];
    gy -= C2[2] * 2.0f * y * db[6];
    gz += C2[2] * 4.0f * z * db[6];
    gx += C2[3] * z * db[7];
    gz += C2[3] * x * db[7];
    gx += C2[4] * 2.0f * x * db[8];
    gy -= C2[4] * 2.0f * y * db[8];
    if constexpr (D >= 3) {
      gx += C3[0] * 6.0f * x * y * db[9];
      gy += C3[0] * 3.0f * (xx - yy) * db[9];
      gx += C3[1] * y * z * db[10];
      gy += C3[1] * x * z * db[10];
      gz += C3[1] * x * y * db[10];
      gx -= C3[2] * 2.0f * x * y * db[11];
      gy += C3[2] * (4.0f * zz - xx - 3.0f * yy) * db[11];
      gz += C3[2] * 8.0f * y * z * db[11];
      gx -= C3[3] * 6.0f * x * z * db[12];
      gy -= C3[3] * 6.0f * y * z * db[12];
      gz += C3[3] * (6.0f * zz - 3.0f * xx - 3.0f * yy) * db[12];
      gx += C3[4] * (4.0f * zz - 3.0f * xx - yy) * db[13];
      gy -= C3[4] * 2.0f * x * y * db[13];
      gz += C3[4] * 8.0f * x * z * db[13];
      gx += C3[5] * 2.0f * x * z * db[14];
      gy -= C3[5] * 2.0f * y * z * db[14];
      gz += C3[5] * (xx - yy) * db[14];
      gx += C3[6] * 3.0f * (xx - yy) * db[15];
      gy -= C3[6] * 6.0f * x * y * db[15];
    }
    if constexpr (D >= 4) {
      const float a1 = 7.0f * zz - 1.0f, a3 = 7.0f * zz - 3.0f;
      gx += C4[0] * y * (3.0f * xx - yy) * db[16];
      gy += C4[0] * x * (xx - 3.0f * yy) * db[16];
      gx += C4[1] * 6.0f * x * y * z * db[17];
      gy += C4[1] * 3.0f * z * (xx - yy) * db[17];
      gz += C4[1] * y * (3.0f * xx - yy) * db[17];
      gx += C4[2] * y * a1 * db[18];
      gy += C4[2] * x * a1 * db[18];
      gz += C4[2] * 14.0f * x * y * z * db[18];
      gy += C4[3] * z * a3 * db[19];
      gz += C4[3] * y * (21.0f * zz - 3.0f) * db[19];
      gz += C4[4] * z * (140.0f * zz - 60.0f) * db[20];
      gx += C4[5] * z * a3 * db[21];
      gz += C4[5] * x * (21.0f * zz - 3.0f) * db[21];
      gx += C4[6] * 2.0f * x * a1 * db[22];
      gy -= C4[6] * 2.0f * y * a1 * db[22];
      gz += C4[6] * 14.0f * z * (xx - yy) * db[22];
      gx += C4[7] * 3.0f * z * (xx - yy) * db[23];
      gy -= C4[7] * 6.0f * x * y * z * db[23];
      gz += C4[7] * x * (xx - 3.0f * yy) * db[23];
      gx += C4[8] * 4.0f * x * (xx - 3.0f * yy) * db[24];
      gy += C4[8] * 4.0f * y * (yy - 3.0f * xx) * db[24];
    }
  }
  du[0] += gx;
  du[1] += gy;
  du[2] += gz;
}

// The unit direction of row g and the divisor it was scaled by.
__device__ __forceinline__ float unit(const float* __restrict__ dirs,
                                      long long g, float* u, float* norm) {
  const float dx = __ldg(dirs + 3 * g), dy = __ldg(dirs + 3 * g + 1),
              dz = __ldg(dirs + 3 * g + 2);
  *norm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float m = fmaxf(*norm, kNormEps);
  u[0] = dx / m;
  u[1] = dy / m;
  u[2] = dz / m;
  return m;
}

// The colour before the clamp: sum_k b[k] * coeff_k + 0.5, k in order; `row`
// holds the active features_rest words of this row in shared memory. Each
// product and sum is rounded on its own, as torch's elementwise ops round
// them (no FMA): a sum that torch puts exactly on the clamp lands there too.
template <int D>
__device__ __forceinline__ void raw_colour(const float* b,
                                          const float* __restrict__ dc,
                                          long long g, const float* row,
                                          float* c) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float acc = __fmul_rn(b[0], __ldg(dc + 3 * g + j));
#pragma unroll
    for (int k = 1; k < Shape<D>::kBases; ++k)
      acc = __fadd_rn(acc, __fmul_rn(b[k], row[3 * (k - 1) + j]));
    c[j] = __fadd_rn(acc, 0.5f);
  }
}

// Flat word i of the CTA's slab of `r`-word rows <-> its shared-memory slot:
// row i / r, column i % r; columns at or past W have no slot.
template <int W, int S>
__device__ __forceinline__ int slot(int i, int r) {
  if constexpr (W == 0) {
    return -1;
  } else {
    if (W == r) return W == S ? i : (i / W) * S + i % W;
    const int row = i / r, col = i - row * r;
    return col < W ? row * S + col : -1;
  }
}

// Copy the active words of `rows` rows of features_rest (`src` = the first
// row, `r` words a row) into shared memory: 16-byte loads where the slab is
// contiguous, else one word at a time over the active columns.
template <int W, int S>
__device__ __forceinline__ void stage_in(const float* __restrict__ src,
                                         int rows, int r, float* sh) {
  if constexpr (W > 0) {
    if (W != r) {
      for (int i = threadIdx.x; i < rows * W; i += kRows) {
        const int row = i / W, col = i - row * W;
        sh[row * S + col] = __ldg(src + static_cast<long long>(row) * r + col);
      }
      return;
    }
    const int words = rows * W;
    const int head = min(
        words, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15))
                                & 15) / 4);
    const int vecs = (words - head) / 4;
    for (int i = threadIdx.x; i < head; i += kRows)
      sh[slot<W, S>(i, r)] = __ldg(src + i);
    const float4* v = reinterpret_cast<const float4*>(src + head);
    for (int j = threadIdx.x; j < vecs; j += kRows) {
      const float4 w = __ldg(v + j);
      const int i = head + 4 * j;
      sh[slot<W, S>(i, r)] = w.x;
      sh[slot<W, S>(i + 1, r)] = w.y;
      sh[slot<W, S>(i + 2, r)] = w.z;
      sh[slot<W, S>(i + 3, r)] = w.w;
    }
    for (int i = head + 4 * vecs + threadIdx.x; i < words; i += kRows)
      sh[slot<W, S>(i, r)] = __ldg(src + i);
  }
}

template <int W, int S>
__device__ __forceinline__ float staged(const float* sh, int i, int r) {
  const int s = slot<W, S>(i, r);
  return s < 0 ? 0.0f : sh[s];
}

// Store `rows` whole rows of d_features_rest (`dst` = the first row) from
// shared memory with 16-byte stores, zeros past the active columns.
template <int W, int S>
__device__ __forceinline__ void stage_out(float* __restrict__ dst, int rows,
                                          int r, const float* sh) {
  const int words = rows * r;
  const int head = min(
      words, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15))
                              & 15) / 4);
  const int vecs = (words - head) / 4;
  for (int i = threadIdx.x; i < head; i += kRows)
    dst[i] = staged<W, S>(sh, i, r);
  float4* v = reinterpret_cast<float4*>(dst + head);
  for (int j = threadIdx.x; j < vecs; j += kRows) {
    const int i = head + 4 * j;
    v[j] = make_float4(staged<W, S>(sh, i, r), staged<W, S>(sh, i + 1, r),
                       staged<W, S>(sh, i + 2, r), staged<W, S>(sh, i + 3, r));
  }
  for (int i = head + 4 * vecs + threadIdx.x; i < words; i += kRows)
    dst[i] = staged<W, S>(sh, i, r);
}

template <int D>
__global__ void __launch_bounds__(kRows)
    sh_forward_kernel(const float* __restrict__ dc,
                      const float* __restrict__ rest,
                      const float* __restrict__ dirs, long long n, int r,
                      float* __restrict__ colors) {
  constexpr int W = Shape<D>::kWords, S = Shape<D>::kStride;
  __shared__ float sh[kRows * S];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows =
      static_cast<int>(min(static_cast<long long>(kRows), n - row0));
  stage_in<W, S>(rest + row0 * r, rows, r, sh);
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= rows) return;
  const long long g = row0 + t;
  float u[3], norm, b[Shape<D>::kBases], c[3];
  unit(dirs, g, u, &norm);
  basis<D>(u[0], u[1], u[2], b);
  raw_colour<D>(b, dc, g, sh + t * S, c);
  // `c < 0 ? 0 : c` keeps a NaN, as torch.clamp_min does
#pragma unroll
  for (int j = 0; j < 3; ++j) colors[3 * g + j] = c[j] < 0.0f ? 0.0f : c[j];
}

template <int D>
__global__ void __launch_bounds__(kRows)
    sh_backward_kernel(const float* __restrict__ dc,
                       const float* __restrict__ rest,
                       const float* __restrict__ dirs,
                       const float* __restrict__ dcolors, long long n, int r,
                       float* __restrict__ d_dc, float* __restrict__ d_rest,
                       float* __restrict__ d_dirs) {
  constexpr int W = Shape<D>::kWords, S = Shape<D>::kStride;
  constexpr int B = Shape<D>::kBases;
  __shared__ float sh[kRows * S];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows =
      static_cast<int>(min(static_cast<long long>(kRows), n - row0));
  stage_in<W, S>(rest + row0 * r, rows, r, sh);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < rows) {
    const long long g = row0 + t;
    float* row = sh + t * S;
    float u[3], norm, b[B], c[3], gc[3];
    const float m = unit(dirs, g, u, &norm);
    basis<D>(u[0], u[1], u[2], b);
    raw_colour<D>(b, dc, g, row, c);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      gc[j] = c[j] >= 0.0f ? __ldg(dcolors + 3 * g + j) : 0.0f;
    if (d_dc != nullptr) {
#pragma unroll
      for (int j = 0; j < 3; ++j) d_dc[3 * g + j] = gc[j] * b[0];
    }
    // d basis_k = coeff_k . gc; then the row's slots take d coeff_k
    float db[B];
    db[0] = 0.0f;
#pragma unroll
    for (int k = 1; k < B; ++k) {
      float* ck = row + 3 * (k - 1);
      db[k] = ck[0] * gc[0] + ck[1] * gc[1] + ck[2] * gc[2];
      ck[0] = gc[0] * b[k];
      ck[1] = gc[1] * b[k];
      ck[2] = gc[2] * b[k];
    }
    if (d_dirs != nullptr) {
      float du[3] = {0.0f, 0.0f, 0.0f};
      basis_vjp<D>(u[0], u[1], u[2], db, du);
      if (norm >= kNormEps) {
        // through u = dirs / |dirs|: the tangential part, over |dirs|
        const float s = du[0] * u[0] + du[1] * u[1] + du[2] * u[2];
#pragma unroll
        for (int j = 0; j < 3; ++j) du[j] -= u[j] * s;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) d_dirs[3 * g + j] = du[j] / m;
    }
  }
  if (d_rest == nullptr) return;  // the same for every thread of the CTA
  __syncthreads();
  stage_out<W, S>(d_rest + row0 * r, rows, r, sh);
}

template <int D>
void launch_forward(const float* dc, const float* rest, const float* dirs,
                    long long n, int r, float* colors, cudaStream_t s) {
  const long long blocks = (n + kRows - 1) / kRows;
  sh_forward_kernel<D><<<static_cast<unsigned>(blocks), kRows, 0, s>>>(
      dc, rest, dirs, n, r, colors);
}

template <int D>
void launch_backward(const float* dc, const float* rest, const float* dirs,
                     const float* dcolors, long long n, int r, float* d_dc,
                     float* d_rest, float* d_dirs, cudaStream_t s) {
  const long long blocks = (n + kRows - 1) / kRows;
  sh_backward_kernel<D><<<static_cast<unsigned>(blocks), kRows, 0, s>>>(
      dc, rest, dirs, dcolors, n, r, d_dc, d_rest, d_dirs);
}

bool bad_shape(int degree, long long n, int k) {
  return degree < 0 || degree > 4 || (degree + 1) * (degree + 1) > k ||
         (n + kRows - 1) / kRows > 0x7fffffffLL;
}

}  // namespace

// colors (N, 3) from features_dc (N, 3), features_rest (N, K - 1, 3) and
// dirs (N, 3), all contiguous float32.
extern "C" int dns_sh_colors(int degree, const void* dc, const void* rest,
                             const void* dirs, long long n, int k,
                             void* colors, void* stream) {
  if (bad_shape(degree, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto a = static_cast<const float*>(dc);
  auto re = static_cast<const float*>(rest);
  auto d = static_cast<const float*>(dirs);
  auto o = static_cast<float*>(colors);
  auto s = static_cast<cudaStream_t>(stream);
  const int r = 3 * (k - 1);
  switch (degree) {
    case 0: launch_forward<0>(a, re, d, n, r, o, s); break;
    case 1: launch_forward<1>(a, re, d, n, r, o, s); break;
    case 2: launch_forward<2>(a, re, d, n, r, o, s); break;
    case 3: launch_forward<3>(a, re, d, n, r, o, s); break;
    default: launch_forward<4>(a, re, d, n, r, o, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The gradients of dns_sh_colors for the colours' gradient dcolors (N, 3):
// d_dc (N, 3), d_rest (N, K - 1, 3), d_dirs (N, 3); a null output is not
// computed.
extern "C" int dns_sh_colors_backward(int degree, const void* dc,
                                      const void* rest, const void* dirs,
                                      const void* dcolors, long long n, int k,
                                      void* d_dc, void* d_rest, void* d_dirs,
                                      void* stream) {
  if (bad_shape(degree, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto a = static_cast<const float*>(dc);
  auto re = static_cast<const float*>(rest);
  auto d = static_cast<const float*>(dirs);
  auto gc = static_cast<const float*>(dcolors);
  auto ga = static_cast<float*>(d_dc);
  auto gr = static_cast<float*>(d_rest);
  auto gd = static_cast<float*>(d_dirs);
  auto s = static_cast<cudaStream_t>(stream);
  const int r = 3 * (k - 1);
  switch (degree) {
    case 0: launch_backward<0>(a, re, d, gc, n, r, ga, gr, gd, s); break;
    case 1: launch_backward<1>(a, re, d, gc, n, r, ga, gr, gd, s); break;
    case 2: launch_backward<2>(a, re, d, gc, n, r, ga, gr, gd, s); break;
    case 3: launch_backward<3>(a, re, d, gc, n, r, ga, gr, gd, s); break;
    default: launch_backward<4>(a, re, d, gc, n, r, ga, gr, gd, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
