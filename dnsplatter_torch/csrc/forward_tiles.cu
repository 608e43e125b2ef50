// Per-tile front-to-back alpha compositing, on Hopper (sm_90a).
//
// Replaces the Pallas kernel `forward_tiles`
// (dnsplatter_tpu/ops/rasterize_pallas.py:527, kernel `_make_fwd_kernel:393`
// with the hit test of `_chunk_geometry:369`). Same contract: tile t owns the
// dense-CSR pair range [starts[t], starts[t] + counts[t]) of a field-major
// payload (rows [mx, my, conic a, b, c, opacity, f0 .. f(F-1)], one column
// per pair, row stride `stride`); outputs are image (T, F, P), final
// transmittance (T, 1, P) and `last` (T, 1, P), the in-tile index of the
// deepest composited pair or -1. Per pixel and pair, in depth order:
//
//     sigma = 0.5 (a dx^2 + c dy^2) + b dx dy;  alpha = min(0.999, op e^-sigma)
//     hit  <=> sigma >= 0 and alpha >= 1/255
//     a hit with T (1 - alpha) <= 1e-4 ends the pixel and is not composited
//
// The kernel reads the payload in its field-major layout: a batch of pairs
// is one contiguous run in every field row, so the cooperative load below is
// coalesced without any transpose in the wrapper.
//
// What bounds it: arithmetic. Every (pixel, pair) the pixel visits costs
// about 20 FP32 operations, one exp on the special-function units (1/8 of
// the FP32 rate) and F fused multiply-adds, against 4 (6 + F) bytes of
// payload read once per pair and shared by the tile's P pixels. Design: one
// CTA per tile and one thread per pixel. The CTA stages batches of 256 pairs
// into shared memory with one load per field per thread; each thread then
// composites sequentially in registers (T, F accumulators, last index), and
// a pixel stops at its own terminator: the per-pixel `break` the TPU could
// only approximate per tile. `__syncthreads_count` ends the whole CTA as soon
// as no pixel of the tile is still open, so saturated tiles skip the rest of
// their pair list. The TPU's 128-lane DMA windows, head masking and
// triangular-matmul transmittance scans are not carried over.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libforward_tiles.so forward_tiles.cu
// The kernel allocates nothing; the caller owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.999f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr int kBatch = 256;  // pairs staged in shared memory per step

template <int F>
__global__ void forward_tiles_kernel(const float* __restrict__ payload,
                                     long long stride,
                                     const int32_t* __restrict__ starts,
                                     const int32_t* __restrict__ counts,
                                     int tile, int tiles_x,
                                     float* __restrict__ out,
                                     float* __restrict__ t_final,
                                     int32_t* __restrict__ last) {
  __shared__ float s_pay[(6 + F) * kBatch];

  const int t = blockIdx.x;
  const int lid = threadIdx.x;
  const int npix = blockDim.x;  // tile * tile
  const int start = starts[t];
  const int cnt = counts[t];
  const float px = static_cast<float>((t % tiles_x) * tile + lid % tile) + 0.5f;
  const float py = static_cast<float>((t / tiles_x) * tile + lid / tile) + 0.5f;

  float trans = 1.0f;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  int last_j = -1;
  bool done = false;

  for (int b0 = 0; b0 < cnt; b0 += kBatch) {
    // Barrier + vote: no thread overwrites the batch others still read,
    // and the CTA leaves once every pixel of the tile has terminated.
    if (__syncthreads_count(!done) == 0) break;
    const int nb = min(kBatch, cnt - b0);
    for (int i = lid; i < nb; i += npix) {
      const long long col = static_cast<long long>(start) + b0 + i;
#pragma unroll
      for (int f = 0; f < 6 + F; ++f) {
        s_pay[f * kBatch + i] = __ldg(payload + f * stride + col);
      }
    }
    __syncthreads();
    if (done) continue;
    for (int i = 0; i < nb; ++i) {
      const float dx = px - s_pay[0 * kBatch + i];
      const float dy = py - s_pay[1 * kBatch + i];
      const float sigma = 0.5f * (s_pay[2 * kBatch + i] * dx * dx +
                                  s_pay[4 * kBatch + i] * dy * dy) +
                          s_pay[3 * kBatch + i] * dx * dy;
      if (!(sigma >= 0.0f)) continue;  // also skips NaN
      const float raw = s_pay[5 * kBatch + i] * expf(-sigma);
      if (!(raw >= kAlphaThreshold)) continue;  // same test as on the clamp
      const float alpha = fminf(kMaxAlpha, raw);
      const float next_t = trans * (1.0f - alpha);
      if (next_t <= kTransmittanceEps) {
        done = true;
        break;
      }
      const float w = alpha * trans;
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += w * s_pay[(6 + f) * kBatch + i];
      trans = next_t;
      last_j = b0 + i;
    }
  }

  const size_t pix = static_cast<size_t>(t) * npix + lid;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    out[(static_cast<size_t>(t) * F + f) * npix + lid] = acc[f];
  }
  t_final[pix] = trans;
  last[pix] = last_j;
}

template <int F>
void launch(const float* payload, long long stride, const int32_t* starts,
            const int32_t* counts, int n_tiles, int tile, int tiles_x,
            float* out, float* t_final, int32_t* last, cudaStream_t stream) {
  forward_tiles_kernel<F><<<n_tiles, tile * tile, 0, stream>>>(
      payload, stride, starts, counts, tile, tiles_x, out, t_final, last);
}

}  // namespace

extern "C" int dns_forward_tiles(const void* payload, long long stride,
                                 const void* starts, const void* counts,
                                 int n_tiles, int n_feats, int tile,
                                 int tiles_x, void* out, void* t_final,
                                 void* last, void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  auto pay = static_cast<const float*>(payload);
  auto st = static_cast<const int32_t*>(starts);
  auto ct = static_cast<const int32_t*>(counts);
  auto o = static_cast<float*>(out);
  auto tf = static_cast<float*>(t_final);
  auto la = static_cast<int32_t*>(last);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_feats) {
    case 1: launch<1>(pay, stride, st, ct, n_tiles, tile, tiles_x, o, tf, la, s); break;
    case 2: launch<2>(pay, stride, st, ct, n_tiles, tile, tiles_x, o, tf, la, s); break;
    case 3: launch<3>(pay, stride, st, ct, n_tiles, tile, tiles_x, o, tf, la, s); break;
    case 4: launch<4>(pay, stride, st, ct, n_tiles, tile, tiles_x, o, tf, la, s); break;
    case 5: launch<5>(pay, stride, st, ct, n_tiles, tile, tiles_x, o, tf, la, s); break;
    case 6: launch<6>(pay, stride, st, ct, n_tiles, tile, tiles_x, o, tf, la, s); break;
    case 7: launch<7>(pay, stride, st, ct, n_tiles, tile, tiles_x, o, tf, la, s); break;
    case 8: launch<8>(pay, stride, st, ct, n_tiles, tile, tiles_x, o, tf, la, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
