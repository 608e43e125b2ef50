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
// What bounds it: instruction issue and latency. Every (pixel, pair) the
// pixel visits costs about 20 FP32 operations and one exp on the
// special-function units (1/8 of the FP32 rate), a hit F fused multiply-adds
// more, against 4 (6 + F) bytes of payload read once per pair and shared by
// the tile's P pixels; the visit is one dependent chain (shared load,
// quadratic, exp, tests, transmittance) of some 200 cycles.
//
// Design: one CTA per tile and one thread per pixel, compositing in
// registers (T, F accumulators, last index); a pixel stops at its own
// terminator, and `__syncthreads_count` ends the CTA as soon as no pixel of
// the tile is open. Pairs are staged up to 256 at a time (one per thread)
// through a two-stage ring of shared-memory records (tile_stage.cuh): each
// staging thread loads its pair of batch b + 1 into registers before batch
// b composites and stores it as a record after, so the loads are in flight
// during the compositing, and one barrier per batch both publishes batch b
// and frees the stage batch b + 1 goes into. The staging thread also stores
// the pair's sigma_cut, a bound past which the hit test fails for certain,
// so a visit far outside the splat skips the exp and the opacity test.
// Budget per (pixel, pair) visit: two float4 shared loads (broadcast: every
// thread reads the same record), the offsets and the unfused quadratic (9
// operations), the cut test; inside the cut the exp (8 instructions on
// this card, one on the special-function unit) and two tests; per hit
// ceil(F / 4) float4 loads, F FMAs and the transmittance update. A
// synchronous copy of each batch (13 scalar loads a thread, then a barrier,
// with nothing in flight) and 6 + F scalar shared loads a visit measured
// slower on the card. sigma is computed unfused in the plain version's
// order (tile_stage.cuh: conic_sigma) and the exp is the same expf, so the
// hit test decides as the plain version does: a fused quadratic rounds
// differently, and a pair within rounding of the 1/255 threshold is then
// composited by one version and not the other (seen on a 1M-Gaussian
// training frame: 2e-4 on one pixel).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libforward_tiles.so forward_tiles.cu
// The kernel allocates nothing; the caller owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stage.cuh"

namespace {

constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.999f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr int kBatch = 256;  // pairs per stage
constexpr int kStages = 2;
constexpr int kMaxThreads = 1024;  // tile * tile <= 1024

template <int F>
__global__ void __launch_bounds__(kMaxThreads)
forward_tiles_kernel(const float* __restrict__ payload, long long stride,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ counts, int tile,
                     int tiles_x, float* __restrict__ out,
                     float* __restrict__ t_final,
                     int32_t* __restrict__ last) {
  __shared__ dns::PairBatch<F, kBatch> s_pairs[kStages];

  const int t = blockIdx.x;
  const int lid = threadIdx.x;
  const int npix = blockDim.x;  // tile * tile
  const long long start = starts[t];
  const int cnt = counts[t];
  const float px = static_cast<float>((t % tiles_x) * tile + lid % tile) + 0.5f;
  const float py = static_cast<float>((t / tiles_x) * tile + lid / tile) + 0.5f;

  float trans = 1.0f;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  int last_j = -1;
  bool done = false;

  // A batch is one pair per staging thread: thread lid < bsz carries
  // column lid of the next batch in registers while this one composites.
  const int bsz = min(kBatch, npix);
  const int nbatches = (cnt + bsz - 1) / bsz;
  float next[6 + F];
  if (lid < min(bsz, cnt)) {
    dns::load_pair<F>(payload, stride, start + lid, next);
    dns::store_pair<F, kBatch>(s_pairs[0], lid, next);
  }
  for (int b = 0; b < nbatches; ++b) {
    // The barrier publishes batch b, and every thread is past compositing
    // batch b - 1, whose stage batch b + 1 goes into; the CTA leaves once
    // no pixel of the tile is open.
    if (__syncthreads_count(!done) == 0) break;
    const int b0 = b * bsz;
    const bool stage_next = b + 1 < nbatches && lid < min(bsz, cnt - b0 - bsz);
    if (stage_next) dns::load_pair<F>(payload, stride, start + b0 + bsz + lid, next);
    const dns::PairBatch<F, kBatch>& sb = s_pairs[b % kStages];
    const int nb = min(bsz, cnt - b0);
    for (int i = 0; i < nb && !done; ++i) {
      const float4 g = sb.geo[i];  // mx, my, a, b
      const float4 co = sb.co[i];  // c, op, sigma_cut
      const float dx = px - g.x;
      const float dy = py - g.y;
      const float sigma = dns::conic_sigma(g.z, g.w, co.x, dx, dy);
      if (sigma > co.z) continue;  // a certain miss: no exp
      if (!(sigma >= 0.0f)) continue;  // also skips NaN
      const float raw = co.y * expf(-sigma);
      if (!(raw >= kAlphaThreshold)) continue;  // same test as on the clamp
      const float alpha = fminf(kMaxAlpha, raw);
      const float next_t = trans * (1.0f - alpha);
      if (next_t <= kTransmittanceEps) {
        done = true;
        break;
      }
      const float w = alpha * trans;
      float feat[4 * dns::PairBatch<F, kBatch>::kFeatVecs];
      dns::load_feats<F, kBatch>(sb, i, feat);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += w * feat[f];
      trans = next_t;
      last_j = b0 + i;
    }
    if (stage_next) dns::store_pair<F, kBatch>(s_pairs[(b + 1) % kStages], lid, next);
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
  if (tile * tile > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
