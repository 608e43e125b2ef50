// Per-pair gradients of the tile compositing, on Hopper (sm_90a).
//
// Replaces the Pallas kernel `backward_tiles`
// (dnsplatter_tpu/ops/rasterize_pallas.py:1289, kernel `_make_bwd_kernel:1069`
// with `_chunk_geometry:369` and the packer `_rne_bf16_bits:1060`). Same
// inputs: the field-major payload and dense CSR of `forward_tiles`, the
// cotangents g_out (T, F, P) and g_alpha (T, 1, P), and the forward's
// t_final (T, 1, P) and last (T, 1, P). Output: one column per pair slot with
// the gradient fields [dmx, dmy, da, db, dc, dop, df0 .. df(F-1)], each summed
// over the tile's P pixels; packed, two bf16 fields per int32 word, high half
// first, round to nearest even ([mx,my | a,b | c,op | f0,f1 | ...], an odd
// count pads with a zero field), or as float32 rows with |dmx|, |dmy| in rows
// 14 and 15. Per pixel and pair k, back to front up to the pixel's `last`:
//
//     hit as in the forward (the same unfused sigma, tile_stage.cuh):
//       sigma >= 0 and op e^-sigma >= 1/255
//     alpha = min(0.999, op e^-sigma);  T_k = T_after_k / (1 - alpha)
//     w = alpha T_k;  fg = sum_c g_out[c] feat[c];  q = sum_{j>k} w_j fg_j
//     g_alpha_k = T_k fg - q / (1 - alpha) + g_alpha t_final / (1 - alpha)
//     g_sigma = -alpha g_alpha_k, g_op = g_alpha_k e^-sigma (both 0 if capped)
//
// The slab arrives zero-filled and a CTA writes only the slots of its own
// tile up to the tile's deepest contributor, so every other slot reads as
// integer zero, structurally: the reduction that follows drops those slots
// and a masked product would have left -0.0, which packs to 0x8000. On the
// TPU the head chunk of a tile went to a separate `stage` output because its
// 128-lane window overlapped the previous tile, and the caller merged it;
// here a CTA owns [starts[t], starts[t] + counts[t]) outright, so the head is
// written in place and `stage` and the per-tile chunk count `nch` are gone.
//
// What bounds it: instruction issue. A composited (pixel, pair) costs
// about 45 FP32 operations, one exp and one reciprocal, and each pair's
// 6 + F values must be summed over up to 256 pixels; lanes of a warp whose
// pixels miss a pair that a neighbour hits still step through the hit path.
//
// Design: one CTA per tile, PIX horizontally adjacent pixels per thread
// (four where whole warps of four cover the tile, P a multiple of 128, as
// at tile 16; else two), each pixel's running transmittance and suffix sum
// in registers, pairs replayed back to front in batches of 32 staged by
// cp.async into a two-stage ring of shared-memory records (tile_stage.cuh).
// A warp starts at its own deepest contributor, not the tile's. Per pair, a
// thread tests its pixels and, unless no pixel of the warp composited the
// pair (one ballot), computes every pixel's 6 + F values without branches,
// a pixel that missed masked to zero by selects, and adds them in
// registers. A reduce-scatter butterfly sums the values, padded to 16
// slots, over the warp: at offsets 16, 8, 4, 2 a lane keeps one half of its
// slots and adds the other half received from its partner, and a last
// exchange at offset 1 completes the sum, so lanes 2q and 2q + 1 hold field
// q's warp sum and the even lanes write all 16 with one store. The warps'
// sums of a batch are added in warp order, from +0 (so no -0 reaches the
// slab), a bit mask per warp marking the pairs it wrote, and packed while
// the next batch replays, from a double-buffered table, so a batch costs
// one CTA barrier. The order is fixed and there are no atomics in the sums,
// so two runs give the same bits. CTAs take their tiles from `order`,
// deepest contributor first (the wrapper sorts it): a deep tile replays for
// a long time on its own, so starting it late leaves the card idle behind
// it. The reciprocal of 1 - alpha is the card's one-instruction
// approximation (about an ulp; the bf16 output keeps 8 bits). Registers
// are capped so that 10 CTAs of four-pixel threads (8 of two-pixel ones)
// fit on an SM.
//
// Budget per (warp, pair) that a warp does not skip, at F = 7 and four
// pixels a thread: 8 + 4 + 2 + 1 + 1 = 16 shuffles and about 46 selects and
// adds for the sum over the warp's 128 pixels (a full xor butterfly for
// each of the 6 + F values would take 65 shuffles, for 32 pixels a warp at
// one pixel a thread), ~20 instructions for each pixel's hit test (an exp
// of 8), ~40 for its gradient and ~10 to finish the geometry sums: about
// 310 instructions, 2.4 a pixel. Per
// (thread, pair): two float4 shared loads for the hit tests and ceil(F / 4)
// float4s when the warp has a hit. Per batch of 32 pairs: one barrier.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbackward_tiles.so backward_tiles.cu
// The kernel allocates nothing; the caller owns (and zero-fills) the slab.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stage.cuh"

namespace {

constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.999f;
constexpr int kBatch = 32;     // pairs per stage; one bit each in a mask
constexpr int kStages = 2;
constexpr int kMaxWarps = 4;   // tile * tile <= 256 at two pixels a thread
constexpr int kSlots = 16;     // 6 + F <= 14 values, padded
constexpr int kRow = kSlots + 1;  // table row, padded: conflict-free reads
constexpr unsigned kFull = 0xffffffffu;

// CTAs per SM the registers must allow at two and at four pixels a thread
// (at most 64 and 102 registers a thread; the fastest caps on the card)
constexpr int kMinCtas2 = 8;
constexpr int kMinCtas4 = 10;

// Round-to-nearest-even float32 -> bf16 bits, in integers.
__device__ __forceinline__ uint32_t rne_bf16(float x) {
  const uint32_t b = __float_as_uint(x);
  return ((b + 0x7FFFu + ((b >> 16) & 1u)) >> 16) & 0xFFFFu;
}

// One stage of the reduce-scatter: a lane keeps the half of v[0 .. 2 HALF)
// its lane bit 2 HALF selects, adds the partner's copy of that half into
// v[0 .. HALF) and sends the other half.
template <int HALF>
__device__ __forceinline__ void scatter_stage(float (&v)[kSlots], int lane) {
  const bool up = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float keep = up ? v[j + HALF] : v[j];
    const float send = up ? v[j] : v[j + HALF];
    v[j] = keep + __shfl_xor_sync(kFull, send, 2 * HALF);
  }
}

// Sum v[0 .. 16) over the warp: returns the warp sum of slot (lane >> 1).
// The order is fixed, so two runs give the same bits.
__device__ __forceinline__ float warp_reduce_scatter16(float (&v)[kSlots],
                                                       int lane) {
  scatter_stage<8>(v, lane);  // offset 16: 8 shuffles
  scatter_stage<4>(v, lane);  // offset 8
  scatter_stage<2>(v, lane);  // offset 4
  scatter_stage<1>(v, lane);  // offset 2
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

// The sum over the warps, in warp order, of field q of pair i of a batch
// (only the warps whose mask holds the pair wrote it).
__device__ __forceinline__ float field_sum(const float (*red)[kBatch * kRow],
                                           const uint32_t* mask, int nwarps,
                                           int q, int i) {
  float s = 0.0f;
  for (int w = 0; w < nwarps; ++w) {
    if ((mask[w] >> i) & 1u) s += red[w][i * kRow + q];
  }
  return s;
}

// Write the slab columns [col0, col0 + nb) of one batch from its table of
// warp sums.
template <int F, bool PACK>
__device__ __forceinline__ void write_batch(
    const float (*red)[kBatch * kRow], const uint32_t* mask, int nwarps,
    long long col0, int nb, int tid, int nthreads, void* slab_v,
    long long slab_stride) {
  constexpr int NV = 6 + F;
  if (PACK) {
    constexpr int PR = (NV + 1) / 2;
    int32_t* slab = static_cast<int32_t*>(slab_v);
    for (int idx = tid; idx < PR * kBatch; idx += nthreads) {
      const int r = idx / kBatch;
      const int i = idx % kBatch;
      if (i >= nb) continue;
      const uint32_t hi = rne_bf16(field_sum(red, mask, nwarps, 2 * r, i));
      const uint32_t lo =
          (2 * r + 1 < NV) ? rne_bf16(field_sum(red, mask, nwarps, 2 * r + 1, i))
                           : 0u;
      slab[r * slab_stride + col0 + i] = static_cast<int32_t>((hi << 16) | lo);
    }
  } else {
    float* slab = static_cast<float*>(slab_v);
    for (int idx = tid; idx < (NV + 2) * kBatch; idx += nthreads) {
      const int q = idx / kBatch;
      const int i = idx % kBatch;
      if (i >= nb) continue;
      if (q < NV) {
        slab[q * slab_stride + col0 + i] = field_sum(red, mask, nwarps, q, i);
      } else {  // |dmx|, |dmy| in the last two of the 16 rows
        slab[(14 + q - NV) * slab_stride + col0 + i] =
            fabsf(field_sum(red, mask, nwarps, q - NV, i));
      }
    }
  }
}

// PIX consecutive values of a pixel row, as one vector load (the wrapper
// checks that the rows are 16-byte aligned).
__device__ __forceinline__ void load_row(const float* p, float (&o)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  o[0] = q.x; o[1] = q.y;
}
__device__ __forceinline__ void load_row(const float* p, float (&o)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void load_row(const int32_t* p, int (&o)[2]) {
  const int2 q = *reinterpret_cast<const int2*>(p);
  o[0] = q.x; o[1] = q.y;
}
__device__ __forceinline__ void load_row(const int32_t* p, int (&o)[4]) {
  const int4 q = *reinterpret_cast<const int4*>(p);
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}

template <int F>
using Batch = dns::PairBatch<F, kBatch>;

template <int F, bool PACK, int PIX>
__global__ void __launch_bounds__(64 * kMaxWarps / PIX,
                                  PIX == 2 ? kMinCtas2 : kMinCtas4)
backward_tiles_kernel(const float* __restrict__ payload, long long stride,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ counts, int tile,
                      int tiles_x, const float* __restrict__ g_out,
                      const float* __restrict__ g_alpha,
                      const float* __restrict__ t_final,
                      const int32_t* __restrict__ last,
                      const int32_t* __restrict__ order,
                      void* __restrict__ slab_v, long long slab_stride) {
  __shared__ Batch<F> s_pairs[kStages];
  // warp sums of a batch: [buffer][warp][pair][slot]
  constexpr int kWarps = kMaxWarps * 2 / PIX;
  __shared__ float s_red[2][kWarps][kBatch * kRow];
  __shared__ uint32_t s_mask[2][kWarps];  // pairs each warp wrote
  __shared__ int s_ml;

  const int t = order[blockIdx.x];  // deepest tiles first
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // tile * tile / PIX, a multiple of 32
  const int npix = nthreads * PIX;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = nthreads >> 5;
  const long long start = starts[t];
  const int cnt = counts[t];
  const int lid = PIX * tid;  // this thread's first pixel; the others follow
  const size_t pix = static_cast<size_t>(t) * npix + lid;

  int my_last[PIX];
  load_row(last + pix, my_last);
#pragma unroll
  for (int k = 0; k < PIX; ++k) my_last[k] = min(my_last[k], cnt - 1);
  if (tid == 0) s_ml = -1;
  __syncthreads();
  int mine = my_last[0];
#pragma unroll
  for (int k = 1; k < PIX; ++k) mine = max(mine, my_last[k]);
  if (mine >= 0) atomicMax(&s_ml, mine);  // a max: order-free
  __syncthreads();
  const int ml = s_ml;  // the tile's deepest contributor
  if (ml < 0) return;

  const int nbatches = ml / kBatch + 1;
  // The walk starts at the deepest batch; stage it before anything else.
  dns::stage_pairs<F, kBatch>(s_pairs[(nbatches - 1) % kStages], payload,
                              stride, start + (nbatches - 1) * kBatch,
                              ml + 1 - (nbatches - 1) * kBatch, tid, nthreads);
  // this warp's deepest contributor: it skips every pair behind it
  const int wl = __reduce_max_sync(kFull, mine);

  const float px0 =
      static_cast<float>((t % tiles_x) * tile + lid % tile) + 0.5f;
  float px[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) px[k] = px0 + static_cast<float>(k);
  const float py = static_cast<float>((t / tiles_x) * tile + lid / tile) + 0.5f;
  float go[PIX][F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float row[PIX];
    load_row(g_out + (static_cast<size_t>(t) * F + f) * npix + lid, row);
#pragma unroll
    for (int k = 0; k < PIX; ++k) go[k][f] = row[k];
  }
  float ga_tf[PIX], t_back[PIX], sacc[PIX];  // t_back: T after the pair
  load_row(t_final + pix, t_back);
  load_row(g_alpha + pix, ga_tf);
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    ga_tf[k] *= t_back[k];
    sacc[k] = 0.0f;  // sum of w fg over the pairs behind
  }

  for (int b = nbatches - 1; b >= 0; --b) {
    // Batch b has landed; the barrier publishes it, and every thread is
    // past the replay of batch b + 1 (its table is complete and its stage
    // free) and past the write of batch b + 2 (whose table b reuses).
    dns::cp_async_wait_all();
    __syncthreads();
    if (b > 0) {
      dns::stage_pairs<F, kBatch>(s_pairs[(b - 1) % kStages], payload,
                                  stride, start + (b - 1) * kBatch, kBatch,
                                  tid, nthreads);
    }
    if (b + 1 < nbatches) {
      write_batch<F, PACK>(s_red[(b + 1) & 1], s_mask[(b + 1) & 1], nwarps,
                           start + (b + 1) * kBatch,
                           min(kBatch, ml + 1 - (b + 1) * kBatch), tid,
                           nthreads, slab_v, slab_stride);
    }

    const Batch<F>& sb = s_pairs[b % kStages];
    float* red = s_red[b & 1][warp];
    const int b0 = b * kBatch;
    uint32_t wmask = 0u;  // pairs this warp contributed to
    for (int i = min(kBatch, wl + 1 - b0) - 1; i >= 0; --i) {
      const float4 g = sb.geo[i];  // mx, my, a, b
      const float4 co = sb.co[i];  // c, op, sigma_cut
      const float dy = py - g.y;
      // both pixels' hit tests, as in the forward, without branches
      bool hit[PIX];
      float dx[PIX], raw[PIX], ealpha[PIX];
#pragma unroll
      for (int k = 0; k < PIX; ++k) {
        dx[k] = px[k] - g.x;
        const float sigma = dns::conic_sigma(g.z, g.w, co.x, dx[k], dy);
        ealpha[k] = expf(-sigma);
        raw[k] = co.y * ealpha[k];
        hit[k] = b0 + i <= my_last[k] && sigma >= 0.0f &&
                 raw[k] >= kAlphaThreshold;
      }
      bool any = hit[0];
#pragma unroll
      for (int k = 1; k < PIX; ++k) any = any || hit[k];
      if (__ballot_sync(kFull, any) == 0u) continue;
      wmask |= 1u << i;
      float feat[4 * Batch<F>::kFeatVecs];
      dns::load_feats<F, kBatch>(sb, i, feat);
      // The pixels' terms, a pixel that missed masked to zero by selects
      // (a pair some pixel of the warp hit has finite conic entries, so
      // the masked lanes' products are finite). The geometry terms go
      // through three sums over the pixels (dy is the same for a thread's
      // pixels): S1 = sum g_sigma, S2 = sum g_sigma dx, S3 = sum g_sigma
      // dx^2; then dmx = -(a S2 + b dy S1), dmy = -(c dy S1 + b S2),
      // da = S3 / 2, db = dy S2, dc = dy^2 S1 / 2.
      float v[kSlots];
      float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
      for (int k = 0; k < PIX; ++k) {
        const float alpha = fminf(kMaxAlpha, raw[k]);
        const float rcp = dns::fast_rcp(1.0f - alpha);
        const float t_entry = t_back[k] * rcp;
        const float w = alpha * t_entry;
        float fg = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) fg = fmaf(go[k][f], feat[f], fg);
        const float g_alpha_k = fmaf(t_entry, fg, (ga_tf[k] - sacc[k]) * rcp);
        const bool grad = hit[k] && raw[k] < kMaxAlpha;  // not through the cap
        const float gs = grad ? -alpha * g_alpha_k : 0.0f;
        const float gop = grad ? g_alpha_k * ealpha[k] : 0.0f;
        const float wm = hit[k] ? w : 0.0f;
        const float d = dx[k];
        s1 += gs;
        s2 = fmaf(gs, d, s2);
        s3 = fmaf(gs, d * d, s3);
        if (k == 0) {
#pragma unroll
          for (int f = 0; f < F; ++f) v[6 + f] = go[k][f] * wm;
          v[5] = gop;
#pragma unroll
          for (int q = 6 + F; q < kSlots; ++q) v[q] = 0.0f;
        } else {
#pragma unroll
          for (int f = 0; f < F; ++f) v[6 + f] = fmaf(go[k][f], wm, v[6 + f]);
          v[5] += gop;
        }
        if (hit[k]) {
          t_back[k] = t_entry;
          sacc[k] = fmaf(w, fg, sacc[k]);
        }
      }
      const float dys1 = dy * s1;
      v[0] = -fmaf(g.z, s2, g.w * dys1);
      v[1] = -fmaf(co.x, dys1, g.w * s2);
      v[2] = 0.5f * s3;
      v[3] = dy * s2;
      v[4] = 0.5f * dy * dys1;
      const float s = warp_reduce_scatter16(v, lane);
      if ((lane & 1) == 0) red[i * kRow + (lane >> 1)] = s;
    }
    if (lane == 0) s_mask[b & 1][warp] = wmask;
  }
  __syncthreads();
  write_batch<F, PACK>(s_red[0], s_mask[0], nwarps, start,
                       min(kBatch, ml + 1), tid, nthreads, slab_v,
                       slab_stride);
}

template <int F, int PIX>
void launch_pix(bool pack, const float* payload, long long stride,
                const int32_t* starts, const int32_t* counts, int n_tiles,
                int tile, int tiles_x, const float* g_out,
                const float* g_alpha, const float* t_final,
                const int32_t* last, const int32_t* order, void* slab,
                long long slab_stride, cudaStream_t stream) {
  const int threads = tile * tile / PIX;
  if (pack) {
    backward_tiles_kernel<F, true, PIX><<<n_tiles, threads, 0, stream>>>(
        payload, stride, starts, counts, tile, tiles_x, g_out, g_alpha,
        t_final, last, order, slab, slab_stride);
  } else {
    backward_tiles_kernel<F, false, PIX><<<n_tiles, threads, 0, stream>>>(
        payload, stride, starts, counts, tile, tiles_x, g_out, g_alpha,
        t_final, last, order, slab, slab_stride);
  }
}

// Four pixels a thread where whole warps of them cover the tile (P a
// multiple of 128), else two (P a multiple of 64).
template <int F>
void launch(bool pack, const float* payload, long long stride,
            const int32_t* starts, const int32_t* counts, int n_tiles,
            int tile, int tiles_x, const float* g_out, const float* g_alpha,
            const float* t_final, const int32_t* last, const int32_t* order,
            void* slab, long long slab_stride, cudaStream_t stream) {
  if ((tile * tile) % (32 * 4) == 0) {
    launch_pix<F, 4>(pack, payload, stride, starts, counts, n_tiles, tile,
                     tiles_x, g_out, g_alpha, t_final, last, order, slab,
                     slab_stride, stream);
  } else {
    launch_pix<F, 2>(pack, payload, stride, starts, counts, n_tiles, tile,
                     tiles_x, g_out, g_alpha, t_final, last, order, slab,
                     slab_stride, stream);
  }
}

}  // namespace

extern "C" int dns_backward_tiles(const void* payload, long long stride,
                                  const void* starts, const void* counts,
                                  int n_tiles, int n_feats, int tile,
                                  int tiles_x, const void* g_out,
                                  const void* g_alpha, const void* t_final,
                                  const void* last, const void* order,
                                  void* slab, long long slab_stride,
                                  int pack, void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const int npix = tile * tile;
  // Whole warps of two-pixel threads: P a multiple of 64 (every square
  // tile with P a multiple of 32 is: tile is then a multiple of 8).
  if (npix > 32 * 2 * kMaxWarps || npix % (32 * 2) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto pay = static_cast<const float*>(payload);
  auto st = static_cast<const int32_t*>(starts);
  auto ct = static_cast<const int32_t*>(counts);
  auto go = static_cast<const float*>(g_out);
  auto ga = static_cast<const float*>(g_alpha);
  auto tf = static_cast<const float*>(t_final);
  auto la = static_cast<const int32_t*>(last);
  auto od = static_cast<const int32_t*>(order);
  auto s = static_cast<cudaStream_t>(stream);
  const bool pk = pack != 0;
#define DNS_BWD_CASE(F)                                                     \
  case F:                                                                   \
    launch<F>(pk, pay, stride, st, ct, n_tiles, tile, tiles_x, go, ga, tf,  \
              la, od, slab, slab_stride, s);                                \
    break;
  switch (n_feats) {
    DNS_BWD_CASE(1)
    DNS_BWD_CASE(2)
    DNS_BWD_CASE(3)
    DNS_BWD_CASE(4)
    DNS_BWD_CASE(5)
    DNS_BWD_CASE(6)
    DNS_BWD_CASE(7)
    DNS_BWD_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DNS_BWD_CASE
  return static_cast<int>(cudaGetLastError());
}
