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
//     hit as in the forward: sigma >= 0 and op e^-sigma >= 1/255
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
// What bounds it: arithmetic and the cross-pixel sums. A (pixel, pair) visit
// costs about 45 FP32 operations, one exp and one reciprocal, and each pair's
// 6 + F values must be summed over up to 256 pixels. Design: one CTA per
// tile, one thread per pixel, pairs staged 64 at a time into shared memory
// and replayed back to front with a running transmittance and suffix sum in
// registers. A warp whose pixels all skip a pair skips its sums too (one
// ballot); otherwise each value is summed by an xor butterfly of shuffles,
// and the warps' partial sums are added in warp order through shared memory.
// The order is fixed and there are no atomics in the sums, so two runs give
// the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbackward_tiles.so backward_tiles.cu
// The kernel allocates nothing; the caller owns (and zero-fills) the slab.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.999f;
constexpr int kBatch = 64;    // pairs staged in shared memory per step
constexpr int kMaxWarps = 8;  // tile * tile <= 256
constexpr unsigned kFull = 0xffffffffu;

// Round-to-nearest-even float32 -> bf16 bits, in integers.
__device__ __forceinline__ uint32_t rne_bf16(float x) {
  const uint32_t b = __float_as_uint(x);
  return ((b + 0x7FFFu + ((b >> 16) & 1u)) >> 16) & 0xFFFFu;
}

template <int F, bool PACK>
__global__ void __launch_bounds__(256)
backward_tiles_kernel(const float* __restrict__ payload, long long stride,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ counts, int tile,
                      int tiles_x, const float* __restrict__ g_out,
                      const float* __restrict__ g_alpha,
                      const float* __restrict__ t_final,
                      const int32_t* __restrict__ last,
                      void* __restrict__ slab_v, long long slab_stride) {
  constexpr int NV = 6 + F;
  __shared__ float s_pay[NV * kBatch];
  __shared__ float s_red[kMaxWarps][NV][kBatch];
  __shared__ float s_sum[NV][kBatch];
  __shared__ unsigned long long s_mask[kMaxWarps];
  __shared__ int s_ml;

  const int t = blockIdx.x;
  const int lid = threadIdx.x;
  const int npix = blockDim.x;  // tile * tile, a multiple of 32
  const int warp = lid >> 5;
  const int lane = lid & 31;
  const int nwarps = npix >> 5;
  const int start = starts[t];
  const int cnt = counts[t];
  const size_t pix = static_cast<size_t>(t) * npix + lid;
  const int my_last = min(last[pix], cnt - 1);

  if (lid == 0) s_ml = -1;
  __syncthreads();
  if (my_last >= 0) atomicMax(&s_ml, my_last);  // a max: order-free
  __syncthreads();
  const int ml = s_ml;  // the tile's deepest contributor
  if (ml < 0) return;

  const float px = static_cast<float>((t % tiles_x) * tile + lid % tile) + 0.5f;
  const float py = static_cast<float>((t / tiles_x) * tile + lid / tile) + 0.5f;
  float go[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    go[f] = g_out[(static_cast<size_t>(t) * F + f) * npix + lid];
  }
  const float tfin = t_final[pix];
  const float ga_tf = g_alpha[pix] * tfin;
  float t_back = tfin;  // transmittance after the pair being replayed
  float sacc = 0.0f;    // sum of w fg over the pairs behind it

  for (int b0 = (ml / kBatch) * kBatch; b0 >= 0; b0 -= kBatch) {
    const int nb = min(kBatch, ml + 1 - b0);
    for (int i = lid; i < nb; i += npix) {
      const long long col = static_cast<long long>(start) + b0 + i;
#pragma unroll
      for (int f = 0; f < NV; ++f) {
        s_pay[f * kBatch + i] = __ldg(payload + f * stride + col);
      }
    }
    __syncthreads();

    unsigned long long wmask = 0ull;  // pairs this warp contributed to
    for (int i = nb - 1; i >= 0; --i) {
      float v[NV];
#pragma unroll
      for (int q = 0; q < NV; ++q) v[q] = 0.0f;
      bool accept = false;
      if (b0 + i <= my_last) {
        const float ca = s_pay[2 * kBatch + i];
        const float cb = s_pay[3 * kBatch + i];
        const float cc = s_pay[4 * kBatch + i];
        const float dx = px - s_pay[0 * kBatch + i];
        const float dy = py - s_pay[1 * kBatch + i];
        // the forward kernel's expression, term for term
        const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
        if (sigma >= 0.0f) {
          const float ealpha = expf(-sigma);
          const float raw = s_pay[5 * kBatch + i] * ealpha;
          if (raw >= kAlphaThreshold) {
            accept = true;
            const float alpha = fminf(kMaxAlpha, raw);
            const float rcp = 1.0f / (1.0f - alpha);
            const float t_entry = t_back * rcp;
            const float w = alpha * t_entry;
            float fg = 0.0f;
#pragma unroll
            for (int f = 0; f < F; ++f) {
              fg += go[f] * s_pay[(6 + f) * kBatch + i];
              v[6 + f] = go[f] * w;
            }
            const float g_alpha_k = t_entry * fg - sacc * rcp + ga_tf * rcp;
            if (raw < kMaxAlpha) {  // no gradient through the cap
              const float g_sigma = -alpha * g_alpha_k;
              v[0] = -g_sigma * (ca * dx + cb * dy);
              v[1] = -g_sigma * (cc * dy + cb * dx);
              v[2] = g_sigma * 0.5f * dx * dx;
              v[3] = g_sigma * dx * dy;
              v[4] = g_sigma * 0.5f * dy * dy;
              v[5] = g_alpha_k * ealpha;
            }
            t_back = t_entry;
            sacc += w * fg;
          }
        }
      }
      if (__ballot_sync(kFull, accept) == 0u) continue;  // warp-uniform
      wmask |= 1ull << i;
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        float x = v[q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          x += __shfl_xor_sync(kFull, x, off);
        }
        if (lane == 0) s_red[warp][q][i] = x;
      }
    }
    if (lane == 0) s_mask[warp] = wmask;
    __syncthreads();

    // The warps' partial sums, added in warp order.
    for (int idx = lid; idx < NV * kBatch; idx += npix) {
      const int q = idx / kBatch;
      const int i = idx % kBatch;
      if (i >= nb) continue;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) {
        if ((s_mask[w] >> i) & 1ull) s += s_red[w][q][i];
      }
      s_sum[q][i] = s;
    }
    __syncthreads();

    const long long col0 = static_cast<long long>(start) + b0;
    if (PACK) {
      constexpr int PR = (NV + 1) / 2;
      int32_t* slab = static_cast<int32_t*>(slab_v);
      for (int idx = lid; idx < PR * kBatch; idx += npix) {
        const int r = idx / kBatch;
        const int i = idx % kBatch;
        if (i >= nb) continue;
        const uint32_t hi = rne_bf16(s_sum[2 * r][i]);
        const uint32_t lo = (2 * r + 1 < NV) ? rne_bf16(s_sum[2 * r + 1][i]) : 0u;
        slab[r * slab_stride + col0 + i] = static_cast<int32_t>((hi << 16) | lo);
      }
    } else {
      float* slab = static_cast<float*>(slab_v);
      for (int idx = lid; idx < (NV + 2) * kBatch; idx += npix) {
        const int q = idx / kBatch;
        const int i = idx % kBatch;
        if (i >= nb) continue;
        if (q < NV) {
          slab[q * slab_stride + col0 + i] = s_sum[q][i];
        } else {  // |dmx|, |dmy| in the last two of the 16 rows
          slab[(14 + q - NV) * slab_stride + col0 + i] = fabsf(s_sum[q - NV][i]);
        }
      }
    }
    // The next batch's staging writes s_pay only, which no thread reads any
    // more; its barrier orders these reads before the next writes of s_red,
    // s_mask and s_sum.
  }
}

template <int F>
void launch(bool pack, const float* payload, long long stride,
            const int32_t* starts, const int32_t* counts, int n_tiles,
            int tile, int tiles_x, const float* g_out, const float* g_alpha,
            const float* t_final, const int32_t* last, void* slab,
            long long slab_stride, cudaStream_t stream) {
  if (pack) {
    backward_tiles_kernel<F, true><<<n_tiles, tile * tile, 0, stream>>>(
        payload, stride, starts, counts, tile, tiles_x, g_out, g_alpha,
        t_final, last, slab, slab_stride);
  } else {
    backward_tiles_kernel<F, false><<<n_tiles, tile * tile, 0, stream>>>(
        payload, stride, starts, counts, tile, tiles_x, g_out, g_alpha,
        t_final, last, slab, slab_stride);
  }
}

}  // namespace

extern "C" int dns_backward_tiles(const void* payload, long long stride,
                                  const void* starts, const void* counts,
                                  int n_tiles, int n_feats, int tile,
                                  int tiles_x, const void* g_out,
                                  const void* g_alpha, const void* t_final,
                                  const void* last, void* slab,
                                  long long slab_stride, int pack,
                                  void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const int npix = tile * tile;
  if (npix > 32 * kMaxWarps || npix % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto pay = static_cast<const float*>(payload);
  auto st = static_cast<const int32_t*>(starts);
  auto ct = static_cast<const int32_t*>(counts);
  auto go = static_cast<const float*>(g_out);
  auto ga = static_cast<const float*>(g_alpha);
  auto tf = static_cast<const float*>(t_final);
  auto la = static_cast<const int32_t*>(last);
  auto s = static_cast<cudaStream_t>(stream);
  const bool pk = pack != 0;
#define DNS_BWD_CASE(F)                                                     \
  case F:                                                                   \
    launch<F>(pk, pay, stride, st, ct, n_tiles, tile, tiles_x, go, ga, tf,  \
              la, slab, slab_stride, s);                                    \
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
