// Pair staging shared by the tile kernels (forward_tiles.cu,
// backward_tiles.cu).
//
// The payload arrives field-major: rows [mx, my, conic a, b, c, opacity,
// f0 .. f(F-1)], one column per (tile, Gaussian) pair, row stride `stride`.
// A batch of B consecutive pairs goes into shared memory as records that a
// thread reads with vector loads: (mx, my, a, b) and (c, op, sigma_cut, -)
// as two float4s and the features as ceil(F / 4) float4s, so a visit costs
// two shared loads for the hit test and the features are read only for a
// hit.
// Two ways in, both coalesced (neighbouring threads read neighbouring
// columns of one field row) and both in flight while the CTA works on the
// batch before:
// - stage_pairs: 4-byte cp.async, the fields spread over every thread of
//   the CTA, nothing through registers (backward_tiles: 32 pairs a batch
//   over 128 threads). A 16-byte copy would need four consecutive columns
//   to land side by side in shared memory, which records do not give.
// - load_pair / store_pair: one pair per thread through registers, written
//   as whole records with vector stores (forward_tiles: 256 pairs a batch,
//   one per thread; on the card it beat cp.async there, whose scalar
//   stores into records conflict on banks).

#pragma once

#include <cuda_runtime.h>

namespace dns {

template <int F, int B>
struct PairBatch {
  static constexpr int kFeatVecs = (F + 3) / 4;
  float4 geo[B];             // mx, my, conic a, conic b
  // conic c, opacity, sigma_cut(opacity) (store_pair only; stage_pairs
  // leaves it unset), unused
  float4 co[B];
  float4 feat[B][kFeatVecs];  // f0 .. f(F-1); lanes past F never written
};

__device__ __forceinline__ void cp_async4(void* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue the copies of payload columns [col0, col0 + nb), nb <= B, into
// `dst`, spread over the CTA's `nthreads` threads, and commit them as one
// group. The caller waits (cp_async_wait_all) and then passes a CTA barrier
// before any thread reads `dst`.
template <int F, int B>
__device__ __forceinline__ void stage_pairs(PairBatch<F, B>& dst,
                                            const float* __restrict__ payload,
                                            long long stride, long long col0,
                                            int nb, int tid, int nthreads) {
  for (int idx = tid; idx < (6 + F) * B; idx += nthreads) {
    const int f = idx / B;  // field row
    const int i = idx - f * B;
    if (i >= nb) continue;
    float* d = f < 4   ? reinterpret_cast<float*>(&dst.geo[i]) + f
               : f < 6 ? reinterpret_cast<float*>(&dst.co[i]) + (f - 4)
                       : reinterpret_cast<float*>(dst.feat[i]) + (f - 6);
    cp_async4(d, payload + f * stride + col0 + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// sigma = 0.5 (a dx^2 + c dy^2) + b dx dy, every product and sum rounded on
// its own in the plain version's order (the intrinsics are never fused into
// FMAs), so the kernels' hit tests, which compare op e^-sigma with 1/255,
// decide as the plain PyTorch versions do: a fused sigma differs in its
// last bits and flips pairs that sit on the threshold.
__device__ __forceinline__ float conic_sigma(float a, float b, float c,
                                            float dx, float dy) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                            __fmul_rn(__fmul_rn(c, dy), dy));
  return __fadd_rn(__fmul_rn(0.5f, q), __fmul_rn(__fmul_rn(b, dx), dy));
}

// A pair's 6 + F fields from its payload column, into registers.
template <int F>
__device__ __forceinline__ void load_pair(const float* __restrict__ payload,
                                          long long stride, long long col,
                                          float (&r)[6 + F]) {
#pragma unroll
  for (int f = 0; f < 6 + F; ++f) r[f] = __ldg(payload + f * stride + col);
}

// A sigma past which the hit test op e^-sigma >= 1/255 fails for certain:
// ln(255 op), plus a margin far above the rounding of expf (2 ulp), of the
// product and of this bound (the fast log's error is below 1e-6 here). A
// pair with sigma beyond it is a miss without the exp; one inside it takes
// the exact test. NaN or -inf (op = 0) compares false: the exact test.
__device__ __forceinline__ float sigma_cut(float op) {
  const float l = __logf(255.0f * op);
  return l + 1e-3f * (1.0f + fabsf(l));
}

// 1 / x to about an ulp (one MUFU.RCP); x is 1 - alpha, in [0.001, 1).
__device__ __forceinline__ float fast_rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Those fields as record i of `dst`, with the pair's sigma_cut: four or
// five vector or scalar stores.
template <int F, int B>
__device__ __forceinline__ void store_pair(PairBatch<F, B>& dst, int i,
                                           const float (&r)[6 + F]) {
  dst.geo[i] = make_float4(r[0], r[1], r[2], r[3]);
  dst.co[i] = make_float4(r[4], r[5], sigma_cut(r[5]), 0.0f);
#pragma unroll
  for (int v = 0; v < PairBatch<F, B>::kFeatVecs; ++v) {
    float q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = 4 * v + k < F ? r[6 + 4 * v + k] : 0.0f;
    dst.feat[i][v] = make_float4(q[0], q[1], q[2], q[3]);
  }
}

// The F features of pair i, from its float4s (indices fold at compile time
// once the caller's loop over f is unrolled).
template <int F, int B>
__device__ __forceinline__ void load_feats(const PairBatch<F, B>& src, int i,
                                           float* out) {
#pragma unroll
  for (int v = 0; v < PairBatch<F, B>::kFeatVecs; ++v) {
    const float4 q = src.feat[i][v];
    out[4 * v] = q.x;
    out[4 * v + 1] = q.y;
    out[4 * v + 2] = q.z;
    out[4 * v + 3] = q.w;
  }
}

}  // namespace dns
