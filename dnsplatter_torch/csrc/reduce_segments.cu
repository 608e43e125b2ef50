// Per-Gaussian float32 sums over contiguous ranges of a gradient slab, on
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `reduce_segments`
// (dnsplatter_tpu/ops/rasterize_pallas.py:619, kernel
// `_make_reduce_kernel:570`):
//
//     out[r, g] = sum(grads[r, starts[g] : starts[g + 1]])
//
// grads is (GW, C) float32 with GW <= 16, starts (N + 1,) ascending; the
// output is (GW, N). An empty range gives exact zeros; lanes at or past
// starts[N] are never read.
//
// The TPU version contracted 512-lane chunks against a range-membership
// one-hot per 128-id block on the matrix unit, with coarse block bounds, a
// 512-lane tail past starts[N], rows padded to 8 and ids padded to the block.
// Here one thread per id walks its range in lane order and adds each row in
// float32: exact per-range summation (no prefix-sum cancellation), no
// atomics, one fixed order, so two runs give the same bits. That fixed order
// is why the port's exact gradient reduction goes through this kernel: a
// scatter-add on the card adds in arrival order.
//
// What bounds it: bytes. Each slab word below starts[N] and each boundary is
// read once, GW floats are written per id. Neighbouring threads own
// neighbouring ranges, so a warp's loads fall into one contiguous stretch of
// each row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libreduce_segments.so reduce_segments.cu
// The kernel allocates nothing; the caller owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int GW>
__global__ void reduce_segments_kernel(const float* __restrict__ grads,
                                       long long stride, int len,
                                       const int32_t* __restrict__ starts,
                                       int n, float* __restrict__ out,
                                       long long out_stride) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  float acc[GW];
#pragma unroll
  for (int r = 0; r < GW; ++r) acc[r] = 0.0f;
  // Bounds clamped to the slab: a malformed boundary cannot read outside it.
  const int p0 = max(__ldg(starts + g), 0);
  const int p1 = min(__ldg(starts + g + 1), len);
  for (int p = p0; p < p1; ++p) {
#pragma unroll
    for (int r = 0; r < GW; ++r) acc[r] += __ldg(grads + r * stride + p);
  }
#pragma unroll
  for (int r = 0; r < GW; ++r) out[r * out_stride + g] = acc[r];
}

template <int GW>
void launch(const float* grads, long long stride, int len,
            const int32_t* starts, int n, float* out, long long out_stride,
            cudaStream_t stream) {
  constexpr int kThreads = 128;
  reduce_segments_kernel<GW>
      <<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          grads, stride, len, starts, n, out, out_stride);
}

}  // namespace

extern "C" int dns_reduce_segments(const void* grads, long long stride, int len,
                                   const void* starts, int gw, int n, void* out,
                                   long long out_stride, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto gr = static_cast<const float*>(grads);
  auto st = static_cast<const int32_t*>(starts);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define DNS_CASE(GW)                                      \
  case GW:                                                \
    launch<GW>(gr, stride, len, st, n, o, out_stride, s); \
    break;
  switch (gw) {
    DNS_CASE(1) DNS_CASE(2) DNS_CASE(3) DNS_CASE(4) DNS_CASE(5) DNS_CASE(6)
    DNS_CASE(7) DNS_CASE(8) DNS_CASE(9) DNS_CASE(10) DNS_CASE(11) DNS_CASE(12)
    DNS_CASE(13) DNS_CASE(14) DNS_CASE(15) DNS_CASE(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DNS_CASE
  return static_cast<int>(cudaGetLastError());
}
