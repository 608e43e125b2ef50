// Per-Gaussian sums over contiguous ranges of a bf16-packed gradient slab, on
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `reduce_segments_packed`
// (dnsplatter_tpu/ops/rasterize_pallas.py:745, kernel
// `_make_reduce_packed_kernel:682`). Same function: the slab (PR, C) holds two
// bf16 gradient fields per int32 word and is ordered so that Gaussian g owns
// the lanes [starts[g], starts[g + 1]). Output (2 PR + 2, N) float32: the
// decoded field sums of each range, then sum |field 0| and sum |field 1| (the
// absolute screen-space gradient). An empty range gives exact zeros; lanes at
// or past starts[N] are never read.
//
// The TPU version contracted 512-lane chunks against a range-membership
// one-hot per 256-id block and so needed coarse block bounds, a 512-lane zero
// tail past starts[N] and an id count padded to the block. None of that is
// carried over: one thread per id walks its own range in lane order and adds
// in float32. No atomics, one fixed order: two runs give the same bits.
//
// What bounds it: bytes. Each slab word below starts[N] and each boundary is
// read once, 2 PR + 2 floats are written per id. Neighbouring threads own
// neighbouring ranges, so a warp's loads fall into one contiguous stretch of
// each row. A long range (a Gaussian that covers many tiles) is walked by one
// thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libreduce_segments_packed.so
//        reduce_segments_packed.cu
// The kernel allocates nothing; the caller owns every buffer.

#include "packed_run.cuh"

namespace {

template <int PR>
__global__ void reduce_packed_kernel(const int32_t* __restrict__ slab,
                                     long long stride, int len,
                                     const int32_t* __restrict__ starts, int n,
                                     float* __restrict__ out,
                                     long long out_stride) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  float acc[2 * PR + 2];
#pragma unroll
  for (int v = 0; v < 2 * PR + 2; ++v) acc[v] = 0.0f;
  // Bounds clamped to the slab: a malformed boundary cannot read outside it.
  dns::add_packed_run<PR>(slab, stride, max(__ldg(starts + g), 0),
                          min(__ldg(starts + g + 1), len), acc);
#pragma unroll
  for (int v = 0; v < 2 * PR + 2; ++v) out[v * out_stride + g] = acc[v];
}

template <int PR>
void launch(const int32_t* slab, long long stride, int len,
            const int32_t* starts, int n, float* out, long long out_stride,
            cudaStream_t stream) {
  constexpr int kThreads = 128;
  reduce_packed_kernel<PR><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      slab, stride, len, starts, n, out, out_stride);
}

}  // namespace

extern "C" int dns_reduce_segments_packed(const void* slab, long long stride,
                                          int len, const void* starts, int pr,
                                          int n,
                                          void* out, long long out_stride,
                                          void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto sl = static_cast<const int32_t*>(slab);
  auto st = static_cast<const int32_t*>(starts);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (pr) {
    case 1: launch<1>(sl, stride, len, st, n, o, out_stride, s); break;
    case 2: launch<2>(sl, stride, len, st, n, o, out_stride, s); break;
    case 3: launch<3>(sl, stride, len, st, n, o, out_stride, s); break;
    case 4: launch<4>(sl, stride, len, st, n, o, out_stride, s); break;
    case 5: launch<5>(sl, stride, len, st, n, o, out_stride, s); break;
    case 6: launch<6>(sl, stride, len, st, n, o, out_stride, s); break;
    case 7: launch<7>(sl, stride, len, st, n, o, out_stride, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
