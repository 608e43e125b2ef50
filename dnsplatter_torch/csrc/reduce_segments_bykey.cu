// Per-Gaussian sums over a key-sorted, bf16-packed gradient slab, on Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `reduce_segments_bykey`
// (dnsplatter_tpu/ops/rasterize_pallas.py:881, kernel
// `_make_reduce_bykey_kernel:805`). Same contract: rows 0 .. RU-1 of the slab
// hold two bf16 gradient fields per int32 word (high half first), row RU the
// ascending keys, each the Gaussian id of its lane. Output (2 RU + 2, N)
// float32: for id g the decoded field sums over the lanes whose key equals g,
// then sum |field 0| and sum |field 1| (the absolute screen-space gradient).
// A lane whose key is outside [0, N) (the sentinel N, padding) is never read
// into a sum, and an id without lanes gives exact zeros. The decode is
// hi = bits & 0xFFFF0000, lo = bits << 16, each read as float32.
//
// The TPU version matched keys by a one-hot product per 256-id block and so
// needed coarse block bounds, 512-lane chunks, a zero tail and an id count
// padded to the block. None of that is carried over: one thread per id finds
// the first lane of its key by binary search in the key row and walks its
// run, adding in lane order in float32. No atomics, one fixed order: two runs
// give the same bits.
//
// What bounds it: bytes. Each slab word and key is read once and 2 RU + 2
// floats are written per id. Neighbouring threads own neighbouring runs, so a
// warp's loads fall into one contiguous stretch of each row; the binary
// search reads the key row through L2. A long run (a Gaussian that covers many
// tiles) is walked by one thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libreduce_segments_bykey.so
//        reduce_segments_bykey.cu
// The kernel allocates nothing; the caller owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int RU>
__global__ void reduce_bykey_kernel(const int32_t* __restrict__ slab,
                                    long long stride, int len, int n,
                                    float* __restrict__ out,
                                    long long out_stride) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int32_t* keys = slab + RU * stride;
  int lo = 0;
  int hi = len;
  while (lo < hi) {  // first lane whose key is >= g
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < g) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  float acc[2 * RU + 2];
#pragma unroll
  for (int v = 0; v < 2 * RU + 2; ++v) acc[v] = 0.0f;
  for (int p = lo; p < len && __ldg(keys + p) == g; ++p) {
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      const uint32_t bits = static_cast<uint32_t>(__ldg(slab + r * stride + p));
      const float a = __uint_as_float(bits & 0xFFFF0000u);
      const float b = __uint_as_float(bits << 16);
      acc[2 * r] += a;
      acc[2 * r + 1] += b;
      if (r == 0) {
        acc[2 * RU] += fabsf(a);
        acc[2 * RU + 1] += fabsf(b);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < 2 * RU + 2; ++v) out[v * out_stride + g] = acc[v];
}

template <int RU>
void launch(const int32_t* slab, long long stride, int len, int n, float* out,
            long long out_stride, cudaStream_t stream) {
  constexpr int kThreads = 128;
  reduce_bykey_kernel<RU><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      slab, stride, len, n, out, out_stride);
}

}  // namespace

extern "C" int dns_reduce_segments_bykey(const void* slab, long long stride,
                                         int len, int ru, int n, void* out,
                                         long long out_stride, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto sl = static_cast<const int32_t*>(slab);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (ru) {
    case 1: launch<1>(sl, stride, len, n, o, out_stride, s); break;
    case 2: launch<2>(sl, stride, len, n, o, out_stride, s); break;
    case 3: launch<3>(sl, stride, len, n, o, out_stride, s); break;
    case 4: launch<4>(sl, stride, len, n, o, out_stride, s); break;
    case 5: launch<5>(sl, stride, len, n, o, out_stride, s); break;
    case 6: launch<6>(sl, stride, len, n, o, out_stride, s); break;
    case 7: launch<7>(sl, stride, len, n, o, out_stride, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
