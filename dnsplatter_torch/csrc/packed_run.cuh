// Device code shared by the boundary reductions over bf16-packed gradient
// slabs (reduce_segments_packed.cu, reduce_segments_packed_multi.cu).
//
// A slab row holds two bf16 gradient fields per int32 word, high half first.
// The decode is the exact bf16 -> float32 promotion: hi = bits & 0xFFFF0000,
// lo = bits << 16, each read as float32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dns {

// Add lanes [p0, p1) of a (PR, *) packed slab into acc[0 .. 2 PR + 2): the
// 2 PR decoded fields, then |field 0| and |field 1|. Lane order, float32.
template <int PR>
__device__ __forceinline__ void add_packed_run(const int32_t* __restrict__ slab,
                                               long long stride, int p0, int p1,
                                               float* acc) {
  for (int p = p0; p < p1; ++p) {
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      const uint32_t bits = static_cast<uint32_t>(__ldg(slab + r * stride + p));
      const float a = __uint_as_float(bits & 0xFFFF0000u);
      const float b = __uint_as_float(bits << 16);
      acc[2 * r] += a;
      acc[2 * r + 1] += b;
      if (r == 0) {
        acc[2 * PR] += fabsf(a);
        acc[2 * PR + 1] += fabsf(b);
      }
    }
  }
}

}  // namespace dns
