// Device code shared by expand_segments.cu and reduce_segments_bykey.cu: a
// search over a sorted global array by one whole warp.
//
// A thread's binary search over N words is ~log2(N) dependent loads (21 at
// N = 1.25M). The warp instead probes 32 evenly spaced words a round, takes a
// ballot and narrows the range 32-fold: ~log32(N) dependent loads (5 at
// 1.25M), each one coalesced request.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dns {

// The first index in [lo, hi) at which `below(a[i])` is false, hi if none.
// `below` must hold on a prefix of the range (a sorted array and a
// threshold). Every lane of a full warp calls it with the same arguments
// and gets the same result.
template <typename Below>
__device__ __forceinline__ int warp_partition_point(
    const int32_t* __restrict__ a, int lo, int hi, Below below) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;  // ceil(len / 32)
    const int idx = lo + lane * step;
    const bool in = idx < hi && below(__ldg(a + idx));
    const int c = __popc(__ballot_sync(0xffffffffu, in));  // lanes 0..c-1
    if (c == 0) return lo;
    if (step == 1) return lo + c;  // every index of the range was probed
    // a[lo + (c-1) step] is below; a[lo + c step], if inside, is not
    const int next_hi = min(hi, lo + c * step);
    lo += (c - 1) * step + 1;
    hi = next_hi;
  }
  return lo;
}

}  // namespace dns
