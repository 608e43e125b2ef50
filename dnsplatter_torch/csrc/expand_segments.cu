// Piecewise-constant expansion for tile binning, on Hopper (sm_90a).
//
// Replaces the Pallas kernels `expand_segments` and `_expand_segments_stream`
// (dnsplatter_tpu/ops/rasterize_pallas.py:248 and :315, kernel bodies
// `_make_expand_kernel:142` and `_make_expand_stream_kernel:183`):
//
//     out[r, p] = vals[r, g]  for starts[g] <= p < starts[g + 1]
//     out[r, p] = 0           for p >= starts[N] (or p < starts[0])
//
// The TPU version contracted 128-Gaussian membership windows against each
// output chunk on the MXU and, above 2^18 segments, streamed the value table
// because it no longer fit VMEM. Neither constraint exists here: one kernel
// serves both entry points.
//
// What bounds it: device-memory bytes. The function must write R * C words
// and read (R + 1) * N words; it does almost no arithmetic. Design: one
// thread per output position p. The thread finds its segment with an
// upper_bound over starts[0..N] (the last g with starts[g] <= p, so empty
// segments are skipped for free), then copies its R words. Neighbouring
// threads walk nearly the same search path, so the search reads hit L1/L2
// and the device-memory traffic stays close to the bound. Stores are
// coalesced: row r of the output is written by consecutive threads. Values
// move as raw 32-bit words, so int32 rows are bit-exact at any magnitude and
// float32 rows are bit-exact too.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libexpand_segments.so expand_segments.cu
// The kernel allocates nothing; the caller owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void expand_segments_kernel(const uint32_t* __restrict__ vals,
                                       const int32_t* __restrict__ starts,
                                       uint32_t* __restrict__ out, int rows,
                                       int n, int out_len) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= out_len) return;
  // First index in [0, n + 1) whose start lies past p.
  int lo = 0;
  int hi = n + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(starts + mid) <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int g = lo - 1;  // -1: before the first segment; n: past the end
  const bool live = g >= 0 && g < n;
  for (int r = 0; r < rows; ++r) {
    out[static_cast<size_t>(r) * out_len + p] =
        live ? __ldg(vals + static_cast<size_t>(r) * n + g) : 0u;
  }
}

}  // namespace

extern "C" int dns_expand_segments(const void* vals, const void* starts,
                                   void* out, int rows, int n, int out_len,
                                   void* stream) {
  if (out_len > 0 && rows > 0) {
    const int threads = 256;
    const int blocks = (out_len + threads - 1) / threads;
    expand_segments_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(vals),
        static_cast<const int32_t*>(starts), static_cast<uint32_t*>(out), rows,
        n, out_len);
  }
  return static_cast<int>(cudaGetLastError());
}
