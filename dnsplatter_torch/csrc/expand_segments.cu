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
// and read (R + 1) * N words; it does no arithmetic. A search per output
// position (the first design: ~21 dependent loads for every 16 bytes
// written at N = 1.25M) made it latency-bound at 3-4x the bound.
//
// Design: one CTA of 256 threads per chunk of 2,048 consecutive positions.
// 1. A chunk that lies wholly at or past starts[N], or before starts[0],
//    writes zeros and searches nothing (in a training step the pair
//    capacity is three times the pairs, so most chunks end here).
// 2. Two warps find the segments that hold the chunk's first and last
//    positions inside [starts[0], starts[N]), g_lo and g_hi, with one
//    warp-wide search each over starts (warp_search.cuh): two searches a
//    CTA instead of one a position. Positions outside that range are zeros
//    whatever the segments there, so the empty segments that share starts[0]
//    or starts[N] (Gaussians without pairs sorted last, a training state's
//    unused capacity: hundreds of thousands at 1M Gaussians) never enter the
//    window (g_lo, g_hi].
// 3. A window of at most 2,048 segments (the rule): the CTA marks segment
//    heads, seg[starts[g] - p0] = g for every non-empty g in the window, its
//    starts read once, coalesced; an inclusive max-scan over seg (8
//    positions a thread, the warp by shuffles, then the 8 warps through
//    shared memory) gives every position its segment, since the marked ids
//    rise with position.
//    A wider window (a stretch of thousands of empty segments inside the
//    chunk) takes the slower path: each thread places its 8 positions by a
//    binary search over starts[g_lo .. g_hi] in global memory, each search
//    starting past the previous position's segment.
// 4. Each thread writes 4 consecutive positions of a row with one 16-byte
//    store, so a warp writes 512 contiguous bytes a row an instruction; the
//    values come through L1 (neighbouring positions share a few segments).
//    A row whose start is not 16-byte aligned (out_len % 4 != 0), and the
//    ragged end of the output, take 4-byte stores.
// Values move as raw 32-bit words, so int32 rows (any magnitude) and float32
// rows are bit-exact.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libexpand_segments.so expand_segments.cu
// The kernel allocates nothing; the caller owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;                    // positions a thread scans
constexpr int kChunk = kThreads * kPerThread;    // positions a CTA covers
constexpr int kGroups = kChunk / (4 * kThreads);  // 16-byte groups a thread
// The widest window of segments a chunk marks (8 strided rounds); a wider
// one is searched instead.
constexpr int kMarkWindow = 8 * kThreads;

// Write 4 words at out_row[p .. p + 4), clipped to [.., end).
__device__ __forceinline__ void store4(uint32_t* __restrict__ out_row,
                                       long long p, long long end, bool vec,
                                       uint4 w) {
  if (vec && p + 4 <= end) {
    *reinterpret_cast<uint4*>(out_row + p) = w;
    return;
  }
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (p + j < end) out_row[p + j] = v[j];
  }
}

// Ask for vals[r, g] of every row r in L1.
__device__ __forceinline__ void prefetch_values(const uint32_t* vals, int g,
                                                int n, int rows) {
  if (g < 0 || g >= n) return;
  for (int r = 0; r < rows; ++r) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(
        vals + static_cast<long long>(r) * n + g));
  }
}

__global__ void __launch_bounds__(kThreads)
expand_segments_kernel(const uint32_t* __restrict__ vals,
                       const int32_t* __restrict__ starts,
                       uint32_t* __restrict__ out, int rows, int n,
                       int out_len, bool out_aligned) {
  __shared__ __align__(16) int seg[kChunk];
  __shared__ int bounds[2];
  __shared__ int warp_max[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long p0 = static_cast<long long>(blockIdx.x) * kChunk;
  const long long p1 = min(static_cast<long long>(out_len), p0 + kChunk);
  // Row r starts 16-byte aligned iff the buffer is and r * out_len % 4 == 0.
  auto row_vec = [&](int r) {
    return out_aligned && ((static_cast<long long>(r) * out_len) & 3) == 0;
  };

  const int first = __ldg(starts);
  const int end = __ldg(starts + n);
  if (p0 >= end || p1 <= first) {  // all zeros
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int r = 0; r < rows; ++r) {
      uint32_t* orow = out + static_cast<long long>(r) * out_len;
      const bool vec = row_vec(r);
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const long long p = p0 + 4 * (tid + k * kThreads);
        if (p < p1) store4(orow, p, p1, vec, z);
      }
    }
    return;
  }

  // g_lo: the segment holding max(p0, first); g_hi: the one holding the
  // chunk's last position before `end`. Positions before `first` get -1,
  // those from `end` on N: both write zeros.
  for (int i = tid; i < kChunk; i += kThreads) seg[i] = -1;  // no mark yet
  if (warp < 2) {
    const long long x_ll = warp == 0 ? max(p0, static_cast<long long>(first))
                                     : min(p1, static_cast<long long>(end)) - 1;
    const int x = static_cast<int>(x_ll);
    const int g = dns::warp_partition_point(
        starts, 0, n + 1, [x](int32_t s) { return s <= x; }) - 1;
    if (lane == 0) bounds[warp] = g;
  }
  __syncthreads();
  const int g_lo = bounds[0];
  const int g_hi = bounds[1];
  const int base = static_cast<int>(p0);
  if (g_hi - g_lo <= kMarkWindow) {
    // Mark heads: seg[q - p0] = g where non-empty segment g starts at q.
    // Every g in (g_lo, g_hi] starts inside (max(p0, first), p1); of the
    // segments sharing a start only the last is non-empty, so each position
    // has at most one writer. The window's starts are read once, coalesced,
    // and each marked segment's values are prefetched into L1 for the
    // stores (the scan hides the latency).
    if (tid == 0) {
      seg[0] = p0 < first ? -1 : g_lo;
      if (p0 < first) seg[first - base] = g_lo;
      if (end < p1) seg[end - base] = n;
      prefetch_values(vals, g_lo, n, rows);
    }
    for (int g = g_lo + 1 + tid; g <= g_hi; g += kThreads) {
      const int q = __ldg(starts + g);
      if (__ldg(starts + g + 1) > q) {
        seg[q - base] = g;
        prefetch_values(vals, g, n, rows);
      }
    }
    __syncthreads();

    // Inclusive max-scan of seg (marked ids rise with position; -1 is below
    // every id): 8 positions a thread, the warp by shuffles, then the warps
    // in order through shared memory.
    int v[kPerThread];
    int4* mine = reinterpret_cast<int4*>(&seg[kPerThread * tid]);
#pragma unroll
    for (int q = 0; q < kPerThread / 4; ++q) {
      const int4 m = mine[q];
      v[4 * q] = m.x; v[4 * q + 1] = m.y; v[4 * q + 2] = m.z;
      v[4 * q + 3] = m.w;
    }
#pragma unroll
    for (int j = 1; j < kPerThread; ++j) v[j] = max(v[j], v[j - 1]);
    int incl = v[kPerThread - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl = max(incl, o);
    }
    int carry = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) carry = -1;
    if (lane == 31) warp_max[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) carry = max(carry, warp_max[w]);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) v[j] = max(v[j], carry);
#pragma unroll
    for (int q = 0; q < kPerThread / 4; ++q) {
      mine[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
    // A window of more than kMarkWindow segments: a long stretch of empty
    // segments inside the chunk. Each thread places its 8 positions by
    // binary search over starts[g_lo .. g_hi] in global memory, starting
    // each search past the previous position's segment.
    int g = g_lo;
    for (int j = 0; j < kPerThread; ++j) {
      const long long p = p0 + kPerThread * tid + j;
      int gp;
      if (p < first) {
        gp = -1;
      } else if (p >= end || p >= p1) {  // zeros, or not stored
        gp = n;
      } else {
        if (__ldg(starts + g + 1) <= p) {
          int lo = g + 1;  // starts[lo] <= p
          int hi = g_hi + 1;  // starts[hi] > p
          while (hi - lo > 1) {
            const int mid = lo + ((hi - lo) >> 1);
            if (__ldg(starts + mid) <= p) {
              lo = mid;
            } else {
              hi = mid;
            }
          }
          g = lo;
        }
        gp = g;
      }
      seg[kPerThread * tid + j] = gp;
    }
  }
  __syncthreads();

  // Store: thread tid writes positions 4 tid + 1024 k .. + 4 of every row.
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int i = 4 * (tid + k * kThreads);
    const long long p = p0 + i;
    if (p >= p1) break;
    const int4 s = *reinterpret_cast<const int4*>(&seg[i]);
    const int g[4] = {s.x, s.y, s.z, s.w};
    bool live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) live[j] = g[j] >= 0 && g[j] < n;
    for (int r = 0; r < rows; ++r) {
      const uint32_t* vrow = vals + static_cast<long long>(r) * n;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = live[j] ? __ldg(vrow + g[j]) : 0u;
      store4(out + static_cast<long long>(r) * out_len, p, p1, row_vec(r),
             make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
}

}  // namespace

extern "C" int dns_expand_segments(const void* vals, const void* starts,
                                   void* out, int rows, int n, int out_len,
                                   void* stream) {
  if (out_len > 0 && rows > 0) {
    const int blocks = static_cast<int>(
        (static_cast<long long>(out_len) + kChunk - 1) / kChunk);
    const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    expand_segments_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(vals),
        static_cast<const int32_t*>(starts), static_cast<uint32_t*>(out), rows,
        n, out_len, aligned);
  }
  return static_cast<int>(cudaGetLastError());
}
