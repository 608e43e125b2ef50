// Inclusive int32 prefix sum along the last axis of an (R, C) table, on
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `cumsum_lanes_i32`
// (dnsplatter_tpu/ops/rasterize_pallas.py:117, kernel
// `_make_cumsum_kernel:97`): out[r, p] = x[r, 0] + ... + x[r, p].
//
// The TPU version swept the lanes in sequence, one 512-lane block per grid
// step: a triangular matrix product in float32 plus a carry in scratch
// memory, exact only while every running sum stays below 2^24. Blocks on the
// card run in parallel and in no order, so the carry becomes a second pass,
// and the adds are integer adds: exact at any magnitude, wrapping like int32.
//
// Three kernels, written out here (no library scan):
//   1. `scan_tiles`: each block scans one tile of kTile lanes of one row:
//      kItems consecutive lanes per thread, the threads' totals by warp
//      shuffles, the warps' totals through shared memory. Writes the tile's
//      scan and its total.
//   2. `scan_totals`: one block per row turns the tile totals into exclusive
//      prefixes, kThreads at a time with a running carry.
//   3. `add_offsets`: every tile but the first adds its prefix.
//
// What bounds it: bytes. The function must read and write R * C words once
// each; this design reads the table once and the output once more for pass 3
// and writes it twice, about twice the least traffic, and does one add per
// word. Loads and stores are kItems consecutive words per thread,
// neighbouring threads on neighbouring addresses.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcumsum_lanes_i32.so cumsum_lanes_i32.cu
// The kernels allocate nothing; the caller owns the output and the
// (R, tiles) scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

// Inclusive scan of one value per thread over the block; `*total` receives
// the block's sum. Unsigned: wrap-around is defined. `warp_sums` holds kWarps
// words of shared memory; the function ends with the block in step.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* warp_sums,
                                               uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += up;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  uint32_t before = 0;
  uint32_t all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t s = warp_sums[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();  // warp_sums may be written again by the caller's next scan
  *total = all;
  return v + before;
}

__global__ void scan_tiles(const uint32_t* __restrict__ x,
                           uint32_t* __restrict__ out,
                           uint32_t* __restrict__ totals, long long c,
                           int tiles) {
  __shared__ uint32_t warp_sums[kWarps];
  const int tile = blockIdx.x;
  const int row = blockIdx.y;
  const long long base = static_cast<long long>(row) * c;
  const long long p0 =
      static_cast<long long>(tile) * kTile + threadIdx.x * kItems;
  uint32_t v[kItems];
  uint32_t run = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long p = p0 + i;
    run += p < c ? __ldg(x + base + p) : 0u;
    v[i] = run;
  }
  uint32_t total;
  const uint32_t before = block_scan(run, warp_sums, &total) - run;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long p = p0 + i;
    if (p < c) out[base + p] = v[i] + before;
  }
  if (threadIdx.x == 0) {
    totals[static_cast<long long>(row) * tiles + tile] = total;
  }
}

// totals[row, t] -> sum of totals[row, 0 .. t) in place.
__global__ void scan_totals(uint32_t* __restrict__ totals, int tiles) {
  __shared__ uint32_t warp_sums[kWarps];
  uint32_t* t = totals + static_cast<long long>(blockIdx.x) * tiles;
  uint32_t carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    const uint32_t v = i < tiles ? t[i] : 0u;
    uint32_t total;
    const uint32_t incl = block_scan(v, warp_sums, &total);
    if (i < tiles) t[i] = carry + incl - v;
    carry += total;
  }
}

__global__ void add_offsets(uint32_t* __restrict__ out,
                            const uint32_t* __restrict__ totals, long long c,
                            int tiles) {
  const int tile = blockIdx.x + 1;  // tile 0 has no prefix
  const int row = blockIdx.y;
  const uint32_t off = __ldg(totals + static_cast<long long>(row) * tiles + tile);
  const long long base = static_cast<long long>(row) * c;
  const long long p0 =
      static_cast<long long>(tile) * kTile + threadIdx.x * kItems;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long p = p0 + i;
    if (p < c) out[base + p] += off;
  }
}

}  // namespace

// `totals` is the caller's (rows, totals_per_row) scratch; it must hold one
// word per tile of kTile = 2048 lanes.
extern "C" int dns_cumsum_lanes_i32(const void* x, void* out, void* totals,
                                    int totals_per_row, int rows, long long c,
                                    void* stream) {
  if (rows <= 0 || c <= 0) return static_cast<int>(cudaGetLastError());
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_ll = (c + kTile - 1) / kTile;
  if (tiles_ll != totals_per_row) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>(tiles_ll);
  auto s = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const uint32_t*>(x);
  auto o = static_cast<uint32_t*>(out);
  auto t = static_cast<uint32_t*>(totals);
  scan_tiles<<<dim3(tiles, rows), kThreads, 0, s>>>(xi, o, t, c, tiles);
  if (tiles > 1) {
    scan_totals<<<rows, kThreads, 0, s>>>(t, tiles);
    add_offsets<<<dim3(tiles - 1, rows), kThreads, 0, s>>>(o, t, c, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
