// Inclusive int32 prefix sum along the last axis of an (R, C) table, on
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `cumsum_lanes_i32`
// (dnsplatter_tpu/ops/rasterize_pallas.py:117, kernel
// `_make_cumsum_kernel:97`): out[r, p] = x[r, 0] + ... + x[r, p].
//
// The TPU version swept the lanes in sequence, one 512-lane block per grid
// step: a triangular matrix product in float32 plus a carry in scratch
// memory, exact only while every running sum stays below 2^24. Here the
// adds are integer adds: exact at any magnitude, wrapping like int32, and
// the same bits from run to run.
//
// What bounds it: bytes. The function must read and write R * C words once
// each and does one add a word. The first design (tiles scanned with 8
// consecutive words a thread, loaded one word at a time, then a pass that
// read and rewrote every tile to add its prefix) moved about twice those
// bytes with 32 sectors a warp instruction, and ran at 6.9x the bound on an
// H100 SXM.
//
// Design: one pass with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016).
// - A CTA of 256 threads takes a tile of 12,288 lanes of one row, its
//   number drawn from a counter, so every tile it may wait on was drawn
//   earlier by a CTA that is already running: no wait can deadlock.
// - The tile is 12 strips of 1,024 lanes; in each strip a thread holds 4
//   consecutive lanes, loaded and stored as one 16-byte word, neighbouring
//   threads on neighbouring words, so each warp instruction moves 512
//   contiguous bytes. The thread scans its lanes in registers; warp
//   shuffles scan the strips' thread totals at once; one warp scans the
//   96 (strip, warp) totals in strip order. Registers are capped at 80 so
//   that 3 CTAs share an SM: 144 KB of loads in flight an SM.
// - The tile publishes its aggregate, then its inclusive prefix, in one
//   64-bit status word (flag in the high half, value in the low half),
//   written with one release store and read with acquire loads. A row's
//   first tile publishes its prefix at once, so a row never reads another.
// - Warp 0 looks back over 32 predecessors at a time: it adds aggregates
//   until the nearest published prefix, which ends the walk.
// On an H100 SXM, at the (4, 12,582,912) table of a 2^24-Gaussian frame,
// tiles of 4,096 and 8,192 lanes were slower (more tiles in flight, each
// with its counter draw, barriers and look-back), and 16,384 lanes with 2
// CTAs an SM no faster; so were persistent CTAs that load their next tile
// before the look-back, and look-back windows of 128 predecessors.
// A row that does not start on a 16-byte boundary (C % 4 != 0, or a table
// that starts off one) is cut into tiles from the boundary below its start:
// its first and last word groups are read and written one word at a time,
// inside the same kernel. Such rows get 3 lanes of spare room, so a row's
// last tile may lie wholly past its end: it publishes zero.
//
// Reduce-then-scan (tile totals, a scan of them per row, then the tiles
// again with their prefixes: the table read twice) was slower on an H100
// SXM at that table; PERF.md has both times.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcumsum_lanes_i32.so cumsum_lanes_i32.cu
// The kernel allocates nothing; the caller owns the output and the
// scratch: 1 + R * tiles 64-bit words, zero at launch (the first is the
// tile counter, the rest the status words).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrips = 12;
constexpr int kStrip = kThreads * 4;   // lanes of one strip
constexpr int kTile = kStrips * kStrip;  // 12,288 lanes
constexpr int kPer = kStrips * kWarps / 32;  // (strip, warp) totals a lane
static_assert(kStrips * kWarps % 32 == 0, "one warp scans the totals");
constexpr unsigned kFull = 0xffffffffu;
// Status flags, in the high half of a tile's status word.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Where a tile lies: row `row`, lanes [p0, p0 + kTile) of it (p0 may be
// negative by the row's misalignment `head`, 0..3 words).
struct Tile {
  const uint32_t* x;  // the row's first word
  uint32_t* out;
  long long p0;
  long long c;
  bool vec;
};

__device__ __forceinline__ Tile locate(const uint32_t* x, uint32_t* out,
                                       long long c, int tiles, bool vec,
                                       long long id) {
  const long long row = id / tiles;
  const long long t = id - row * tiles;
  Tile tl;
  tl.x = x + row * c;
  tl.out = out + row * c;
  tl.c = c;
  tl.vec = vec;
  const int head =
      vec ? static_cast<int>((reinterpret_cast<uintptr_t>(tl.x) >> 2) & 3) : 0;
  tl.p0 = t * kTile - head;
  return tl;
}

// Loads the thread's 4 lanes of each strip and scans them in place:
// `v[s][3]` is the thread's total of strip s.
__device__ __forceinline__ void load_scan(const Tile& tl,
                                          uint32_t (&v)[kStrips][4]) {
#pragma unroll
  for (int s = 0; s < kStrips; ++s) {
    const long long p = tl.p0 + s * kStrip + 4 * threadIdx.x;
    if (tl.vec && p >= 0 && p + 4 <= tl.c) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(tl.x + p));
      v[s][0] = w.x; v[s][1] = w.y; v[s][2] = w.z; v[s][3] = w.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[s][j] = (p + j >= 0 && p + j < tl.c) ? __ldg(tl.x + p + j) : 0u;
      }
    }
    v[s][1] += v[s][0];
    v[s][2] += v[s][1];
    v[s][3] += v[s][2];
  }
}

__device__ __forceinline__ void store(const Tile& tl,
                                      const uint32_t (&v)[kStrips][4],
                                      const uint32_t (&off)[kStrips]) {
#pragma unroll
  for (int s = 0; s < kStrips; ++s) {
    const long long p = tl.p0 + s * kStrip + 4 * threadIdx.x;
    const uint32_t o = off[s];
    if (tl.vec && p >= 0 && p + 4 <= tl.c) {
      *reinterpret_cast<uint4*>(tl.out + p) =
          make_uint4(v[s][0] + o, v[s][1] + o, v[s][2] + o, v[s][3] + o);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (p + j >= 0 && p + j < tl.c) tl.out[p + j] = v[s][j] + o;
      }
    }
  }
}

// Scans the tile's (strip, thread) totals. On return (the block in step),
// `part[s]` holds the thread's exclusive offset of strip s within the tile
// and warp 0 holds the tile's aggregate in `*agg` (every lane).
// `sums` is kStrips * kWarps words of shared memory.
__device__ __forceinline__ void scan_totals(const uint32_t (&v)[kStrips][4],
                                            uint32_t* sums,
                                            uint32_t (&part)[kStrips],
                                            uint32_t* agg) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t incl[kStrips];
#pragma unroll
  for (int s = 0; s < kStrips; ++s) incl[s] = v[s][3];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int s = 0; s < kStrips; ++s) {
      const uint32_t up = __shfl_up_sync(kFull, incl[s], d);
      if (lane >= d) incl[s] += up;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int s = 0; s < kStrips; ++s) sums[s * kWarps + warp] = incl[s];
  }
  __syncthreads();
  if (warp == 0) {  // the (strip, warp) totals, strip-major, kPer a lane
    uint32_t w[kPer];
    uint32_t run = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      w[i] = run;
      run += sums[lane * kPer + i];
    }
    uint32_t x = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t up = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += up;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) sums[lane * kPer + i] = x - run + w[i];
    *agg = __shfl_sync(kFull, x, 31);
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStrips; ++s) {
    part[s] = sums[s * kWarps + warp] + incl[s] - v[s][3];
  }
}

// Warp 0: the sum of every tile of the row before tile `id` (the row's
// first tile is `first`), from the status words. Every lane returns it.
__device__ __forceinline__ uint32_t look_back(
    const unsigned long long* status, long long id, long long first) {
  const int lane = threadIdx.x & 31;
  uint32_t excl = 0;
  for (long long top = id - 1;; top -= 32) {
    const long long k = top - lane;  // lane 0 the nearest predecessor
    // Before the row's first tile: an empty prefix, which ends the walk.
    unsigned long long s = k >= first ? load_acquire(status + k) : kPrefix;
    while (__any_sync(kFull, (s >> 32) == 0)) {
      if ((s >> 32) == 0) s = load_acquire(status + k);
    }
    const unsigned prefix = __ballot_sync(kFull, (s >> 32) == 2);
    // up to and including the nearest published prefix
    const bool take = prefix == 0 || lane <= __ffs(prefix) - 1;
    excl += __reduce_add_sync(kFull, take ? static_cast<uint32_t>(s) : 0u);
    if (prefix != 0) return excl;
  }
}

__global__ void __launch_bounds__(kThreads, 3)
scan_tiles(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
           unsigned long long* __restrict__ scratch, long long c, int tiles,
           bool vec) {
  __shared__ uint32_t sums[kStrips * kWarps];
  __shared__ long long ticket;
  __shared__ uint32_t tile_prefix;
  if (threadIdx.x == 0) {
    ticket = static_cast<long long>(atomicAdd(scratch, 1ull));
  }
  __syncthreads();
  const long long id = ticket;
  unsigned long long* status = scratch + 1;
  const Tile tl = locate(x, out, c, tiles, vec, id);
  uint32_t v[kStrips][4];
  load_scan(tl, v);
  uint32_t part[kStrips];
  uint32_t agg;
  scan_totals(v, sums, part, &agg);
  if (threadIdx.x < 32) {
    const long long first = id - id % tiles;
    uint32_t excl = 0;
    if (id == first) {
      if (threadIdx.x == 0) store_release(status + id, kPrefix | agg);
    } else {
      if (threadIdx.x == 0) store_release(status + id, kAggregate | agg);
      excl = look_back(status, id, first);
      if (threadIdx.x == 0) {
        store_release(status + id,
                      kPrefix | static_cast<uint32_t>(excl + agg));
      }
    }
    if (threadIdx.x == 0) tile_prefix = excl;
  }
  __syncthreads();
  uint32_t off[kStrips];
#pragma unroll
  for (int s = 0; s < kStrips; ++s) off[s] = tile_prefix + part[s];
  store(tl, v, off);
}

}  // namespace

// `scratch`: 1 + rows * tiles zeroed 64-bit words, tiles =
// ceil((c + head) / 12288) with head 0 when every row starts on a 16-byte
// boundary (the table 16-byte aligned and c % 4 == 0) and 3 otherwise
// (`rasterize_cuda.cumsum_scratch_words` mirrors this).
extern "C" int dns_cumsum_lanes_i32(const void* x, void* out, void* scratch,
                                    long long scratch_words, int rows,
                                    long long c, void* stream) {
  if (rows == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  if (rows > 65535 || rows < 0 || c < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto xa = reinterpret_cast<uintptr_t>(x);
  const auto oa = reinterpret_cast<uintptr_t>(out);
  // 16-byte words line up in both tables only if they are 16 bytes apart
  const bool vec = ((xa - oa) & 15) == 0;
  // every row starts on a 16-byte boundary, or a row may need a head
  const bool aligned = vec && (xa & 15) == 0 && (c & 3) == 0;
  const long long t = (c + (aligned ? 0 : 3) + kTile - 1) / kTile;
  if (t * rows >= (1ll << 31) || 1 + t * rows > scratch_words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = static_cast<int>(t);
  scan_tiles<<<tiles * rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<unsigned long long*>(scratch), c, tiles, vec);
  return static_cast<int>(cudaGetLastError());
}
