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
// What bounds it: bytes. Each slab word and key is read once and 2 RU + 2
// floats are written per id (at 1M ids the writes are two thirds of the
// bytes). The first design (one thread per id: a binary search of ~20
// dependent loads, then a serial walk of the id's run, neighbouring threads
// a run apart) was latency-bound at 2.5-7x the bound.
//
// Design: one CTA of 128 threads per block of 256 or 512 consecutive ids
// (the wrapper takes 512 while such a grid still fills every CTA slot of
// the card: fewer CTAs pay the fixed costs below when there are many waves,
// smaller blocks keep every SM busy when there is one).
// 1. Two warps find the block's lanes [a, b) with one warp-wide search each
//    over the key row (warp_search.cuh): the first lane whose key is >= g0
//    and the first >= g0 + ids. Every id's run lies inside exactly one
//    block, so no partial sum crosses a CTA and no second pass or side
//    buffer is needed; the sentinel tail (keys >= N) lies past every block
//    and is never read.
// 2. The CTA walks [a, b) in tiles of 512 lanes, 4 consecutive lanes a
//    thread, loaded with 16-byte loads when the slab's row stride is a
//    multiple of 4 words (the caller pads it), and decodes in registers.
//    However long a run is, 128 threads share it.
// 3. A segmented scan by key in a fixed order, with heads where the key
//    changes: each thread folds its 4 lanes in lane order; the warp combines
//    the threads' (head, sum) pairs with 5 shuffle rounds; the CTA combines
//    the 4 warps' pairs in warp order through shared memory, starting from
//    the run carried over from the previous tile. The lane where a run ends
//    stores the run's sum into a shared (2 RU + 2, ids) tile. No atomics:
//    every sum is formed in an order fixed by the tile structure, so two runs
//    give the same bits (the order differs from lane order; the sums agree
//    with a lane-order sum to float32 rounding).
// 4. The shared tile starts at zero, so ids without lanes are exact zeros,
//    and leaves in coalesced rows: the output is written once, with no
//    separate zero pass.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libreduce_segments_bykey.so
//        reduce_segments_bykey.cu
// The kernel allocates nothing; the caller owns every buffer.

#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_search.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 4;                 // slab lanes a thread takes a tile
constexpr int kTile = kThreads * kLanes;  // lanes a CTA takes a tile
constexpr int kMaxIds = 512;              // ids a CTA owns: 256 or 512
constexpr unsigned kFull = 0xffffffffu;

// The 2 RU + 2 values of one lane from its RU packed words.
template <int RU>
__device__ __forceinline__ void decode(const uint32_t (&w)[RU][kLanes], int j,
                                       float (&x)[2 * RU + 2]) {
#pragma unroll
  for (int r = 0; r < RU; ++r) {
    x[2 * r] = __uint_as_float(w[r][j] & 0xFFFF0000u);
    x[2 * r + 1] = __uint_as_float(w[r][j] << 16);
  }
  x[2 * RU] = fabsf(x[0]);
  x[2 * RU + 1] = fabsf(x[1]);
}

template <int RU, int IDS>
__global__ void __launch_bounds__(kThreads)
reduce_bykey_kernel(const int32_t* __restrict__ slab, long long stride,
                    int len, int n, float* __restrict__ out,
                    long long out_stride, bool vec) {
  constexpr int NV = 2 * RU + 2;
  __shared__ float acc[NV][IDS];
  __shared__ float warp_sum[kWarps][NV];
  __shared__ int warp_head[kWarps];
  // The run open at the previous tile's end, double-buffered: tile t reads
  // carry[t & 1] and its last warp writes carry[(t + 1) & 1].
  __shared__ float carry[2][NV];
  __shared__ int bounds[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g0 = blockIdx.x * IDS;
  const int g1 = min(n, g0 + IDS);
  const int32_t* keys = slab + RU * stride;

  if (warp < 2) {
    const int x = warp == 0 ? g0 : g1;
    const int l = dns::warp_partition_point(
        keys, 0, len, [x](int32_t k) { return k < x; });
    if (lane == 0) bounds[warp] = l;
  }
  for (int i = tid; i < NV * IDS; i += kThreads) (&acc[0][0])[i] = 0.0f;
  if (tid < NV) carry[0][tid] = 0.0f;
  __syncthreads();
  const int a = bounds[0];
  const int b = bounds[1];

  int buf = 0;
  for (int t0 = a & ~(kLanes - 1); t0 < b; t0 += kTile, buf ^= 1) {
    const int l0 = t0 + kLanes * tid;
    // Lanes outside [a, b) get key -1 (no id) and zero words.
    int key[kLanes];
    uint32_t w[RU][kLanes];
    if (l0 < b && l0 + kLanes > a && vec && l0 + kLanes <= len) {
      const int4 k4 = __ldg(reinterpret_cast<const int4*>(keys + l0));
      key[0] = k4.x; key[1] = k4.y; key[2] = k4.z; key[3] = k4.w;
#pragma unroll
      for (int r = 0; r < RU; ++r) {
        const uint4 w4 = __ldg(reinterpret_cast<const uint4*>(
            slab + r * stride + l0));
        w[r][0] = w4.x; w[r][1] = w4.y; w[r][2] = w4.z; w[r][3] = w4.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const int l = l0 + j;
        const bool in = l >= a && l < b;
        key[j] = in ? __ldg(keys + l) : -1;
#pragma unroll
        for (int r = 0; r < RU; ++r) {
          w[r][j] = in ? static_cast<uint32_t>(__ldg(slab + r * stride + l))
                       : 0u;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (l0 + j < a || l0 + j >= b) {
        key[j] = -1;
#pragma unroll
        for (int r = 0; r < RU; ++r) w[r][j] = 0u;
      }
    }
    // The keys of the lanes just before and just after this thread's.
    int prev = __shfl_up_sync(kFull, key[kLanes - 1], 1);
    if (lane == 0) {
      prev = (l0 - 1 >= a && l0 - 1 < b) ? __ldg(keys + l0 - 1) : -1;
    }
    int next = __shfl_down_sync(kFull, key[0], 1);
    if (lane == 31) {
      next = (l0 + kLanes >= a && l0 + kLanes < b)
                 ? __ldg(keys + l0 + kLanes) : -1;
    }
    bool head[kLanes];
    head[0] = key[0] != prev;
#pragma unroll
    for (int j = 1; j < kLanes; ++j) head[j] = key[j] != key[j - 1];

    // The thread's (head, sum): the lanes from its last head on, in order.
    float s[NV];
    float x[NV];
    decode<RU>(w, 0, s);
    bool f = head[0];
#pragma unroll
    for (int j = 1; j < kLanes; ++j) {
      decode<RU>(w, j, x);
#pragma unroll
      for (int v = 0; v < NV; ++v) s[v] = head[j] ? x[v] : s[v] + x[v];
      f = f || head[j];
    }
    // Inclusive segmented scan over the warp: (f1, s1) then (f2, s2) gives
    // (f1 | f2, f2 ? s2 : s1 + s2).
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const bool of = __shfl_up_sync(kFull, static_cast<int>(f), d) != 0;
#pragma unroll
      for (int v = 0; v < NV; ++v) x[v] = __shfl_up_sync(kFull, s[v], d);
      if (lane >= d) {
        if (!f) {
#pragma unroll
          for (int v = 0; v < NV; ++v) s[v] = x[v] + s[v];
        }
        f = f || of;
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int v = 0; v < NV; ++v) warp_sum[warp][v] = s[v];
      warp_head[warp] = f;
    }
    // Exclusive: the lanes of the open run before this thread, in the warp.
    const bool ef = __shfl_up_sync(kFull, static_cast<int>(f), 1) != 0;
#pragma unroll
    for (int v = 0; v < NV; ++v) s[v] = __shfl_up_sync(kFull, s[v], 1);
    __syncthreads();

    // Across warps, in warp order, from the carried run.
    float run[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) run[v] = carry[buf][v];
#pragma unroll 1
    for (int u = 0; u < warp; ++u) {
      const bool uf = warp_head[u] != 0;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        run[v] = uf ? warp_sum[u][v] : run[v] + warp_sum[u][v];
      }
    }
    if (warp == kWarps - 1 && lane == 0) {  // the next tile's carry
      const bool uf = warp_head[warp] != 0;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        carry[buf ^ 1][v] =
            uf ? warp_sum[warp][v] : run[v] + warp_sum[warp][v];
      }
    }
    if (lane > 0) {
#pragma unroll
      for (int v = 0; v < NV; ++v) run[v] = ef ? s[v] : run[v] + s[v];
    }
    // Walk the thread's lanes; the lane that ends a run stores its sum.
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      decode<RU>(w, j, x);
#pragma unroll
      for (int v = 0; v < NV; ++v) run[v] = head[j] ? x[v] : run[v] + x[v];
      const int after = j + 1 < kLanes ? key[j + 1] : next;
      if (key[j] != after && key[j] >= g0 && key[j] < g1) {
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[v][key[j] - g0] = run[v];
      }
    }
    __syncthreads();  // warp_sum and carry[buf] are rewritten next tile
  }

  const int count = g1 - g0;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int k = 0; k < IDS / kThreads; ++k) {
      const int i = tid + k * kThreads;
      if (i < count) out[v * out_stride + g0 + i] = acc[v][i];
    }
  }
}

template <int RU>
void launch(const int32_t* slab, long long stride, int len, int n, float* out,
            long long out_stride, int ids, cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(slab) & 15) == 0 &&
                   (stride & 3) == 0;
  if (ids == kMaxIds) {
    reduce_bykey_kernel<RU, kMaxIds>
        <<<(n + kMaxIds - 1) / kMaxIds, kThreads, 0, stream>>>(
            slab, stride, len, n, out, out_stride, vec);
  } else {
    reduce_bykey_kernel<RU, kMaxIds / 2>
        <<<(n + kMaxIds / 2 - 1) / (kMaxIds / 2), kThreads, 0, stream>>>(
            slab, stride, len, n, out, out_stride, vec);
  }
}

template <int RU>
int resident() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, reduce_bykey_kernel<RU, kMaxIds>, kThreads, 0);
  return blocks;
}

}  // namespace

// Ids a CTA owns: `ids_per_cta`, 256 or 512 (the wrapper chooses by
// `rasterize_cuda.bykey_ids_per_cta`).
extern "C" int dns_reduce_segments_bykey(const void* slab, long long stride,
                                         int len, int ru, int n, void* out,
                                         long long out_stride, int ids_per_cta,
                                         void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (len < 0 || len > INT_MAX - 2 * kTile ||
      (ids_per_cta != kMaxIds / 2 && ids_per_cta != kMaxIds)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto sl = static_cast<const int32_t*>(slab);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int ids = ids_per_cta;
  switch (ru) {
    case 1: launch<1>(sl, stride, len, n, o, out_stride, ids, s); break;
    case 2: launch<2>(sl, stride, len, n, o, out_stride, ids, s); break;
    case 3: launch<3>(sl, stride, len, n, o, out_stride, ids, s); break;
    case 4: launch<4>(sl, stride, len, n, o, out_stride, ids, s); break;
    case 5: launch<5>(sl, stride, len, n, o, out_stride, ids, s); break;
    case 6: launch<6>(sl, stride, len, n, o, out_stride, ids, s); break;
    case 7: launch<7>(sl, stride, len, n, o, out_stride, ids, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the RU instance that one SM holds at once (0 for an unknown RU).
extern "C" int dns_reduce_segments_bykey_resident(int ru) {
  switch (ru) {
    case 1: return resident<1>();
    case 2: return resident<2>();
    case 3: return resident<3>();
    case 4: return resident<4>();
    case 5: return resident<5>();
    case 6: return resident<6>();
    case 7: return resident<7>();
    default: return 0;
  }
}
