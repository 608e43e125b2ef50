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
// output is (GW, N). An empty range gives exact zeros; lanes outside
// [starts[0], starts[N]) are never read, and every bound is clamped to the
// slab. No atomics and one fixed order of adds, so two runs give the same
// bits: that is why the port's exact gradient reduction (`segsum`) goes
// through this kernel, where a scatter-add on the card adds in arrival
// order.
//
// What bounds it: bytes. Each slab word below starts[N] and each boundary is
// read once, GW floats are written per id. The first design (one thread
// per id walking its range in lane order) made a warp read 32 ranges at
// once, up to 32 sectors a load, and last as long as its longest range
// (2,304 lanes for a Gaussian over many tiles, against a mean of about
// 22): 9.5x the bound on an H100 SXM.
//
// Design: the id-block design of reduce_segments_bykey.cu, with the
// boundaries given instead of searched for in a key row.
// 1. One CTA of 128 threads owns a block of B = 128 consecutive ids. Its
//    B + 1 boundaries, clamped to the slab, are staged in shared memory;
//    its lanes are [starts[g0], starts[g0 + B]), so every range lies in
//    one CTA and no partial sum crosses CTAs. On an H100 SXM at the 127k
//    ids of a 100k-Gaussian training state, blocks of 256 and 512 ids were
//    slower (fewer CTAs than the card holds at once, each walking more
//    tiles); PERF.md has the times.
// 2. The CTA walks its lanes in tiles of 512, 4 consecutive lanes a thread,
//    loaded with 16-byte loads where the slab and its row stride allow
//    (both 16-byte multiples) and the 4 lanes are all the CTA's. A lane's
//    id is a binary search of the staged boundaries (8-10 steps in shared
//    memory).
// 3. A segmented scan by id in a fixed order: each thread folds its 4
//    lanes in lane order; 5 shuffle rounds combine the threads of a warp;
//    the 4 warps combine in warp order through shared memory, starting
//    from the run carried over from the previous tile. The lane where a run
//    ends stores the run's sum into a shared (GW, B) block. The order
//    differs from lane order; the sums agree with a lane-order sum to
//    float32 rounding.
// 4. The block starts at zero, so ids without lanes are exact zeros, and is
//    written once, in coalesced rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libreduce_segments.so reduce_segments.cu
// The kernel allocates nothing; the caller owns every buffer.

#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 4;                 // slab lanes a thread takes a tile
constexpr int kTile = kThreads * kLanes;  // lanes a CTA takes a tile
constexpr int kIds = 128;                 // ids a CTA owns
constexpr unsigned kFull = 0xffffffffu;

template <int GW>
__global__ void __launch_bounds__(kThreads)
reduce_segments_kernel(const float* __restrict__ grads, long long stride,
                       int len, const int32_t* __restrict__ starts, int n,
                       float* __restrict__ out, long long out_stride,
                       bool vec) {
  __shared__ float acc[GW][kIds];
  __shared__ int bnd[kIds + 1];
  __shared__ float warp_sum[kWarps][GW];
  __shared__ int warp_head[kWarps];
  // The run open at the previous tile's end, double-buffered: tile t reads
  // carry[t & 1] and its last warp writes carry[(t + 1) & 1].
  __shared__ float carry[2][GW];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g0 = blockIdx.x * kIds;
  const int count = min(n - g0, kIds);

  for (int i = tid; i <= count; i += kThreads) {
    bnd[i] = min(max(__ldg(starts + g0 + i), 0), len);
  }
  for (int i = tid; i < GW * kIds; i += kThreads) (&acc[0][0])[i] = 0.0f;
  if (tid < GW) carry[0][tid] = 0.0f;
  __syncthreads();
  const int a = bnd[0];
  const int b = bnd[count];
  // The block-local id of lane l: the last i < count with bnd[i] <= l, or
  // -1 outside [a, b). bnd[count] = b > l keeps it below count.
  auto local_id = [&](int l) -> int {
    if (l < a || l >= b) return -1;
    int i = 0;
#pragma unroll
    for (int step = kIds; step > 0; step >>= 1) {
      if (i + step <= count && bnd[i + step] <= l) i += step;
    }
    return i;
  };

  int buf = 0;
  for (int t0 = a & ~(kLanes - 1); t0 < b; t0 += kTile, buf ^= 1) {
    const int l0 = t0 + kLanes * tid;
    // The loads first, so the searches below overlap them.
    float w[GW][kLanes];
    if (vec && l0 >= a && l0 + kLanes <= b) {
#pragma unroll
      for (int r = 0; r < GW; ++r) {
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(
            grads + r * stride + l0));
        w[r][0] = w4.x; w[r][1] = w4.y; w[r][2] = w4.z; w[r][3] = w4.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const bool in = l0 + j >= a && l0 + j < b;
#pragma unroll
        for (int r = 0; r < GW; ++r) {
          w[r][j] = in ? __ldg(grads + r * stride + l0 + j) : 0.0f;
        }
      }
    }
    int key[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) key[j] = local_id(l0 + j);
    // The ids of the lanes just before and just after this thread's.
    int prev = __shfl_up_sync(kFull, key[kLanes - 1], 1);
    if (lane == 0) prev = local_id(l0 - 1);
    int next = __shfl_down_sync(kFull, key[0], 1);
    if (lane == 31) next = local_id(l0 + kLanes);
    bool head[kLanes];
    head[0] = key[0] != prev;
#pragma unroll
    for (int j = 1; j < kLanes; ++j) head[j] = key[j] != key[j - 1];

    // The thread's (head, sum): the lanes from its last head on, in order.
    float s[GW];
    float x[GW];
#pragma unroll
    for (int v = 0; v < GW; ++v) s[v] = w[v][0];
    bool f = head[0];
#pragma unroll
    for (int j = 1; j < kLanes; ++j) {
#pragma unroll
      for (int v = 0; v < GW; ++v) s[v] = head[j] ? w[v][j] : s[v] + w[v][j];
      f = f || head[j];
    }
    // Inclusive segmented scan over the warp: (f1, s1) then (f2, s2) gives
    // (f1 | f2, f2 ? s2 : s1 + s2).
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const bool of = __shfl_up_sync(kFull, static_cast<int>(f), d) != 0;
#pragma unroll
      for (int v = 0; v < GW; ++v) x[v] = __shfl_up_sync(kFull, s[v], d);
      if (lane >= d) {
        if (!f) {
#pragma unroll
          for (int v = 0; v < GW; ++v) s[v] = x[v] + s[v];
        }
        f = f || of;
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int v = 0; v < GW; ++v) warp_sum[warp][v] = s[v];
      warp_head[warp] = f;
    }
    // Exclusive: the lanes of the open run before this thread, in the warp.
    const bool ef = __shfl_up_sync(kFull, static_cast<int>(f), 1) != 0;
#pragma unroll
    for (int v = 0; v < GW; ++v) s[v] = __shfl_up_sync(kFull, s[v], 1);
    __syncthreads();

    // Across warps, in warp order, from the carried run.
    float run[GW];
#pragma unroll
    for (int v = 0; v < GW; ++v) run[v] = carry[buf][v];
#pragma unroll 1
    for (int u = 0; u < warp; ++u) {
      const bool uf = warp_head[u] != 0;
#pragma unroll
      for (int v = 0; v < GW; ++v) {
        run[v] = uf ? warp_sum[u][v] : run[v] + warp_sum[u][v];
      }
    }
    if (warp == kWarps - 1 && lane == 0) {  // the next tile's carry
      const bool uf = warp_head[warp] != 0;
#pragma unroll
      for (int v = 0; v < GW; ++v) {
        carry[buf ^ 1][v] =
            uf ? warp_sum[warp][v] : run[v] + warp_sum[warp][v];
      }
    }
    if (lane > 0) {
#pragma unroll
      for (int v = 0; v < GW; ++v) run[v] = ef ? s[v] : run[v] + s[v];
    }
    // Walk the thread's lanes; the lane that ends a run stores its sum.
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
#pragma unroll
      for (int v = 0; v < GW; ++v) {
        run[v] = head[j] ? w[v][j] : run[v] + w[v][j];
      }
      const int after = j + 1 < kLanes ? key[j + 1] : next;
      if (key[j] != after && key[j] >= 0) {
#pragma unroll
        for (int v = 0; v < GW; ++v) acc[v][key[j]] = run[v];
      }
    }
    __syncthreads();  // warp_sum and carry[buf] are rewritten next tile
  }

#pragma unroll
  for (int v = 0; v < GW; ++v) {
    for (int i = tid; i < count; i += kThreads) {
      out[v * out_stride + g0 + i] = acc[v][i];
    }
  }
}

template <int GW>
void launch(const float* grads, long long stride, int len,
            const int32_t* starts, int n, float* out, long long out_stride,
            cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(grads) & 15) == 0 &&
                   (stride & 3) == 0;
  reduce_segments_kernel<GW><<<(n + kIds - 1) / kIds, kThreads, 0, stream>>>(
      grads, stride, len, starts, n, out, out_stride, vec);
}

}  // namespace

extern "C" int dns_reduce_segments(const void* grads, long long stride, int len,
                                   const void* starts, int gw, int n, void* out,
                                   long long out_stride, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (len < 0 || len > INT_MAX - 2 * kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
