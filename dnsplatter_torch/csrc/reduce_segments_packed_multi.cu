// Per-Gaussian sums over KP independently sorted pieces of a bf16-packed
// gradient slab, on Hopper (sm_90a).
//
// Replaces the Pallas kernel `reduce_segments_packed_multi`
// (dnsplatter_tpu/ops/rasterize_pallas.py:997, kernel
// `_make_reduce_packed_multi_kernel:923`). Same function: `packed` is
// (KP, PR, CP), each piece sorted by Gaussian id on its own, and Gaussian g
// owns the piece-local lanes [piece_starts[j, g], piece_starts[j, g + 1]) of
// piece j. Output (2 PR + 2, N) float32: the decoded field sums over all KP
// ranges, then sum |field 0| and sum |field 1|. A Gaussian without lanes in
// any piece gives exact zeros; lanes at or past piece_starts[j, N] are never
// read.
//
// The TPU version ran one program per 256-id block and, per piece, streamed
// 512-lane chunks against a range-membership one-hot, with coarse per-piece
// block bounds, a 512-lane tail after each piece and a padded id count. Here
// one thread per id walks its KP ranges, piece 0 first, each in lane order,
// adding in float32 into one set of registers, and writes once. No atomics,
// one fixed order: two runs give the same bits.
//
// What bounds it: bytes. Each slab word below its piece's end and each
// boundary is read once, 2 PR + 2 floats are written per id. Within a piece,
// neighbouring threads own neighbouring ranges, so a warp's loads fall into
// one contiguous stretch of each row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libreduce_segments_packed_multi.so
//        reduce_segments_packed_multi.cu
// The kernel allocates nothing; the caller owns every buffer.

#include "packed_run.cuh"

namespace {

template <int PR>
__global__ void reduce_packed_multi_kernel(
    const int32_t* __restrict__ packed, long long piece_stride,
    long long row_stride, int cp, const int32_t* __restrict__ piece_starts,
    int kp, int n, float* __restrict__ out, long long out_stride) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  float acc[2 * PR + 2];
#pragma unroll
  for (int v = 0; v < 2 * PR + 2; ++v) acc[v] = 0.0f;
  for (int j = 0; j < kp; ++j) {
    // Boundaries are local to piece j: they index its own (PR, CP) slab.
    const int32_t* st = piece_starts + static_cast<long long>(j) * (n + 1);
    dns::add_packed_run<PR>(packed + j * piece_stride, row_stride,
                            max(__ldg(st + g), 0), min(__ldg(st + g + 1), cp),
                            acc);
  }
#pragma unroll
  for (int v = 0; v < 2 * PR + 2; ++v) out[v * out_stride + g] = acc[v];
}

template <int PR>
void launch(const int32_t* packed, long long piece_stride, long long row_stride,
            int cp, const int32_t* piece_starts, int kp, int n, float* out,
            long long out_stride, cudaStream_t stream) {
  constexpr int kThreads = 128;
  reduce_packed_multi_kernel<PR>
      <<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          packed, piece_stride, row_stride, cp, piece_starts, kp, n, out,
          out_stride);
}

}  // namespace

extern "C" int dns_reduce_segments_packed_multi(
    const void* packed, long long piece_stride, long long row_stride, int cp,
    const void* piece_starts, int kp, int pr, int n, void* out,
    long long out_stride, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto pk = static_cast<const int32_t*>(packed);
  auto st = static_cast<const int32_t*>(piece_starts);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define DNS_CASE(PR)                                                         \
  case PR:                                                                   \
    launch<PR>(pk, piece_stride, row_stride, cp, st, kp, n, o, out_stride, s); \
    break;
  switch (pr) {
    DNS_CASE(1) DNS_CASE(2) DNS_CASE(3) DNS_CASE(4) DNS_CASE(5) DNS_CASE(6)
    DNS_CASE(7)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DNS_CASE
  return static_cast<int>(cudaGetLastError());
}
