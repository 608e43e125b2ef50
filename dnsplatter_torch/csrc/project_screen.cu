// The per-Gaussian screen-space stage of a render and its gradient, on Hopper
// (sm_90a): EWA projection, the per-Gaussian normal in the camera frame and
// the (N, 7) feature rows, for every capacity row.
//
// Replaces no Pallas kernel: the JAX package's `project_gaussians`,
// `per_gaussian_normals` and `world_to_camera_normals` are plain jnp, which
// XLA fuses into a few passes over the rows. Run eagerly by PyTorch, the same
// functions made about 290 elementwise launches over the rows forward and
// about 420 in autograd's backward, most of them on strided (N,) columns
// unbound from (N, 3) and (N, 4) rows, and a `torch.cat` of the features.
// Same function as `rasterize_cuda.project_screen_plain` (that is,
// `ops/projection.project_gaussians` on exp(scales) with sigmoid(opacities),
// `ops/normals.per_gaussian_normals`, `world_to_camera_normals` and the
// features' concatenation):
//
//   forward:  means2d (N, 2), conics (N, 3), depths (N,), opacities (N,)
//             (times the compensation when antialiased), features (N, 7)
//             = [colors, camera-frame normal, depth], valid (N,) (alive and
//             in the frustum), radii_xy (N, 2), radii (N,)
//   backward: the gradients of means (N, 3), quats (N, 4), log-scales
//             (N, 3), opacity logits (N,) and colors (N, 3) for those of
//             means2d, conics, depths, opacities and features; with the
//             camera's, the gradients of viewmat[:3, :4] and c2w[:3, :3].
//
// Rounding. The forward rounds each operation where PyTorch's elementwise op
// of the plain version rounds it (no FMA contraction: __fmul_rn, __fadd_rn,
// ...), and fuses where PyTorch's own kernels fuse, as measured on an H100
// with torch 2.11 / CUDA 12.8: `means @ rot.T` is cuBLAS's chain
// fma(m2, r2, fma(m1, r1, m0 r0)); `torch.linalg.norm` over 4 sums
// (x0^2 + x2^2) + (x1^2 + x3^2), over 3 (x0^2 + x2^2) + x1^2, each square
// rounded; `torch.sum` over 3 sums (p0 + p2) + p1; `torch.linalg.cross` is
// fma(a1, b2, -(a2 b1)); sigmoid is 1 / (1 + exp(-x)); a Python scalar over a
// tensor is the tensor's reciprocal times the scalar. So every discrete
// outcome (the ceil of the radii, the `valid` comparisons, the argmin of the
// scales with ties to the lower index, the camera-facing flip, the clamps of
// txz / tyz, the `where`s on tz, det and the norms) agrees with the plain
// version on the card bit for bit, and so do the continuous outputs up to
// exp / log, which both take from CUDA's libdevice. The backward computes the
// same gradients as autograd, through the same masks (a clamp passes its
// gradient at a tie, as torch.clamp does; a `where` passes none to its
// constant side), in its own order of operations: it agrees to rounding.
//
// What bounds it: bytes. The forward reads a row's means, quats, log-scales,
// opacity logit, alive and colours (60 B) and writes 69 B; the backward reads
// the incoming gradients (13 words, 52 B, where the rasterizer's backward
// left them: strided columns of one (N, 15) array), the four parameter rows
// again (44 B) and writes five gradient rows (56 B). 281 B a row for the
// pair, against some 600 FP32 operations, two a byte where the card does 20.
//
// Design:
// 1. One thread a row, 128 rows a CTA. The camera (viewmat, c2w, fx, fy, cx,
//    cy: device tensors, never read by the host) is read by every thread
//    through the read-only cache, the same words for the whole grid.
// 2. Quaternion rows (16 B) load as one float4 where the tensor is aligned;
//    (N, 3) rows as three words, a warp's three covering 384 contiguous
//    bytes.
// 3. The backward recomputes the forward of its row with the same inline
//    code (so every mask it takes is the forward's), and reads each incoming
//    gradient through its own row and column strides: no copy of the
//    rasterizer's gradient columns is made.
// 4. The camera's gradient (21 words a row) is summed over the CTA by warp
//    shuffles, written as one partial row a CTA, and the partials summed by a
//    second small kernel in a fixed order: two runs give the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libproject_screen.so project_screen.cu
// The kernels allocate nothing and do not synchronise; the caller owns every
// buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // rows, and threads, a CTA
constexpr int kCamWords = 21;  // d rot_wc (9), d t_wc (3), d c2w rotation (9)
constexpr float kEps2d = 0.3f;
constexpr float kNormEps = 1e-12f;

// One rounding each, as PyTorch's elementwise ops round.
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
// a0 b0 + a1 b1 + a2 b2, each product and sum rounded apart
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
// torch.clamp_min / clamp_max with a scalar: a NaN stays NaN
__device__ __forceinline__ float at_least(float v, float lo) {
  return v < lo ? lo : v;
}
__device__ __forceinline__ float at_most(float v, float hi) {
  return v > hi ? hi : v;
}
// torch.linalg.cross(a, b)[i] for the cyclic (j, k) = (i + 1, i + 2)
__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* c) {
  c[0] = __fmaf_rn(a[1], b[2], -mul(a[2], b[1]));
  c[1] = __fmaf_rn(a[2], b[0], -mul(a[0], b[2]));
  c[2] = __fmaf_rn(a[0], b[1], -mul(a[1], b[0]));
}
// torch.linalg.norm over a row of 3
__device__ __forceinline__ float norm3(const float* v) {
  return root(add(add(mul(v[0], v[0]), mul(v[2], v[2])), mul(v[1], v[1])));
}

struct Camera {
  float R[3][3], T[3];  // viewmat[:3, :3], viewmat[:3, 3]
  float C[3][3];        // c2w[:3, :3]
  float pos[3];         // c2w[:3, 3]
  float fx, fy, cx, cy;
  float lim_x, lim_y;   // 1.3 tan(fov / 2)
};

__device__ __forceinline__ void load_camera(
    const float* __restrict__ viewmat, const float* __restrict__ c2w,
    const float* __restrict__ fx, const float* __restrict__ fy,
    const float* __restrict__ cx, const float* __restrict__ cy, int width,
    int height, Camera& k) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      k.R[i][j] = __ldg(viewmat + 4 * i + j);
      k.C[i][j] = __ldg(c2w + 4 * i + j);
    }
    k.T[i] = __ldg(viewmat + 4 * i + 3);
    k.pos[i] = __ldg(c2w + 4 * i + 3);
  }
  k.fx = __ldg(fx);
  k.fy = __ldg(fy);
  k.cx = __ldg(cx);
  k.cy = __ldg(cy);
  // tan_fov = 0.5 W / fx: fx's reciprocal times the scalar
  k.lim_x = mul(1.3f, mul(dvd(1.0f, k.fx), 0.5f * static_cast<float>(width)));
  k.lim_y = mul(1.3f, mul(dvd(1.0f, k.fy), 0.5f * static_cast<float>(height)));
}

// Everything of the forward of one row that its backward reads.
struct Row {
  float m[3], q[4], sl[3], ol;
  float qnorm, qden, qn[4];
  float rq[3][3], s[3], M[3][3], B[3][3];
  float cov[6];  // c00 c01 c02 c11 c12 c22
  float mc[3], tzs, vx, vy, cvx, cvy, txz, tyz, rz, rz2;
  float j00, j02, j11, j12, A1, A2, B1, B2, C1, C2;
  float a, b, c, det_orig, a_b, c_b, det, ds, ratio, comp;
  float conic[3], m2[2], opr;
  // the normal: the flattest axis, rotated, normalised, facing the camera
  int idx;  // the flattest axis
  float t[3], out[3], onorm, oden, nrm[3], nw[3], ncam[3];
  bool flip;
};

__device__ __forceinline__ void load_row(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ scales, const float* __restrict__ opac_logit,
    bool quats_aligned, long long g, Row& r) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    r.m[j] = __ldg(means + 3 * g + j);
    r.sl[j] = __ldg(scales + 3 * g + j);
  }
  if (quats_aligned) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(quats) + g);
    r.q[0] = v.x;
    r.q[1] = v.y;
    r.q[2] = v.z;
    r.q[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) r.q[j] = __ldg(quats + 4 * g + j);
  }
  r.ol = __ldg(opac_logit + g);
}

// The forward of one row, rounded as the plain version rounds it.
__device__ __forceinline__ void forward_row(const Camera& k, Row& r) {
  // quat_normalize
  const float* q = r.q;
  r.qnorm = root(add(add(mul(q[0], q[0]), mul(q[2], q[2])),
                     add(mul(q[1], q[1]), mul(q[3], q[3]))));
  r.qden = at_least(r.qnorm, kNormEps);
#pragma unroll
  for (int j = 0; j < 4; ++j) r.qn[j] = dvd(q[j], r.qden);
  const float w = r.qn[0], x = r.qn[1], y = r.qn[2], z = r.qn[3];
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  r.rq[0][0] = sub(1.0f, mul(2.0f, add(yy, zz)));
  r.rq[0][1] = mul(2.0f, sub(xy, wz));
  r.rq[0][2] = mul(2.0f, add(xz, wy));
  r.rq[1][0] = mul(2.0f, add(xy, wz));
  r.rq[1][1] = sub(1.0f, mul(2.0f, add(xx, zz)));
  r.rq[1][2] = mul(2.0f, sub(yz, wx));
  r.rq[2][0] = mul(2.0f, sub(xz, wy));
  r.rq[2][1] = mul(2.0f, add(yz, wx));
  r.rq[2][2] = sub(1.0f, mul(2.0f, add(xx, yy)));
#pragma unroll
  for (int j = 0; j < 3; ++j) r.s[j] = expf(r.sl[j]);
  // b[i][j] = (W r)[i][j] s[j], summed over k in order
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r.M[i][j] = dot3(k.R[i][0], r.rq[0][j], k.R[i][1], r.rq[1][j],
                       k.R[i][2], r.rq[2][j]);
      r.B[i][j] = mul(r.M[i][j], r.s[j]);
    }
  }
  {
    int e = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int l = i; l < 3; ++l) {
        r.cov[e++] = dot3(r.B[i][0], r.B[l][0], r.B[i][1], r.B[l][1],
                          r.B[i][2], r.B[l][2]);
      }
    }
  }
  const float c00 = r.cov[0], c01 = r.cov[1], c02 = r.cov[2], c11 = r.cov[3],
              c12 = r.cov[4], c22 = r.cov[5];
  // mean_c = means @ rot_wc.T + t_wc
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float p =
        __fmaf_rn(r.m[2], k.R[i][2],
                  __fmaf_rn(r.m[1], k.R[i][1], mul(r.m[0], k.R[i][0])));
    r.mc[i] = add(p, k.T[i]);
  }
  const float tz = r.mc[2];
  r.tzs = fabsf(tz) < 1e-8f ? 1e-8f : tz;
  r.vx = dvd(r.mc[0], r.tzs);
  r.vy = dvd(r.mc[1], r.tzs);
  // torch.clamp with tensor bounds: min(max(v, lo), hi), a NaN kept
  r.cvx = r.vx != r.vx ? r.vx : fminf(fmaxf(r.vx, -k.lim_x), k.lim_x);
  r.cvy = r.vy != r.vy ? r.vy : fminf(fmaxf(r.vy, -k.lim_y), k.lim_y);
  r.txz = mul(r.cvx, r.tzs);
  r.tyz = mul(r.cvy, r.tzs);
  r.rz = dvd(1.0f, r.tzs);
  r.rz2 = mul(r.rz, r.rz);
  r.j00 = mul(k.fx, r.rz);
  r.j02 = mul(mul(-k.fx, r.txz), r.rz2);
  r.j11 = mul(k.fy, r.rz);
  r.j12 = mul(mul(-k.fy, r.tyz), r.rz2);
  const float j00 = r.j00, j02 = r.j02, j11 = r.j11, j12 = r.j12;
  r.A1 = add(mul(j00, c00), mul(j02, c02));
  r.A2 = add(mul(j00, c02), mul(j02, c22));
  r.B1 = add(mul(j11, c01), mul(j12, c02));
  r.B2 = add(mul(j11, c12), mul(j12, c22));
  r.C1 = add(mul(j11, c11), mul(j12, c12));
  r.C2 = add(mul(j11, c12), mul(j12, c22));
  r.a = add(mul(j00, r.A1), mul(j02, r.A2));
  r.b = add(mul(j00, r.B1), mul(j02, r.B2));
  r.c = add(mul(j11, r.C1), mul(j12, r.C2));
  r.det_orig = sub(mul(r.a, r.c), mul(r.b, r.b));
  r.a_b = add(r.a, kEps2d);
  r.c_b = add(r.c, kEps2d);
  r.det = sub(mul(r.a_b, r.c_b), mul(r.b, r.b));
  r.ds = r.det <= 0.0f ? 1e-12f : r.det;
  r.ratio = dvd(r.det_orig, r.ds);
  r.comp = root(at_least(r.ratio, 0.0f));
  r.conic[0] = dvd(r.c_b, r.ds);
  r.conic[1] = dvd(-r.b, r.ds);
  r.conic[2] = dvd(r.a_b, r.ds);
  r.m2[0] = add(mul(mul(k.fx, r.mc[0]), r.rz), k.cx);
  r.m2[1] = add(mul(mul(k.fy, r.mc[1]), r.rz), k.cy);
  r.opr = dvd(1.0f, add(1.0f, expf(-r.ol)));

  // per_gaussian_normals: argmin of the log-scales (ties to the lower index,
  // a NaN wins as torch's argmin lets it)
  int idx = 0;
  float best = r.sl[0];
#pragma unroll
  for (int j = 1; j < 3; ++j) {
    if (best == best && (r.sl[j] < best || r.sl[j] != r.sl[j])) {
      best = r.sl[j];
      idx = j;
    }
  }
  r.idx = idx;
  const float e[3] = {idx == 0 ? 1.0f : 0.0f, idx == 1 ? 1.0f : 0.0f,
                      idx == 2 ? 1.0f : 0.0f};
  const float qv[3] = {x, y, z};
  // quat_rotate: v + w t + qv x t with t = 2 qv x v
  float cr[3];
  cross(qv, e, cr);
#pragma unroll
  for (int j = 0; j < 3; ++j) r.t[j] = mul(2.0f, cr[j]);
  cross(qv, r.t, cr);
#pragma unroll
  for (int j = 0; j < 3; ++j) r.out[j] = add(add(e[j], mul(w, r.t[j])), cr[j]);
  r.onorm = norm3(r.out);
  r.oden = at_least(r.onorm, kNormEps);
#pragma unroll
  for (int j = 0; j < 3; ++j) r.nrm[j] = dvd(r.out[j], r.oden);
  float vd[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) vd[j] = sub(k.pos[j], r.m[j]);
  const float vden = at_least(norm3(vd), kNormEps);
#pragma unroll
  for (int j = 0; j < 3; ++j) vd[j] = dvd(vd[j], vden);
  const float dots = add(add(mul(r.nrm[0], vd[0]), mul(r.nrm[2], vd[2])),
                         mul(r.nrm[1], vd[1]));
  r.flip = dots < 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) r.nw[j] = r.flip ? -r.nrm[j] : r.nrm[j];
  // world_to_camera_normals: n @ c2w[:3, :3]
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r.ncam[i] = add(add(mul(r.nw[0], k.C[0][i]), mul(r.nw[1], k.C[1][i])),
                    mul(r.nw[2], k.C[2][i]));
}

// The screen extents of a row and whether it is in the frustum (the plain
// version computes them under no_grad); `valid` is that and alive.
__device__ __forceinline__ bool extents(const Row& r, int width, int height,
                                        float near_plane, float far_plane,
                                        float* radius, float* rx, float* ry) {
  const float mid = mul(0.5f, add(r.a_b, r.c_b));
  const float disc = root(at_least(sub(mul(mid, mid), r.det), 0.01f));
  const float vmax = add(mid, disc);
  const float sigma_bound =
      at_most(logf(at_least(mul(255.0f, r.opr), 1e-12f)), 4.5f);
  const float sb2 = mul(2.0f, at_least(sigma_bound, 0.0f));
  *radius = ceilf(root(mul(sb2, at_least(vmax, 0.0f))));
  *rx = ceilf(root(mul(sb2, at_least(r.a_b, 0.0f))));
  *ry = ceilf(root(mul(sb2, at_least(r.c_b, 0.0f))));
  const float tz = r.mc[2];
  return tz > near_plane && tz < far_plane && r.det > 0.0f && *radius > 0.0f &&
         add(r.m2[0], *rx) > 0.0f &&
         sub(r.m2[0], *rx) < static_cast<float>(width) &&
         add(r.m2[1], *ry) > 0.0f &&
         sub(r.m2[1], *ry) < static_cast<float>(height);
}

// The incoming gradients of one row (zero where the caller passed none).
struct RowGrads {
  float m2[2], conic[3], depth, opac, feat[7];
};

// The gradients of one row's inputs, as autograd computes them through the
// plain version: dm (3), dq (4), dsl (3), dol, and the camera's (kCamWords:
// d rot_wc row-major, d t_wc, d c2w[:3, :3] row-major) where `cam` is set.
// Every product and sum is rounded on its own, as autograd's elementwise
// backward ops round them: where two terms cancel exactly in autograd (a
// flat Gaussian's gradient along the rotation about its normal, whose two
// in-plane scales are equal), they cancel here as often. A fused
// multiply-add would leave the rounding error of one of them instead, a
// gradient of 1e-12 where autograd's is 0, which Adam (eps 1e-15) turns
// into a full step.
template <bool AA>
__device__ __forceinline__ void backward_row(const Camera& k, const Row& r,
                                             const RowGrads& g, float* dm,
                                             float* dq, float* dsl, float* dol,
                                             float* cam) {
  // -- the normal: features[:, 3:6] = nw @ C --
  float dnw[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    dnw[j] = dot3(g.feat[3], k.C[j][0], g.feat[4], k.C[j][1], g.feat[5],
                  k.C[j][2]);
  if (cam != nullptr) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        cam[12 + 3 * j + i] = mul(g.feat[3 + i], r.nw[j]);
  }
  float dn[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) dn[j] = r.flip ? -dnw[j] : dnw[j];
  // nrm = out / max(|out|, eps)
  float dout[3];
  {
    const float dot = dot3(dn[0], r.out[0], dn[1], r.out[1], dn[2], r.out[2]);
    const float dden = -dvd(dot, mul(r.oden, r.oden));
    const float dnorm = r.onorm >= kNormEps ? dvd(dden, r.onorm) : 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dout[j] = add(dvd(dn[j], r.oden), mul(dnorm, r.out[j]));
  }
  // out = e + w t + qv x t, t = 2 qv x e
  const float w = r.qn[0];
  const float qv[3] = {r.qn[1], r.qn[2], r.qn[3]};
  float dqn[4];
  dqn[0] = dot3(dout[0], r.t[0], dout[1], r.t[1], dout[2], r.t[2]);
  float dt[3], dqv[3];
  dt[0] = add(mul(w, dout[0]), sub(mul(dout[1], qv[2]), mul(dout[2], qv[1])));
  dt[1] = add(mul(w, dout[1]), sub(mul(dout[2], qv[0]), mul(dout[0], qv[2])));
  dt[2] = add(mul(w, dout[2]), sub(mul(dout[0], qv[1]), mul(dout[1], qv[0])));
  dqv[0] = sub(mul(r.t[1], dout[2]), mul(r.t[2], dout[1]));
  dqv[1] = sub(mul(r.t[2], dout[0]), mul(r.t[0], dout[2]));
  dqv[2] = sub(mul(r.t[0], dout[1]), mul(r.t[1], dout[0]));
  // + 2 e x dt, e the one-hot flattest axis: with (i, j, k) cyclic,
  // (e_i x dt)[j] = -dt[k], (e_i x dt)[k] = dt[j]
  if (r.idx == 0) {
    dqv[1] = sub(dqv[1], mul(2.0f, dt[2]));
    dqv[2] = add(dqv[2], mul(2.0f, dt[1]));
  } else if (r.idx == 1) {
    dqv[2] = sub(dqv[2], mul(2.0f, dt[0]));
    dqv[0] = add(dqv[0], mul(2.0f, dt[2]));
  } else {
    dqv[0] = sub(dqv[0], mul(2.0f, dt[1]));
    dqv[1] = add(dqv[1], mul(2.0f, dt[0]));
  }
  dqn[1] = dqv[0];
  dqn[2] = dqv[1];
  dqn[3] = dqv[2];

  // -- the projection --
  const float fx = k.fx, fy = k.fy;
  const float j00 = r.j00, j02 = r.j02, j11 = r.j11, j12 = r.j12;
  float d_mc[3] = {mul(mul(g.m2[0], fx), r.rz), mul(mul(g.m2[1], fy), r.rz),
                   0.0f};
  float d_rz = add(mul(g.m2[0], mul(fx, r.mc[0])),
                   mul(g.m2[1], mul(fy, r.mc[1])));
  // conic = (c_b, -b, a_b) / ds
  float d_cb = dvd(g.conic[0], r.ds);
  float d_b = -dvd(g.conic[1], r.ds);
  float d_ab = dvd(g.conic[2], r.ds);
  float d_ds = -dvd(dot3(g.conic[0], r.conic[0], g.conic[1], r.conic[1],
                         g.conic[2], r.conic[2]), r.ds);
  float d_do = 0.0f;
  float d_opr = g.opac;
  if (AA) {
    d_opr = mul(g.opac, r.comp);
    const float d_comp = mul(g.opac, r.opr);
    // sqrt(clamp_min(ratio, 0)): grad / (2 sqrt), passed where ratio >= 0
    const float d_ratio =
        r.ratio >= 0.0f ? dvd(d_comp, mul(2.0f, r.comp)) : 0.0f;
    d_do = dvd(d_ratio, r.ds);
    d_ds = sub(d_ds, dvd(mul(d_ratio, r.ratio), r.ds));
  }
  // ds = where(det <= 0, 1e-12, det)
  const float d_det = r.det <= 0.0f ? 0.0f : d_ds;
  d_ab = add(d_ab, mul(d_det, r.c_b));
  d_cb = add(d_cb, mul(d_det, r.a_b));
  d_b = sub(d_b, mul(mul(2.0f, r.b), add(d_det, d_do)));
  const float d_a = add(d_ab, mul(d_do, r.c));
  const float d_c = add(d_cb, mul(d_do, r.a));
  // a = j00 A1 + j02 A2, b = j00 B1 + j02 B2, c = j11 C1 + j12 C2
  const float dA1 = mul(d_a, j00), dA2 = mul(d_a, j02), dB1 = mul(d_b, j00),
              dB2 = mul(d_b, j02), dC1 = mul(d_c, j11), dC2 = mul(d_c, j12);
  const float c00 = r.cov[0], c01 = r.cov[1], c02 = r.cov[2], c11 = r.cov[3],
              c12 = r.cov[4], c22 = r.cov[5];
  const float d_j00 = add(add(mul(d_a, r.A1), mul(d_b, r.B1)),
                          add(mul(dA1, c00), mul(dA2, c02)));
  const float d_j02 = add(add(mul(d_a, r.A2), mul(d_b, r.B2)),
                          add(mul(dA1, c02), mul(dA2, c22)));
  const float d_j11 =
      add(add(mul(d_c, r.C1), add(mul(dB1, c01), mul(dB2, c12))),
          add(mul(dC1, c11), mul(dC2, c12)));
  const float d_j12 =
      add(add(mul(d_c, r.C2), add(mul(dB1, c02), mul(dB2, c22))),
          add(mul(dC1, c12), mul(dC2, c22)));
  float dcov[6];
  dcov[0] = mul(dA1, j00);
  dcov[1] = mul(dB1, j11);
  dcov[2] = add(add(mul(dA1, j02), mul(dA2, j00)), mul(dB1, j12));
  dcov[3] = mul(dC1, j11);
  dcov[4] = add(add(mul(dB2, j11), mul(dC1, j12)), mul(dC2, j11));
  dcov[5] = add(add(mul(dA2, j02), mul(dB2, j12)), mul(dC2, j12));
  // j00 = fx rz, j02 = (-fx txz) rz2, and the same in y
  d_rz = add(d_rz, add(mul(d_j00, fx), mul(d_j11, fy)));
  const float d_txz = mul(mul(d_j02, r.rz2), -fx);
  const float d_tyz = mul(mul(d_j12, r.rz2), -fy);
  const float d_rz2 = add(mul(d_j02, mul(-fx, r.txz)),
                          mul(d_j12, mul(-fy, r.tyz)));
  d_rz = add(d_rz, mul(mul(2.0f, r.rz), d_rz2));
  float d_tzs = -mul(d_rz, mul(r.rz, r.rz));
  // txz = clamp(vx, -lim, lim) tzs, vx = mc0 / tzs; a tie passes
  d_tzs = add(d_tzs, add(mul(d_txz, r.cvx), mul(d_tyz, r.cvy)));
  const float d_vx =
      (r.vx >= -k.lim_x && r.vx <= k.lim_x) ? mul(d_txz, r.tzs) : 0.0f;
  const float d_vy =
      (r.vy >= -k.lim_y && r.vy <= k.lim_y) ? mul(d_tyz, r.tzs) : 0.0f;
  d_mc[0] = add(d_mc[0], dvd(d_vx, r.tzs));
  d_mc[1] = add(d_mc[1], dvd(d_vy, r.tzs));
  d_tzs = sub(d_tzs, dvd(add(mul(d_vx, r.vx), mul(d_vy, r.vy)), r.tzs));
  // tzs = where(|tz| < 1e-8, 1e-8, tz); depth = tz
  d_mc[2] = add(add(fabsf(r.mc[2]) < 1e-8f ? 0.0f : d_tzs, g.feat[6]),
                g.depth);
  // mean_c = W m + t
#pragma unroll
  for (int j = 0; j < 3; ++j)
    dm[j] = dot3(d_mc[0], k.R[0][j], d_mc[1], k.R[1][j], d_mc[2], k.R[2][j]);
  if (cam != nullptr) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) cam[3 * i + j] = mul(d_mc[i], r.m[j]);
      cam[9 + i] = d_mc[i];
    }
  }
  // cov[i][l] = sum_j B[i][j] B[l][j]
  float dB[3][3];
  {
    const float g00 = mul(2.0f, dcov[0]), g11 = mul(2.0f, dcov[3]),
                g22 = mul(2.0f, dcov[5]);
    const float g01 = dcov[1], g02 = dcov[2], g12 = dcov[4];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dB[0][j] = dot3(g00, r.B[0][j], g01, r.B[1][j], g02, r.B[2][j]);
      dB[1][j] = dot3(g01, r.B[0][j], g11, r.B[1][j], g12, r.B[2][j]);
      dB[2][j] = dot3(g02, r.B[0][j], g12, r.B[1][j], g22, r.B[2][j]);
    }
  }
  // B[i][j] = M[i][j] s[j], M = W rq
  float G[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float ds_j = dot3(dB[0][j], r.M[0][j], dB[1][j], r.M[1][j],
                            dB[2][j], r.M[2][j]);
    dsl[j] = mul(ds_j, r.s[j]);  // s = exp(log-scale)
    const float dM0 = mul(dB[0][j], r.s[j]), dM1 = mul(dB[1][j], r.s[j]),
                dM2 = mul(dB[2][j], r.s[j]);
#pragma unroll
    for (int kk = 0; kk < 3; ++kk)
      G[kk][j] = dot3(dM0, k.R[0][kk], dM1, k.R[1][kk], dM2, k.R[2][kk]);
    if (cam != nullptr) {
      // d W[i][kk] += dM[i][j] rq[kk][j]
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
        cam[kk] = add(cam[kk], mul(dM0, r.rq[kk][j]));
        cam[3 + kk] = add(cam[3 + kk], mul(dM1, r.rq[kk][j]));
        cam[6 + kk] = add(cam[6 + kk], mul(dM2, r.rq[kk][j]));
      }
    }
  }
  // rq from the unit quaternion (w, x, y, z): the gradients of the nine
  // products, then of each component
  {
    const float x = r.qn[1], y = r.qn[2], z = r.qn[3];
    const float g_xx = -mul(2.0f, add(G[1][1], G[2][2]));
    const float g_yy = -mul(2.0f, add(G[0][0], G[2][2]));
    const float g_zz = -mul(2.0f, add(G[0][0], G[1][1]));
    const float g_xy = mul(2.0f, add(G[0][1], G[1][0]));
    const float g_xz = mul(2.0f, add(G[0][2], G[2][0]));
    const float g_yz = mul(2.0f, add(G[1][2], G[2][1]));
    const float g_wx = mul(2.0f, sub(G[2][1], G[1][2]));
    const float g_wy = mul(2.0f, sub(G[0][2], G[2][0]));
    const float g_wz = mul(2.0f, sub(G[1][0], G[0][1]));
    dqn[0] = add(dqn[0], dot3(g_wx, x, g_wy, y, g_wz, z));
    dqn[1] = add(dqn[1], add(add(mul(g_wx, w), mul(g_xz, z)),
                             add(mul(g_xy, y), mul(mul(2.0f, g_xx), x))));
    dqn[2] = add(dqn[2], add(add(mul(g_wy, w), mul(g_yz, z)),
                             add(mul(g_xy, x), mul(mul(2.0f, g_yy), y))));
    dqn[3] = add(dqn[3], add(add(mul(g_wz, w), mul(g_yz, y)),
                             add(mul(g_xz, x), mul(mul(2.0f, g_zz), z))));
  }
  // qn = q / max(|q|, eps)
  {
    const float dot = add(add(mul(dqn[0], r.q[0]), mul(dqn[1], r.q[1])),
                          add(mul(dqn[2], r.q[2]), mul(dqn[3], r.q[3])));
    const float dnorm =
        r.qnorm >= kNormEps
            ? dvd(-dvd(dot, mul(r.qden, r.qden)), r.qnorm)
            : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq[j] = add(dvd(dqn[j], r.qden), mul(dnorm, r.q[j]));
  }
  // sigmoid: grad (1 - y) y
  *dol = mul(mul(d_opr, sub(1.0f, r.opr)), r.opr);
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

struct Inputs {
  const float* means;
  const float* quats;
  const float* scales;
  const float* opac_logit;
  const float* viewmat;
  const float* c2w;
  const float* fx;
  const float* fy;
  const float* cx;
  const float* cy;
  int width, height;
  long long n;
  bool quats_aligned;
};

template <bool AA>
__global__ void __launch_bounds__(kRows)
    project_forward_kernel(Inputs in, const float* __restrict__ colors,
                           const float* __restrict__ alive, float near_plane,
                           float far_plane, float* __restrict__ means2d,
                           float* __restrict__ conics,
                           float* __restrict__ depths,
                           float* __restrict__ opacities,
                           float* __restrict__ features,
                           unsigned char* __restrict__ valid,
                           float* __restrict__ radii_xy,
                           float* __restrict__ radii) {
  const long long g = static_cast<long long>(blockIdx.x) * kRows + threadIdx.x;
  if (g >= in.n) return;
  Camera k;
  load_camera(in.viewmat, in.c2w, in.fx, in.fy, in.cx, in.cy, in.width,
              in.height, k);
  Row r;
  load_row(in.means, in.quats, in.scales, in.opac_logit, in.quats_aligned, g,
           r);
  forward_row(k, r);
  float radius, rx, ry;
  const bool ok = extents(r, in.width, in.height, near_plane, far_plane,
                          &radius, &rx, &ry);
  means2d[2 * g] = r.m2[0];
  means2d[2 * g + 1] = r.m2[1];
#pragma unroll
  for (int j = 0; j < 3; ++j) conics[3 * g + j] = r.conic[j];
  depths[g] = r.mc[2];
  opacities[g] = AA ? mul(r.opr, r.comp) : r.opr;
  float* f = features + 7 * g;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    f[j] = __ldg(colors + 3 * g + j);
    f[3 + j] = r.ncam[j];
  }
  f[6] = r.mc[2];
  valid[g] = ok && __ldg(alive + g) > 0.5f ? 1 : 0;
  radii_xy[2 * g] = ok ? rx : 0.0f;
  radii_xy[2 * g + 1] = ok ? ry : 0.0f;
  radii[g] = ok ? radius : 0.0f;
}

// An incoming gradient: element (row, col) at p[row * rs + col * cs]; null
// reads as zeros.
struct GradView {
  const float* p;
  long long rs, cs;
  __device__ __forceinline__ float at(long long row, int col) const {
    return p == nullptr ? 0.0f : __ldg(p + row * rs + col * cs);
  }
};

struct GradViews {
  GradView m2, conic, depth, opac, feat;
};

struct Outputs {
  float* d_means;
  float* d_quats;
  float* d_scales;
  float* d_opac;
  float* d_colors;
  float* cam_partial;  // (blocks, kCamWords), CAM only
};

template <bool AA, bool CAM>
__global__ void __launch_bounds__(kRows)
    project_backward_kernel(Inputs in, GradViews gv, Outputs out) {
  const long long g = static_cast<long long>(blockIdx.x) * kRows + threadIdx.x;
  float cam[kCamWords];
#pragma unroll
  for (int i = 0; i < kCamWords; ++i) cam[i] = 0.0f;
  if (g < in.n) {
    Camera k;
    load_camera(in.viewmat, in.c2w, in.fx, in.fy, in.cx, in.cy, in.width,
                in.height, k);
    Row r;
    load_row(in.means, in.quats, in.scales, in.opac_logit, in.quats_aligned,
             g, r);
    forward_row(k, r);
    RowGrads gr;
    gr.m2[0] = gv.m2.at(g, 0);
    gr.m2[1] = gv.m2.at(g, 1);
#pragma unroll
    for (int j = 0; j < 3; ++j) gr.conic[j] = gv.conic.at(g, j);
    gr.depth = gv.depth.at(g, 0);
    gr.opac = gv.opac.at(g, 0);
#pragma unroll
    for (int j = 0; j < 7; ++j) gr.feat[j] = gv.feat.at(g, j);
    float dm[3], dq[4], dsl[3], dol;
    backward_row<AA>(k, r, gr, dm, dq, dsl, &dol, CAM ? cam : nullptr);
    if (out.d_means != nullptr) {
#pragma unroll
      for (int j = 0; j < 3; ++j) out.d_means[3 * g + j] = dm[j];
    }
    if (out.d_quats != nullptr) {
      reinterpret_cast<float4*>(out.d_quats)[g] =
          make_float4(dq[0], dq[1], dq[2], dq[3]);
    }
    if (out.d_scales != nullptr) {
#pragma unroll
      for (int j = 0; j < 3; ++j) out.d_scales[3 * g + j] = dsl[j];
    }
    if (out.d_opac != nullptr) out.d_opac[g] = dol;
    if (out.d_colors != nullptr) {
#pragma unroll
      for (int j = 0; j < 3; ++j) out.d_colors[3 * g + j] = gr.feat[j];
    }
  }
  if constexpr (CAM) {
    // the CTA's sum of each camera word: warp shuffles, then the warps
    __shared__ float part[kRows / 32][kCamWords];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < kCamWords; ++i) {
      float v = cam[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) part[warp][i] = v;
    }
    __syncthreads();
    if (threadIdx.x < kCamWords) {
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kRows / 32; ++w) v += part[w][threadIdx.x];
      out.cam_partial[static_cast<long long>(blockIdx.x) * kCamWords +
                      threadIdx.x] = v;
    }
  }
}

// One CTA an entry of d_viewmat (4, 4) then d_c2w (4, 4): the sum of its
// partial column over the CTAs of the backward, in a fixed order; zeros
// where the kernel computes no gradient (the bottom rows, c2w's translation).
constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kSumThreads)
    camera_sum_kernel(const float* __restrict__ partial, long long blocks,
                      float* __restrict__ d_viewmat,
                      float* __restrict__ d_c2w) {
  const int entry = blockIdx.x;  // 0-15 viewmat, 16-31 c2w
  const int row = (entry & 15) >> 2, col = entry & 3;
  int word = -1;
  if (row < 3) {
    if (entry < 16)
      word = col < 3 ? 3 * row + col : 9 + row;
    else if (col < 3)
      word = 12 + 3 * row + col;
  }
  __shared__ float acc[kSumThreads];
  float v = 0.0f;
  if (word >= 0) {
    for (long long b = threadIdx.x; b < blocks; b += kSumThreads)
      v += partial[b * kCamWords + word];
  }
  acc[threadIdx.x] = v;
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) acc[threadIdx.x] += acc[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) (entry < 16 ? d_viewmat : d_c2w)[entry & 15] = acc[0];
}

Inputs make_inputs(const void* means, const void* quats, const void* scales,
                   const void* opac_logit, const void* viewmat,
                   const void* c2w, const void* fx, const void* fy,
                   const void* cx, const void* cy, int width, int height,
                   long long n) {
  Inputs in;
  in.means = static_cast<const float*>(means);
  in.quats = static_cast<const float*>(quats);
  in.scales = static_cast<const float*>(scales);
  in.opac_logit = static_cast<const float*>(opac_logit);
  in.viewmat = static_cast<const float*>(viewmat);
  in.c2w = static_cast<const float*>(c2w);
  in.fx = static_cast<const float*>(fx);
  in.fy = static_cast<const float*>(fy);
  in.cx = static_cast<const float*>(cx);
  in.cy = static_cast<const float*>(cy);
  in.width = width;
  in.height = height;
  in.n = n;
  in.quats_aligned = (reinterpret_cast<uintptr_t>(quats) & 15) == 0;
  return in;
}

long long grid_of(long long n) { return (n + kRows - 1) / kRows; }

}  // namespace

// The forward of N rows: means (N, 3), quats (N, 4), log-scales (N, 3),
// opacity logits (N,), colors (N, 3), alive (N,) contiguous float32;
// viewmat and c2w (4, 4) contiguous, fx, fy, cx, cy 0-d, all float32 on the
// card; `planes`, on the host, the float32 near and far planes. Writes
// means2d (N, 2), conics (N, 3), depths (N,), opacities (N,), features
// (N, 7), valid (N,) bytes 0 / 1, radii_xy (N, 2), radii (N,).
extern "C" int dns_project_screen(
    const void* means, const void* quats, const void* scales,
    const void* opac_logit, const void* colors, const void* alive,
    const void* viewmat, const void* c2w, const void* fx, const void* fy,
    const void* cx, const void* cy, int width, int height,
    const void* planes, int antialiased, long long n, void* means2d,
    void* conics, void* depths, void* opacities, void* features, void* valid,
    void* radii_xy, void* radii, void* stream) {
  if (n < 0 || grid_of(n) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float near_plane = static_cast<const float*>(planes)[0];
  const float far_plane = static_cast<const float*>(planes)[1];
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const Inputs in = make_inputs(means, quats, scales, opac_logit, viewmat,
                                c2w, fx, fy, cx, cy, width, height, n);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(grid_of(n));
  auto launch = antialiased ? project_forward_kernel<true>
                            : project_forward_kernel<false>;
  launch<<<blocks, kRows, 0, s>>>(
      in, static_cast<const float*>(colors), static_cast<const float*>(alive),
      near_plane, far_plane, static_cast<float*>(means2d),
      static_cast<float*>(conics), static_cast<float*>(depths),
      static_cast<float*>(opacities), static_cast<float*>(features),
      static_cast<unsigned char*>(valid), static_cast<float*>(radii_xy),
      static_cast<float*>(radii));
  return static_cast<int>(cudaGetLastError());
}

// The gradients of dns_project_screen's inputs for those of its outputs.
// g_* are the incoming gradients (null: zero), element (row, col) of each at
// g[row * rs + col * cs] with `strides`, on the host, eight long longs:
// {means2d rs, cs, conics rs, cs, depths s, opacities s, features rs, cs}. d_means (N, 3), d_quats (N, 4,
// 16-byte aligned), d_scales (N, 3), d_opac (N,), d_colors (N, 3): a null
// output is not written. With `cam_partial` ((N + 127) / 128 x 21 floats of
// scratch) the kernel also writes d_viewmat and d_c2w, both (4, 4).
extern "C" int dns_project_screen_backward(
    const void* means, const void* quats, const void* scales,
    const void* opac_logit, const void* viewmat, const void* c2w,
    const void* fx, const void* fy, const void* cx, const void* cy,
    int width, int height, int antialiased, long long n,
    const void* g_means2d, const void* g_conics, const void* g_depths,
    const void* g_opac, const void* g_features, const void* strides_,
    void* d_means, void* d_quats, void* d_scales, void* d_opac,
    void* d_colors, void* d_viewmat, void* d_c2w, void* cam_partial,
    void* stream) {
  if (n < 0 || grid_of(n) > 0x7fffffffLL ||
      (cam_partial != nullptr && (d_viewmat == nullptr || d_c2w == nullptr)) ||
      (reinterpret_cast<uintptr_t>(d_quats) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const bool cam = cam_partial != nullptr;
  const long long* strides = static_cast<const long long*>(strides_);
  if (n > 0) {
    const Inputs in = make_inputs(means, quats, scales, opac_logit, viewmat,
                                  c2w, fx, fy, cx, cy, width, height, n);
    GradViews gv;
    gv.m2 = {static_cast<const float*>(g_means2d), strides[0], strides[1]};
    gv.conic = {static_cast<const float*>(g_conics), strides[2], strides[3]};
    gv.depth = {static_cast<const float*>(g_depths), strides[4], 0};
    gv.opac = {static_cast<const float*>(g_opac), strides[5], 0};
    gv.feat = {static_cast<const float*>(g_features), strides[6], strides[7]};
    Outputs out = {static_cast<float*>(d_means), static_cast<float*>(d_quats),
                   static_cast<float*>(d_scales), static_cast<float*>(d_opac),
                   static_cast<float*>(d_colors),
                   static_cast<float*>(cam_partial)};
    const unsigned blocks = static_cast<unsigned>(grid_of(n));
    auto launch =
        antialiased
            ? (cam ? project_backward_kernel<true, true>
                   : project_backward_kernel<true, false>)
            : (cam ? project_backward_kernel<false, true>
                   : project_backward_kernel<false, false>);
    launch<<<blocks, kRows, 0, s>>>(in, gv, out);
  }
  if (cam) {
    camera_sum_kernel<<<32, kSumThreads, 0, s>>>(
        static_cast<const float*>(cam_partial), grid_of(n),
        static_cast<float*>(d_viewmat), static_cast<float*>(d_c2w));
  }
  return static_cast<int>(cudaGetLastError());
}
