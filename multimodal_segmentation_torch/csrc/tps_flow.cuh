// The thin-plate-spline flow of the output points, shared by the fused warp
// (tps_warp.cu, kernel B1) and the flow-stage dump (tps_flow_dbg.cu, B5),
// so that the dump shows exactly the flow that the warp blends at.
//
// For output point q = qi * W + qj of image b,
//
//   (qy, qx) = (qi / (H-1), qj / (W-1)),
//   phi_i(q) = 0.5 r2 log(max(r2, 1e-10)),  r2 = |(qy, qx) - cp_i|^2,
//   f_b(q)   = sum_i w_bi * phi_i(q) + [qy, qx, 1] @ v_b,
//
// in f32 with the accurate logf. The basis phi_i(q) depends on the point
// and on the control grid only, which every image shares; only [w; v]
// differs per image. So the flow comes in two parts: tps_basis evaluates
// the 25 phi_i of a point once (the logf are most of the flow's cost), and
// tps_flow sums one image's flow from them. tps_for_each_point_image runs
// both for every (point, image) of a block and hands each flow to the
// kernel's start and finish. The RBF sum cancels heavily, so the
// expressions and their order are fixed (phi first, then fy += phi * w for
// i = 0..24, then the affine rows): every image count computes the same
// bits, and nvcc contracts the same FMAs in both kernels.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// control_grid((5, 5)): every configuration's cp_dims. A compile-time count
// keeps phi in registers (a runtime-indexed array would go to local memory).
constexpr int kControlPoints = 25;
constexpr int kCoefficients = (kControlPoints + 3) * 2;  // [w; v], (y, x)
constexpr int kThreads = 256;  // a thread a point
// images a block, whose coefficients the block stages in shared memory.
// Of the layouts measured on the H100 (PERF.md), a thread a point serving
// 8 images was the fastest or within 3 % of it at B = 12 (f32 and bf16)
// and B = 24 (bf16).
constexpr int kChunk = 8;

// The normalised query point (qy, qx) of output point q and the 25 basis
// terms phi_i there. s_cp: (25, 2) control points (y, x).
struct TpsBasis {
  float qy;
  float qx;
  float phi[kControlPoints];
};

__device__ __forceinline__ TpsBasis tps_basis(int q, int H, int W, const float* s_cp) {
  TpsBasis t;
  const int qi = q / W;
  const int qj = q - qi * W;
  // control_grid((H, W)): row-major (y, x), each axis divided by (dim - 1)
  t.qy = (float)qi / (float)(H - 1);
  t.qx = (float)qj / (float)(W - 1);
#pragma unroll
  for (int i = 0; i < kControlPoints; ++i) {
    const float dy = t.qy - s_cp[2 * i];
    const float dx = t.qx - s_cp[2 * i + 1];
    const float d2 = dy * dy + dx * dx;
    t.phi[i] = 0.5f * d2 * logf(fmaxf(d2, 1e-10f));
  }
  return t;
}

// One image's flow (normalised; times H-1 / W-1: pixels) from the basis
// phi of a point and that image's coefficients s_wv, (25 + 3, 2).
__device__ __forceinline__ void tps_flow(const float* phi, float qy, float qx,
                                         const float* s_wv, float* fy_out, float* fx_out) {
  float fy = 0.f;
  float fx = 0.f;
#pragma unroll
  for (int i = 0; i < kControlPoints; ++i) {
    fy += phi[i] * s_wv[2 * i];
    fx += phi[i] * s_wv[2 * i + 1];
  }
  const float* v = s_wv + 2 * kControlPoints;  // affine rows multiply qy, qx, 1
  fy += qy * v[0] + qx * v[2] + v[4];
  fx += qy * v[1] + qx * v[3] + v[5];
  *fy_out = fy;
  *fx_out = fx;
}

// For every output point q of this block (a thread a point) and every
// image b of its chunk (images blockIdx.y * kChunk onwards, at most
// kChunk of them), runs
//
//   auto pending = start(b, q, qy, qx, phi0, fy, fx);  ...  finish(pending);
//
// The chunk's coefficients and the control points go to shared memory once
// per block. A thread evaluates its point's basis into registers and
// serves the chunk's images in turn, summing the next image's flow between
// start and finish of this one (a kernel that issues its loads in start
// has them in flight meanwhile).
template <typename Start, typename Finish>
__device__ __forceinline__ void tps_for_each_point_image(const float* __restrict__ wv,
                                                         const float* __restrict__ cp,
                                                         int B, int H, int W, Start start,
                                                         Finish finish) {
  __shared__ float s_cp[kControlPoints * 2];
  __shared__ float s_wv[kChunk * kCoefficients];
  const int b0 = blockIdx.y * kChunk;
  const int nb = min(kChunk, B - b0);
  for (int i = threadIdx.x; i < nb * kCoefficients; i += blockDim.x)
    s_wv[i] = wv[(int64_t)b0 * kCoefficients + i];
  for (int i = threadIdx.x; i < kControlPoints * 2; i += blockDim.x) s_cp[i] = cp[i];
  __syncthreads();

  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= H * W) return;
  const TpsBasis t = tps_basis(q, H, W, s_cp);
  float fy, fx;
  tps_flow(t.phi, t.qy, t.qx, s_wv, &fy, &fx);
  for (int k = 0; k < nb; ++k) {
    auto pending = start(b0 + k, q, t.qy, t.qx, t.phi[0], fy, fx);
    if (k + 1 < nb) tps_flow(t.phi, t.qy, t.qx, s_wv + (k + 1) * kCoefficients, &fy, &fx);
    finish(pending);
  }
}

// The grid of tps_for_each_point_image for B images of H x W; B is at
// most 65535 (the callers' check), so the chunks fit in gridDim.y.
inline dim3 tps_grid(int B, int H, int W) {
  const int64_t n = (int64_t)H * W;
  return dim3((unsigned)((n + kThreads - 1) / kThreads), (unsigned)((B + kChunk - 1) / kChunk));
}
