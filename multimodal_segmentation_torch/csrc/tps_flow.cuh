// The thin-plate-spline flow of one output point, shared by the fused warp
// (tps_warp.cu, kernel B1) and the flow-stage dump (tps_flow_dbg.cu, B5),
// so that the dump shows exactly the flow that the warp blends at.
//
// For output point q = qi * W + qj of an image,
//
//   (qy, qx) = (qi / (H-1), qj / (W-1)),
//   f(q) = sum_i w_i * 0.5 r2 log(max(r2, 1e-10)) + [qy, qx, 1] @ v,
//
// in f32 with the accurate logf, in one fixed order: the RBF sum cancels
// heavily, so the expressions and their order stay as they are (nvcc
// contracts the same FMAs in both kernels). A caller that does not read
// phi0 loses it to dead-code elimination.

#pragma once

#include <math.h>
#include <stdint.h>

constexpr int kMaxControlPoints = 64;

struct TpsFlow {
  float qy;    // normalised query point
  float qx;
  float phi0;  // the first radial basis term
  float fy;    // flow, normalised (times H-1 / W-1: pixels)
  float fx;
};

// Copies image b's (n_cp + 3, 2) coefficients [w; v] and the (n_cp, 2)
// control points into shared memory; the caller synchronises after it.
__device__ __forceinline__ void tps_stage_coefficients(float* s_wv, float* s_cp,
                                                       const float* __restrict__ wv,
                                                       const float* __restrict__ cp,
                                                       int b, int n_cp) {
  const int n_wv = (n_cp + 3) * 2;
  for (int i = threadIdx.x; i < n_wv; i += blockDim.x)
    s_wv[i] = wv[(int64_t)b * n_wv + i];
  for (int i = threadIdx.x; i < n_cp * 2; i += blockDim.x) s_cp[i] = cp[i];
}

// s_wv: [w; v] as (n_cp + 3, 2), s_cp: (n_cp, 2), both (y, x).
__device__ __forceinline__ TpsFlow tps_flow(int q, int H, int W, const float* s_wv,
                                            const float* s_cp, int n_cp) {
  const int qi = q / W;
  const int qj = q - qi * W;
  // control_grid((H, W)): row-major (y, x), each axis divided by (dim - 1)
  const float qy = (float)qi / (float)(H - 1);
  const float qx = (float)qj / (float)(W - 1);

  float fy = 0.f;
  float fx = 0.f;
  float phi0 = 0.f;
  for (int i = 0; i < n_cp; ++i) {
    const float dy = qy - s_cp[2 * i];
    const float dx = qx - s_cp[2 * i + 1];
    const float d2 = dy * dy + dx * dx;
    const float phi = 0.5f * d2 * logf(fmaxf(d2, 1e-10f));
    if (i == 0) phi0 = phi;
    fy += phi * s_wv[2 * i];
    fx += phi * s_wv[2 * i + 1];
  }
  const float* v = s_wv + 2 * n_cp;  // affine rows multiply qy, qx, 1
  fy += qy * v[0] + qx * v[2] + v[4];
  fx += qy * v[1] + qx * v[3] + v[5];
  return {qy, qx, phi0, fy, fx};
}
