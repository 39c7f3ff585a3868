// The thin-plate-spline flow stage of the warp, dumped per point, for
// sm_90a.
//
// Replaces tools/debug_warp_kernel.py::flow_dbg (body `kernel`), the TPU
// bisect of the fused warp's flow stage. For every output point q of
// image b it writes five f32 values,
//
//   out[b, q, :] = (f_y * (H-1), f_x * (W-1), qy, qx, phi_0),
//
// the flow in pixels, the normalised query point and the first radial
// basis term: the TPU kernel's first five lanes. The flow is B1's own
// (tps_flow.cuh, the code tps_warp.cu runs), so B1's output equals a
// bilinear blend at these locations, and this kernel's time at B1's
// shapes is the cost of B1's flow stage alone.
//
// Bound. It reads B x 28 x 2 coefficients and writes B x H x W x 20 bytes
// (17.7 MB at B = 24, 192x192: 5.3 us at 3.35 TB/s). Counting a logf as
// one operation, the basis (~9 a term, 25 terms a point, once a point and
// chunk) and each image's sums (2 FMAs a term) take less time at the f32
// rate, so the bound is the bytes. An accurate logf is some thirty
// instructions, though, so the kernel's time over that bound measures the
// flow's arithmetic: its time at B1's shapes is B1's flow stage.
//
// Design. B1's structure and flow code (tps_flow.cuh,
// tps_for_each_point_image): the basis phi_i of a point evaluated once
// for a chunk of images, each image's flow summed from it and its [w; v]
// in shared memory, a thread a point. Neighbouring threads write
// neighbouring 20-byte records, so a warp's five stores cover one
// contiguous 640-byte span. What the TPU layout needed stays behind: the
// 128-lane output padding, the 32-row padding of w and of the control
// points (padded with 7.0), v in SMEM, and the 1024-point blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tps_flow.cuh"

namespace {

constexpr int kColumns = 5;

__global__ void __launch_bounds__(kThreads)
tps_flow_dbg_kernel(const float* __restrict__ wv, const float* __restrict__ cp,
                    float* __restrict__ out, int B, int H, int W) {
  tps_for_each_point_image(
      wv, cp, B, H, W,
      [&](int b, int q, float qy, float qx, float phi0, float fy, float fx) {
        float* o = out + ((int64_t)b * H * W + q) * kColumns;
        o[0] = fy * (float)(H - 1);
        o[1] = fx * (float)(W - 1);
        o[2] = qy;
        o[3] = qx;
        o[4] = phi0;
        return 0;
      },
      [](int) {});
}

}  // namespace

// wv: (B, n_cp + 3, 2) f32, 1 <= B <= 65535. cp: (n_cp, 2) f32; n_cp must
// be 25. out: (B, H * W, 5) f32, contiguous. Launches on `stream` and
// returns cudaGetLastError() after the launch.
extern "C" int tps_flow_dbg(const void* wv, const void* cp, void* out, int B, int H, int W,
                            int n_cp, void* stream) {
  if (B < 1 || B > 65535 || H < 2 || W < 2 || n_cp != kControlPoints ||
      (int64_t)H * W > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  tps_flow_dbg_kernel<<<tps_grid(B, H, W), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)wv, (const float*)cp, (float*)out, B, H, W);
  return (int)cudaGetLastError();
}
