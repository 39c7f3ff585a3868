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
// one operation, the flow's ~13 a term, 25 terms a point (0.3 GFLOP at
// B = 24) take less time at the f32 rate, so the bound is the bytes. An
// accurate logf is some twenty instructions, though, so the kernel's time
// over that bound measures the flow's arithmetic.
//
// Design. As B1: one thread a point, the block's image index blockIdx.y,
// the coefficients and control points in shared memory once per block.
// Neighbouring threads write neighbouring 20-byte records, so a warp's
// five stores cover one contiguous 640-byte span. What the TPU layout
// needed stays behind: the 128-lane output padding, the 32-row padding of
// w and of the control points (padded with 7.0), v in SMEM, and the
// 1024-point blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tps_flow.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColumns = 5;

__global__ void __launch_bounds__(kThreads)
tps_flow_dbg_kernel(const float* __restrict__ wv, const float* __restrict__ cp,
                    float* __restrict__ out, int H, int W, int n_cp) {
  __shared__ float s_wv[(kMaxControlPoints + 3) * 2];
  __shared__ float s_cp[kMaxControlPoints * 2];
  const int b = blockIdx.y;
  tps_stage_coefficients(s_wv, s_cp, wv, cp, b, n_cp);
  __syncthreads();

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= H * W) return;
  const TpsFlow f = tps_flow(q, H, W, s_wv, s_cp, n_cp);

  float* o = out + ((int64_t)b * H * W + q) * kColumns;
  o[0] = f.fy * (float)(H - 1);
  o[1] = f.fx * (float)(W - 1);
  o[2] = f.qy;
  o[3] = f.qx;
  o[4] = f.phi0;
}

}  // namespace

// wv: (B, n_cp + 3, 2) f32. cp: (n_cp, 2) f32. out: (B, H * W, 5) f32,
// contiguous. Launches on `stream` and returns cudaGetLastError() after
// the launch.
extern "C" int tps_flow_dbg(const void* wv, const void* cp, void* out, int B, int H,
                            int W, int n_cp, void* stream) {
  if (B < 1 || B > 65535 || H < 2 || W < 2 || n_cp < 1 || n_cp > kMaxControlPoints ||
      (int64_t)H * W > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t points = (int64_t)H * W;
  const dim3 grid((unsigned)((points + kThreads - 1) / kThreads), (unsigned)B);
  tps_flow_dbg_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)wv, (const float*)cp, (float*)out, H, W, n_cp);
  return (int)cudaGetLastError();
}
