// Fused thin-plate-spline flow + bilinear warp, forward, for sm_90a.
//
// Replaces multimodal_segmentation_tpu/ops/pallas_kernels.py::
// tps_bilinear_warp_pallas (body _warp_kernel). It computes the same
// function, not the same blocks: for every output point q of image b,
//
//   f(q) = sum_i w_i * 0.5 r2 log(max(r2, 1e-10)) + [qy, qx, 1] @ v,
//   (y, x) = (f_y * (H-1), f_x * (W-1)),
//   out[b, q, :] = bilinear blend of the 4 corners around (y, x), where a
//                  corner outside the image contributes 0.
//
// Bound. At the inference shapes (B = padded volume length ~24, 192x192,
// C = 8) the kernel must read vol once and write out once: 2 x 28.3 MB in
// f32, 2 x 14.2 MB in bf16, against 3.35 TB/s of HBM. The flow costs
// 25 logf and ~12 FLOP per term per point (~0.3 GFLOP), far below the
// f32 rate, so the kernel is memory-bound.
//
// Design. One thread per output point; the block's image index is
// blockIdx.y, so the 28x2 coefficients and the 25x2 control points go to
// shared memory once per block. Each point evaluates its own flow in f32
// with the accurate logf (the RBF sum cancels heavily: no fast math), then
// reads each corner's C channels contiguously from the channels-last
// source and accumulates in f32. Neighbouring threads are neighbouring
// output pixels, so their C-channel writes are contiguous. The TPU
// kernel's one-hot blend matmuls, channel-major relayout, 32-row padding
// and 128-lane constraints are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxControlPoints = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tps_warp_fwd_kernel(const T* __restrict__ vol, const float* __restrict__ wv,
                    const float* __restrict__ cp, T* __restrict__ out, int H,
                    int W, int C, int n_cp) {
  __shared__ float s_wv[(kMaxControlPoints + 3) * 2];
  __shared__ float s_cp[kMaxControlPoints * 2];
  const int b = blockIdx.y;
  const int n_wv = (n_cp + 3) * 2;
  for (int i = threadIdx.x; i < n_wv; i += blockDim.x)
    s_wv[i] = wv[(int64_t)b * n_wv + i];
  for (int i = threadIdx.x; i < n_cp * 2; i += blockDim.x) s_cp[i] = cp[i];
  __syncthreads();

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= H * W) return;
  const int qi = q / W;
  const int qj = q - qi * W;
  // control_grid((H, W)): row-major (y, x), each axis divided by (dim - 1)
  const float qy = (float)qi / (float)(H - 1);
  const float qx = (float)qj / (float)(W - 1);

  float fy = 0.f;
  float fx = 0.f;
  for (int i = 0; i < n_cp; ++i) {
    const float dy = qy - s_cp[2 * i];
    const float dx = qx - s_cp[2 * i + 1];
    const float d2 = dy * dy + dx * dx;
    const float phi = 0.5f * d2 * logf(fmaxf(d2, 1e-10f));
    fy += phi * s_wv[2 * i];
    fx += phi * s_wv[2 * i + 1];
  }
  const float* v = s_wv + 2 * n_cp;  // affine rows multiply qy, qx, 1
  fy += qy * v[0] + qx * v[2] + v[4];
  fx += qy * v[1] + qx * v[3] + v[5];

  const float y = fy * (float)(H - 1);
  const float x = fx * (float)(W - 1);

  T* o = out + ((int64_t)b * H * W + q) * C;
  // Every corner is out of range (or has weight 0) unless -1 < y < H and
  // -1 < x < W. Testing that first also rejects NaN and huge values before
  // the int conversion below.
  if (!(y > -1.f && y < (float)H && x > -1.f && x < (float)W)) {
    for (int c = 0; c < C; ++c) store_f32(o + c, 0.f);
    return;
  }

  const float y0f = floorf(y);
  const float x0f = floorf(x);
  const int y0 = (int)y0f;
  const int x0 = (int)x0f;
  const float wy1 = y - y0f;
  const float wx1 = x - x0f;
  const float wy0 = 1.f - wy1;
  const float wx0 = 1.f - wx1;
  const bool in_y0 = y0 >= 0;
  const bool in_y1 = y0 + 1 <= H - 1;
  const bool in_x0 = x0 >= 0;
  const bool in_x1 = x0 + 1 <= W - 1;

  const T* src = vol + (int64_t)b * H * W * C;
  const T* p00 = src + ((int64_t)y0 * W + x0) * C;
  const T* p01 = p00 + C;
  const T* p10 = p00 + (int64_t)W * C;
  const T* p11 = p10 + C;
  const float w00 = wy0 * wx0;
  const float w01 = wy0 * wx1;
  const float w10 = wy1 * wx0;
  const float w11 = wy1 * wx1;

#pragma unroll 8
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
    if (in_y0 && in_x0) acc += load_f32(p00 + c) * w00;
    if (in_y0 && in_x1) acc += load_f32(p01 + c) * w01;
    if (in_y1 && in_x0) acc += load_f32(p10 + c) * w10;
    if (in_y1 && in_x1) acc += load_f32(p11 + c) * w11;
    store_f32(o + c, acc);
  }
}

}  // namespace

// vol, out: (B, H, W, C) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// wv: (B, n_cp + 3, 2) f32. cp: (n_cp, 2) f32. Launches on `stream` and
// returns cudaGetLastError() after the launch.
extern "C" int tps_warp_fwd(const void* vol, const void* wv, const void* cp,
                            void* out, int B, int H, int W, int C, int n_cp,
                            int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 2 || W < 2 || C < 1 || n_cp < 1 ||
      n_cp > kMaxControlPoints || (int64_t)H * W > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t points = (int64_t)H * W;
  const dim3 grid((unsigned)((points + kThreads - 1) / kThreads), (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    tps_warp_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)vol, (const float*)wv, (const float*)cp,
        (__nv_bfloat16*)out, H, W, C, n_cp);
  } else {
    tps_warp_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)vol, (const float*)wv, (const float*)cp, (float*)out, H,
        W, C, n_cp);
  }
  return (int)cudaGetLastError();
}
