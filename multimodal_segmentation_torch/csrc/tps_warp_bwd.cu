// Backward of the bilinear warp (the TPS fuser's resample), for sm_90a.
//
// Replaces multimodal_segmentation_tpu/ops/pallas_kernels.py::
// tps_bilinear_warp_bwd_pallas (body _warp_bwd_kernel). The forward blends
// the 4 corners around each sample location (y, x) of image b, a corner
// outside the image counting 0 (csrc/tps_warp.cu). Given the locations
// locs (B, H*W, 2) and the output cotangent g (B, H, W, C), this computes
//
//   grad_vol[b, corner, c] += g[b, q, c] * w_corner(q)     (in-range corners)
//   grad_locs[b, q, 0] = sum_c g_c * [(1-wx)(v10 - v00) + wx (v11 - v01)]
//   grad_locs[b, q, 1] = sum_c g_c * [(1-wy)(v01 - v00) + wy (v11 - v10)]
//
// where v_ij is corner (y0+i, x0+j) of image b, 0 when out of range (the
// Pallas kernel's hit_* * in_* masks). A location that is NaN or outside
// [-1, H) x [-1, W) has no corner in range and contributes nothing; the
// test comes before any int conversion. At y = -1 exactly the weight of
// row 0 is 0 but its slope is not, so the closed end is kept, as autograd
// of the plain version (ops/resample.py::bilinear_sample) does.
//
// Bound. The kernel must read vol, g and locs once and write grad_vol and
// grad_locs once. At the training shapes (B = 12 fusion directions,
// 192x192, C = 8, f32) that is 3 x 14.16 MB + 2 x 3.54 MB = 49.6 MB: 14.8 us
// at 3.35 TB/s; the arithmetic (~16 FLOP per channel and point) is far
// below the f32 rate. The wrapper's zero fill of grad_vol is one more
// write of 14.16 MB.
//
// Design. One thread per sample point: it reads its location and its C
// cotangent values once, reads the 4 corners' C channels contiguously from
// the channels-last source, scatters g * w into an f32 grad_vol with
// atomicAdd, and accumulates both location gradients in f32 registers.
// Neighbouring points share corners, so the atomics contend; that is left
// for a later PR. The TPU kernel's one-hot scatter matmuls, its (H, C*W)
// relayout and the pre-transposed locations are not carried over.
//
// Determinism. f32 atomics add in an order that changes from run to run,
// so grad_vol is not bit-reproducible (a few ulp of its largest entries);
// grad_locs is, since each point sums its own channels in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tps_warp_bwd_kernel(const T* __restrict__ vol, const float2* __restrict__ locs,
                    const T* __restrict__ g, float* __restrict__ grad_vol,
                    float2* __restrict__ grad_locs, int H, int W, int C) {
  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= H * W) return;
  const int64_t p = (int64_t)b * H * W + q;
  const float2 l = locs[p];
  const float y = l.x;
  const float x = l.y;
  float gy = 0.f;
  float gx = 0.f;
  if (y >= -1.f && y < (float)H && x >= -1.f && x < (float)W) {
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
    const bool in00 = in_y0 && in_x0;
    const bool in01 = in_y0 && in_x1;
    const bool in10 = in_y1 && in_x0;
    const bool in11 = in_y1 && in_x1;
    // element offsets of the corners inside image b; used only when in range
    const int64_t base = (int64_t)b * H * W * C;
    const int64_t o00 = base + ((int64_t)y0 * W + x0) * C;
    const int64_t o01 = o00 + C;
    const int64_t o10 = o00 + (int64_t)W * C;
    const int64_t o11 = o10 + C;
    const float w00 = wy0 * wx0;
    const float w01 = wy0 * wx1;
    const float w10 = wy1 * wx0;
    const float w11 = wy1 * wx1;
    const T* gp = g + p * C;
    for (int c = 0; c < C; ++c) {
      const float gc = load_f32(gp + c);
      const float v00 = in00 ? load_f32(vol + o00 + c) : 0.f;
      const float v01 = in01 ? load_f32(vol + o01 + c) : 0.f;
      const float v10 = in10 ? load_f32(vol + o10 + c) : 0.f;
      const float v11 = in11 ? load_f32(vol + o11 + c) : 0.f;
      if (in00) atomicAdd(grad_vol + o00 + c, gc * w00);
      if (in01) atomicAdd(grad_vol + o01 + c, gc * w01);
      if (in10) atomicAdd(grad_vol + o10 + c, gc * w10);
      if (in11) atomicAdd(grad_vol + o11 + c, gc * w11);
      gy += gc * (wx0 * (v10 - v00) + wx1 * (v11 - v01));
      gx += gc * (wy0 * (v01 - v00) + wy1 * (v11 - v10));
    }
  }
  grad_locs[p] = make_float2(gy, gx);
}

}  // namespace

// vol, g: (B, H, W, C) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// locs: (B, H*W, 2) contiguous f32 pixel-space (y, x). grad_vol: (B, H, W, C)
// f32, zero-filled by the caller. grad_locs: (B, H*W, 2) f32. Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int tps_warp_bwd(const void* vol, const void* locs, const void* g,
                            void* grad_vol, void* grad_locs, int B, int H,
                            int W, int C, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 ||
      (int64_t)H * W > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t points = (int64_t)H * W;
  const dim3 grid((unsigned)((points + kThreads - 1) / kThreads), (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    tps_warp_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)vol, (const float2*)locs,
        (const __nv_bfloat16*)g, (float*)grad_vol, (float2*)grad_locs, H, W,
        C);
  } else {
    tps_warp_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)vol, (const float2*)locs, (const float*)g,
        (float*)grad_vol, (float2*)grad_locs, H, W, C);
  }
  return (int)cudaGetLastError();
}
