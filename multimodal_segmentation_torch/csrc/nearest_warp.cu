// Nearest-neighbour warp at explicit sample locations, for sm_90a.
//
// Replaces multimodal_segmentation_tpu/ops/pallas_kernels.py::
// nearest_warp_pallas (body _nearest_warp_kernel). For every output point q
// of image b, with (ly, lx) = locs[b, q]:
//
//   y = clip(round_half_even(ly), 0, H-1),  x = clip(round_half_even(lx), 0, W-1),
//   out[b, q, :] = vol[b, y, x, :].
//
// It serves the rotation augmentation of the training step (ops/augment.py:
// three calls per step, C = 10, 8 and 2 at B = 6, 192x192, f32). The
// locations come from the caller (ops/augment.py::rotation_locations), as
// the TPU kernel takes them: computing the rotation here would invite FMA
// contraction, which moves a location off an exact .5 tie and flips the
// rounding. rintf rounds half to even, as jnp.round and torch.round do
// (roundf would round half away from zero). A NaN location clamps to 0.
//
// Bound. The kernel reads vol and locs once and writes out once: at C = 10
// that is 8.85 + 1.77 + 8.85 MB, 5.8 us at 3.35 TB/s; it does no arithmetic
// to speak of. At these sizes the launch costs about as much as the copy.
//
// Design. One thread per output point; it copies the C channels of its
// source pixel as raw bits (4-byte words for f32, 2-byte for bf16), so the
// output is bit-exact for images and {0,1} masks alike. The TPU kernel's
// one-hot row/column matmuls and its channel-major (H, C*W) relayout are not
// carried over (on the TPU they also rounded image values to bf16).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
nearest_warp_kernel(const T* __restrict__ vol, const float2* __restrict__ locs,
                    T* __restrict__ out, int H, int W, int C) {
  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= H * W) return;
  const int64_t p = (int64_t)b * H * W + q;
  const float2 l = locs[p];  // (y, x)
  // fmaxf returns the non-NaN operand, so a NaN location lands on 0
  const float yf = fminf(fmaxf(rintf(l.x), 0.f), (float)(H - 1));
  const float xf = fminf(fmaxf(rintf(l.y), 0.f), (float)(W - 1));
  const T* src = vol + ((int64_t)b * H * W + (int64_t)yf * W + (int64_t)xf) * C;
  T* o = out + p * C;
  for (int c = 0; c < C; ++c) o[c] = src[c];
}

}  // namespace

// vol, out: (B, H, W, C) contiguous, elem_bytes = 4 (f32) or 2 (bf16).
// locs: (B, H*W, 2) contiguous f32 pixel-space (y, x). Launches on `stream`
// and returns cudaGetLastError() after the launch.
extern "C" int nearest_warp(const void* vol, const void* locs, void* out, int B,
                            int H, int W, int C, int elem_bytes, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 ||
      (int64_t)H * W > INT32_MAX || (elem_bytes != 4 && elem_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const int64_t points = (int64_t)H * W;
  const dim3 grid((unsigned)((points + kThreads - 1) / kThreads), (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    nearest_warp_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
        (const uint32_t*)vol, (const float2*)locs, (uint32_t*)out, H, W, C);
  } else {
    nearest_warp_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        (const uint16_t*)vol, (const float2*)locs, (uint16_t*)out, H, W, C);
  }
  return (int)cudaGetLastError();
}
