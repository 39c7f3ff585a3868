// Elementwise round half to even, for sm_90a: the forward of the
// straight-through rounding of the anatomy heads.
//
// Replaces multimodal_segmentation_tpu/ops/pallas_kernels.py::
// round_ste_pallas (body _round_kernel, call in _round_pallas_raw): the
// value is rounded in f32 and written back in the input's dtype. rintf
// rounds half to even, as jnp.round and torch.round do (roundf would round
// half away from zero). The TPU kernel takes a (rows, 128) view and falls
// back to jnp.round for sizes that are not a multiple of 128; this kernel
// takes any size. The identity gradient needs no kernel (ops/rounding.py).
//
// Bound. It reads the input once and writes the output once and does one
// operation an element: at the training step's anatomy tensor, (12, 8,
// 192, 192) f32, 2 x 14.2 MB, 8.5 us at 3.35 TB/s.
//
// Design. A grid-stride loop over 16-byte words (4 f32 or 8 bf16 values)
// when both buffers are 16-byte aligned, and a scalar loop for the tail
// and for unaligned buffers. A bf16 value rounds exactly: every bf16 of
// magnitude >= 128 is an integer already, and every integer up to 256 is
// a bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks on each of the 132 SMs

__device__ __forceinline__ float round_even(float v) { return rintf(v); }

__device__ __forceinline__ __nv_bfloat16 round_even(__nv_bfloat16 v) {
  return __float2bfloat16_rn(rintf(__bfloat162float(v)));
}

__device__ __forceinline__ uint4 round_word(uint4 w, float) {
  float4 v = *reinterpret_cast<float4*>(&w);
  v.x = rintf(v.x);
  v.y = rintf(v.y);
  v.z = rintf(v.z);
  v.w = rintf(v.w);
  return *reinterpret_cast<uint4*>(&v);
}

__device__ __forceinline__ uint4 round_word(uint4 w, __nv_bfloat16) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(p[k]);
    p[k] = __floats2bfloat162_rn(rintf(f.x), rintf(f.y));
  }
  return w;
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
round_ste_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (kVector) {
    constexpr int kPerWord = 16 / sizeof(T);
    const int64_t words = n / kPerWord;
    const uint4* xw = reinterpret_cast<const uint4*>(x);
    uint4* yw = reinterpret_cast<uint4*>(y);
    for (int64_t i = tid; i < words; i += stride) yw[i] = round_word(xw[i], T());
    done = words * kPerWord;
  }
  for (int64_t i = done + tid; i < n; i += stride) y[i] = round_even(x[i]);
}

template <typename T>
void launch(const void* x, void* y, int64_t n, cudaStream_t s) {
  const bool vector = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const int64_t units = vector ? (n * (int64_t)sizeof(T) + 15) / 16 : n;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  if (vector) {
    round_ste_kernel<T, true><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const T*)x, (T*)y, n);
  } else {
    round_ste_kernel<T, false><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const T*)x, (T*)y, n);
  }
}

}  // namespace

// x, y: n contiguous elements, elem_bytes = 4 (f32) or 2 (bf16). Launches
// on `stream` and returns cudaGetLastError() after the launch.
extern "C" int round_ste(const void* x, void* y, long long n, int elem_bytes,
                         void* stream) {
  if (n < 0 || (elem_bytes != 4 && elem_bytes != 2))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    launch<float>(x, y, (int64_t)n, s);
  } else {
    launch<__nv_bfloat16>(x, y, (int64_t)n, s);
  }
  return (int)cudaGetLastError();
}
