// Nearest-neighbour warp, for sm_90a: the rotation augmentation of the
// training step, and a warp at explicit sample locations.
//
// Replaces multimodal_segmentation_tpu/ops/pallas_kernels.py::
// nearest_warp_pallas (body _nearest_warp_kernel) and, for the rotation,
// what feeds it in multimodal_segmentation_tpu/ops/augment.py::
// random_rotate_batch (the channel concatenation, rotation_locations, the
// split). For every output point q = (i, j) of image b and a source
// location (ly, lx):
//
//   y = clip(round_half_even(ly), 0, H-1),  x = clip(round_half_even(lx), 0, W-1),
//   out[b, i, j, :] = src[b, y, x, :].
//
// Two entry points share one kernel:
//   rotate_group  up to 4 arrays of one group (ops/augment.py::
//                 random_rotate_batch: x1, x2, m1, m2 / dm1, dm2 / dx1, dx2,
//                 with 1 or 4 channels each, B = 6, 192x192, f32), each
//                 read from and written to its own tensor. The location is
//                 computed here from the sample's cos/sin in the f32
//                 operation order of ops/augment.py::rotation_locations:
//                   ly = ((cos * dy) - (sin * dx)) + cy
//                   lx = ((sin * dy) + (cos * dx)) + cx,  dy = i - cy, dx = j - cx,
//                 every operation rounded on its own (__fmul_rn, __fsub_rn,
//                 __fadd_rn), so no FMA contraction moves a location off an
//                 exact .5 tie and flips its rounding.
//   nearest_warp  one array, the locations given as (B, H*W, 2) f32 (y, x);
//                 ops/augment.py::rotate_batch calls it, twice a step of
//                 the volumetric path (random_rotate_volumes: volumes and
//                 masks, (B*D, 128, 128, 3) f32).
// rintf rounds half to even, as torch.round does (roundf would round half
// away from zero). fmaxf returns its non-NaN operand, so a NaN location
// lands on 0.
//
// Bound. The kernel reads each source once and writes each output once:
// for a training step's three groups, 2 x (10 + 8 + 2) x 0.885 MB =
// 35.4 MB, 10.6 us at 3.35 TB/s (the locations no longer travel through
// memory: they were 3 x 1.77 MB more). It does ~20 integer and 6 float
// operations a point: memory-bound.
//
// Design. Adjacent threads write adjacent output words: each thread copies
// one vector of one output pixel's channels, the widest of 16, 8, 4 or 2
// bytes that divides the pixel's C x elem_bytes and the arrays' alignment
// (a 4-channel f32 mask is one 16-byte vector a thread, a 1-channel f32
// image 4 bytes), so the warp's stores are one contiguous span. The loads
// follow the rotated row, mostly along x at +-20 degrees, and go through
// the read-only path. A block belongs to one array of the group (the
// arrays' blocks are laid end to end on the 1-D grid), so its vector width
// is uniform. Values are copied as raw bits: the output is bit-exact for
// images and {0,1} masks alike. The TPU kernel's one-hot row/column
// matmuls and its (H, C*W) relayout are not carried over (on the TPU they
// also rounded image values to bf16).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxArrays = 4;

struct Arrays {
  const char* src[kMaxArrays];
  char* dst[kMaxArrays];
  int vec_bytes[kMaxArrays];       // bytes a thread copies: 16, 8, 4 or 2
  int vecs[kMaxArrays];            // vectors a pixel: C * elem_bytes / vec_bytes
  unsigned block_end[kMaxArrays];  // one past each array's last block
  int n;
};

// Source pixel (y * W + x inside the image) of output point q = (i, j).
struct FromLocs {
  const float2* locs;  // (B, H*W) of (y, x)
  __device__ __forceinline__ int64_t operator()(int b, int64_t q, int i, int j,
                                                int H, int W) const {
    const float2 l = __ldg(locs + (int64_t)b * H * W + q);
    const float yf = fminf(fmaxf(rintf(l.x), 0.f), (float)(H - 1));
    const float xf = fminf(fmaxf(rintf(l.y), 0.f), (float)(W - 1));
    return (int64_t)yf * W + (int64_t)xf;
  }
};

struct FromRotation {
  const float* cos_t;  // (B,)
  const float* sin_t;  // (B,)
  float cy, cx;        // (H - 1) / 2, (W - 1) / 2
  __device__ __forceinline__ int64_t operator()(int b, int64_t q, int i, int j,
                                                int H, int W) const {
    const float c = __ldg(cos_t + b);
    const float s = __ldg(sin_t + b);
    const float dy = __fsub_rn((float)i, cy);
    const float dx = __fsub_rn((float)j, cx);
    const float ly = __fadd_rn(__fsub_rn(__fmul_rn(c, dy), __fmul_rn(s, dx)), cy);
    const float lx = __fadd_rn(__fadd_rn(__fmul_rn(s, dy), __fmul_rn(c, dx)), cx);
    const float yf = fminf(fmaxf(rintf(ly), 0.f), (float)(H - 1));
    const float xf = fminf(fmaxf(rintf(lx), 0.f), (float)(W - 1));
    return (int64_t)yf * W + (int64_t)xf;
  }
};

template <typename V>
__device__ __forceinline__ void copy(const char* src, char* dst, int64_t from,
                                     int64_t to) {
  reinterpret_cast<V*>(dst)[to] = __ldg(reinterpret_cast<const V*>(src) + from);
}

template <class Source>
__global__ void __launch_bounds__(kThreads)
nearest_copy_kernel(const __grid_constant__ Arrays a, const Source where, int B,
                    int H, int W) {
  int k = 0;
  while (k < a.n - 1 && blockIdx.x >= a.block_end[k]) ++k;
  const unsigned first = k ? a.block_end[k - 1] : 0u;
  const int vecs = a.vecs[k];
  const int64_t t = (int64_t)(blockIdx.x - first) * kThreads + threadIdx.x;
  const int64_t p = vecs == 1 ? t : t / vecs;  // output pixel
  const int v = (int)(t - p * vecs);           // its vector
  const int64_t hw = (int64_t)H * W;
  if (p >= (int64_t)B * hw) return;
  const int b = (int)(p / hw);
  const int64_t q = p - (int64_t)b * hw;
  const int i = (int)(q / W);
  const int j = (int)(q - (int64_t)i * W);
  const int64_t from = ((int64_t)b * hw + where(b, q, i, j, H, W)) * vecs + v;
  const int64_t to = p * vecs + v;
  switch (a.vec_bytes[k]) {
    case 16: copy<uint4>(a.src[k], a.dst[k], from, to); break;
    case 8: copy<uint2>(a.src[k], a.dst[k], from, to); break;
    case 4: copy<uint32_t>(a.src[k], a.dst[k], from, to); break;
    default: copy<uint16_t>(a.src[k], a.dst[k], from, to); break;
  }
}

// The widest vector that divides a pixel's bytes and both addresses.
int vector_bytes(int64_t pixel_bytes, const void* src, const void* dst) {
  for (int v = 16; v > 2; v /= 2)
    if (pixel_bytes % v == 0 && (uintptr_t)src % v == 0 && (uintptr_t)dst % v == 0)
      return v;
  return 2;
}

// Fills a.vec_bytes, a.vecs and a.block_end for arrays of C[k] channels;
// returns the grid size, or 0 if a size is out of range.
unsigned plan(Arrays& a, const int* C, int elem_bytes, int64_t pixels) {
  int64_t blocks = 0;
  for (int k = 0; k < a.n; ++k) {
    const int64_t pixel_bytes = (int64_t)C[k] * elem_bytes;
    a.vec_bytes[k] = vector_bytes(pixel_bytes, a.src[k], a.dst[k]);
    if (pixel_bytes / a.vec_bytes[k] > INT32_MAX) return 0;
    a.vecs[k] = (int)(pixel_bytes / a.vec_bytes[k]);
    blocks += (pixels * a.vecs[k] + kThreads - 1) / kThreads;
    if (blocks > INT32_MAX) return 0;
    a.block_end[k] = (unsigned)blocks;
  }
  return (unsigned)blocks;
}

bool bad_shape(int B, int H, int W, int elem_bytes) {
  return B < 1 || H < 1 || W < 1 || (int64_t)H * W > INT32_MAX ||
         (elem_bytes != 4 && elem_bytes != 2);
}

}  // namespace

// vol, out: (B, H, W, C) contiguous, elem_bytes = 4 (f32) or 2 (bf16).
// locs: (B, H*W, 2) contiguous f32 pixel-space (y, x). Launches on `stream`
// and returns cudaGetLastError() after the launch.
extern "C" int nearest_warp(const void* vol, const void* locs, void* out, int B,
                            int H, int W, int C, int elem_bytes, void* stream) {
  if (bad_shape(B, H, W, elem_bytes) || C < 1) return (int)cudaErrorInvalidValue;
  Arrays a = {};
  a.n = 1;
  a.src[0] = (const char*)vol;
  a.dst[0] = (char*)out;
  const unsigned grid = plan(a, &C, elem_bytes, (int64_t)B * H * W);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  nearest_copy_kernel<FromLocs><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, FromLocs{(const float2*)locs}, B, H, W);
  return (int)cudaGetLastError();
}

// n arrays (1..4): src_k, dst_k (B, H, W, C_k) contiguous, all of one
// element size (4: f32, 2: bf16); unused slots are ignored. cos_t, sin_t:
// (B,) f32. Launches on `stream` and returns cudaGetLastError() after the
// launch.
extern "C" int rotate_group(int n, const void* src0, const void* src1,
                            const void* src2, const void* src3, void* dst0,
                            void* dst1, void* dst2, void* dst3, int C0, int C1,
                            int C2, int C3, const void* cos_t, const void* sin_t,
                            int B, int H, int W, int elem_bytes, void* stream) {
  const int C[kMaxArrays] = {C0, C1, C2, C3};
  if (n < 1 || n > kMaxArrays || bad_shape(B, H, W, elem_bytes))
    return (int)cudaErrorInvalidValue;
  const void* src[kMaxArrays] = {src0, src1, src2, src3};
  void* dst[kMaxArrays] = {dst0, dst1, dst2, dst3};
  Arrays a = {};
  a.n = n;
  for (int k = 0; k < n; ++k) {
    if (C[k] < 1) return (int)cudaErrorInvalidValue;
    a.src[k] = (const char*)src[k];
    a.dst[k] = (char*)dst[k];
  }
  const unsigned grid = plan(a, C, elem_bytes, (int64_t)B * H * W);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  const FromRotation where{(const float*)cos_t, (const float*)sin_t,
                           (float)(H - 1) * 0.5f, (float)(W - 1) * 0.5f};
  nearest_copy_kernel<FromRotation><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, where, B, H, W);
  return (int)cudaGetLastError();
}
