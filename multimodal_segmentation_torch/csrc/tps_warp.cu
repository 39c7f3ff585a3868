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
// Bound. At the main path's shapes (192x192, C = 8; B = 12 in training,
// B ~ 24 a padded volume in inference) the kernel must read vol once and
// write out once: 28.3 MB at B = 12 in f32 and at B = 24 in bf16, 8.5 us
// at 3.35 TB/s. On the H100 it takes 1.7-2.9 times that (PERF.md):
// what bounds it is the instructions a (point, image) pair issues, ~300 in
// SASS (the flow's 50 FMAs and their coefficient loads, the corners'
// weights and addresses, the blend), and the latency of its corner loads.
// The bytes come third. Before this design one thread served one point of
// one image and evaluated the 25 accurate logf of the basis for each
// image (~800 instructions), 0.62-0.84 of the kernel's time.
//
// Design. The basis phi_i of a point is evaluated once for a chunk of 8
// images and each image's flow is summed from it and that image's [w; v],
// staged in shared memory (tps_flow.cuh, which the flow-stage dump
// tps_flow_dbg.cu shares); in f32 with the accurate logf (the RBF sum
// cancels heavily: no fast math), in the order the one-image-a-thread
// kernel used, so the output is that kernel's bits. A thread serves one
// point of the chunk's images in turn: it issues an image's corner loads,
// sums the next image's flow while they are in flight, then blends. Each
// corner's C channels are read contiguously from the channels-last source,
// 16 bytes a load where C * sizeof(T) is a multiple of 16 and both
// pointers are 16-byte aligned (C = 8: two loads a corner in f32, one in
// bf16), else a channel at a time; the blend accumulates in f32.
// Neighbouring threads are neighbouring output pixels, so a warp's writes
// are contiguous. Of the layouts measured (images a block, the basis in
// registers or in shared memory), this one was the fastest (PERF.md). The
// TPU kernel's one-hot blend matmuls, channel-major
// relayout, 32-row padding and 128-lane constraints are not carried over.
//
// The general entry. The same function for any spline of the JAX
// signature (ops/tps.py::tps_sample_locations: cp_dims, inverse, order):
// 1 to 32 control points (the TPU kernel pads to 32 too), the radial
// basis of any polyharmonic order, and the centres either shared by the
// batch (the control grid) or one set per image (the inverse mapping's
// warped control points). Above, the 25-point order-2 shared-grid case
// keeps its own specialisation, so the main path's code and output do not
// move. The flow is evaluated in float64 from the f32 inputs (the
// kernel's own rounding then stays far below 1e-4 px): orders 3 and 4
// have coefficients up to ~12 at offsets of +-0.025 (order 2: ~1) and
// their sums cancel more, so an f32 evaluation is off by ~1e-3 px, and two
// f32 evaluations that sum in another order differ by as much. The blend
// is B1's (Pixel below).
// Bound and design. What the entry must do is B1's bytes (8.5 us at B =
// 12 f32) and the float64 flow, which the card issues at half its f32
// rate (34 TFLOP/s). The order is a template parameter (1 to 4; a generic
// instantiation takes any other), so the basis neither branches on it nor
// calls pow, and the log is a reduced-range float64 log (log_reduced: 10
// FP64 instructions and a table lookup) in place of libdevice's, valid
// for the clamped, normal argument. The coefficients, centres and log
// table are staged in shared memory as float64. With shared centres a
// thread serves a point of 4 images and sums their flows centre by
// centre: the basis once a centre, then 2 FMAs an image, 8 independent
// chains, so the FP64 latency overlaps within the thread. With per-image
// centres (the inverse mapping) nothing is shared between images and a
// thread serves one (point, image). Blocks are 128 threads. Measured on
// the H100 (PERF.md, PR 13), this beat the layouts that hold more in
// registers: the basis of 32 doubles kept for a chunk of 8 images, or
// image k + 1's corner loads in flight while image k is blended (122-194
// registers a thread, 8 warps an SM), and chunks of 2 or 8 images, or of
// more than one with per-image centres. chip_smoke.py's warp-general
// phase counts the bound from the basis' SASS.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tps_flow.cuh"

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of channels: 4 f32 or 8 bf16, unpacked to f32 and packed back
// (a bf16 is the high half of its f32, so unpacking is exact).
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int kLanes = 4;
  __device__ __forceinline__ static void unpack(uint4 w, float* v) {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int kLanes = 8;
  __device__ __forceinline__ static void unpack(uint4 w, float* v) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

__device__ __forceinline__ uint4 load_word(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The bilinear blend of image b at pixel location (y, x) into out[b, q, :],
// in two stages: start finds the corners and their weights and, with
// kWords > 0 (C * sizeof(T) = 16 * kWords), issues the loads of their
// channels; finish blends and stores. kWords = 0 reads a channel at a
// time, kWords = -1 16 bytes at a time for any C * sizeof(T) that is a
// multiple of 16; both load in finish.
template <typename T, int kWords>
struct Pixel {
  T* o;
  const T* p00;  // corner (y0, x0); the others follow at + C, + W * C
  bool inside, m00, m01, m10, m11;
  float w00, w01, w10, w11;
  uint4 v[4][kWords > 0 ? kWords : 1];

  __device__ __forceinline__ static Pixel start(const T* __restrict__ vol, T* __restrict__ out,
                                                int b, int q, int H, int W, int C, float y,
                                                float x) {
    Pixel px;
    px.o = out + ((int64_t)b * H * W + q) * C;
    // Every corner is out of range (or has weight 0) unless -1 < y < H and
    // -1 < x < W. Testing that first also rejects NaN and huge values
    // before the int conversion below.
    px.inside = y > -1.f && y < (float)H && x > -1.f && x < (float)W;
    if (!px.inside) return px;
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
    px.m00 = in_y0 && in_x0;
    px.m01 = in_y0 && in_x1;
    px.m10 = in_y1 && in_x0;
    px.m11 = in_y1 && in_x1;
    px.w00 = wy0 * wx0;
    px.w01 = wy0 * wx1;
    px.w10 = wy1 * wx0;
    px.w11 = wy1 * wx1;
    px.p00 = vol + ((int64_t)b * H * W + (int64_t)y0 * W + x0) * C;
    if constexpr (kWords > 0) {
      const T* p10 = px.p00 + (int64_t)W * C;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const int c = w * Word<T>::kLanes;
        px.v[0][w] = px.m00 ? load_word(px.p00 + c) : uint4{};
        px.v[1][w] = px.m01 ? load_word(px.p00 + C + c) : uint4{};
        px.v[2][w] = px.m10 ? load_word(p10 + c) : uint4{};
        px.v[3][w] = px.m11 ? load_word(p10 + C + c) : uint4{};
      }
    }
    return px;
  }

  // acc = sum of the in-range corners' value * weight, in the order 00, 01,
  // 10, 11, from 0 (the one-image-a-thread kernel's expressions).
  __device__ __forceinline__ void blend_word(const uint4* corner, uint4* dst) const {
    constexpr int L = Word<T>::kLanes;
    float a[4][L], acc[L];
#pragma unroll
    for (int k = 0; k < 4; ++k) Word<T>::unpack(corner[k], a[k]);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      acc[l] = 0.f;
      if (m00) acc[l] += a[0][l] * w00;
      if (m01) acc[l] += a[1][l] * w01;
      if (m10) acc[l] += a[2][l] * w10;
      if (m11) acc[l] += a[3][l] * w11;
    }
    *dst = Word<T>::pack(acc);
  }

  __device__ __forceinline__ void finish(int C, int W) const {
    if constexpr (kWords != 0) {
      constexpr int L = Word<T>::kLanes;
      if (!inside) {
        for (int c = 0; c < C; c += L) *reinterpret_cast<uint4*>(o + c) = make_uint4(0, 0, 0, 0);
        return;
      }
      if constexpr (kWords > 0) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          const uint4 corner[4] = {v[0][w], v[1][w], v[2][w], v[3][w]};
          blend_word(corner, reinterpret_cast<uint4*>(o + w * L));
        }
      } else {
        const T* p10 = p00 + (int64_t)W * C;
        for (int c = 0; c < C; c += L) {
          const uint4 corner[4] = {m00 ? load_word(p00 + c) : uint4{},
                                   m01 ? load_word(p00 + C + c) : uint4{},
                                   m10 ? load_word(p10 + c) : uint4{},
                                   m11 ? load_word(p10 + C + c) : uint4{}};
          blend_word(corner, reinterpret_cast<uint4*>(o + c));
        }
      }
    } else {
      if (!inside) {
        for (int c = 0; c < C; ++c) store_f32(o + c, 0.f);
        return;
      }
      const T* p01 = p00 + C;
      const T* p10 = p00 + (int64_t)W * C;
      const T* p11 = p10 + C;
#pragma unroll 8
      for (int c = 0; c < C; ++c) {
        float acc = 0.f;
        if (m00) acc += load_f32(p00 + c) * w00;
        if (m01) acc += load_f32(p01 + c) * w01;
        if (m10) acc += load_f32(p10 + c) * w10;
        if (m11) acc += load_f32(p11 + c) * w11;
        store_f32(o + c, acc);
      }
    }
  }
};

template <typename T, int kWords>
__global__ void __launch_bounds__(kThreads)
tps_warp_fwd_kernel(const T* __restrict__ vol, const float* __restrict__ wv,
                    const float* __restrict__ cp, T* __restrict__ out, int B, int H,
                    int W, int C) {
  tps_for_each_point_image(
      wv, cp, B, H, W,
      [&](int b, int q, float, float, float, float fy, float fx) {
        return Pixel<T, kWords>::start(vol, out, b, q, H, W, C, fy * (float)(H - 1),
                                       fx * (float)(W - 1));
      },
      [&](const Pixel<T, kWords>& px) { px.finish(C, W); });
}

// ---- the general entry

constexpr int kMaxControlPoints = 32;
// the log table: 2^7 bins of the mantissa, as tests/test_torch_tps_general.py::
// test_reduced_range_log_matches_numpy models it
constexpr int kLogBits = 7;
constexpr int kLogBins = 1 << kLogBits;
constexpr double kLn2 = 0.6931471805599453;

// The general entry's block and the images a thread serves where the
// centres are shared (with per-image centres, one)
constexpr int kGeneralThreads = 128;
constexpr int kGeneralChunk = 4;

// The general entry's shared memory: the log table, each image's
// coefficients [w; v] and the centres (the chunk's, or the one image's) as
// float64 (y, x) rows.
struct GeneralShared {
  double2 log[kLogBins];
  double2 wv[kGeneralChunk][kMaxControlPoints + 3];
  double2 cp[kMaxControlPoints];
};

// log[j] = (1 / c_j rounded to double, -log of it), c_j = 1 + (j + 0.5) / 2^7:
// the centre of mantissa bin j
__device__ __forceinline__ void stage_log_table(double2* s_log) {
  for (int j = threadIdx.x; j < kLogBins; j += blockDim.x) {
    const double inv = 1.0 / (1.0 + (j + 0.5) / kLogBins);
    s_log[j] = make_double2(inv, -log(inv));
  }
}

// log(x) of a positive normal double, here max(r2, 1e-10), within ~3e-15
// of the correctly rounded log over [1e-10, 8]. x = 2^k m with m in [1, 2);
// the top 7 bits of m's fraction pick bin j; r = m / c_j - 1 = fma(m, 1/c_j,
// -1), |r| < 2^-8 (one rounding: m * (1/c_j) is exact inside the fma);
// log(1 + r) is its Taylor polynomial to degree 6 (the first term left out,
// r^7 / 7, is below 3e-18); log x = k ln2 - log(1/c_j) + log(1 + r). The
// exponent comes from the bits: k = (bits of 2^52 + biased exponent) -
// (2^52 + 1023), one DADD. 7 DFMA, 1 DMUL, 2 DADD and one shared load,
// where libdevice's log handles every range and special value. Its numpy
// model is tests/test_torch_tps_general.py::_log_model.
__device__ __forceinline__ double log_reduced(double x, const double2* s_log) {
  const int hi = __double2hiint(x);
  const double2 t = s_log[(hi >> (20 - kLogBits)) & (kLogBins - 1)];
  const double m = __hiloint2double((hi & 0x000fffff) | 0x3ff00000, __double2loint(x));
  const double k = __hiloint2double(0x43300000, hi >> 20) - 4503599627371519.0;
  const double r = fma(m, t.x, -1.0);
  double p = fma(r, -1.0 / 6.0, 0.2);
  p = fma(r, p, -0.25);
  p = fma(r, p, 1.0 / 3.0);
  p = fma(r, p, -0.5);
  p = fma(r * r, p, r);
  return fma(k, kLn2, t.y + p);
}

// phi(r2) of polyharmonic order kOrder (1 to 4), or of the runtime `order`
// with kOrder = 0, as ops/tps.py::_phi: odd orders r2c^((order-1)/2)
// sqrt(r2c), even ones 0.5 r2c^(order/2) log(r2c), r2c = max(r2, 1e-10),
// with the unclamped r2 outside the log for orders 2 and 4; integer powers,
// no pow.
template <int kOrder>
__device__ __forceinline__ double phi_general(double r2, int order, const double2* s_log) {
  const double r2c = fmax(r2, 1e-10);
  if constexpr (kOrder == 1) {
    return sqrt(r2c);
  } else if constexpr (kOrder == 2) {
    return 0.5 * r2 * log_reduced(r2c, s_log);
  } else if constexpr (kOrder == 3) {
    return r2c * sqrt(r2c);
  } else if constexpr (kOrder == 4) {
    return 0.5 * r2 * r2 * log_reduced(r2c, s_log);
  } else {
    double p = 1.0;
    for (int j = 0; j < order / 2; ++j) p *= r2c;
    return order % 2 == 0 ? 0.5 * p * log_reduced(r2c, s_log) : p * sqrt(r2c);
  }
}

// The general entry: a thread serves one point of kImages images
// (blockIdx.y): with shared centres (cp: (n_cp, 2)) a chunk of 4, whose
// flows it sums centre by centre, evaluating the centre's float64 basis
// once and adding it to every image's flow (2 FMAs an image), 8
// independent chains; with per-image centres (kPerImage, cp: (B, n_cp,
// 2)) one image, whose basis no other image shares. Then it blends each
// image. wv: (B, n_cp + 3, 2).
template <typename T, int kWords, int kOrder, bool kPerImage>
__global__ void __launch_bounds__(kGeneralThreads)
tps_warp_general_kernel(const T* __restrict__ vol, const float* __restrict__ wv,
                        const float* __restrict__ cp, T* __restrict__ out, int B, int H, int W,
                        int C, int n_cp, int order) {
  constexpr int kImages = kPerImage ? 1 : kGeneralChunk;
  __shared__ GeneralShared s;
  const int b0 = blockIdx.y * kImages;
  const int nb = min(kImages, B - b0);
  const int rows = n_cp + 3;
  for (int i = threadIdx.x; i < nb * rows; i += blockDim.x) {
    const float* src = wv + ((int64_t)b0 * rows + i) * 2;
    s.wv[i / rows][i % rows] = make_double2(src[0], src[1]);
  }
  const float* cp_b = kPerImage ? cp + (int64_t)b0 * n_cp * 2 : cp;
  for (int i = threadIdx.x; i < n_cp; i += blockDim.x)
    s.cp[i] = make_double2(cp_b[2 * i], cp_b[2 * i + 1]);
  stage_log_table(s.log);
  __syncthreads();

  const int q = blockIdx.x * kGeneralThreads + threadIdx.x;
  if (q >= H * W) return;
  const int qi = q / W;
  const int qj = q - qi * W;
  // control_grid((H, W)) in f32, as B1's basis computes it
  const double qy = (double)((float)qi / (float)(H - 1));
  const double qx = (double)((float)qj / (float)(W - 1));
  double fy[kImages], fx[kImages];
#pragma unroll
  for (int k = 0; k < kImages; ++k) fy[k] = fx[k] = 0.0;
#pragma unroll 2
  for (int i = 0; i < n_cp; ++i) {
    const double dy = qy - s.cp[i].x;
    const double dx = qx - s.cp[i].y;
    const double phi = phi_general<kOrder>(dy * dy + dx * dx, order, s.log);
#pragma unroll
    for (int k = 0; k < kImages; ++k) {
      if (k < nb) {
        const double2 w = s.wv[k][i];
        fy[k] = fma(phi, w.x, fy[k]);
        fx[k] = fma(phi, w.y, fx[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kImages; ++k) {
    if (k < nb) {
      const double2* v = s.wv[k] + n_cp;  // the affine rows multiply qy, qx and 1
      const double y = (fy[k] + (qy * v[0].x + qx * v[1].x + v[2].x)) * (double)(H - 1);
      const double x = (fx[k] + (qy * v[0].y + qx * v[1].y + v[2].y)) * (double)(W - 1);
      Pixel<T, kWords>::start(vol, out, b0 + k, q, H, W, C, (float)y, (float)x).finish(C, W);
    }
  }
}

template <typename T, int kWords>
void launch(const void* vol, const void* wv, const void* cp, void* out, int B, int H, int W,
            int C, cudaStream_t s) {
  tps_warp_fwd_kernel<T, kWords><<<tps_grid(B, H, W), kThreads, 0, s>>>(
      (const T*)vol, (const float*)wv, (const float*)cp, (T*)out, B, H, W, C);
}

template <typename T, int kWords, bool kPerImage>
void launch_general(const void* vol, const void* wv, const void* cp, void* out, int B, int H,
                    int W, int C, int n_cp, int order, cudaStream_t s) {
  auto kernel = tps_warp_general_kernel<T, kWords, 0, kPerImage>;
  if (order == 1)
    kernel = tps_warp_general_kernel<T, kWords, 1, kPerImage>;
  else if (order == 2)
    kernel = tps_warp_general_kernel<T, kWords, 2, kPerImage>;
  else if (order == 3)
    kernel = tps_warp_general_kernel<T, kWords, 3, kPerImage>;
  else if (order == 4)
    kernel = tps_warp_general_kernel<T, kWords, 4, kPerImage>;
  const int images = kPerImage ? 1 : kGeneralChunk;
  const dim3 grid((unsigned)(((int64_t)H * W + kGeneralThreads - 1) / kGeneralThreads),
                  (unsigned)((B + images - 1) / images));
  kernel<<<grid, kGeneralThreads, 0, s>>>((const T*)vol, (const float*)wv, (const float*)cp,
                                          (T*)out, B, H, W, C, n_cp, order);
}

template <typename T, int kWords>
void launch_general(const void* vol, const void* wv, const void* cp, void* out, int B, int H,
                    int W, int C, int n_cp, int order, int per_image, cudaStream_t s) {
  if (per_image)
    launch_general<T, kWords, true>(vol, wv, cp, out, B, H, W, C, n_cp, order, s);
  else
    launch_general<T, kWords, false>(vol, wv, cp, out, B, H, W, C, n_cp, order, s);
}

template <typename T>
void launch_words(const void* vol, const void* wv, const void* cp, void* out, int B, int H,
                  int W, int C, cudaStream_t s) {
  const int bytes = C * (int)sizeof(T);
  const bool aligned = (uintptr_t)vol % 16 == 0 && (uintptr_t)out % 16 == 0 && bytes % 16 == 0;
  if (aligned && bytes == 16)
    launch<T, 1>(vol, wv, cp, out, B, H, W, C, s);
  else if (aligned && bytes == 32)
    launch<T, 2>(vol, wv, cp, out, B, H, W, C, s);
  else if (aligned)
    launch<T, -1>(vol, wv, cp, out, B, H, W, C, s);
  else
    launch<T, 0>(vol, wv, cp, out, B, H, W, C, s);
}

template <typename T>
void launch_general_words(const void* vol, const void* wv, const void* cp, void* out, int B,
                          int H, int W, int C, int n_cp, int order, int per_image,
                          cudaStream_t s) {
  const int bytes = C * (int)sizeof(T);
  const bool aligned = (uintptr_t)vol % 16 == 0 && (uintptr_t)out % 16 == 0 && bytes % 16 == 0;
  if (aligned && bytes == 16)
    launch_general<T, 1>(vol, wv, cp, out, B, H, W, C, n_cp, order, per_image, s);
  else if (aligned && bytes == 32)
    launch_general<T, 2>(vol, wv, cp, out, B, H, W, C, n_cp, order, per_image, s);
  else if (aligned)
    launch_general<T, -1>(vol, wv, cp, out, B, H, W, C, n_cp, order, per_image, s);
  else
    launch_general<T, 0>(vol, wv, cp, out, B, H, W, C, n_cp, order, per_image, s);
}

}  // namespace

// vol, out: (B, H, W, C) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// 1 <= B <= 65535. wv: (B, n_cp + 3, 2) f32. cp: (n_cp, 2) f32; n_cp must
// be 25. Launches on `stream` and returns cudaGetLastError() after the
// launch.
extern "C" int tps_warp_fwd(const void* vol, const void* wv, const void* cp, void* out,
                            int B, int H, int W, int C, int n_cp, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 2 || W < 2 || C < 1 || n_cp != kControlPoints ||
      (int64_t)H * W > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    launch_words<__nv_bfloat16>(vol, wv, cp, out, B, H, W, C, s);
  else
    launch_words<float>(vol, wv, cp, out, B, H, W, C, s);
  return (int)cudaGetLastError();
}

// The general entry: vol, out and wv as tps_warp_fwd's; cp: (n_cp, 2) f32,
// or with cp_per_image (B, n_cp, 2); 1 <= n_cp <= 32; order >= 1.
extern "C" int tps_warp_fwd_general(const void* vol, const void* wv, const void* cp,
                                    void* out, int B, int H, int W, int C, int n_cp,
                                    int order, int cp_per_image, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 2 || W < 2 || C < 1 || n_cp < 1 ||
      n_cp > kMaxControlPoints || order < 1 || (int64_t)H * W > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    launch_general_words<__nv_bfloat16>(vol, wv, cp, out, B, H, W, C, n_cp, order,
                                        cp_per_image, s);
  else
    launch_general_words<float>(vol, wv, cp, out, B, H, W, C, n_cp, order, cp_per_image, s);
  return (int)cudaGetLastError();
}
