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
// below the f32 rate. What the scatter costs on top is atomics: one
// g * w per corner, channel and point (14.2 M at these shapes), which a
// scalar f32 atomicAdd to device memory a time makes the limit, since
// neighbouring points hit the same corners.
//
// Design. A block owns a 32 x 8 tile of output points of one image, one
// thread a point; a warp is one tile row. The threads find the tile's
// corner bounding box (a block min/max of the in-range corner rows and
// columns). If the box's C channels fit the shared-memory window
// (kWindow floats, 24 KB), the block sums g * w there with shared-memory
// f32 atomics and then adds the window to grad_vol once per element,
// coalesced, with sm_90's vector atomics (float4 when C % 4 == 0, float2
// when even), skipping vectors that stayed 0. The window is channel-major
// (win[c][row][col]): a warp's 32 points have neighbouring corner columns,
// so each shared atomic of the warp falls in its own bank (pixel-major,
// C = 8 puts 8 lanes on a bank: PERF.md has both designs' times). If the box
// does not fit (large or scattered displacements), the window is a
// fitting part of it around the tile's mean corner, and every corner
// outside the window goes straight to a device-memory atomicAdd, so any
// location stays right. Under a smooth TPS flow a tile's box is about
// (8 + 1 + a few) x (32 + 1 + a few) pixels: at C = 8, ~800 float4
// atomics to device memory for 256 points instead of 8,192 scalar ones. A corner's C
// channels are read 16 (f32) or 8 (bf16) bytes at a time when C % 4 == 0.
// g is read through its strides (the fuser hands it over channels-first,
// where a warp's 32 points read 32 neighbouring words per channel), so the
// caller makes no contiguous copy. grad_vol starts as zeros from a
// cudaMemsetAsync issued here, on the same stream, ahead of the kernel.
// grad_locs stays in registers, one thread a point, as before. The TPU
// kernel's one-hot scatter matmuls, its (H, C*W) relayout and the
// pre-transposed locations are not carried over.
//
// Determinism. f32 atomics add in an order that changes from run to run,
// so grad_vol is not bit-reproducible (a few ulp of its largest entries);
// grad_locs is, since each point sums its own channels in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 6144;  // floats of the shared-memory window (24 KB)

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

struct Window {
  int y0, x0, h, w;  // rows [y0, y0 + h), columns [x0, x0 + w); h = 0: none
};

// The block's window. Every thread passes its in-range corner rows
// [rlo, rhi] and columns [clo, chi] (rlo > rhi when it has none) and its
// corner (y0, x0); thread 0 decides and all threads return the decision.
__device__ Window choose_window(int rlo, int rhi, int clo, int chi, bool hit,
                                int y0, int x0, int C) {
  __shared__ int s_red[6][kWarps];
  __shared__ Window s_win;
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int v[6] = {__reduce_min_sync(all, rlo), __reduce_max_sync(all, rhi),
                    __reduce_min_sync(all, clo), __reduce_max_sync(all, chi),
                    __reduce_add_sync(all, hit ? y0 : 0),
                    __reduce_add_sync(all, hit ? x0 : 0)};
  const int hits = __popc(__ballot_sync(all, hit));
  __shared__ int s_hits[kWarps];
  if (lane == 0) {
    for (int r = 0; r < 6; ++r) s_red[r][warp] = v[r];
    s_hits[warp] = hits;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int ymin = s_red[0][0], ymax = s_red[1][0], xmin = s_red[2][0], xmax = s_red[3][0];
    long long sy = 0, sx = 0;
    int n = 0;
    for (int k = 0; k < kWarps; ++k) {
      ymin = min(ymin, s_red[0][k]);
      ymax = max(ymax, s_red[1][k]);
      xmin = min(xmin, s_red[2][k]);
      xmax = max(xmax, s_red[3][k]);
      sy += s_red[4][k];
      sx += s_red[5][k];
      n += s_hits[k];
    }
    Window w = {0, 0, 0, 0};
    if (n > 0) {
      const int bh = ymax - ymin + 1;
      const int bw = xmax - xmin + 1;
      if ((long long)bh * bw * C <= kWindow) {
        w = {ymin, xmin, bh, bw};
      } else {
        // a part of the box around the mean corner: as many rows as the
        // tile has plus a margin, as many columns as then fit
        const int h = min(bh, kTileY + 8);
        const int wd = min(bw, kWindow / (C * h));
        if (wd >= 2) {
          const int cy = (int)(sy / n) - h / 2 + 1;
          const int cx = (int)(sx / n) - wd / 2 + 1;
          w = {max(ymin, min(cy, ymax - h + 1)), max(xmin, min(cx, xmax - wd + 1)), h, wd};
        }
      }
    }
    s_win = w;
  }
  __syncthreads();
  return s_win;
}

// 4 consecutive channels from 16 (f32) or 8 (bf16) aligned bytes
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// kVec: C % 4 == 0 and vol aligned, so a corner's channels are read 4 at
// a time. The window is channel-major, win[c][row][col]: the 32 lanes of
// a warp are 32 neighbouring points of one tile row, whose corners are
// neighbouring columns, so a warp's shared atomics fall in different banks.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
tps_warp_bwd_kernel(const T* __restrict__ vol, const float2* __restrict__ locs,
                    const T* __restrict__ g, float* __restrict__ grad_vol,
                    float2* __restrict__ grad_locs, int H, int W, int C,
                    int64_t gs_b, int64_t gs_h, int64_t gs_w, int64_t gs_c) {
  __shared__ float win[kWindow];
  const int b = blockIdx.z;
  const int i = blockIdx.y * kTileY + threadIdx.x / kTileX;
  const int j = blockIdx.x * kTileX + threadIdx.x % kTileX;
  const bool point = i < H && j < W;
  const int64_t p = ((int64_t)b * H + i) * W + j;
  float y = NAN, x = NAN;
  if (point) {
    const float2 l = locs[p];
    y = l.x;
    x = l.y;
  }
  const bool hit = y >= -1.f && y < (float)H && x >= -1.f && x < (float)W;
  const float y0f = floorf(y);
  const float x0f = floorf(x);
  const int y0 = hit ? (int)y0f : 0;
  const int x0 = hit ? (int)x0f : 0;
  // rows / columns of the in-range corners (empty when no hit)
  const int rlo = hit ? max(y0, 0) : INT_MAX;
  const int rhi = hit ? min(y0 + 1, H - 1) : INT_MIN;
  const int clo = hit ? max(x0, 0) : INT_MAX;
  const int chi = hit ? min(x0 + 1, W - 1) : INT_MIN;
  const Window wn = choose_window(rlo, rhi, clo, chi, hit, y0, x0, C);
  const int plane = wn.h * wn.w;  // one channel of the window
  for (int e = threadIdx.x; e < plane * C; e += kThreads) win[e] = 0.f;
  __syncthreads();

  float gy = 0.f;
  float gx = 0.f;
  if (hit) {
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
    // window row / column of corner 00; a corner inside the window adds
    // to shared memory, one outside to grad_vol
    const int ry = y0 - wn.y0;
    const int rx = x0 - wn.x0;
    const bool wy_0 = ry >= 0 && ry < wn.h;
    const bool wy_1 = ry + 1 >= 0 && ry + 1 < wn.h;
    const bool wx_0 = rx >= 0 && rx < wn.w;
    const bool wx_1 = rx + 1 >= 0 && rx + 1 < wn.w;
    const int s00 = ry * wn.w + rx;  // used only when inside
    const int s01 = s00 + 1;
    const int s10 = s00 + wn.w;
    const int s11 = s10 + 1;
    // element offsets of the corners inside grad_vol / vol
    const int64_t o00 = (((int64_t)b * H + y0) * W + x0) * C;
    const int64_t o01 = o00 + C;
    const int64_t o10 = o00 + (int64_t)W * C;
    const int64_t o11 = o10 + C;
    const float w00 = wy0 * wx0;
    const float w01 = wy0 * wx1;
    const float w10 = wy1 * wx0;
    const float w11 = wy1 * wx1;
    const T* gp = g + b * gs_b + i * gs_h + j * gs_w;
#define SCATTER(in, inside, s, o, w)                     \
  if (in) {                                              \
    if (inside)                                          \
      atomicAdd(win + (s) + c * plane, gc * (w));        \
    else                                                 \
      atomicAdd(grad_vol + (o) + c, gc * (w));           \
  }
#define CHANNEL(v00, v01, v10, v11)                                  \
  {                                                                  \
    const float gc = load_f32(gp + c * gs_c);                        \
    SCATTER(in00, wy_0 && wx_0, s00, o00, w00)                       \
    SCATTER(in01, wy_0 && wx_1, s01, o01, w01)                       \
    SCATTER(in10, wy_1 && wx_0, s10, o10, w10)                       \
    SCATTER(in11, wy_1 && wx_1, s11, o11, w11)                       \
    gy += gc * (wx0 * ((v10) - (v00)) + wx1 * ((v11) - (v01)));      \
    gx += gc * (wy0 * ((v01) - (v00)) + wy1 * ((v11) - (v10)));      \
  }
    if (kVec) {
      for (int c4 = 0; c4 < C; c4 += 4) {
        float v00[4] = {0.f, 0.f, 0.f, 0.f}, v01[4] = {0.f, 0.f, 0.f, 0.f};
        float v10[4] = {0.f, 0.f, 0.f, 0.f}, v11[4] = {0.f, 0.f, 0.f, 0.f};
        if (in00) load4(vol + o00 + c4, v00);
        if (in01) load4(vol + o01 + c4, v01);
        if (in10) load4(vol + o10 + c4, v10);
        if (in11) load4(vol + o11 + c4, v11);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = c4 + k;
          CHANNEL(v00[k], v01[k], v10[k], v11[k])
        }
      }
    } else {
      for (int c = 0; c < C; ++c) {
        CHANNEL(in00 ? load_f32(vol + o00 + c) : 0.f, in01 ? load_f32(vol + o01 + c) : 0.f,
                in10 ? load_f32(vol + o10 + c) : 0.f, in11 ? load_f32(vol + o11 + c) : 0.f)
      }
    }
#undef CHANNEL
#undef SCATTER
  }
  if (point) grad_locs[p] = make_float2(gy, gx);
  __syncthreads();

  // the window to grad_vol: window row r is wn.w * C contiguous floats of
  // grad_vol from pixel (wn.y0 + r, wn.x0), channels last
  float* base = grad_vol + (((int64_t)b * H + wn.y0) * W + wn.x0) * C;
  const int64_t pitch = (int64_t)W * C;
  if (C % 4 == 0) {
    const int q = C / 4;  // float4s a pixel
    for (int e = threadIdx.x; e < plane * q; e += kThreads) {
      const int px = e / q;  // window pixel r * wn.w + col
      const int c = (e - px * q) * 4;
      const float* w = win + c * plane + px;
      const float4 v = make_float4(w[0], w[plane], w[2 * plane], w[3 * plane]);
      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) {
        const int r = px / wn.w;
        atomicAdd(reinterpret_cast<float4*>(base + r * pitch + (px - r * wn.w) * C + c), v);
      }
    }
  } else if (C % 2 == 0) {
    const int q = C / 2;
    for (int e = threadIdx.x; e < plane * q; e += kThreads) {
      const int px = e / q;
      const int c = (e - px * q) * 2;
      const float* w = win + c * plane + px;
      const float2 v = make_float2(w[0], w[plane]);
      if (v.x != 0.f || v.y != 0.f) {
        const int r = px / wn.w;
        atomicAdd(reinterpret_cast<float2*>(base + r * pitch + (px - r * wn.w) * C + c), v);
      }
    }
  } else {
    for (int e = threadIdx.x; e < plane * C; e += kThreads) {
      const int px = e / C;
      const int c = e - px * C;
      const float v = win[c * plane + px];
      if (v != 0.f) {
        const int r = px / wn.w;
        atomicAdd(base + r * pitch + (px - r * wn.w) * C + c, v);
      }
    }
  }
}

template <typename T>
void launch(const void* vol, const void* locs, const void* g, void* grad_vol,
            void* grad_locs, int H, int W, int C, long long gs_b, long long gs_h,
            long long gs_w, long long gs_c, dim3 grid, cudaStream_t s) {
  const bool vec = C % 4 == 0 && (uintptr_t)vol % (4 * sizeof(T)) == 0;
  if (vec) {
    tps_warp_bwd_kernel<T, true><<<grid, kThreads, 0, s>>>(
        (const T*)vol, (const float2*)locs, (const T*)g, (float*)grad_vol,
        (float2*)grad_locs, H, W, C, gs_b, gs_h, gs_w, gs_c);
  } else {
    tps_warp_bwd_kernel<T, false><<<grid, kThreads, 0, s>>>(
        (const T*)vol, (const float2*)locs, (const T*)g, (float*)grad_vol,
        (float2*)grad_locs, H, W, C, gs_b, gs_h, gs_w, gs_c);
  }
}

}  // namespace

// vol: (B, H, W, C) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// g: (B, H, W, C) of vol's type with element strides gs_b, gs_h, gs_w,
// gs_c. locs: (B, H*W, 2) contiguous f32 pixel-space (y, x). grad_vol:
// (B, H, W, C) f32, 16-byte aligned, zero-filled here. grad_locs:
// (B, H*W, 2) f32. Launches on `stream` and returns cudaGetLastError()
// after the launch.
extern "C" int tps_warp_bwd(const void* vol, const void* locs, const void* g,
                            void* grad_vol, void* grad_locs, int B, int H,
                            int W, int C, int is_bf16, long long gs_b,
                            long long gs_h, long long gs_w, long long gs_c,
                            void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 ||
      (int64_t)H * W > INT32_MAX || (uintptr_t)grad_vol % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      grad_vol, 0, (size_t)B * H * W * C * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((W + kTileX - 1) / kTileX),
                  (unsigned)((H + kTileY - 1) / kTileY), (unsigned)B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    launch<__nv_bfloat16>(vol, locs, g, grad_vol, grad_locs, H, W, C, gs_b, gs_h,
                          gs_w, gs_c, grid, s);
  } else {
    launch<float>(vol, locs, g, grad_vol, grad_locs, H, W, C, gs_b, gs_h, gs_w,
                  gs_c, grid, s);
  }
  return (int)cudaGetLastError();
}
