// A 'same' 3x3x3 convolution (stride 1, zero padding 1) of a bf16 NDHWC
// input with 48 or 96 channels to 48 output channels, for sm_90a: an
// implicit GEMM on Hopper's warpgroup tensor-core instruction (wgmma
// m64n48k16, f32 sums), its input brought into shared memory by the tensor
// memory accelerator (TMA).
//
//   y[n, d, h, w, k] = sum over c, i, j, l of
//                      wt[k, c, i, j, l] * x[n, d + i - 1, h + j - 1, w + l - 1, c]
//
// with x zero outside its extent, summed in f32 and rounded once to bf16
// (as cuDNN rounds); no bias (Swin UNETR's convolutions have none). x and y
// are NDHWC (PyTorch's channels_last_3d), the layout the Swin decoder runs
// in on the card.
//
// Replaces no TPU kernel: the JAX package left its convolutions to XLA. It
// was added for Swin UNETR's 48-output-channel convolutions (48 -> 48 and
// 96 -> 48 at 128^3 and 64^3; nn/swin_unetr.py::UnetResBlock through
// nn/unet3d.py::ValidConv3d), which cuDNN runs as an sm80 implicit GEMM
// with 256 x 32 tiles at 12-19 % of the H100's bf16 peak, whatever engine
// it is let choose (PERF.md).
//
// Bound. The products: 2 x 27 x C x 48 a voxel, 260.9 GFLOP at 128^3 and C
// = 48 (0.264 ms at 989 TFLOP/s), against 403 MB of input and output read
// and written once (0.12 ms at 3.35 TB/s): the tensor cores bound it. A
// wgmma m64n48k16 reads 2 KB of A and 1.5 KB of B from shared memory, ~28
// clocks at 128 B a clock against its ~24 clocks of products, so shared
// memory caps the kernel near 85 % of the peak.
//
// Design. The GEMM's M is the output voxels, N the 48 channels, K the 27
// taps times C. A block takes a tile of 64 (W) x 4 (H) x 2 (D) output
// voxels at a time, and loops over tiles (one block an SM, the tiles dealt
// round-robin). Its input, the tile's halo brick of 66 x 6 x 4 voxels,
// comes into shared memory 16 channels at a time (a stage), as two TMA
// boxes of 8 channels each: a box's 16-byte rows land one voxel after the
// next, so eight consecutive voxels of a slice form one 128-byte core
// matrix of wgmma's unswizzled K-major layout, and the A operand of any
// tap is the same slice seen from another start address (a multiple of 16
// bytes): no im2col is staged and nothing is copied in shared memory.
// TMA's out-of-bounds fill gives the zero padding, at every edge and at
// ragged D, H and W. The stage's weights, packed once per module into
// B's core-matrix layout (27 taps x 16 channels x 48, 41.5 KB; the
// whole set is 124 or 249 KB, more than a block holds), come with it by
// one bulk copy. Two stages of 90 KB ring through shared memory, guarded
// by mbarriers: one producer thread issues the copies; two consumer
// warpgroups each own one D row of the tile (4 H rows x 64 W, four m64
// blocks, 96 f32 sums a thread) and issue 27 x 4 wgmmas a stage, then
// free it. The epilogue rounds the sums to bf16 and writes each voxel's
// 48 channels (96 bytes) from registers, masking the ragged edge, while
// the producer already loads the next tile's stages.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 48;                                   // output channels
constexpr int kTW = 64, kTH = 4, kTD = 2;                  // output tile
constexpr int kBW = kTW + 2, kBH = kTH + 2, kBD = kTD + 2;  // its halo brick
constexpr int kSlice = kBW * kBH * kBD * 16;               // 8 channels of it, bytes
constexpr int kTapBytes = 16 * kOut * 2;                   // one tap's B
constexpr int kWeightBytes = 27 * kTapBytes;               // a stage's B
constexpr int kStageBytes = 2 * kSlice + kWeightBytes;     // 16 channels
constexpr int kStages = 2;
constexpr int kConsumers = 2;                              // warpgroups
constexpr int kThreads = kConsumers * 128 + 32;            // and the producer warp
static_assert(kConsumers == kTD, "a consumer warpgroup a D row of the tile");
constexpr size_t kSmem = (size_t)kStages * kStageBytes + 2 * kStages * 8 + 1024;
static_assert(kSlice % 128 == 0 && kStageBytes % 1024 == 0, "stage alignment");
static_assert(kSmem <= 232448, "more shared memory than a block can have");

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one 8-channel box of the halo brick, at (c, w, h, d, n) of x
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int c, int w, int h, int d, int n) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(d), "r"(n)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma's shared-memory matrix descriptor, unswizzled: the start address,
// the byte offset between core matrices along K (lbo) and along M or N
// (sbo), all in 16-byte units
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}

__device__ __forceinline__ void keep(float (&d)[24]) {
#pragma unroll
  for (int i = 0; i < 24; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) * B (16 x 48, K-major), both in shared memory
__device__ __forceinline__ void wgmma_m64n48k16(float (&d)[24], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t round_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16;
}

// x through `xmap` (5-D: C, W, H, D, N; boxes of 8 x 66 x 6 x 4 x 1); wp:
// (kChunks, 27, 2, 6, 8, 8) bf16, 16-byte aligned: for each 16 input
// channels and tap, B's core matrices [k / 8][n / 8][n % 8][k % 8]; y:
// (N, D, H, W, 48) bf16, 4-byte aligned. Tiles are numbered W-tile
// fastest, then H, D and the sample.
template <int kChunks>
__global__ void __launch_bounds__(kThreads, 1)
same_conv3d_c48_kernel(const __grid_constant__ CUtensorMap xmap, const uint16_t* __restrict__ wp,
                       uint16_t* __restrict__ y, int D, int H, int W, int tiles_w, int tiles_h,
                       int tiles_d, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto tile_origin = [&](int t, int& n, int& d0, int& h0, int& w0) {
    const int wt = t % tiles_w;
    int rest = t / tiles_w;
    const int ht = rest % tiles_h;
    rest /= tiles_h;
    const int dt = rest % tiles_d;
    n = rest / tiles_d;
    d0 = dt * kTD;
    h0 = ht * kTH;
    w0 = wt * kTW;
  };

  if (warp == kConsumers * 4) {
    // the producer: one thread keeps the ring full
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int n, d0, h0, w0;
        tile_origin(t, n, d0, h0, w0);
        for (int c = 0; c < kChunks; ++c) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t dst = base + stage * kStageBytes;
          mbar_expect_tx(full(stage), kStageBytes);
          tma_load_box(dst, &xmap, full(stage), 16 * c, w0 - 1, h0 - 1, d0 - 1, n);
          tma_load_box(dst + kSlice, &xmap, full(stage), 16 * c + 8, w0 - 1, h0 - 1, d0 - 1,
                       n);
          bulk_load(dst + 2 * kSlice, wp + (size_t)c * (kWeightBytes / 2), kWeightBytes,
                    full(stage));
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: D row g of the tile, its 4 H rows the m64 blocks
  const int g = warp / 4, tid = threadIdx.x % 128;
  const int row = (tid / 32) * 16 + lane / 4, col = 2 * (lane % 4);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int n, d0, h0, w0;
    tile_origin(t, n, d0, h0, w0);
    float acc[kTH][24];
#pragma unroll
    for (int m = 0; m < kTH; ++m)
#pragma unroll
      for (int i = 0; i < 24; ++i) acc[m][i] = 0.0f;

    for (int c = 0; c < kChunks; ++c) {
      mbar_wait(full(stage), phase);
      const uint32_t a0 = base + stage * kStageBytes, b0 = a0 + 2 * kSlice;
#pragma unroll
      for (int m = 0; m < kTH; ++m) keep(acc[m]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kd = 0; kd < 3; ++kd)
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const uint64_t b = descriptor(b0 + ((kd * 3 + kh) * 3 + kw) * kTapBytes,
                                          (kOut / 8) * 128, 128);
#pragma unroll
            for (int m = 0; m < kTH; ++m) {
              const uint32_t voxel = ((g + kd) * kBH + m + kh) * kBW + kw;
              wgmma_m64n48k16(acc[m], descriptor(a0 + voxel * 16, kSlice, 128), b);
            }
          }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int m = 0; m < kTH; ++m) keep(acc[m]);
      // each warp's share of a wgmma runs on its own tensor core, so each
      // warp frees the stage once its own wgmmas are done with it
      if (lane == 0) mbar_arrive(empty(stage));
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // the sums, rounded, from the accumulator layout: rows row and row + 8
    // of each m64 block, channels col, col + 1 of each 8
    const int d = d0 + g;
#pragma unroll
    for (int m = 0; m < kTH; ++m) {
      const int h = h0 + m;
      if (d >= D || h >= H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = w0 + row + 8 * half;
        if (w >= W) continue;
        uint32_t* out = reinterpret_cast<uint32_t*>(
            y + ((((long long)n * D + d) * H + h) * W + w) * kOut + col);
#pragma unroll
        for (int j = 0; j < kOut / 8; ++j)
          out[4 * j] = round_pair(acc[m][4 * j + 2 * half], acc[m][4 * j + 2 * half + 1]);
      }
    }
  }
}

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int kChunks>
int launch(const void* x, const void* wp, void* y, int N, int D, int H, int W, cudaStream_t s) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int C = kChunks * 16;
  CUtensorMap xmap;
  const cuuint64_t dims[5] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D,
                              (cuuint64_t)N};
  const cuuint64_t strides[4] = {(cuuint64_t)C * 2, (cuuint64_t)C * 2 * W,
                                 (cuuint64_t)C * 2 * W * H, (cuuint64_t)C * 2 * W * H * D};
  const cuuint32_t box[5] = {8, kBW, kBH, kBD, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  auto kernel = same_conv3d_c48_kernel<kChunks>;
  static bool sized = false;
  cudaError_t err = cudaSuccess;
  if (!sized) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    sized = err == cudaSuccess;
  }
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH,
            tiles_d = (D + kTD - 1) / kTD;
  const long long tiles = (long long)N * tiles_d * tiles_h * tiles_w;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(tiles < sms ? tiles : sms);
  kernel<<<blocks, kThreads, kSmem, s>>>(xmap, (const uint16_t*)wp, (uint16_t*)y, D, H, W,
                                         tiles_w, tiles_h, tiles_d, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, D, H, W, C) contiguous bf16 (NDHWC), C 48 or 96, 16-byte aligned;
// wp: (C / 16, 27, 2, 6, 8, 8) contiguous bf16, 16-byte aligned (the
// weights in B's core-matrix layout, ops/same_conv.py::pack_weight); y:
// (N, D, H, W, 48) contiguous bf16, 4-byte aligned. Launches on `stream`
// and returns the first CUDA error (cudaGetLastError() after the launch).
extern "C" int same_conv3d(const void* x, const void* wp, void* y, int N, int C, int D, int H,
                           int W, void* stream) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || (C != 48 && C != 96) || (uintptr_t)x % 16 ||
      (uintptr_t)wp % 16 || (uintptr_t)y % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return C == 48 ? launch<3>(x, wp, y, N, D, H, W, s) : launch<6>(x, wp, y, N, D, H, W, s);
}
