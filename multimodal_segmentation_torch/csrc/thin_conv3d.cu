// A valid (unpadded) 3x3x3 convolution, stride 1, of a bf16 input with 1-4
// channels and an even width, for sm_90a, with f32 sums: an implicit GEMM
// on the tensor cores (mma.sync m16n8k16), the reduction over the C * 27
// taps zero-padded to a multiple of 16.
//
//   y[n, k, d, h, w] = sum over c, i, j, l of
//                      wt[k, c, i, j, l] * x[n, c, d + i, h + j, w + l]
//
// summed in f32 and rounded once to bf16 (as cuDNN rounds);
// no bias (its caller adds it as PyTorch adds cuDNN's). x is read NCDHW,
// as the overlap-tile gathers it; y is written NDHWC (PyTorch's
// channels_last_3d), the layout in which the U-Net's later convolutions
// run on the card: cuDNN's sm90 kernels read and write NDHWC, and an NCDHW
// tensor costs them a transform each way (PERF.md).
//
// Replaces no TPU kernel: it was added for the 3D U-Net's first
// convolution (3 -> 32 channels, nn/unet3d.py::ValidConv3d), for which
// cuDNN picks a legacy kernel without tensor cores (12.9 ms for 16 tiles
// of 132 x 132 x 116 on an H100), and with the input zero-padded to 8 or
// 16 channels an sm80 kernel that is no faster once its layout transforms
// are counted (PERF.md).
//
// Bound. Memory: the output is 32 values a voxel against 3 read (1.97 GB
// of bf16 written for those 16 tiles, 0.59 ms at 3.35 TB/s, against 0.19
// GB read). The products, 2 x 81 x 32 a voxel (1.6e11 FLOP for those
// tiles, 96 of 81 taps with the padding), are far below the tensor cores'
// rate.
//
// Design. A block of 4 warps takes tiles of 128 consecutive output voxels
// of one sample (in (d, h, w) memory order) and 32 output channels
// (blockIdx.y), looping over tiles; the channel count is a template
// parameter, so every tap's offset is a constant. For a tile it gathers
// the im2col matrix into shared memory as At[kk][m] (kk the tap c * 27 +
// i * 9 + j * 3 + l, m the voxel), zero for the padding taps and for
// voxels past the sample's end. A thread takes two neighbouring voxels
// (W is even, so both lie in one row): two 4-byte loads of a (c, i, j)
// row give both voxels' three taps, stored as three 4-byte words. The
// next tile's loads are issued before this tile is multiplied and
// stored, so their latency is hidden. Each warp then multiplies its 32
// voxels by the 32 channels' weights (kept in shared memory for the
// block's life): ldmatrix.trans reads the A fragments from At, ldmatrix
// the B fragments from the weights. The sums go through shared memory, by
// voxel: a voxel's 32 channels are one 64-byte row, so a tile of 128
// voxels is one contiguous 8 KB run of 16-byte stores where K = 32, and
// 64-byte runs a voxel where K > 32. The rows' four 16-byte chunks are
// swizzled (chunk ^ (voxel / 2) % 4), so that the mma fragments' stores and
// the 16-byte reads both fall in distinct banks. Rows of At and of the
// weights are padded by 16 bytes so that ldmatrix's eight rows fall in
// distinct banks. At (16, 3, 116, 132, 132) -> 32 channels it runs in
// 1.7 ms on an H100, as it did writing NCDHW: ~38 % of the bytes' bound
// (PERF.md).
//
// Only what a caller reaches is built: bf16 (the port's compute dtype; fp16
// is no configuration's), 1-4 channels (the published net's 3 and its
// base-width-4 cut's 4) and even widths (the U-Net's tiles); everything
// else is left to cuDNN (nn/unet3d.py::_thin_input).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // 4 warps
constexpr int kTile = 128;       // output voxels a tile
constexpr int kChannels = 32;    // output channels a block
constexpr int kMaxChannels = 4;
constexpr int kRow = kTile + 8;  // At's row, in 16-bit elements

__host__ __device__ constexpr int padded_taps(int C) { return (C * 27 + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint16_t round_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// x: (N, C, D, H, W) contiguous and y: (N, D - 2, H - 2, W - 2, K)
// contiguous (NDHWC), as bf16 bit patterns, W even, x 4-byte aligned and y
// 16-byte aligned; wp: (gridDim.y * 32, KK) packed weights, zero past (K, C
// * 27). Shared memory: At (KK rows of kRow), the staged sums Os (kTile
// rows of 32 channels, swizzled), the block's weights Ws (32 rows of KK +
// 8).
template <int kC>
__global__ void __launch_bounds__(kThreads)
thin_conv3d_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wp,
                   uint16_t* __restrict__ y, int D, int H, int W, int K,
                   int tiles_per_sample, long long tiles) {
  constexpr int kTaps = kC * 27, KK = padded_taps(kC), kWRow = KK + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* At = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Os = At + KK * kRow;
  uint16_t* Ws = Os + kTile * kChannels;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Do = D - 2, Ho = H - 2, Wo = W - 2;
  const int HW = H * W;
  const long long DHW = (long long)D * HW;
  const int M = Do * Ho * Wo;
  const int k0 = blockIdx.y * kChannels;

  for (int e = tid; e < kChannels * KK; e += kThreads) {
    const int r = e / KK, q = e - r * KK;
    Ws[r * kWRow + q] = wp[(long long)(k0 + r) * KK + q];
  }
  // the padding taps stay zero
  for (int e = tid; e < (KK - kTaps) * kTile; e += kThreads)
    At[(kTaps + e / kTile) * kRow + e % kTile] = 0;
  __syncthreads();

  // ldmatrix lane roles: row lr of sub-matrix lj; mma's: group g, thread tg
  const int lr = lane & 7, lj = lane >> 3;
  const int g = lane >> 2, tg = lane & 3;
  // a voxel's 16-byte chunk of 8 channels c lies at chunk c ^ swizzle(m)
  auto swizzle = [](int m) { return (m >> 1) & 3; };
  const bool vector_rows = (K % 8) == 0;

  // A thread takes voxels m, m + 1 (m even, so one row: Wo is even) and
  // every other (c, i, j), whose inputs p0..p3 give both voxels' three
  // taps. The next tile's inputs are loaded while this one is multiplied
  // and stored.
  constexpr int kRows = (kC * 9 + 1) / 2;
  const int u = tid & (kTile / 2 - 1), half = tid / (kTile / 2);
  uint32_t p01[kRows], p23[kRows];
  auto gather_pairs = [&](long long t) {
    const long long n = t / tiles_per_sample;
    const int m = (int)(t - n * tiles_per_sample) * kTile + 2 * u;
    const bool valid = t < tiles && m < M;
    const int d = m / (Ho * Wo), rest = m - d * (Ho * Wo);
    const int h = rest / Wo, w = rest - h * Wo;
    const uint16_t* src = x + n * kC * DHW + (long long)d * HW + h * W + w;
#pragma unroll
    for (int e = 0; e < kRows; ++e) {
      const int r = 2 * e + half;
      const int c = r / 9, i = r / 3 % 3, j = r % 3;
      p01[e] = p23[e] = 0;
      if (valid && r < kC * 9) {
        const uint32_t* row =
            reinterpret_cast<const uint32_t*>(src + c * DHW + i * HW + j * W);
        p01[e] = __ldg(row);
        p23[e] = __ldg(row + 1);
      }
    }
  };
  gather_pairs(blockIdx.x);

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long n = t / tiles_per_sample;
    const int m0 = (int)(t - n * tiles_per_sample) * kTile;

    // im2col of the tile into At: row q = c * 27 + i * 9 + j * 3 + l
#pragma unroll
    for (int e = 0; e < kRows; ++e) {
      const int r = 2 * e + half;
      if (r >= kC * 9) continue;
      uint32_t* dst = reinterpret_cast<uint32_t*>(At + r * 3 * kRow + 2 * u);
      dst[0] = p01[e];
      dst[kRow / 2] = __byte_perm(p01[e], p23[e], 0x5432);
      dst[kRow] = p23[e];
    }
    __syncthreads();
    gather_pairs(t + gridDim.x);

    float acc[2][4][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.0f;

#pragma unroll
    for (int ks = 0; ks < KK; ks += 16) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        ldmatrix_x4_trans(af[a], At + (ks + lr + (lj >> 1) * 8) * kRow + warp * 32 + a * 16 +
                                     (lj & 1) * 8);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4(bf[p], Ws + (p * 16 + (lj >> 1) * 8 + lr) * kWRow + ks + (lj & 1) * 8);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          mma(acc[a][b], af[a], bf[b >> 1][(b & 1) * 2], bf[b >> 1][(b & 1) * 2 + 1]);
    }

    // the sums, rounded, into the staging rows (by voxel): channels k and
    // k + 1 of a voxel are one 4-byte word; m and m + 8 share a swizzle
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int m = warp * 32 + a * 16 + g, col = (b ^ swizzle(m)) * 8 + tg * 2;
        *reinterpret_cast<uint32_t*>(Os + m * kChannels + col) =
            round_bits(acc[a][b][0]) | (uint32_t)round_bits(acc[a][b][1]) << 16;
        *reinterpret_cast<uint32_t*>(Os + (m + 8) * kChannels + col) =
            round_bits(acc[a][b][2]) | (uint32_t)round_bits(acc[a][b][3]) << 16;
      }
    __syncthreads();

    // each thread a voxel's 8 channels at a time, neighbouring threads
    // neighbouring 16 bytes. Where K = 32 and the tile is whole, its output
    // is one run (the index arithmetic of the general case cost 236
    // registers against 158 and 10 % of the time, PERF.md)
    const bool dense = K == kChannels && m0 + kTile <= M;
    uint4* run = reinterpret_cast<uint4*>(y + (n * M + m0) * K);
#pragma unroll
    for (int i = 0; i < kChannels * kTile / 8 / kThreads; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kChannels / 8), c = v % (kChannels / 8), k = k0 + c * 8;
      const uint16_t* src = Os + r * kChannels + (c ^ swizzle(r)) * 8;
      if (dense) {
        run[v] = *reinterpret_cast<const uint4*>(src);
        continue;
      }
      if (m0 + r >= M || k >= K) continue;
      uint16_t* dst = y + (n * M + m0 + r) * K + k;
      if (vector_rows) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && k + e < K; ++e) dst[e] = src[e];
      }
    }
  }
}

constexpr size_t smem_bytes(int C) {
  return ((size_t)padded_taps(C) * kRow + (size_t)kTile * kChannels +
          (size_t)kChannels * (padded_taps(C) + 8)) *
         2;
}
static_assert(smem_bytes(kMaxChannels) <= 48 * 1024, "no opt-in to more shared memory");

template <int kC>
int launch(const void* x, const void* wp, void* y, int N, int D, int H, int W, int K,
           cudaStream_t s) {
  const int M = (D - 2) * (H - 2) * (W - 2);
  const int tiles_per_sample = (M + kTile - 1) / kTile;
  const long long tiles = (long long)N * tiles_per_sample;
  const int groups = (K + kChannels - 1) / kChannels;
  const size_t smem = smem_bytes(kC);
  auto kernel = thin_conv3d_kernel<kC>;
  // as many blocks as the card holds at once, so that every block loops
  // over the same number of tiles (the blocks an SM holds are the
  // kernel's own, so they are asked once)
  static int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)sms * per_sm / groups;
  if (blocks < 1) blocks = 1;
  if (blocks > tiles) blocks = tiles;
  kernel<<<dim3((unsigned)blocks, (unsigned)groups), kThreads, smem, s>>>(
      (const uint16_t*)x, (const uint16_t*)wp, (uint16_t*)y, D, H, W, K, tiles_per_sample,
      tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, C, D, H, W) contiguous bf16, 1 <= C <= 4, D, H >= 3, W >= 4 and
// even, 4-byte aligned; wp: (ceil(K / 32) * 32, ceil(C * 27 / 16) * 16)
// contiguous bf16, the (K, C * 27) weights zero-padded; y: (N, D - 2, H -
// 2, W - 2, K) contiguous bf16 (NDHWC), 16-byte aligned. Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int thin_conv3d(const void* x, const void* wp, void* y, int N, int C, int D, int H,
                           int W, int K, void* stream) {
  if (N < 1 || C < 1 || C > kMaxChannels || D < 3 || H < 3 || W < 4 || W % 2 || K < 1 ||
      (uintptr_t)x % 4 || (uintptr_t)y % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch<1>(x, wp, y, N, D, H, W, K, s);
    case 2: return launch<2>(x, wp, y, N, D, H, W, K, s);
    case 3: return launch<3>(x, wp, y, N, D, H, W, K, s);
    default: return launch<4>(x, wp, y, N, D, H, W, K, s);
  }
}
