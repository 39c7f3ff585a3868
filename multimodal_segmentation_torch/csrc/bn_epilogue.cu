// The eval-mode conv epilogue, for sm_90a: a bias-free convolution's
// output c becomes, in one read and one write,
//
//   y = relu?( r(r(r(r(c + b_conv) - mean) * mul) + beta) )
//   mul = r(r(rsqrt(r(r(var) + eps))) * r(weight))
//
// where r rounds to c's dtype (bf16, or nothing for f32) after each step,
// exactly as PyTorch's separate operations round the same chain: cuDNN's
// bias add_, then nn/blocks.py::BatchNorm.forward in eval mode ((x - mean)
// * mul + bias in the input's dtype), then F.relu. Each step is done in
// f32 with __fadd_rn / __fsub_rn / __fmul_rn, so nothing is contracted into
// an FMA, and rounded with __float2bfloat16_rn (round to nearest even, as
// c10::BFloat16). The per-channel constants are computed here from the
// module's f32 parameters with the same roundings, rsqrtf as torch.rsqrt
// on the card. The result is bit-identical to the chain in bf16 and f32.
//
// Replaces no TPU kernel: the JAX package leaves the same chain to XLA,
// which fuses it. It was added because the port ran the chain as five
// broadcast passes over each activation, the largest device cost of
// serving (PERF.md).
//
// Bound. Memory: c is read once and y written once, 2 bytes an element
// each in bf16 (2 x 358.6 MB at (76, 64, 192, 192), 214 us at 3.35 TB/s);
// about 60 f32 operations an 8-element vector, far below the card's rate.
//
// Design. A block takes a contiguous range of the tensor in memory order:
// 256 threads, 4 16-byte vectors each (8 bf16 or 4 f32), loaded together
// before any is used. The channel of the element at memory offset e is
// (e / inner) % C, with inner = H*W for contiguous NCHW and 1 for
// channels_last, so one kernel takes both layouts. A block first computes
// the constants of the channels its range touches (at most min(C, range /
// inner + 2)) into shared memory, then streams. A vector whose lanes share
// a channel (inner a multiple of the lanes) reads one table entry; under
// channels_last with C a multiple of the lanes, its lanes read consecutive
// entries; otherwise each lane finds its own. Elements past the last whole
// vector, and unaligned buffers, take a scalar loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVectors = 4;  // 16-byte vectors a thread

// per-channel constants in f32, each already rounded to the dtype
struct Affine {
  float cbias, mean, mul, beta;
};

// Table entry j sits at slot j + j / 8. Under channels_last neighbouring
// threads take the entries of vectors 8 channels apart, which would all
// fall in one shared-memory bank (16-byte entries, 32 banks); one spare
// slot every 8 spreads them. A vector's 8 consecutive entries stay
// consecutive.
__host__ __device__ __forceinline__ int padded(int j) { return j + (j >> 3); }

__device__ __forceinline__ float rnd(float v, float) { return v; }

__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ Affine channel_affine(int ch, const float* cbias, const float* mean,
                                                 const float* var, const float* weight,
                                                 const float* beta, float eps) {
  const T t = T();
  Affine a;
  a.cbias = rnd(cbias[ch], t);
  a.mean = rnd(mean[ch], t);
  const float shifted = rnd(__fadd_rn(rnd(var[ch], t), eps), t);
  a.mul = rnd(__fmul_rn(rnd(rsqrtf(shifted), t), rnd(weight[ch], t)), t);
  a.beta = rnd(beta[ch], t);
  return a;
}

template <typename T, bool kRelu>
__device__ __forceinline__ float epilogue(float v, const Affine& a) {
  const T t = T();
  v = rnd(__fadd_rn(v, a.cbias), t);
  v = rnd(__fsub_rn(v, a.mean), t);
  v = rnd(__fmul_rn(v, a.mul), t);
  v = rnd(__fadd_rn(v, a.beta), t);
  if (kRelu) v = isnan(v) ? v : fmaxf(v, 0.0f);
  return v;  // exact in T: the store does not round again
}

// kMode: 0 each lane finds its channel, 1 a vector's lanes share one,
// 2 a vector's lanes take consecutive channels (channels_last)
template <typename T, int kMode, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_epilogue_kernel(const T* __restrict__ c, T* __restrict__ y, int64_t n, int inner, int C,
                   bool vector, const float* __restrict__ cbias,
                   const float* __restrict__ mean, const float* __restrict__ var,
                   const float* __restrict__ weight, const float* __restrict__ beta,
                   float eps) {
  constexpr int kLanes = 16 / sizeof(T);
  constexpr int64_t kChunk = (int64_t)kThreads * kVectors * kLanes;
  extern __shared__ Affine table[];

  const int64_t start = (int64_t)blockIdx.x * kChunk;
  const int64_t end = start + kChunk < n ? start + kChunk : n;
  const int64_t q0 = start / inner;
  const int64_t span = (end - 1) / inner - q0 + 1;
  const int entries = span < C ? (int)span : C;
  for (int j = threadIdx.x; j < entries; j += kThreads)
    table[padded(j)] =
        channel_affine<T>((int)((q0 + j) % C), cbias, mean, var, weight, beta, eps);
  __syncthreads();

  // the table slot of the element at offset l from start
  const int r0 = (int)(start - q0 * inner);
  auto slot = [&](int l) {
    const int j = (r0 + l) / inner;
    return padded(j < C ? j : j % C);
  };

  int done = 0;
  if (vector) {
    const int words = (int)((end - start) / kLanes);
    const uint4* cw = reinterpret_cast<const uint4*>(c + start);
    uint4* yw = reinterpret_cast<uint4*>(y + start);
    uint4 w[kVectors];
#pragma unroll
    for (int k = 0; k < kVectors; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < words) w[k] = cw[i];
    }
#pragma unroll
    for (int k = 0; k < kVectors; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= words) continue;
      const T* in = reinterpret_cast<const T*>(&w[k]);
      uint4 o;
      T* out = reinterpret_cast<T*>(&o);
      const int l = i * kLanes;
      if (kMode == 1) {
        const Affine a = table[slot(l)];
#pragma unroll
        for (int e = 0; e < kLanes; ++e)
          from_f(epilogue<T, kRelu>(to_f(in[e]), a), out + e);
      } else if (kMode == 2) {
        const int j = slot(l);
#pragma unroll
        for (int e = 0; e < kLanes; ++e)
          from_f(epilogue<T, kRelu>(to_f(in[e]), table[j + e]), out + e);
      } else {
#pragma unroll
        for (int e = 0; e < kLanes; ++e)
          from_f(epilogue<T, kRelu>(to_f(in[e]), table[slot(l + e)]), out + e);
      }
      yw[i] = o;
    }
    done = words * kLanes;
  }
  const int count = (int)(end - start);
  for (int l = done + threadIdx.x; l < count; l += kThreads)
    from_f(epilogue<T, kRelu>(to_f(c[start + l]), table[slot(l)]), y + start + l);
}

template <typename T, int kMode, bool kRelu>
int launch_mode(const void* c, void* y, int64_t n, int inner, int C, bool vector,
                const float* cbias, const float* mean, const float* var, const float* weight,
                const float* beta, float eps, cudaStream_t s) {
  constexpr int64_t kChunk = (int64_t)kThreads * kVectors * (16 / sizeof(T));
  const int64_t blocks = (n + kChunk - 1) / kChunk;
  // the most table entries a block needs
  int64_t entries = kChunk / inner + 2;
  if (entries > C) entries = C;
  const size_t smem = (size_t)(padded((int)entries) + 1) * sizeof(Affine);
  auto kernel = bn_epilogue_kernel<T, kMode, kRelu>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>((const T*)c, (T*)y, n, inner, C, vector,
                                                  cbias, mean, var, weight, beta, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool kRelu>
int launch(const void* c, void* y, int64_t n, int inner, int C, const float* cbias,
           const float* mean, const float* var, const float* weight, const float* beta,
           float eps, cudaStream_t s) {
  constexpr int kLanes = 16 / sizeof(T);
  const bool vector = ((uintptr_t)c % 16 == 0) && ((uintptr_t)y % 16 == 0);
  if (inner % kLanes == 0)
    return launch_mode<T, 1, kRelu>(c, y, n, inner, C, vector, cbias, mean, var, weight, beta,
                                    eps, s);
  if (inner == 1 && C % kLanes == 0)
    return launch_mode<T, 2, kRelu>(c, y, n, inner, C, vector, cbias, mean, var, weight, beta,
                                    eps, s);
  return launch_mode<T, 0, kRelu>(c, y, n, inner, C, vector, cbias, mean, var, weight, beta, eps,
                                  s);
}

template <typename T>
int dispatch(const void* c, void* y, int64_t n, int inner, int C, const float* cbias,
             const float* mean, const float* var, const float* weight, const float* beta,
             float eps, int relu, cudaStream_t s) {
  return relu ? launch<T, true>(c, y, n, inner, C, cbias, mean, var, weight, beta, eps, s)
              : launch<T, false>(c, y, n, inner, C, cbias, mean, var, weight, beta, eps, s);
}

}  // namespace

// c, y: n elements in memory order, the channel of offset e being
// (e / inner) % C; elem_bytes = 4 (f32) or 2 (bf16). cbias, mean, var,
// weight, beta: C contiguous f32 values each. Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int bn_epilogue(const void* c, void* y, long long n, int inner, int C,
                           const void* cbias, const void* mean, const void* var,
                           const void* weight, const void* beta, float eps, int relu,
                           int elem_bytes, void* stream) {
  if (n <= 0 || inner < 1 || C < 1 || (elem_bytes != 4 && elem_bytes != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* f[5] = {(const float*)cbias, (const float*)mean, (const float*)var,
                       (const float*)weight, (const float*)beta};
  if (elem_bytes == 4)
    return dispatch<float>(c, y, (int64_t)n, inner, C, f[0], f[1], f[2], f[3], f[4], eps, relu,
                           s);
  return dispatch<__nv_bfloat16>(c, y, (int64_t)n, inner, C, f[0], f[1], f[2], f[3], f[4], eps,
                                 relu, s);
}
