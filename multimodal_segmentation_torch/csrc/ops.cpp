// The port's CUDA kernels as PyTorch operators (namespace mmseg_cuda),
// registered with TORCH_LIBRARY for the CUDA dispatch key.
//
// Each kernel source (tps_warp.cu, tps_warp_bwd.cu, nearest_warp.cu,
// round_ste.cu, tps_flow_dbg.cu, bn_epilogue.cu, thin_conv3d.cu,
// same_conv3d.cu) keeps a
// plain C entry point; this file checks the tensors, allocates the outputs
// with the caching allocator and calls the entry point, in one call from
// Python.
// The checks raise ValueError (TORCH_CHECK_VALUE); a launch error raises
// RuntimeError. The stream is the raw handle of the caller's current
// stream on the tensors' device, passed in as an int, so this file needs
// no CUDA header; the caller (ops/cuda_kernels.py) makes that device
// current. Built by ops/cuda_kernels.py with g++ against torch's headers
// and linked with the kernels' objects into one library, loaded with
// torch.ops.load_library.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <torch/library.h>

#include <cstdint>
#include <string>
#include <tuple>
#include <vector>

extern "C" {
int tps_warp_fwd(const void* vol, const void* wv, const void* cp, void* out, int B,
                 int H, int W, int C, int n_cp, int is_bf16, void* stream);
int tps_warp_fwd_general(const void* vol, const void* wv, const void* cp, void* out, int B,
                         int H, int W, int C, int n_cp, int order, int cp_per_image,
                         int is_bf16, void* stream);
int tps_warp_bwd(const void* vol, const void* locs, const void* g, void* grad_vol,
                 void* grad_locs, int B, int H, int W, int C, int is_bf16,
                 long long gs_b, long long gs_h, long long gs_w, long long gs_c,
                 void* stream);
int nearest_warp(const void* vol, const void* locs, void* out, int B, int H, int W,
                 int C, int elem_bytes, void* stream);
int rotate_group(int n, const void* src0, const void* src1, const void* src2,
                 const void* src3, void* dst0, void* dst1, void* dst2, void* dst3,
                 int C0, int C1, int C2, int C3, const void* cos_t, const void* sin_t,
                 int B, int H, int W, int elem_bytes, void* stream);
int round_ste(const void* x, void* y, long long n, int elem_bytes, void* stream);
int tps_flow_dbg(const void* wv, const void* cp, void* out, int B, int H, int W, int n_cp,
                 void* stream);
int bn_epilogue(const void* c, void* y, long long n, int inner, int C, const void* cbias,
                const void* mean, const void* var, const void* weight, const void* beta,
                float eps, int relu, int elem_bytes, void* stream);
int thin_conv3d(const void* x, const void* wp, void* y, int N, int C, int D, int H, int W,
                int K, void* stream);
int same_conv3d(const void* x, const void* wp, void* y, int N, int C, int D, int H, int W,
                void* stream);
}

namespace {

constexpr int kMaxGroup = 4;  // rotate_group's arrays (csrc/nearest_warp.cu)

bool float_type(const at::Tensor& t) {
  return t.scalar_type() == at::kFloat || t.scalar_type() == at::kBFloat16;
}

// (B, H, W, C) contiguous float32/bfloat16 CUDA tensor, 1 <= B <= 65535
void check_vol(const at::Tensor& v, const char* name, const std::string& what) {
  TORCH_CHECK_VALUE(v.is_cuda(), name, ": ", what, " must be a CUDA tensor, got ",
                    v.device());
  TORCH_CHECK_VALUE(float_type(v), name, ": ", what,
                    " must be float32 or bfloat16, got ", v.scalar_type());
  TORCH_CHECK_VALUE(v.dim() == 4, name, ": ", what, " must be (B, H, W, C), got ",
                    v.sizes());
  TORCH_CHECK_VALUE(v.is_contiguous(), name, ": ", what, " must be contiguous");
  TORCH_CHECK_VALUE(v.size(0) >= 1 && v.size(0) <= 65535 && v.numel() > 0, name,
                    ": unsupported ", what, " shape ", v.sizes());
}

// contiguous float32 tensor of `shape` on `like`'s device
void check_f32(const at::Tensor& t, const char* name, const char* what,
               at::IntArrayRef shape, const at::Tensor& like) {
  TORCH_CHECK_VALUE(t.device() == like.device(), name, ": ", what, " must be on ",
                    like.device(), ", got ", t.device());
  TORCH_CHECK_VALUE(t.scalar_type() == at::kFloat, name, ": ", what,
                    " must be float32, got ", t.scalar_type());
  TORCH_CHECK_VALUE(t.sizes() == shape, name, ": ", what, " must be ", shape, ", got ",
                    t.sizes());
  TORCH_CHECK_VALUE(t.is_contiguous(), name, ": ", what, " must be contiguous");
}

void launched(int err, const char* name) {
  TORCH_CHECK(err == 0, name, " launch failed with CUDA error ", err);
}

void* stream_of(int64_t stream) { return reinterpret_cast<void*>(stream); }

int is_bf16(const at::Tensor& t) { return t.scalar_type() == at::kBFloat16; }

int i32(int64_t v) { return static_cast<int>(v); }

at::Tensor op_tps_warp_fwd(const at::Tensor& vol, const at::Tensor& wv,
                           const at::Tensor& cp, int64_t stream) {
  const char* name = "tps_warp_fwd";
  check_vol(vol, name, "vol");
  TORCH_CHECK_VALUE(vol.size(1) >= 2 && vol.size(2) >= 2, name,
                    ": unsupported vol shape ", vol.sizes());
  const int64_t B = vol.size(0);
  check_f32(wv, name, "wv", {B, 28, 2}, vol);
  check_f32(cp, name, "cp", {25, 2}, vol);
  at::Tensor out = at::empty_like(vol);
  launched(tps_warp_fwd(vol.data_ptr(), wv.data_ptr(), cp.data_ptr(), out.data_ptr(),
                        i32(B), i32(vol.size(1)), i32(vol.size(2)), i32(vol.size(3)), 25,
                        is_bf16(vol), stream_of(stream)),
           name);
  return out;
}

// cp: (n_cp, 2) shared or (B, n_cp, 2) per image, 1 <= n_cp <= 32
at::Tensor op_tps_warp_fwd_general(const at::Tensor& vol, const at::Tensor& wv,
                                   const at::Tensor& cp, int64_t order, int64_t stream) {
  const char* name = "tps_warp_fwd_general";
  check_vol(vol, name, "vol");
  TORCH_CHECK_VALUE(vol.size(1) >= 2 && vol.size(2) >= 2, name,
                    ": unsupported vol shape ", vol.sizes());
  const int64_t B = vol.size(0);
  TORCH_CHECK_VALUE((cp.dim() == 2 || cp.dim() == 3) && cp.size(-1) == 2, name,
                    ": cp must be (n_cp, 2) or (B, n_cp, 2), got ", cp.sizes());
  const bool per_image = cp.dim() == 3;
  const int64_t n_cp = cp.size(per_image ? 1 : 0);
  TORCH_CHECK_VALUE(n_cp >= 1 && n_cp <= 32, name,
                    ": the kernel takes 1 to 32 control points, got ", n_cp);
  TORCH_CHECK_VALUE(order >= 1 && order <= 64, name, ": order must be in [1, 64], got ",
                    order);
  if (per_image)
    check_f32(cp, name, "cp", {B, n_cp, 2}, vol);
  else
    check_f32(cp, name, "cp", {n_cp, 2}, vol);
  check_f32(wv, name, "wv", {B, n_cp + 3, 2}, vol);
  at::Tensor out = at::empty_like(vol);
  launched(tps_warp_fwd_general(vol.data_ptr(), wv.data_ptr(), cp.data_ptr(), out.data_ptr(),
                                i32(B), i32(vol.size(1)), i32(vol.size(2)), i32(vol.size(3)),
                                i32(n_cp), i32(order), per_image, is_bf16(vol),
                                stream_of(stream)),
           name);
  return out;
}

// grad_vol comes back in float32 (the caller casts it to vol's dtype)
std::tuple<at::Tensor, at::Tensor> op_tps_warp_bwd(const at::Tensor& vol,
                                                   const at::Tensor& locs,
                                                   const at::Tensor& g, int64_t stream) {
  const char* name = "tps_warp_bwd";
  check_vol(vol, name, "vol");
  const int64_t B = vol.size(0), H = vol.size(1), W = vol.size(2), C = vol.size(3);
  check_f32(locs, name, "locs", {B, H * W, 2}, vol);
  TORCH_CHECK_VALUE(g.device() == vol.device() && g.scalar_type() == vol.scalar_type() &&
                        g.sizes() == vol.sizes(),
                    name, ": g must match vol's device, dtype and shape, got ", g.device(),
                    " ", g.scalar_type(), " ", g.sizes());
  at::Tensor grad_vol = at::empty(vol.sizes(), vol.options().dtype(at::kFloat));
  at::Tensor grad_locs = at::empty_like(locs);
  launched(tps_warp_bwd(vol.data_ptr(), locs.data_ptr(), g.data_ptr(), grad_vol.data_ptr(),
                        grad_locs.data_ptr(), i32(B), i32(H), i32(W), i32(C), is_bf16(vol),
                        g.stride(0), g.stride(1), g.stride(2), g.stride(3),
                        stream_of(stream)),
           name);
  return {grad_vol, grad_locs};
}

at::Tensor op_nearest_warp(const at::Tensor& vol, const at::Tensor& locs, int64_t stream) {
  const char* name = "nearest_warp";
  check_vol(vol, name, "vol");
  const int64_t B = vol.size(0), H = vol.size(1), W = vol.size(2);
  check_f32(locs, name, "locs", {B, H * W, 2}, vol);
  at::Tensor out = at::empty_like(vol);
  launched(nearest_warp(vol.data_ptr(), locs.data_ptr(), out.data_ptr(), i32(B), i32(H),
                        i32(W), i32(vol.size(3)), i32(vol.element_size()),
                        stream_of(stream)),
           name);
  return out;
}

std::vector<at::Tensor> op_rotate_group(at::TensorList arrays, const at::Tensor& cos_t,
                                        const at::Tensor& sin_t, int64_t stream) {
  const char* name = "rotate_group";
  const int n = static_cast<int>(arrays.size());
  TORCH_CHECK_VALUE(n >= 1 && n <= kMaxGroup, name, ": takes 1 to ", kMaxGroup,
                    " arrays, got ", n);
  const at::Tensor& a0 = arrays[0];
  check_vol(a0, name, "arrays[0]");
  const void* src[kMaxGroup] = {nullptr, nullptr, nullptr, nullptr};
  void* dst[kMaxGroup] = {nullptr, nullptr, nullptr, nullptr};
  int C[kMaxGroup] = {0, 0, 0, 0};
  int64_t total = 0;
  for (int k = 0; k < n; ++k) {
    const at::Tensor& a = arrays[k];
    TORCH_CHECK_VALUE(a.device() == a0.device() && a.scalar_type() == a0.scalar_type() &&
                          a.dim() == 4 && a.sizes().slice(0, 3) == a0.sizes().slice(0, 3),
                      name, ": arrays[", k,
                      "] must share arrays[0]'s device, dtype and (B, H, W), got ",
                      a.device(), " ", a.scalar_type(), " ", a.sizes());
    check_vol(a, name, "arrays[" + std::to_string(k) + "]");
    src[k] = a.data_ptr();
    C[k] = i32(a.size(3));
    total += a.numel();
  }
  // one allocation for the group, cut into contiguous outputs
  const at::Tensor flat = at::empty({total}, a0.options());
  std::vector<at::Tensor> outs;
  outs.reserve(n);
  int64_t offset = 0;
  for (int k = 0; k < n; ++k) {
    const at::Tensor& a = arrays[k];
    outs.push_back(flat.as_strided(a.sizes(), a.strides(), offset));
    dst[k] = outs.back().data_ptr();
    offset += a.numel();
  }
  const int64_t B = a0.size(0);
  check_f32(cos_t, name, "cos_t", {B}, a0);
  check_f32(sin_t, name, "sin_t", {B}, a0);
  launched(rotate_group(n, src[0], src[1], src[2], src[3], dst[0], dst[1], dst[2], dst[3],
                        C[0], C[1], C[2], C[3], cos_t.data_ptr(), sin_t.data_ptr(), i32(B),
                        i32(a0.size(1)), i32(a0.size(2)), i32(a0.element_size()),
                        stream_of(stream)),
           name);
  return outs;
}

at::Tensor op_round_ste(const at::Tensor& x, int64_t stream) {
  const char* name = "round_ste";
  TORCH_CHECK_VALUE(x.is_cuda(), name, ": x must be a CUDA tensor, got ", x.device());
  TORCH_CHECK_VALUE(float_type(x), name, ": x must be float32 or bfloat16, got ",
                    x.scalar_type());
  TORCH_CHECK_VALUE(x.is_contiguous(), name, ": x must be contiguous");
  at::Tensor out = at::empty_like(x);
  if (x.numel() > 0)
    launched(round_ste(x.data_ptr(), out.data_ptr(), x.numel(), i32(x.element_size()),
                       stream_of(stream)),
             name);
  return out;
}

// (B, H * W, 5) f32: flow in pixels (y, x), qy, qx, phi_0 per point
at::Tensor op_tps_flow_dbg(const at::Tensor& wv, const at::Tensor& cp, int64_t H, int64_t W,
                           int64_t stream) {
  const char* name = "tps_flow_dbg";
  TORCH_CHECK_VALUE(wv.is_cuda(), name, ": wv must be a CUDA tensor, got ", wv.device());
  TORCH_CHECK_VALUE(wv.dim() == 3 && wv.size(0) >= 1 && wv.size(0) <= 65535, name,
                    ": unsupported wv shape ", wv.sizes());
  const int64_t B = wv.size(0);
  check_f32(wv, name, "wv", {B, 28, 2}, wv);
  check_f32(cp, name, "cp", {25, 2}, wv);
  TORCH_CHECK_VALUE(H >= 2 && W >= 2 && H <= INT32_MAX && W <= INT32_MAX && H * W <= INT32_MAX,
                    name, ": unsupported (H, W) = (", H, ", ", W, ")");
  at::Tensor out = at::empty({B, H * W, 5}, wv.options());
  launched(tps_flow_dbg(wv.data_ptr(), cp.data_ptr(), out.data_ptr(), i32(B), i32(H), i32(W),
                        25, stream_of(stream)),
           name);
  return out;
}

// (N, C, H, W) float32/bfloat16, contiguous NCHW or channels_last; the
// output in c's dtype and layout. cbias, mean, var, weight, beta: (C,)
// float32 on c's device.
at::Tensor op_bn_epilogue(const at::Tensor& c, const at::Tensor& cbias,
                          const at::Tensor& mean, const at::Tensor& var,
                          const at::Tensor& weight, const at::Tensor& beta, double eps,
                          bool relu, int64_t stream) {
  const char* name = "bn_epilogue";
  TORCH_CHECK_VALUE(c.is_cuda(), name, ": c must be a CUDA tensor, got ", c.device());
  TORCH_CHECK_VALUE(float_type(c), name, ": c must be float32 or bfloat16, got ",
                    c.scalar_type());
  TORCH_CHECK_VALUE(c.dim() == 4 && c.numel() > 0, name,
                    ": c must be a non-empty (N, C, H, W), got ", c.sizes());
  const int64_t C = c.size(1), HW = c.size(2) * c.size(3);
  const bool nchw = c.is_contiguous();
  TORCH_CHECK_VALUE(nchw || c.is_contiguous(at::MemoryFormat::ChannelsLast), name,
                    ": c must be contiguous NCHW or channels_last, got strides ", c.strides());
  // the channel of memory offset e is (e / inner) % C
  const int64_t inner = nchw ? HW : 1;
  TORCH_CHECK_VALUE(C <= INT32_MAX && HW <= (int64_t(1) << 30), name, ": unsupported c shape ",
                    c.sizes());
  check_f32(cbias, name, "conv bias", {C}, c);
  check_f32(mean, name, "mean", {C}, c);
  check_f32(var, name, "var", {C}, c);
  check_f32(weight, name, "weight", {C}, c);
  check_f32(beta, name, "beta", {C}, c);
  at::Tensor out = at::empty_like(c);
  launched(bn_epilogue(c.data_ptr(), out.data_ptr(), c.numel(), i32(inner), i32(C),
                       cbias.data_ptr(), mean.data_ptr(), var.data_ptr(),
                       weight.data_ptr(), beta.data_ptr(), static_cast<float>(eps), relu,
                       i32(c.element_size()), stream_of(stream)),
           name);
  return out;
}

// x: (N, C, D, H, W) contiguous bfloat16, 1 <= C <= 4, D, H >= 3, W >= 4
// and even, 4-byte aligned; wp: (ceil(K / 32) * 32, ceil(C * 27 / 16) *
// 16) contiguous bfloat16 on x's device, the (K, C * 27) weights
// zero-padded. The output, (N, K, D - 2, H - 2, W - 2) bfloat16 in
// channels_last_3d (NDHWC in memory): the layout the 3D U-Net keeps on the
// card, in which cuDNN's convolutions need no transform.
at::Tensor op_thin_conv3d(const at::Tensor& x, const at::Tensor& wp, int64_t K,
                          int64_t stream) {
  const char* name = "thin_conv3d";
  TORCH_CHECK_VALUE(x.is_cuda(), name, ": x must be a CUDA tensor, got ", x.device());
  TORCH_CHECK_VALUE(x.scalar_type() == at::kBFloat16, name, ": x must be bfloat16, got ",
                    x.scalar_type());
  TORCH_CHECK_VALUE(x.dim() == 5 && x.is_contiguous(), name,
                    ": x must be a contiguous (N, C, D, H, W), got ", x.sizes(), " strides ",
                    x.strides());
  TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(x.data_ptr()) % 4 == 0, name,
                    ": x must be 4-byte aligned");
  const int64_t N = x.size(0), C = x.size(1), D = x.size(2), H = x.size(3), W = x.size(4);
  TORCH_CHECK_VALUE(N >= 1 && C >= 1 && C <= 4 && D >= 3 && H >= 3 && W >= 4 && W % 2 == 0 &&
                        C * D * H * W <= INT32_MAX && N <= INT32_MAX,
                    name, ": unsupported x shape ", x.sizes());
  TORCH_CHECK_VALUE(K >= 1 && K <= INT32_MAX, name, ": unsupported K ", K);
  const int64_t rows = (K + 31) / 32 * 32, taps = (C * 27 + 15) / 16 * 16;
  TORCH_CHECK_VALUE(wp.device() == x.device() && wp.scalar_type() == x.scalar_type() &&
                        wp.sizes() == at::IntArrayRef({rows, taps}) && wp.is_contiguous(),
                    name, ": wp must be a contiguous (", rows, ", ", taps, ") ",
                    x.scalar_type(), " on ", x.device(), ", got ", wp.sizes(), " ",
                    wp.scalar_type(), " on ", wp.device());
  at::Tensor out = at::empty({N, K, D - 2, H - 2, W - 2}, x.options(),
                             at::MemoryFormat::ChannelsLast3d);
  launched(thin_conv3d(x.data_ptr(), wp.data_ptr(), out.data_ptr(), i32(N), i32(C), i32(D),
                       i32(H), i32(W), i32(K), stream_of(stream)),
           name);
  return out;
}

// x: (N, C, D, H, W) bf16 CUDA tensor, C 48 or 96, contiguous in
// channels_last_3d (NDHWC in memory), 16-byte aligned; wp: (C / 16, 27, 2,
// 6, 8, 8) contiguous bf16, 16-byte aligned
at::Tensor op_same_conv3d(const at::Tensor& x, const at::Tensor& wp, int64_t stream) {
  const char* name = "same_conv3d";
  TORCH_CHECK_VALUE(x.is_cuda(), name, ": x must be a CUDA tensor, got ", x.device());
  TORCH_CHECK_VALUE(x.scalar_type() == at::kBFloat16, name, ": x must be bfloat16, got ",
                    x.scalar_type());
  TORCH_CHECK_VALUE(x.dim() == 5 && x.is_contiguous(at::MemoryFormat::ChannelsLast3d), name,
                    ": x must be an (N, C, D, H, W) contiguous in channels_last_3d, got ",
                    x.sizes(), " strides ", x.strides());
  TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0, name,
                    ": x must be 16-byte aligned");
  const int64_t N = x.size(0), C = x.size(1), D = x.size(2), H = x.size(3), W = x.size(4);
  TORCH_CHECK_VALUE((C == 48 || C == 96) && N >= 1 && D >= 1 && H >= 1 && W >= 1 &&
                        N * D * H * W * C <= INT32_MAX,
                    name, ": unsupported x shape ", x.sizes());
  TORCH_CHECK_VALUE(wp.device() == x.device() && wp.scalar_type() == x.scalar_type() &&
                        wp.sizes() == at::IntArrayRef({C / 16, 27, 2, 6, 8, 8}) &&
                        wp.is_contiguous() &&
                        reinterpret_cast<uintptr_t>(wp.data_ptr()) % 16 == 0,
                    name, ": wp must be a contiguous 16-byte aligned (", C / 16,
                    ", 27, 2, 6, 8, 8) ", x.scalar_type(), " on ", x.device(), ", got ",
                    wp.sizes(), " ", wp.scalar_type(), " on ", wp.device());
  at::Tensor out = at::empty({N, 48, D, H, W}, x.options(), at::MemoryFormat::ChannelsLast3d);
  launched(same_conv3d(x.data_ptr(), wp.data_ptr(), out.data_ptr(), i32(N), i32(C), i32(D),
                       i32(H), i32(W), stream_of(stream)),
           name);
  return out;
}

}  // namespace

TORCH_LIBRARY(mmseg_cuda, m) {
  m.def("tps_warp_fwd(Tensor vol, Tensor wv, Tensor cp, int stream) -> Tensor");
  m.def(
      "tps_warp_fwd_general(Tensor vol, Tensor wv, Tensor cp, int order, int stream) -> "
      "Tensor");
  m.def("tps_warp_bwd(Tensor vol, Tensor locs, Tensor g, int stream) -> (Tensor, Tensor)");
  m.def("nearest_warp(Tensor vol, Tensor locs, int stream) -> Tensor");
  m.def("rotate_group(Tensor[] arrays, Tensor cos_t, Tensor sin_t, int stream) -> Tensor[]");
  m.def("round_ste(Tensor x, int stream) -> Tensor");
  m.def("tps_flow_dbg(Tensor wv, Tensor cp, int H, int W, int stream) -> Tensor");
  m.def(
      "bn_epilogue(Tensor c, Tensor cbias, Tensor mean, Tensor var, Tensor weight, "
      "Tensor beta, float eps, bool relu, int stream) -> Tensor");
  m.def("thin_conv3d(Tensor x, Tensor wp, int K, int stream) -> Tensor");
  m.def("same_conv3d(Tensor x, Tensor wp, int stream) -> Tensor");
}

TORCH_LIBRARY_IMPL(mmseg_cuda, CUDA, m) {
  m.impl("tps_warp_fwd", &op_tps_warp_fwd);
  m.impl("tps_warp_fwd_general", &op_tps_warp_fwd_general);
  m.impl("tps_warp_bwd", &op_tps_warp_bwd);
  m.impl("nearest_warp", &op_nearest_warp);
  m.impl("rotate_group", &op_rotate_group);
  m.impl("round_ste", &op_round_ste);
  m.impl("tps_flow_dbg", &op_tps_flow_dbg);
  m.impl("bn_epilogue", &op_bn_epilogue);
  m.impl("thin_conv3d", &op_thin_conv3d);
  m.impl("same_conv3d", &op_same_conv3d);
}
