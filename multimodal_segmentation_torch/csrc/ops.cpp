// The port's CUDA kernels as PyTorch operators (namespace mmseg_cuda),
// registered with TORCH_LIBRARY for the CUDA dispatch key.
//
// Each kernel source (tps_warp.cu, tps_warp_bwd.cu, nearest_warp.cu,
// round_ste.cu, tps_flow_dbg.cu) keeps a plain C entry point; this file checks the tensors,
// allocates the outputs with the caching allocator and calls the entry
// point, in one call from Python. The checks raise ValueError
// (TORCH_CHECK_VALUE); a launch error raises RuntimeError. The stream is the
// raw handle of the caller's current stream on the tensors' device, passed
// in as an int, so this file needs no CUDA header; the caller
// (ops/cuda_kernels.py) makes that device current. Built by
// ops/cuda_kernels.py with g++ against torch's headers and linked with the
// kernels' objects into one library, loaded with torch.ops.load_library.

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

}  // namespace

TORCH_LIBRARY(mmseg_cuda, m) {
  m.def("tps_warp_fwd(Tensor vol, Tensor wv, Tensor cp, int stream) -> Tensor");
  m.def("tps_warp_bwd(Tensor vol, Tensor locs, Tensor g, int stream) -> (Tensor, Tensor)");
  m.def("nearest_warp(Tensor vol, Tensor locs, int stream) -> Tensor");
  m.def("rotate_group(Tensor[] arrays, Tensor cos_t, Tensor sin_t, int stream) -> Tensor[]");
  m.def("round_ste(Tensor x, int stream) -> Tensor");
  m.def("tps_flow_dbg(Tensor wv, Tensor cp, int H, int W, int stream) -> Tensor");
}

TORCH_LIBRARY_IMPL(mmseg_cuda, CUDA, m) {
  m.impl("tps_warp_fwd", &op_tps_warp_fwd);
  m.impl("tps_warp_bwd", &op_tps_warp_bwd);
  m.impl("nearest_warp", &op_nearest_warp);
  m.impl("rotate_group", &op_rotate_group);
  m.impl("round_ste", &op_round_ste);
  m.impl("tps_flow_dbg", &op_tps_flow_dbg);
}
