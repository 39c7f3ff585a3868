"""The port's hand-written CUDA kernels: build, bind, check, launch, count.

Each kernel is a source under csrc/ with a plain C interface. On first use
it is compiled with nvcc for sm_90a into build/ (next to csrc/, listed in
.gitignore) and loaded with ctypes. Every pointer and the stream go to C as
c_void_p. A wrapper checks device, dtype, shape and contiguity, allocates
its output with torch.empty, launches on the current stream without
synchronising, raises if the C function reports a launch error, and adds
one to its kernel's `launches` count. Nothing is built or loaded when this
module is imported, so it imports on a machine without CUDA.

The wrappers take CUDA tensors only; the callers in ops/ (tps.py,
augment.py) run the plain PyTorch versions for tensors on the CPU.
"""

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on first use")
    return path


class Kernel:
    """One CUDA source with one C entry point, built on first use."""

    def __init__(self, name, source, argtypes):
        self.name = name
        self.source = os.path.join(CSRC_DIR, source)
        self.library = os.path.join(
            BUILD_DIR, "lib%s.so" % os.path.splitext(source)[0]
        )
        self.argtypes = argtypes
        self.launches = 0
        self.build_info = None   # {"seconds", "ptxas"} after a build
        self._fn = None
        self._lock = threading.Lock()

    def _stale(self):
        return (not os.path.exists(self.library)
                or os.path.getmtime(self.library) < os.path.getmtime(self.source))

    def _start_build(self):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (self.library, os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, time.perf_counter()

    def _finish_build(self, proc, tmp, t0):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (self.source, log))
        os.replace(tmp, self.library)
        self.build_info = {
            "seconds": time.perf_counter() - t0,
            "ptxas": [l.strip() for l in log.splitlines()
                      if "registers" in l or "spill" in l],
        }

    def fn(self):
        """The bound C function, building the library first if needed."""
        with self._lock:
            if self._fn is None:
                if self._stale():
                    self._finish_build(*self._start_build())
                f = getattr(ctypes.CDLL(self.library), self.name)
                f.argtypes = self.argtypes
                f.restype = ctypes.c_int
                self._fn = f
            return self._fn


TPS_WARP_FWD = Kernel(
    "tps_warp_fwd", "tps_warp.cu", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
)
TPS_WARP_BWD = Kernel(
    "tps_warp_bwd", "tps_warp_bwd.cu", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
)
NEAREST_WARP = Kernel(
    "nearest_warp", "nearest_warp.cu", [_P, _P, _P, _I, _I, _I, _I, _I, _P]
)
KERNELS = (TPS_WARP_FWD, TPS_WARP_BWD, NEAREST_WARP)


def build_all():
    """Build every kernel library from its source, one nvcc per source, all
    started together. Returns {kernel name: build_info}."""
    started = [(k, k._start_build()) for k in KERNELS]
    for k, job in started:
        k._finish_build(*job)
    return {k.name: k.build_info for k in KERNELS}


def launch_counts():
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def _check(cond, msg, name="tps_warp_fwd"):
    if not cond:
        raise ValueError("%s: %s" % (name, msg))


def _check_vol(vol, name):
    _check(vol.device.type == "cuda", "vol must be a CUDA tensor, got %s" % vol.device, name)
    _check(vol.dtype in (torch.float32, torch.bfloat16),
           "vol must be float32 or bfloat16, got %s" % vol.dtype, name)
    _check(vol.dim() == 4, "vol must be (B, H, W, C), got %s" % (tuple(vol.shape),), name)
    B, H, W, C = vol.shape
    _check(1 <= B <= 65535 and H >= 1 and W >= 1 and C >= 1,
           "unsupported vol shape %s" % (tuple(vol.shape),), name)
    _check(vol.is_contiguous(), "vol must be contiguous", name)


def _check_locs(locs, vol, name):
    B, H, W, _ = vol.shape
    _check(locs.device == vol.device, "locs must be on %s" % vol.device, name)
    _check(locs.dtype == torch.float32, "locs must be float32, got %s" % locs.dtype, name)
    _check(tuple(locs.shape) == (B, H * W, 2),
           "locs must be %s, got %s" % ((B, H * W, 2), tuple(locs.shape)), name)
    _check(locs.is_contiguous(), "locs must be contiguous", name)


def _launch(kernel, device, *args):
    fn = kernel.fn()
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("%s launch failed with CUDA error %d" % (kernel.name, err))
    kernel.launches += 1


def tps_warp_fwd(vol, wv, cp):
    """Fused TPS flow + bilinear warp on the GPU (csrc/tps_warp.cu).

    Replaces multimodal_segmentation_tpu/ops/pallas_kernels.py::
    tps_bilinear_warp_pallas. Memory-bound: it reads vol and writes out
    once (2 x 28.3 MB at B=24, 192x192, C=8 in f32), and evaluates the
    flow per point in f32 with an accurate logf. One thread per output
    point, corners read channels-last, f32 accumulation.

    Args:
      vol: (B, H, W, C) contiguous CUDA tensor, float32 or bfloat16.
      wv: (B, 28, 2) contiguous float32 spline coefficients [w; v]
        (ops/tps.py::tps_coefficients).
      cp: (25, 2) contiguous float32 control points (control_grid((5, 5))).

    Returns:
      (B, H, W, C) warped images in vol's dtype.
    """
    _check_vol(vol, "tps_warp_fwd")
    B, H, W, C = vol.shape
    _check(H >= 2 and W >= 2, "unsupported vol shape %s" % (tuple(vol.shape),))
    for name, t, shape in (("wv", wv, (B, 28, 2)), ("cp", cp, (25, 2))):
        _check(t.device == vol.device, "%s must be on %s" % (name, vol.device))
        _check(t.dtype == torch.float32, "%s must be float32, got %s" % (name, t.dtype))
        _check(tuple(t.shape) == shape,
               "%s must be %s, got %s" % (name, shape, tuple(t.shape)))
    _check(wv.is_contiguous() and cp.is_contiguous(), "inputs must be contiguous")

    out = torch.empty_like(vol)
    _launch(TPS_WARP_FWD, vol.device, vol.data_ptr(), wv.data_ptr(), cp.data_ptr(),
            out.data_ptr(), B, H, W, C, cp.shape[0], int(vol.dtype == torch.bfloat16))
    return out


def tps_warp_bwd(vol, locs, g):
    """Backward of the bilinear warp on the GPU (csrc/tps_warp_bwd.cu).

    Replaces multimodal_segmentation_tpu/ops/pallas_kernels.py::
    tps_bilinear_warp_bwd_pallas. Memory-bound: it reads vol, g and locs
    and writes grad_vol and grad_locs once (49.6 MB at B=12, 192x192, C=8
    in f32). One thread per sample point; the corner scatter into grad_vol
    uses f32 atomics, so grad_vol is not bit-reproducible across runs.

    Args:
      vol: (B, H, W, C) contiguous CUDA tensor, float32 or bfloat16: the
        forward's source.
      locs: (B, H*W, 2) contiguous float32 pixel-space (y, x) locations
        (ops/tps.py::tps_sample_locations).
      g: (B, H, W, C) contiguous cotangent of the forward output, vol's dtype.

    Returns:
      (grad_vol, grad_locs): (B, H, W, C) in vol's dtype (accumulated in
      f32) and (B, H*W, 2) float32.
    """
    name = "tps_warp_bwd"
    _check_vol(vol, name)
    _check_locs(locs, vol, name)
    _check(g.device == vol.device and g.dtype == vol.dtype and g.shape == vol.shape,
           "g must match vol's device, dtype and shape, got %s %s %s"
           % (g.device, g.dtype, tuple(g.shape)), name)
    _check(g.is_contiguous(), "g must be contiguous", name)
    B, H, W, C = vol.shape
    grad_vol = torch.zeros(vol.shape, dtype=torch.float32, device=vol.device)
    grad_locs = torch.empty_like(locs)
    _launch(TPS_WARP_BWD, vol.device, vol.data_ptr(), locs.data_ptr(), g.data_ptr(),
            grad_vol.data_ptr(), grad_locs.data_ptr(), B, H, W, C,
            int(vol.dtype == torch.bfloat16))
    return grad_vol.to(vol.dtype), grad_locs


def nearest_warp(vol, locs):
    """Nearest-neighbour warp at explicit locations on the GPU
    (csrc/nearest_warp.cu).

    Replaces multimodal_segmentation_tpu/ops/pallas_kernels.py::
    nearest_warp_pallas. y = clip(round_half_even(ly), 0, H-1), x likewise,
    and the C channels of that pixel are copied bit for bit. Memory-bound:
    vol and locs read once, the output written once. Not differentiable.

    Args:
      vol: (B, H, W, C) contiguous CUDA tensor, float32 or bfloat16.
      locs: (B, H*W, 2) contiguous float32 pixel-space (y, x) locations
        (ops/augment.py::rotation_locations).

    Returns:
      (B, H, W, C) in vol's dtype.
    """
    name = "nearest_warp"
    _check_vol(vol, name)
    _check_locs(locs, vol, name)
    B, H, W, C = vol.shape
    out = torch.empty_like(vol)
    _launch(NEAREST_WARP, vol.device, vol.data_ptr(), locs.data_ptr(), out.data_ptr(),
            B, H, W, C, vol.element_size())
    return out
