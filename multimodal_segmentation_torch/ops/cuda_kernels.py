"""The port's hand-written CUDA kernels: build, bind, check, launch, count.

Each kernel is a source under csrc/ with a plain C entry point (one or
more). csrc/ops.cpp registers them as PyTorch operators (namespace
mmseg_cuda, TORCH_LIBRARY, CUDA dispatch key): in one call from Python it
checks the tensors, allocates the outputs and launches. On first use the
kernels are compiled with nvcc for sm_90a and ops.cpp with g++ against
torch's headers, all at once, and linked into one library in build/ (next
to csrc/, listed in .gitignore), loaded with torch.ops.load_library. No
ninja and no pybind11 are needed. The library's name holds torch's
version, so another torch builds its own; each build writes its objects
and the library under names of its own process, and the library takes
its place with one rename, so processes that build at once in one
checkout do not read each other's half-written files.

The launch path is kept light, since at the training shapes a call's host
time is as long as its device time:
  * the operators are read without a lock once they are loaded;
  * the device is switched only when the tensor's device is not current;
  * the stream is the raw handle of the current stream
    (torch._C._cuda_getCurrentRawStream), passed to the operator as an int;
  * the checks and the allocations are C++, inside the one call.
A bad input raises ValueError (before anything is built if it is not a
CUDA tensor), a launch error RuntimeError. A wrapper launches on the
current stream without synchronising and adds one to its kernel's
`launches` count. Nothing is built or loaded when this module is
imported, so it imports on a machine without CUDA.

The wrappers take CUDA tensors only; the callers in ops/ (tps.py,
augment.py, rounding.py) run the plain PyTorch versions for tensors on the
CPU.
"""

import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
LIBRARY = os.path.join(BUILD_DIR, "libmmseg_cuda.torch%s.so" % torch.__version__)
BINDING = os.path.join(CSRC_DIR, "ops.cpp")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the most arrays one rotate_group launch takes (csrc/nearest_warp.cu)
MAX_GROUP = 4


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on first use")
    return path


class Kernel:
    """One CUDA source and the operators that launch it; `launches`
    counts the launches of all of them."""

    def __init__(self, name, source, entries):
        self.name = name
        self.source = os.path.join(CSRC_DIR, source)
        self.entries = entries
        self.launches = 0
        self.fns = None          # {entry: torch.ops overload} once loaded

    def fn(self, entry=None):
        """The operator `entry` (default: the kernel's name), building and
        loading the library on first use."""
        fns = self.fns
        if fns is None:
            fns = _load()[self.name]
        return fns[entry or self.name]


TPS_WARP_FWD = Kernel("tps_warp_fwd", "tps_warp.cu", ("tps_warp_fwd",))
TPS_WARP_BWD = Kernel("tps_warp_bwd", "tps_warp_bwd.cu", ("tps_warp_bwd",))
NEAREST_WARP = Kernel("nearest_warp", "nearest_warp.cu", ("nearest_warp", "rotate_group"))
ROUND_STE = Kernel("round_ste", "round_ste.cu", ("round_ste",))
TPS_FLOW_DBG = Kernel("tps_flow_dbg", "tps_flow_dbg.cu", ("tps_flow_dbg",))
KERNELS = (TPS_WARP_FWD, TPS_WARP_BWD, NEAREST_WARP, ROUND_STE, TPS_FLOW_DBG)
_lock = threading.Lock()


def _start(cmd):
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter())


def _finish(job, what):
    proc, t0 = job
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError("build failed for %s:\n%s" % (what, log))
    return {"seconds": time.perf_counter() - t0,
            "ptxas": [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]}


def build_all():
    """Build the library from csrc/: one nvcc per kernel source and one g++
    for ops.cpp, all started together, then one link. Returns {kernel
    name: {"seconds", "ptxas"}, "ops.cpp": ..., "link": ...}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    torch_lib = os.path.join(torch_dir, "lib")
    pid = os.getpid()
    objects = {k.name: os.path.join(BUILD_DIR, "%s.%d.o" % (k.name, pid)) for k in KERNELS}
    binding = os.path.join(BUILD_DIR, "ops.%d.o" % pid)
    tmp = "%s.%d.tmp" % (LIBRARY, pid)
    try:
        jobs = [(k, _start([_nvcc(), *NVCC_FLAGS, "-c", "-o", objects[k.name], k.source]))
                for k in KERNELS]
        gxx = _start([shutil.which("g++") or "c++", "-std=c++17", "-O2", "-fPIC", "-w",
                      "-D_GLIBCXX_USE_CXX11_ABI=%d" % int(torch._C._GLIBCXX_USE_CXX11_ABI),
                      "-I", os.path.join(torch_dir, "include"), "-c", "-o", binding, BINDING])
        info = {k.name: _finish(job, k.source) for k, job in jobs}
        info["ops.cpp"] = _finish(gxx, BINDING)
        info["link"] = _finish(_start([_nvcc(), "-shared", "-o", tmp, *objects.values(),
                                       binding, "-L", torch_lib, "-lc10", "-ltorch_cpu",
                                       "-Xlinker", "-rpath", "-Xlinker", torch_lib]), LIBRARY)
        os.replace(tmp, LIBRARY)
    finally:
        for path in [*objects.values(), binding, tmp]:
            if os.path.exists(path):
                os.remove(path)
    return info


def _stale():
    """Whether the library is missing or older than any file under csrc/:
    the kernel sources, ops.cpp and the headers they include."""
    if not os.path.exists(LIBRARY):
        return True
    built = os.path.getmtime(LIBRARY)
    return any(os.path.getmtime(os.path.join(CSRC_DIR, f)) > built for f in os.listdir(CSRC_DIR))


def _load():
    """Build the library if it is missing or older than a source, load it
    once, and bind every kernel's operators. Returns {kernel name: fns}."""
    with _lock:
        if any(k.fns is None for k in KERNELS):
            if _stale():
                build_all()
            torch.ops.load_library(LIBRARY)
            for k in KERNELS:
                k.fns = {e: getattr(torch.ops.mmseg_cuda, e).default for e in k.entries}
        return {k.name: k.fns for k in KERNELS}


def launch_counts():
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def _launch(kernel, entry, t, *args, count=1):
    """The operator `entry` of `kernel` on (*args, stream): the current
    stream of t's device, made current for the call if it is not; counts
    the launch unless it raised."""
    fn = kernel.fn(entry)
    idx = t.get_device()
    if idx == torch._C._cuda_getDevice():
        out = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            out = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    kernel.launches += count
    return out


def _fail(name, msg):
    raise ValueError("%s: %s" % (name, msg))


def _cuda(t, name, what):
    """The only check made in Python: the rest are the operators' own (in
    C++), but a CPU tensor must raise before anything is built."""
    if not t.is_cuda:
        _fail(name, "%s must be a CUDA tensor, got %s" % (what, t.device))


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
    _cuda(vol, "tps_warp_fwd", "vol")
    return _launch(TPS_WARP_FWD, "tps_warp_fwd", vol, vol, wv, cp)


def tps_warp_bwd(vol, locs, g):
    """Backward of the bilinear warp on the GPU (csrc/tps_warp_bwd.cu).

    Replaces multimodal_segmentation_tpu/ops/pallas_kernels.py::
    tps_bilinear_warp_bwd_pallas. Memory-bound: it reads vol, g and locs
    and writes grad_vol and grad_locs once (49.6 MB at B=12, 192x192, C=8
    in f32). A block sums its tile's scatter into grad_vol in a
    shared-memory window and adds the window to grad_vol with vector
    atomics; grad_vol is not bit-reproducible across runs, grad_locs is.

    Args:
      vol: (B, H, W, C) contiguous CUDA tensor, float32 or bfloat16: the
        forward's source.
      locs: (B, H*W, 2) contiguous float32 pixel-space (y, x) locations
        (ops/tps.py::tps_sample_locations).
      g: (B, H, W, C) cotangent of the forward output in vol's dtype, any
        strides (the kernel reads it through them; the fuser's permute
        hands it over channels-first).

    Returns:
      (grad_vol, grad_locs): (B, H, W, C) in vol's dtype (accumulated in
      f32) and (B, H*W, 2) float32.
    """
    _cuda(vol, "tps_warp_bwd", "vol")
    grad_vol, grad_locs = _launch(TPS_WARP_BWD, "tps_warp_bwd", vol, vol, locs, g)
    if vol.dtype != torch.float32:
        grad_vol = grad_vol.to(vol.dtype)
    return grad_vol, grad_locs


def nearest_warp(vol, locs):
    """Nearest-neighbour warp at explicit locations on the GPU
    (csrc/nearest_warp.cu, entry nearest_warp).

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
    _cuda(vol, "nearest_warp", "vol")
    return _launch(NEAREST_WARP, "nearest_warp", vol, vol, locs)


def rotate_group(arrays, cos_t, sin_t):
    """Rotate up to MAX_GROUP arrays by the same per-sample angles in one
    launch (csrc/nearest_warp.cu, entry rotate_group).

    The same function as ops/augment.py::random_rotate_batch on the
    concatenated group: each output point's source pixel is computed in
    the kernel from cos/sin, in the f32 operation order of
    ops/augment.py::rotation_locations, rounded half to even and clamped
    to the edge; the channels are copied bit for bit. Each array is read
    and each output written directly: no concatenation, no split. The
    outputs share one allocation.

    Args:
      arrays: 1 to MAX_GROUP contiguous (B, H, W, C_i) CUDA tensors of one
        dtype (float32 or bfloat16) and one (B, H, W).
      cos_t, sin_t: (B,) contiguous float32 cos and sin of the angles.

    Returns:
      A list of (B, H, W, C_i) tensors in the arrays' dtype.
    """
    if not arrays:
        _fail("rotate_group", "takes 1 to %d arrays, got none" % MAX_GROUP)
    _cuda(arrays[0], "rotate_group", "arrays[0]")
    return _launch(NEAREST_WARP, "rotate_group", arrays[0], arrays, cos_t, sin_t)


def round_ste(x):
    """Round half to even, elementwise, on the GPU (csrc/round_ste.cu).

    Replaces multimodal_segmentation_tpu/ops/pallas_kernels.py::
    round_ste_pallas (its forward; the identity gradient is
    ops/rounding.py's). Rounds in f32 with rintf and writes x's dtype, for
    any size. Memory-bound: x read once, the output written once (2 x 14.2
    MB at the training step's (12, 8, 192, 192) f32 anatomy).

    Args:
      x: contiguous CUDA tensor of any shape, float32 or bfloat16.

    Returns:
      A new tensor of x's shape and dtype.
    """
    _cuda(x, "round_ste", "x")
    return _launch(ROUND_STE, "round_ste", x, x, count=int(x.numel() > 0))


def tps_flow_dbg(wv, cp, vol_shape):
    """The TPS warp's flow stage, dumped per point, on the GPU
    (csrc/tps_flow_dbg.cu).

    Replaces tools/debug_warp_kernel.py::flow_dbg, the TPU bisect of the
    fused warp's flow stage. It runs the flow code of tps_warp_fwd
    (csrc/tps_flow.cuh) and writes, per output point, what the warp would
    blend at. Its bound is the bytes, B x H x W x 20 written (17.7 MB at
    B=24, 192x192); its time is the flow's arithmetic (25 accurate logf a
    point), several times that bound.

    Args:
      wv: (B, 28, 2) contiguous CUDA float32 spline coefficients [w; v]
        (ops/tps.py::tps_coefficients).
      cp: (25, 2) contiguous float32 control points on wv's device.
      vol_shape: (H, W) of the image the flow warps.

    Returns:
      (B, H*W, 5) float32: per point the flow in pixels (y, x), the
      normalised query point (qy, qx) and the first radial basis term.
    """
    _cuda(wv, "tps_flow_dbg", "wv")
    H, W = vol_shape
    return _launch(TPS_FLOW_DBG, "tps_flow_dbg", wv, wv, cp, int(H), int(W))
