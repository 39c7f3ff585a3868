"""The traced window, reduced to what the per-layer readers and the
breakdown need.

Over the measured window torch.profiler records the device's activity
alone (kernels, copies, fills: CUPTI), which costs the host little; the
benchmark's own spans come from its host clock (`Spans`). A second,
short profile after the window (`shapes_profiler`) also records the
host's operators with their input shapes, for the bounds of the port's
kernels. `kernel_kind` is the classifier of the port's chip_smoke.py
(`_kernel_kind`), copied.
"""

import bisect
import collections

import contextlib
import time

# the profiler's activity types: what ran on the device, the host's calls
# into the CUDA runtime and driver (whose correlation ids name what they
# launched), and the host's operators and spans
DEVICE_ACTIVITY = {"kernel", "concurrent_kernel", "gpu_memcpy", "gpu_memset"}
RUNTIME_ACTIVITY = {"cuda_runtime", "cuda_driver"}
HOST_ACTIVITY = {"cpu_op", "user_annotation"}


def kernel_kind(name):
    n = name.lower()
    if any(k in n for k in ("tps_warp_fwd", "tps_warp_general", "tps_warp_bwd", "nearest_copy",
                            "round_ste", "tps_flow_dbg")):
        return "port kernels"
    # cuDNN's FFT-tiling convolutions: complex (cf32) GEMMs, FFTs, tile transforms
    if any(k in n for k in ("cf32", "fft", "dse::", "region_transform")):
        return "convolution"
    if any(k in n for k in ("conv", "cudnn", "implicit", "wgrad", "dgrad", "fprop")):
        return "convolution"
    if "gemm" in n or "cutlass" in n or "sm90_" in n:
        return "matmul"
    if "reduce" in n or "norm" in n:
        return "reduction"
    if "memcpy" in n or "memset" in n:
        return "copy/fill"
    return "elementwise/other"


def _activity(e):
    """The profiler's activity type of event `e`; where this torch's events
    do not say, told from the device and the name: CUDA runtime and driver
    calls are named cuda* and cu*."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if str(e.device_type()).endswith("CUDA"):
        return "gpu_user_annotation" if e.is_user_annotation() else "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    return "cuda_runtime" if e.name().startswith("cu") else "cpu_op"


def profiler():
    """The window's profiler: the device's activity only (the host's where
    there is no card, as in the CPU tests)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.cuda.is_available()
    return profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU])


def shapes_profiler():
    """The short profile after the window: the host's operators with their
    input shapes and the device's activity, linked by correlation."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True)


class Spans:
    """The benchmark's own spans on the host clock, in the profiler's time
    base (nanoseconds since the epoch): `with spans("data_wait"): ...`."""

    def __init__(self, on=True):
        self.on = on
        self.items = []

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        start = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, start, time.time_ns()))

    def durations(self, name):
        return [(e - s) / 1e9 for n, s, e in self.items if n == name]


class Trace:
    """device: [(name, start_ns, end_ns, correlation)]; host ops:
    [(name, start_ns, end_ns, thread, shapes, dtypes)]; runtime calls:
    [(start_ns, thread, correlation)]; window_s: the traced window's
    length on the host clock; spans: the benchmark's Spans."""

    def __init__(self, prof, window_s, spans=None):
        self.window_s = window_s
        self.spans = spans or Spans(False)
        self.device, self.ops, self.runtime = [], [], []
        for e in prof.profiler.kineto_results.events():
            kind = _activity(e)
            start, dur = e.start_ns(), e.duration_ns()
            if kind in DEVICE_ACTIVITY:
                self.device.append((e.name(), start, start + dur, e.correlation_id()))
            elif kind in RUNTIME_ACTIVITY:
                self.runtime.append((start, e.start_thread_id(), e.correlation_id()))
            elif kind in HOST_ACTIVITY:
                self.ops.append((e.name(), start, start + dur, e.start_thread_id(),
                                 e.shapes(), e.dtypes()))
        self.device.sort(key=lambda d: d[1])
        self.runtime.sort()
        self._busy = self._merged()

    def _merged(self):
        out = []
        for _, s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self):
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self._busy) / 1e9

    def device_by_name(self):
        acc = collections.Counter()
        for name, s, e, _ in self.device:
            acc[name] += (e - s) / 1e9
        return acc

    def device_s_of_kind(self, kind):
        return sum((e - s) / 1e9 for name, s, e, _ in self.device if kernel_kind(name) == kind)

    def calls(self, prefix):
        """[(op name, shapes, dtypes, device s)] of each host operator whose
        name starts with `prefix`, with the device time of everything it
        launched (matched through the runtime calls made inside it)."""
        by_corr = collections.defaultdict(float)
        for _, s, e, c in self.device:
            by_corr[c] += (e - s) / 1e9
        starts = [r[0] for r in self.runtime]
        out = []
        for name, s, e, thread, shapes, dtypes in self.ops:
            if not name.startswith(prefix):
                continue
            i = bisect.bisect_left(starts, s)
            dev = 0.0
            while i < len(starts) and starts[i] <= e:
                if self.runtime[i][1] == thread:
                    dev += by_corr.get(self.runtime[i][2], 0.0)
                i += 1
            out.append((name, shapes, dtypes, dev))
        return out

    def idle_gaps(self, top=10):
        """The `top` longest gaps between device activity, each named by
        what the host was doing at its middle: the benchmark's innermost
        span open then."""
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(self._busy, self._busy[1:])),
                      reverse=True)[:top]
        out = []
        for length, s, e in gaps:
            mid = (s + e) // 2
            open_spans = [(se - ss, n) for n, ss, se in self.spans.items if ss <= mid <= se]
            out.append([min(open_spans)[1] if open_spans else "outside the benchmark's spans",
                        length / 1e9])
        return out

    def breakdown(self, top=10):
        ops = self.device_by_name().most_common(top)
        return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": self.idle_gaps(top)}
