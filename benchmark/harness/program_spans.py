"""The program's own spans (multimodal_segmentation_torch/utils/tracing.py:
`predict_mask` and its children) read against the traced window's device
activity.

The program records its spans while the window's profiler runs, on the
profiler's clock (`time.time_ns()`). Each device activity (kernel, copy,
fill) belongs to the innermost program span open when its CUDA runtime
call was made: activity and call are matched by correlation id, call and
span by time (the cells drive the program from one client thread). An
activity whose call lies outside every span is the client's (`CLIENT`:
e.g. the harness's `.cpu()` copy of a mask); one with no runtime call in
the trace is `UNATTRIBUTED`.

`window_spans` and the readers' functions return None where there is
nothing to read: no device trace, or a program that records no spans.
"""

import bisect
import collections
import types

CLIENT = "client"
UNATTRIBUTED = "unattributed"


def window_spans(trace):
    """The program's spans of the traced window: those of the root spans
    that overlap the window's device activity (which drops the spans of a
    profile run after the window). None without a device trace or spans."""
    if trace is None or not trace.device:
        return None
    try:
        from multimodal_segmentation_torch.utils import tracing
    except ImportError:
        return None
    first = trace.device[0][1]
    last = max(e for _, _, e, _ in trace.device)
    spans = tracing.spans()
    roots = {s.span_id for s in spans
             if s.parent_id is None and s.start_ns < last and s.end_ns > first}
    return [s for s in spans if s.request_id in roots] or None


def _segments(spans):
    """[(start_ns, end_ns, name)]: the spans' intervals cut where a child
    opens or closes, each piece named by the innermost span open over it;
    disjoint and in order (spans of one thread nest)."""
    out, stack, cursor = [], [], None
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1].end_ns <= s.start_ns:
            top = stack.pop()
            out.append((cursor, top.end_ns, top.name))
            cursor = top.end_ns
        if stack:
            out.append((cursor, s.start_ns, stack[-1].name))
        stack.append(s)
        cursor = s.start_ns
    while stack:
        top = stack.pop()
        out.append((cursor, top.end_ns, top.name))
        cursor = top.end_ns
    return [seg for seg in out if seg[1] > seg[0]]


def _busy_ns(busy, starts, a, b):
    """ns of [a, b) in which some device activity ran."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0
    while i < len(busy) and busy[i][0] < b:
        total += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return total


def attribute(trace, spans):
    """What the window's device did for each span name, the client and
    nothing: `device_s` (a Counter of device seconds by owner), `ops` (by
    owner, a Counter of device seconds by activity name), `idle_s` (idle
    device seconds inside each name's own pieces of time; the client's is
    the window's rest), and the roots' `root_s`, `root_idle_s` and
    `slices`."""
    segments = _segments(spans)
    seg_starts = [s for s, _, _ in segments]
    call_at = {corr: start for start, _, corr in trace.runtime}
    device_s, ops = collections.Counter(), collections.defaultdict(collections.Counter)
    for name, s, e, corr in trace.device:
        t = call_at.get(corr)
        if t is None:
            owner = UNATTRIBUTED
        else:
            i = bisect.bisect_right(seg_starts, t) - 1
            owner = segments[i][2] if i >= 0 and t < segments[i][1] else CLIENT
        device_s[owner] += (e - s) / 1e9
        ops[owner][name] += (e - s) / 1e9
    busy = trace._busy  # the union of the device's activity, in order
    busy_starts = [b[0] for b in busy]
    idle_s = collections.Counter()
    for s, e, name in segments:
        idle_s[name] += (e - s - _busy_ns(busy, busy_starts, s, e)) / 1e9
    roots = [s for s in spans if s.parent_id is None]
    root_s = sum(r.end_ns - r.start_ns for r in roots) / 1e9
    root_idle_s = sum(r.end_ns - r.start_ns - _busy_ns(busy, busy_starts, r.start_ns, r.end_ns)
                      for r in roots) / 1e9
    idle_s[CLIENT] = trace.window_s - trace.busy_s - root_idle_s
    return types.SimpleNamespace(device_s=device_s, ops=ops, idle_s=idle_s, root_s=root_s,
                                 root_idle_s=root_idle_s,
                                 slices=sum(r.attrs["slices"] for r in roots))


def _attribution(ctx):
    spans = window_spans(ctx.trace)
    return None if spans is None else attribute(ctx.trace, spans)


def idle_share(ctx):
    """% of the window's root spans' time in which the device ran nothing."""
    a = _attribution(ctx)
    if a is None or a.root_s <= 0:
        return None
    return 100.0 * a.root_idle_s / a.root_s


def device_ms_per_slice(ctx, name):
    """Device ms that span `name` owns, over the window's slices."""
    a = _attribution(ctx)
    if a is None or not a.slices or name not in a.device_s:
        return None
    return 1e3 * a.device_s[name] / a.slices
