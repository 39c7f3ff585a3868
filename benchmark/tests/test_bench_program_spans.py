"""benchmark/harness/program_spans.py and the four readers of the program's
spans, on a hand-made window with known answers: idle inside the spans,
device time by innermost span where parent and child are both open, the
client's remainder and unattributed activity, and the spans of a profile
after the window (or of an earlier one) dropped.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import sys
import types

import pytest

import multimodal_segmentation_torch.utils
from benchmark.harness import common, program_spans
from benchmark.harness.trace import Spans, Trace
from multimodal_segmentation_torch.utils import tracing

US = 1000  # ns


def _span(name, span_id, start, end, parent=None, **attrs):
    return tracing.Span(name, span_id, parent and parent.span_id,
                        parent.request_id if parent else span_id, attrs, start * US, end * US)


def _request(first_id, start, end, slices, children):
    root = _span("predict_mask", first_id, start, end, slices=slices, fusion="max")
    return [root] + [_span(n, first_id + 1 + i, s, e, root)
                     for i, (n, s, e) in enumerate(children)]


# two requests in the window, one root before it and one after it (the
# shapes profile's), each µs
SPANS = (_request(1, -3000, -2000, 50, [("predict.encode", -2900, -2100)])
         + _request(10, 0, 1000, 4, [("predict.inputs", 10, 100), ("predict.encode", 100, 600),
                                     ("predict.fuse", 600, 700), ("predict.segment", 700, 900)])
         + _request(20, 2000, 2500, 6, [("predict.encode", 2000, 2400)])
         + _request(30, 5000, 6000, 50, [("predict.encode", 5000, 5900)]))
# (runtime call's start µs, correlation, device start µs, device end µs)
LAUNCHES = [(20, 1, 30, 90),        # inputs: the host-to-device copy
            (150, 2, 150, 500),     # encode
            (300, 3, 500, 800),     # encode, run on into fuse's and segment's time
            (650, 4, 800, 850),     # fuse
            (905, 5, 850, 870),     # predict_mask's own time, after segment closed
            (750, 6, 870, 1100),    # segment
            (1200, 7, 1200, 1500),  # the client's copy of the mask
            (2100, 8, 2100, 2300)]  # the second request's encode
UNMATCHED = ("Memset", 1500 * US, 1520 * US, 99)
WINDOW_S = 4000e-6


def _trace():
    t = Trace.__new__(Trace)
    t.window_s, t.spans, t.ops = WINDOW_S, Spans(False), []
    t.device = sorted([("k%d" % c, s * US, e * US, c) for _, c, s, e in LAUNCHES] + [UNMATCHED],
                      key=lambda d: d[1])
    t.runtime = sorted((call * US, 1, c) for call, c, _, _ in LAUNCHES)
    t._busy = t._merged()
    return t


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: list(SPANS))


def test_window_spans_drop_the_roots_outside_the_window(recorded):
    kept = program_spans.window_spans(_trace())
    assert sorted({s.request_id for s in kept}) == [10, 20]
    assert len(kept) == 7


def test_attribution_by_innermost_span(recorded):
    trace = _trace()
    a = program_spans.attribute(trace, program_spans.window_spans(trace))
    us = {k: round(v * 1e6, 6) for k, v in a.device_s.items()}
    assert us == {"predict.inputs": 60, "predict.encode": 350 + 300 + 200, "predict.fuse": 50,
                  "predict_mask": 20, "predict.segment": 230, program_spans.CLIENT: 300,
                  program_spans.UNATTRIBUTED: 20}
    assert a.ops["predict.encode"] == {"k2": pytest.approx(350e-6), "k3": pytest.approx(300e-6),
                                       "k8": pytest.approx(200e-6)}
    assert a.slices == 10
    # idle inside the roots: [0, 30) and [90, 150) of the first, all but
    # [2100, 2300) of the second
    assert a.root_s == pytest.approx(1500e-6) and a.root_idle_s == pytest.approx(390e-6)
    idle = {k: round(v * 1e6, 6) for k, v in a.idle_s.items() if v}
    assert idle == {"predict.inputs": 30, "predict.encode": 50 + 200, "predict_mask": 10 + 100,
                    program_spans.CLIENT: 4000 - 1530 - 390}


def test_readers(recorded):
    ctx = types.SimpleNamespace(trace=_trace())
    read = {m: common.reader(m)(ctx) for m in ("predict_idle_share.infer",
                                                "encode_device_ms.infer", "fuse_device_ms.infer",
                                                "segment_device_ms.infer")}
    assert read == {"predict_idle_share.infer": pytest.approx(100 * 390 / 1500),
                    "encode_device_ms.infer": pytest.approx(0.850 / 10),
                    "fuse_device_ms.infer": pytest.approx(0.050 / 10),
                    "segment_device_ms.infer": pytest.approx(0.230 / 10)}


@pytest.mark.parametrize("case", ["no trace", "no device activity", "no spans",
                                  "no tracing module"])
def test_nothing_to_read(monkeypatch, case):
    trace = _trace()
    spans = SPANS
    if case == "no trace":
        trace = None
    elif case == "no device activity":
        trace.device = []
    elif case == "no spans":
        spans = []
    else:
        # a program without utils/tracing.py: the import fails
        monkeypatch.setitem(sys.modules, "multimodal_segmentation_torch.utils.tracing", None)
        monkeypatch.delattr(multimodal_segmentation_torch.utils, "tracing")
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    ctx = types.SimpleNamespace(trace=trace)
    assert program_spans.window_spans(trace) is None
    assert program_spans.idle_share(ctx) is None
    assert program_spans.device_ms_per_slice(ctx, "predict.encode") is None
