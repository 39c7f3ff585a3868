"""The port's span recorder (multimodal_segmentation_torch/utils/tracing.py)
and the spans of `MaskPredictor.predict_mask`, on the CPU: nothing is
recorded and no clock is read without a profiler; under one, the root span
and its children carry ids, parent links and attributes, appear in the
profile as user annotations, and share the profiler's clock; the masks do
not change by a bit."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_segmentation_torch.config import tiny_test_config
from multimodal_segmentation_torch.models import build_model
from multimodal_segmentation_torch.utils import tracing

CHILDREN = {
    "max": ["predict.inputs", "predict.encode", "predict.fuse", "predict.segment"],
    "simple": ["predict.inputs", "predict.encode", "predict.segment"],
}


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(1)
    return build_model(tiny_test_config(), device="cpu")


def _images(n=3, seed=0):
    r = np.random.RandomState(seed)
    return [r.rand(n, 32, 32, 1).astype(np.float32) for _ in range(2)]


@contextlib.contextmanager
def _profiled():
    tracing.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def test_no_profiler_records_nothing_and_reads_no_clock(model, monkeypatch):
    tracing.clear()

    def no_clock():
        raise AssertionError("a span read the clock with no profiler running")

    monkeypatch.setattr(tracing.time, "time_ns", no_clock)
    assert tracing.span("predict.encode") is tracing.span("x", a=1) is tracing._NOOP
    model.predict_mask(1, "max", _images(), device="cpu")
    assert tracing.spans() == []


@pytest.mark.parametrize("fusion", sorted(CHILDREN))
def test_predict_mask_records_its_root_and_children(model, fusion):
    with _profiled():
        model.predict_mask(1, fusion, _images(n=3), device="cpu")
    root, *children = tracing.spans()
    assert root.name == "predict_mask" and root.parent_id is None
    assert root.request_id == root.span_id
    assert root.attrs == {"slices": 3, "fusion": fusion}
    assert [c.name for c in children] == CHILDREN[fusion]
    assert all(c.parent_id == root.span_id and c.request_id == root.request_id
               for c in children)
    assert all(c.attrs == {} for c in children)
    bounds = [root.start_ns] + [t for c in children for t in (c.start_ns, c.end_ns)] + \
        [root.end_ns]
    assert bounds == sorted(bounds)


def test_two_calls_two_requests(model):
    with _profiled():
        for _ in range(2):
            model.predict_mask(0, "max", _images(n=2), device="cpu")
    spans = tracing.spans()
    roots = [s for s in spans if s.parent_id is None]
    assert len(spans) == 10 and len(roots) == 2
    assert roots[0].request_id != roots[1].request_id
    for r in roots:
        assert sum(s.request_id == r.request_id for s in spans) == 5


def test_spans_are_user_annotations_of_the_profile(model):
    with _profiled() as prof:
        model.predict_mask(1, "max", _images(), device="cpu")
    annotations = [e.name() for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()]
    assert sorted(set(annotations)) == sorted(["predict_mask"] + CHILDREN["max"])


def test_span_clock_is_the_profilers():
    a = torch.randn(256, 256)
    with _profiled() as prof:
        for _ in range(3):
            with tracing.span("mm"):
                torch.mm(a, a)
    mms = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    spans = tracing.spans()
    assert len(mms) == len(spans) == 3
    for e, s in zip(sorted(mms, key=lambda e: e.start_ns()), spans):
        assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns


@pytest.mark.parametrize("fusion", sorted(CHILDREN))
def test_masks_bit_identical_under_a_profiler(model, fusion):
    images = _images(n=4, seed=3)
    plain = model.predict_mask(1, fusion, images, device="cpu")
    with _profiled():
        traced = model.predict_mask(1, fusion, images, device="cpu")
    assert len(tracing.spans()) == 1 + len(CHILDREN[fusion])
    assert torch.equal(plain, traced)
