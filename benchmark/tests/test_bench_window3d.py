"""The window3d kind (harness/window3d.py) at the CPU cut of
swin-unetr-infer-brats, in float32: the control (the reference in fp8
against it) and each fault planted under the timed path (a stitch shifted
by one window stride, a mirrored axis, and in the window attention the
bias's h and w offsets swapped, the shift mask dropped, the roll's sign
flipped) come out as not correct under the cell's own limits; the Swin
UNETR readers on a hand-made window. The sound run is
tests/test_torch_swin_unetr.py's."""

import time
import types

import pytest
import torch

from benchmark.flops import peaks, swin_attention
from benchmark.harness import check, common, window3d
from benchmark.harness.trace import Spans, Trace
from benchmark.tests import tiny
from multimodal_segmentation_torch import config
from multimodal_segmentation_torch.utils import tracing

CELL = "swin-unetr-infer-brats"


def test_control_is_not_correct():
    torch.set_num_threads(1)
    _, _, workload, cfg = tiny.cell(CELL)
    nums, where = window3d.reading("control", tiny.SEED, 0, workload, cfg, tiny.CPU)
    assert len(where["studies"]) == 1
    assert not check.verdict(nums, workload["checks"])[0], nums


@pytest.mark.parametrize("fault", sorted(window3d.FAULTS))
def test_fault_is_not_correct(fault):
    """Each fault reads region_gap far above the cut's limit: a stitch
    fault over 100 times it; one in the attention, which moves the outputs
    less (0.005-0.02 at the cut, with the maker's peaked attention), over
    10 times it."""
    torch.set_num_threads(1)
    _, _, workload, cfg = tiny.cell(CELL)
    res = window3d.run(tiny.SEED, 0.5, False, workload, cfg, time.perf_counter(), tiny.CPU,
                       wrap_predict=window3d.FAULTS[fault])
    margin = 100 if fault in ("shifted", "mirrored") else 10
    assert res.correct is False, res.numbers
    assert res.numbers["region_gap"] > margin * workload["checks"]["region_gap"], res.numbers


def test_attention_least_time_of_the_published_window():
    """Stage 1 of a 128^3 window: 64^3 tokens padded to 70^3, 48 channels,
    7^3 windows; its FLOPs (qkv, q k^T, p v, proj) bound it, not its bytes.
    Stage 4 runs at 8^3 tokens padded to 14^3; a stage of 4^3 tokens takes
    its size as the window, unpadded."""
    least, flops, moved = swin_attention.block_least_s([64, 64, 64], 48)
    tokens = 70 ** 3
    assert flops == 2 * tokens * 4 * 48 * 48 + 4 * tokens * 343 * 48
    assert moved == 2 * 64 ** 3 * 48 * 2
    assert least == flops / peaks.BF16_FLOPS > moved / peaks.HBM_BYTES_PER_S
    _, flops4, _ = swin_attention.block_least_s([8, 8, 8], 384)
    assert flops4 == 2 * 14 ** 3 * 4 * 384 * 384 + 4 * 14 ** 3 * 343 * 384
    # a 4^3 stage takes its size as the window, unpadded
    _, small, _ = swin_attention.block_least_s([4, 4, 4], 8)
    assert small == 2 * 64 * 4 * 64 + 4 * 64 * 64 * 8
    conf = config.swin_unetr_brats()
    total = sum(2 * swin_attention.block_least_s([64 // 2 ** i] * 3, 48 * 2 ** i)[0]
                for i in range(4))
    assert swin_attention.least_s_per_window(conf) == pytest.approx(total)


US = 1000  # ns


def test_swin_readers(monkeypatch):
    """The four Swin UNETR readers on a hand-made window of one study of 4
    windows: device time by innermost span (attention and resblock inside
    net), over the windows; the roofline share the windows' least time
    over the attention spans' device time; nothing to read without the
    program's spans."""
    def span(name, span_id, start, end, parent=None):
        attrs = {"slices": 155, "windows": 4} if parent is None else {}
        return tracing.Span(name, span_id, parent and parent.span_id, 1, attrs,
                            start * US, end * US)

    root = span("predict_volume", 1, 0, 1000)
    net = span("predict3d.net", 3, 100, 900, root)
    spans = [root, span("predict3d.inputs", 2, 0, 100, root), net,
             span("predict3d.attention", 4, 200, 300, net),
             span("predict3d.resblock", 5, 400, 600, net),
             span("predict3d.stitch", 6, 900, 1000, root)]
    # (runtime call µs, device start µs, device end µs)
    launches = [(10, 10, 90), (150, 150, 190), (250, 250, 330), (450, 450, 650),
                (950, 950, 960)]
    trace = Trace.__new__(Trace)
    trace.window_s, trace.spans, trace.ops = 1e-3, Spans(False), []
    trace.device = [("k%d" % c, s * US, e * US, c) for c, (_, s, e) in enumerate(launches)]
    trace.runtime = [(t * US, 1, c) for c, (t, _, _) in enumerate(launches)]
    trace._busy = trace._merged()
    names = ("swin_net_device_ms.window3d", "swin_attention_device_ms.window3d",
             "resblock_device_ms.window3d", "swin_attention_roofline.window3d",
             "tiling_device_ms.infer3d")
    read = {name: common.reader(name) for name in names}
    conf = config.swin_unetr_brats()
    ctx = types.SimpleNamespace(trace=trace, slices=4, model_conf=conf)
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    assert read["swin_net_device_ms.window3d"](ctx) == pytest.approx((0.040 + 0.080 + 0.200) / 4)
    assert read["swin_attention_device_ms.window3d"](ctx) == pytest.approx(0.080 / 4)
    assert read["resblock_device_ms.window3d"](ctx) == pytest.approx(0.200 / 4)
    assert read["tiling_device_ms.infer3d"](ctx) == pytest.approx((0.080 + 0.010) / 4)
    assert read["swin_attention_roofline.window3d"](ctx) == pytest.approx(
        100 * swin_attention.least_s_per_window(conf) * 4 / 80e-6)
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert all(r(ctx) is None for r in read.values())
