"""The infer3d kind (harness/infer3d.py) at the CPU cut of
unet3d-infer-volumes, in float32: a sound run reads the reference to
round-off; the control (the reference in fp8 against it) and each fault
planted under the timed path (a stitch shifted by one tile, a mirrored
axis) come out as not correct under the cell's own limits; the volume
numbers see a moved block and nothing else."""

import time
import types

import pytest
import torch

from benchmark.harness import check, common, infer3d
from benchmark.harness.trace import Spans, Trace
from benchmark.tests import tiny
from multimodal_segmentation_torch.utils import tracing

CELL = "unet3d-infer-volumes"


def test_sound_run_reads_the_reference():
    torch.set_num_threads(1)
    _, _, workload, config = tiny.cell(CELL)
    res = infer3d.run(tiny.SEED, 0.5, False, workload, config, time.perf_counter(), tiny.CPU)
    assert res.correct and res.failed == 0 and res.attempted > 0
    # every volume of the cut takes 2 x 2 x 2 output tiles: the run's units
    assert res.slices == 8 * res.attempted
    assert res.numbers["mask_mismatch"] == 0.0
    assert res.numbers["region_gap"] < 1e-5 and res.numbers["volume_gap"] < 1e-5


def test_control_is_not_correct():
    torch.set_num_threads(1)
    _, _, workload, config = tiny.cell(CELL)
    nums, where = infer3d.reading("control", tiny.SEED, 0, workload, config, tiny.CPU)
    assert len(where["volumes"]) == 2
    assert not check.verdict(nums, workload["checks"])[0], nums


@pytest.mark.parametrize("fault", sorted(infer3d.FAULTS))
def test_fault_is_not_correct(fault):
    torch.set_num_threads(1)
    _, _, workload, config = tiny.cell(CELL)
    res = infer3d.run(tiny.SEED, 0.5, False, workload, config, time.perf_counter(), tiny.CPU,
                      wrap_predict=infer3d.FAULTS[fault])
    assert res.correct is False, res.numbers
    assert res.numbers["region_gap"] > 100 * workload["checks"]["region_gap"], res.numbers


def test_volume_numbers():
    g = torch.Generator().manual_seed(0)
    ref = torch.softmax(torch.randn(1, 9, 17, 12, 3, generator=g), -1)
    same = infer3d.volume_numbers([ref.clone()], [ref])
    assert same == {"mask_mismatch": 0.0, "volume_gap": 0.0, "region_gap": 0.0}
    # one voxel's mass moved to a voxel in another block: the volumes keep
    moved = ref.clone()
    moved[0, 0, 0, 0], moved[0, 8, 16, 11] = ref[0, 8, 16, 11], ref[0, 0, 0, 0]
    nums = infer3d.volume_numbers([moved], [ref])
    assert nums["volume_gap"] < 1e-12 < nums["region_gap"]
    assert infer3d.volume_numbers([], [])["volume_gap"] == float("inf")


US = 1000  # ns


def test_device_ms_per_tile(monkeypatch):
    """net3d_ and tiling_device_ms.infer3d on a hand-made window of one
    volume of 32 tiles: device time by innermost span, over the run's
    tiles; nothing to read without the program's spans or tiles."""
    def span(name, span_id, start, end, parent=None):
        attrs = {"slices": 60, "tiles": 32} if parent is None else {}
        return tracing.Span(name, span_id, parent and parent.span_id, 1, attrs,
                            start * US, end * US)

    root = span("predict_volume", 1, 0, 1000)
    spans = [root, span("predict3d.inputs", 2, 0, 100, root),
             span("predict3d.tiles", 3, 100, 200, root), span("predict3d.net", 4, 200, 800, root),
             span("predict3d.stitch", 5, 800, 900, root)]
    # (runtime call µs, device start µs, device end µs)
    launches = [(10, 10, 90), (150, 150, 190), (300, 300, 940), (850, 940, 960)]
    trace = Trace.__new__(Trace)
    trace.window_s, trace.spans, trace.ops = 1e-3, Spans(False), []
    trace.device = [("k%d" % c, s * US, e * US, c) for c, (_, s, e) in enumerate(launches)]
    trace.runtime = [(t * US, 1, c) for c, (t, _, _) in enumerate(launches)]
    trace._busy = trace._merged()
    metrics = {name: common.reader(name) for name in
               ("net3d_device_ms.infer3d", "tiling_device_ms.infer3d")}
    ctx = types.SimpleNamespace(trace=trace, slices=32)
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    assert metrics["net3d_device_ms.infer3d"](ctx) == pytest.approx(0.640 / 32)
    assert metrics["tiling_device_ms.infer3d"](ctx) == pytest.approx((0.080 + 0.040 + 0.020) / 32)
    assert metrics["net3d_device_ms.infer3d"](types.SimpleNamespace(trace=trace, slices=0)) is None
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert all(read(ctx) is None for read in metrics.values())
