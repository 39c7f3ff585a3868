"""Swin UNETR (arXiv:2201.01266) in the port, on the CPU:
nn/swin_unetr.py::SwinUNETR and its sliding-window inference through
models/volumetric.py::Cardiac3DSegmenter (conf.model == "swin_unetr").

The JAX package has no such model, so the reference is the benchmark's
plain one (benchmark/reference/swin_unetr.py, its own net and sliding
window). The CPU cut is feature size 12 and 64^3 windows: the stages run
at 32, 16, 8 and 4 tokens a axis, so three of them pad to a multiple of
the 7^3 window and roll, and the last takes a 4^3 window and no roll
(MONAI's rule); a 32^3 window would leave x4 at 1^3, where InstanceNorm
has a single voxel. Weights come from the benchmark's seeded maker
(benchmark/traffic/swin_weights.py: MONAI's draws but for the attention,
drawn peaked, as MONAI's 0.02 leaves every window's attention nearly
uniform); the float32 comparison of the whole net also takes MONAI's
draws throughout, and those with every linear map 20 times larger. The
published widths are checked on meta tensors."""

import dataclasses
import itertools
import time
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import window3d
from benchmark.reference import swin_unetr as reference
from benchmark.reference.precision import set_precision
from benchmark.tests import tiny
from benchmark.traffic import swin_weights, volumes
from multimodal_segmentation_torch import config
from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter, window_starts
from multimodal_segmentation_torch.nn import swin_unetr, unet3d
from multimodal_segmentation_torch.nn.swin_unetr import SwinUNETR
from multimodal_segmentation_torch.ops import thin_conv
from multimodal_segmentation_torch.utils import tracing

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _conf(**kw):
    return dataclasses.replace(config.swin_unetr_brats(), volume_shape=(64, 64, 64, 4),
                               filters3d=12, batch_size=2, compute_dtype="float32", **kw)


def _ns(conf):
    return types.SimpleNamespace(**dataclasses.asdict(conf))


_STATES = {}


def _state(seed, scale=None):
    """The maker's weights of the cut; with `scale`, MONAI's draws (the
    program's SwinUNETR.init_, the attention's too) with every linear map
    and bias table times `scale`."""
    if scale is not None:
        net = SwinUNETR(4, 3, 12).init_(torch.Generator().manual_seed(seed))
        return {k: v * scale if v.dim() == 2 else v for k, v in net.state_dict().items()}
    if seed not in _STATES:
        traffic = {"depths": [64, 64], "hw": [66, 66], "blobs": 4}
        _STATES[seed] = swin_weights.make_weights(reference.MODEL, _ns(_conf()), traffic, seed,
                                                  CPU)
    return {k: v.clone() for k, v in _STATES[seed].items()}


def _study(size, seed):
    g = torch.Generator().manual_seed(seed)
    return volumes.render(tuple(size), 4, 4, g, CPU).numpy()[None]


def _program(conf, state, **kw):
    seg = Cardiac3DSegmenter(dataclasses.replace(conf, **kw), device="cpu")
    return seg, seg.init(state_dict=state)[0]


def _reference(conf, state, precision):
    model = reference.MODEL(_ns(conf))
    model.load_state_dict(state)
    return set_precision(model, precision).eval()


def test_published_widths_on_meta():
    """62,191,941 parameters (the paper's ~62 M), 8,063,154 of them in the
    Swin encoder; the hidden states at 64^3 x 48, 32^3 x 96, 16^3 x 192,
    8^3 x 384 and 4^3 x 768 of a 128^3 window; the port's and the
    reference's state_dicts have the same keys and shapes, which are
    MONAI's names."""
    conf = config.swin_unetr_brats()
    with torch.device("meta"):
        net = SwinUNETR(in_channels=4, out_channels=3, feature_size=48)
        ref = reference.MODEL(_ns(conf))
        x = torch.zeros(1, 4, 128, 128, 128)
        hidden = net.swinViT(x, torch.bfloat16)
        out = ref(x)
    assert sum(p.numel() for p in net.parameters()) == 62_191_941
    assert sum(p.numel() for n, p in net.named_parameters() if n.startswith("swinViT")) == 8_063_154
    assert [tuple(h.shape) for h in hidden] == [(1, 48 * 2 ** i, 64 // 2 ** i, 64 // 2 ** i,
                                                 64 // 2 ** i) for i in range(5)]
    assert tuple(out.shape) == (1, 3, 128, 128, 128)
    keys = {k: v.shape for k, v in net.state_dict().items()}
    assert keys == {k: v.shape for k, v in ref.state_dict().items()}
    for k in ("swinViT.layers1.0.blocks.1.attn.relative_position_bias_table",
              "swinViT.layers4.0.downsample.reduction.weight", "encoder1.layer.conv3.conv.weight",
              "decoder5.transp_conv.conv.weight", "out.conv.conv.bias"):
        assert k in keys
    assert keys["swinViT.layers1.0.blocks.0.attn.relative_position_bias_table"] == (13 ** 3, 3)
    assert keys["swinViT.patch_embed.proj.weight"] == (48, 4, 2, 2, 2)


def test_init_builds_the_published_net_in_eval_mode():
    seg = Cardiac3DSegmenter(config.swin_unetr_brats(), device="cpu")
    net, opt = seg.init(0)
    assert isinstance(net, SwinUNETR) and opt is None and not net.training
    assert seg.dtype == net.dtype == torch.bfloat16 and config.SWIN_UNETR_OVERLAP == 0.5
    assert net.out_channels == 3 and net.decoder1.conv_block.conv1.conv.out_channels == 48
    assert all(p.dtype == torch.float32 for p in net.state_dict().values())
    table = net.swinViT.layers2[0].blocks[0].attn.relative_position_bias_table
    assert 0.015 < table.std().item() < 0.025


@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_net_matches_the_reference_in_float32(scale):
    """Two 64^3 windows through the port's net and the reference's, in
    float32: the sigmoid probabilities within 1e-5 relative / 1e-4
    absolute (the two sum convolutions, norms and attention in other
    orders, and InstanceNorm over the last stage's 2^3 voxels magnifies
    float32's round-off: 5e-5 of a logit at most here), with MONAI's
    weights and with every linear map 20 times larger (the maker's own
    draw is the other tests')."""
    conf = _conf()
    state = _state(3, scale)
    _, net = _program(conf, state)
    x = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (2, 4, 64, 64, 64))
                         .astype(np.float32))
    with torch.no_grad():
        got = torch.sigmoid(net(x))
        ref = torch.sigmoid(_reference(conf, state, "float32")(x))
    assert got.shape == (2, 3, 64, 64, 64) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)


def _per_window_attention(block, x, shifted):
    """A Swin block's attention half by a loop over windows, in float64:
    each window's tokens gathered from the padded, rolled grid by index,
    the bias read at each token pair's offsets, the mask from each
    token's shift region (0 up to 7 before the padded axis's end, 1 up to
    3 before it, 2 after)."""
    b, d, h, w, c = x.shape
    ws, shift = swin_unetr.window_and_shift((d, h, w))
    roll = shifted and any(shift)
    dims = [-(-s // n) * n for s, n in zip((d, h, w), ws)]
    y = torch.zeros(b, *dims, c, dtype=torch.float64)
    y[:, :d, :h, :w] = F.layer_norm(x.double(), (c,), block.norm1.weight.double(),
                                    block.norm1.bias.double(), 1e-5)
    attn = block.attn
    heads, hd = attn.heads, c // attn.heads
    wq, bq = attn.qkv.weight.double(), attn.qkv.bias.double()
    wp, bp = attn.proj.weight.double(), attn.proj.bias.double()
    table = attn.relative_position_bias_table.double()
    out = torch.zeros_like(y)
    size = torch.tensor(dims)
    for corner in itertools.product(*[range(0, n, s) for n, s in zip(dims, ws)]):
        # the window's tokens on the rolled grid, and where each lies on
        # the padded grid: the rolled grid's p is the padded grid's p + 3
        tokens = torch.tensor(list(itertools.product(
            *[range(o, o + s) for o, s in zip(corner, ws)])))
        src = (tokens + (torch.tensor(shift) if roll else 0)) % size
        rel = tokens[:, None] - tokens[None, :] + 6
        bias = table[rel[..., 0] * 169 + rel[..., 1] * 13 + rel[..., 2]].permute(2, 0, 1)
        if roll:
            region = (tokens >= size - 7).long() + (tokens >= size - 3).long()
            bias = bias + (region[:, None] != region[None, :]).any(-1) * -100.0
        for bi in range(b):
            v = y[bi, src[:, 0], src[:, 1], src[:, 2]]
            q, k, val = (v @ wq.T + bq).view(-1, 3, heads, hd).permute(1, 2, 0, 3)
            o = torch.softmax((q * hd ** -0.5) @ k.transpose(-2, -1) + bias, -1) @ val
            out[bi, src[:, 0], src[:, 1], src[:, 2]] = o.transpose(0, 1).reshape(-1, c) @ wp.T + bp
    return out[:, :d, :h, :w]


@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_matches_a_per_window_loop(shifted):
    """The attention half of a Swin block (LN1, zero padding to a multiple
    of 7, the roll, the windows, the bias, the mask, the projection, the
    windows, roll and padding undone) on (1, 9, 8, 10) tokens of 6
    channels in 2 heads, against a loop over the windows in float64 that
    gathers each window's tokens by index: within 1e-5 in float32."""
    torch.manual_seed(0)
    block = swin_unetr.SwinTransformerBlock(6, 2, shifted)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape) * (1.0 if p.dim() == 2 else 0.3))
    x = torch.randn(1, 9, 8, 10, 6)
    mask = None
    if shifted:
        mask = swin_unetr.shift_mask((14, 14, 14), (7, 7, 7), (3, 3, 3), CPU)
    with torch.no_grad():
        y = swin_unetr._layer_norm(x, block.norm1, torch.float32)
        y = F.pad(y, (0, 0, 0, 4, 0, 6, 0, 5))
        if shifted:
            y = torch.roll(y, (-3, -3, -3), (1, 2, 3))
        a = block.attn(swin_unetr.partition(y, (7, 7, 7)), mask, torch.float32)
        a = swin_unetr.reverse(a, (7, 7, 7), (1, 14, 14, 14))
        if shifted:
            a = torch.roll(a, (3, 3, 3), (1, 2, 3))
        got = a[:, :9, :8, :10]
        full = block(x, mask, torch.float32)
    want = _per_window_attention(block, x, shifted)
    assert (got.double() - want).abs().max().item() <= 1e-5
    # the block is x + that, then x + MLP(LN2(x))
    mid = x + got
    mlp = block.mlp(F.layer_norm(mid, (6,), block.norm2.weight, block.norm2.bias, 1e-5),
                    torch.float32)
    torch.testing.assert_close(full, mid + mlp, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size, roi, overlap, want", [
    ([240, 240, 155], [128, 128, 128], 0.5, [[0, 64, 112], [0, 64, 112], [0, 27]]),
    ([128, 200, 129], [128, 128, 128], 0.5, [[0], [0, 64, 72], [0, 1]]),
    ([64, 67, 70], [64, 64, 64], 0.5, [[0], [0, 3], [0, 6]]),
    ([240, 100, 64], [128, 64, 64], 0.25, [[0, 96, 112], [0, 36], [0]]),
])
def test_window_starts_are_monais(size, roi, overlap, want):
    """240 -> 0, 64, 112 and 155 -> 0, 27 at the published 128^3 and
    overlap 0.5 (18 windows a BraTS study); an axis as long as the roi
    takes one window; the last window of an axis ends flush with it. The
    program's rule and the reference's agree."""
    assert window_starts(size, roi, overlap) == want
    assert reference.window_starts(size, roi, overlap) == want


class _Stub(torch.nn.Module):
    """A net whose logits are its input's first three channels plus the
    index of the window in its batch times 10, and a counter of windows."""

    out_channels = 3

    def __init__(self):
        super().__init__()
        self.seen = []

    def forward(self, x):
        self.seen.append(x.shape[0])
        return x[:, :3].float() + 10.0 * torch.arange(x.shape[0]).view(-1, 1, 1, 1, 1)


@pytest.mark.parametrize("size", [(70, 67, 64), (40, 66, 80)])
def test_sliding_window_average_is_constant_mode(size):
    """predict through a stub net on a study of `size` (the second shorter
    than the 64^3 window along D, so zero-padded around the study first,
    as MONAI pads it): the sigmoid of each voxel's logits averaged over
    the windows that cover it, against a loop over MONAI's windows in
    float64, within 1e-6; batches of 2 windows."""
    conf = _conf()
    seg = Cardiac3DSegmenter(conf, device="cpu")
    stub = _Stub()
    v = _study(size, 5)
    got = seg.predict(stub, v)[0].double()
    x = torch.from_numpy(v[0]).double().permute(3, 0, 1, 2)
    grown = [max(s, 64) for s in size]
    before = [(g - s) // 2 for g, s in zip(grown, size)]
    x = F.pad(x, [p for g, s, b in reversed(list(zip(grown, size, before)))
                  for p in (b, g - s - b)])
    total = torch.zeros(3, *grown, dtype=torch.float64)
    count = torch.zeros(grown, dtype=torch.float64)
    corners = list(itertools.product(*window_starts(grown, (64, 64, 64), 0.5)))
    for n, (d, h, w) in enumerate(corners):
        total[:, d:d + 64, h:h + 64, w:w + 64] += x[:3, d:d + 64, h:h + 64, w:w + 64] + 10.0 * (
            n % 2)
        count[d:d + 64, h:h + 64, w:w + 64] += 1
    want = torch.sigmoid(total / count)[:, before[0]:before[0] + size[0],
                                        before[1]:before[1] + size[1],
                                        before[2]:before[2] + size[2]].permute(1, 2, 3, 0)
    assert got.shape == (*size, 3)
    assert (got - want).abs().max().item() <= 1e-6
    assert stub.seen == [2] * (len(corners) // 2) + [1] * (len(corners) % 2)


def test_predict_matches_the_reference_sliding_window():
    """A (64, 67, 70) study, 1 x 2 x 2 windows in batches of 2, by the
    port's predict and by the reference's own sliding window: within 1e-5
    relative / 1e-4 absolute in float32."""
    conf = _conf()
    state = _state(4)
    seg, net = _program(conf, state)
    v = _study((64, 67, 70), 6)
    got = seg.predict(net, v)
    assert got.shape == (1, 64, 67, 70, 3) and got.dtype == torch.float32
    ref = reference.predict_volume(_reference(conf, state, "float32"), v[0], 2, CPU, 0.5)
    torch.testing.assert_close(got[0], torch.from_numpy(ref), rtol=1e-5, atol=1e-4)


def test_net_in_bf16_is_held_to_the_references_rounding():
    """Two 64^3 windows through the port's net in bf16, against the float32
    reference: the mean absolute gap of the probabilities is of the size
    that the reference rounding at bf16 has (between a quarter and twice
    it: the two round at other points), and under half of the reference's
    at fp8, so a program computing in fp8 would fail it."""
    conf = _conf()
    state = _state(7)
    _, net = _program(conf, state, compute_dtype="bfloat16")
    x = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (2, 4, 64, 64, 64))
                         .astype(np.float32))
    with torch.no_grad():
        got = torch.sigmoid(net(x.bfloat16()))
        ref32, ref16, ref8 = (torch.sigmoid(_reference(conf, state, p)(x))
                              for p in ("float32", "bfloat16", "fp8"))
    program_gap = (got - ref32).abs().mean().item()
    rounding = (ref16 - ref32).abs().mean().item()
    assert got.dtype == torch.float32
    assert 0.25 * rounding <= program_gap <= 2.0 * rounding, (program_gap, rounding)
    assert program_gap < 0.5 * (ref8 - ref32).abs().mean().item()


def test_predict_spans_and_their_attributes():
    """Under a profiler predict records one `predict_volume` a study
    (slices = D, windows) with its children in order: the inputs, then a
    batch's tiles, net and stitch, then the average's stitch; inside each
    net span 8 `predict3d.attention` spans (one a Swin block) and 10
    `predict3d.resblock` spans a window; without a profiler, nothing; the
    probabilities are the same bit for bit."""
    conf = _conf()
    seg, net = _program(conf, _state(3), batch_size=1)
    v = _study((64, 64, 67), 8)
    tracing.clear()
    plain = seg.predict(net, v)
    assert tracing.spans() == []
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        traced = seg.predict(net, v)
    finally:
        prof.stop()
    assert torch.equal(plain, traced)
    spans = tracing.spans()
    root = [s for s in spans if s.parent_id is None]
    assert [(s.name, s.attrs) for s in root] == [("predict_volume", {"slices": 64, "windows": 2})]
    by_id = {s.span_id: s for s in spans}
    children = sorted((s for s in spans if s.parent_id == root[0].span_id),
                      key=lambda s: s.start_ns)
    assert [s.name for s in children] == ["predict3d.inputs"] + [
        "predict3d.tiles", "predict3d.net", "predict3d.stitch"] * 2 + ["predict3d.stitch"]
    nets = [s for s in children if s.name == "predict3d.net"]
    for n in nets:
        inner = [s for s in spans if s.parent_id == n.span_id]
        assert sorted(s.name for s in inner) == ["predict3d.attention"] * 8 + [
            "predict3d.resblock"] * 10
        assert all(n.start_ns <= s.start_ns <= s.end_ns <= n.end_ns for s in inner)
    assert all(by_id[s.request_id] is root[0] for s in spans)
    tracing.clear()


def test_step_refuses_the_net():
    seg, net = _program(_conf(), _state(3))
    v = _study((64, 64, 64), 9)
    with pytest.raises(NotImplementedError, match="served by predict"):
        seg.step(net, None, torch.from_numpy(v), torch.zeros(v.shape[:4] + (3,)))


def test_first_convolution_takes_the_thin_path(monkeypatch):
    """Deciding as on the card in bf16 (the kernel's plain version in its
    place), enc0's first convolution, of the 4-channel window, runs once a
    window as the thin-input convolution of the window zero-padded by one
    voxel, into 48 channels at the published width (meta tensors) and 12
    at the cut, and equals the 'same' convolution within float32's
    round-off; no other convolution takes it."""
    calls = []

    def counted(x, weight):
        calls.append((tuple(x.shape), weight.shape[0]))
        return thin_conv.thin_conv3d(x, weight)

    monkeypatch.setattr(unet3d, "_thin_input", lambda x, dt: (
        x.shape[1] <= thin_conv.MAX_CHANNELS and x.shape[-1] % 2 == 0))
    monkeypatch.setattr(unet3d, "thin_conv3d", counted)
    with torch.device("meta"), torch.no_grad():
        SwinUNETR(4, 3, 48)(torch.zeros(2, 4, 64, 64, 64))
    assert calls == [((1, 4, 66, 66, 66), 48)] * 2
    calls.clear()
    conv = SwinUNETR(4, 3, 12).encoder1.layer.conv1.conv
    torch.nn.init.normal_(conv.weight, 0.0, 0.2)
    x = torch.randn(1, 4, 10, 12, 14)
    got = conv(x)
    assert calls == [((1, 4, 12, 14, 16), 12)]
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    torch.testing.assert_close(got, F.conv3d(x, conv.weight, padding=1), rtol=0, atol=1e-5)


def test_tiny_cell_sound_run_reads_the_reference():
    """The window3d harness at the CPU cut of swin-unetr-infer-brats
    (TINY_TRAFFIC, TINY_CHECKS), in float32: the run is correct, every
    study takes 1 x 2 x 2 windows (the run's units), and the checks read
    the reference to round-off; the outputs' argmax differs only at ties
    within round-off (3 voxels of 295,680 on one thread, where the
    reference's top two outputs lie within 5.1e-7 of each other)."""
    _, _, workload, cfg = tiny.cell("swin-unetr-infer-brats")
    res = window3d.run(tiny.SEED, 0.5, False, workload, cfg, time.perf_counter(), tiny.CPU)
    assert res.correct and res.failed == 0 and res.attempted > 0
    assert res.slices == 4 * res.attempted
    assert res.numbers["mask_mismatch"] < 1e-4
    assert res.numbers["region_gap"] < 1e-5 and res.numbers["volume_gap"] < 1e-5
