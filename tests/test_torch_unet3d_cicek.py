"""The 3D U-Net of Cicek et al. (arXiv:1606.06650) in the port, on the CPU:
nn/unet3d.py::UNet3DCicek and its overlap-tile inference through
models/volumetric.py::Cardiac3DSegmenter (conf.model == "unet3d").

The JAX package has no such model, so the reference is the benchmark's
plain one (benchmark/reference/unet3d.py, its own net and overlap-tile).
The CPU cut keeps the published depth (3 poolings) at base width 4, whose
input tile of 92^3 gives a 4^3 output tile. Weights come from the
benchmark's seeded maker (benchmark/traffic/volumes.py), whose BatchNorm
statistics are those of a tile of a volume of the size served. Volumes
keep every axis's mirror period, 2 (n - 1), off multiples of 8: a period
of 8 makes the bottom level constant, and a BatchNorm fitted to that
magnifies whatever differs. The published widths are checked on meta
tensors."""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import unet3d as reference
from benchmark.reference.precision import set_precision
from benchmark.traffic import volumes
from multimodal_segmentation_torch import config
from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter, mirror_index
from multimodal_segmentation_torch.nn import blocks, unet3d
from multimodal_segmentation_torch.nn.unet3d import (
    BatchNorm3d,
    UNet3DCicek,
    ValidBlock3D,
    ValidConv3d,
)
from multimodal_segmentation_torch.ops import epilogue, thin_conv
from multimodal_segmentation_torch.utils import tracing

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _conf(**kw):
    return dataclasses.replace(config.unet3d_cicek(), volume_shape=(92, 92, 92, 3), filters3d=4,
                               batch_size=2, compute_dtype="float32", **kw)


def _case(size, seed, conf=None):
    """(conf, weights, a (1, D, H, W, 3) volume of `size`): the weights'
    statistics from a tile of another volume of that size."""
    conf = conf or _conf()
    traffic = {"depths": [size[0]] * 2, "hw": [size[1]] * 2, "blobs": 4}
    state = volumes.make_weights(reference.MODEL, types.SimpleNamespace(
        **dataclasses.asdict(conf)), traffic, seed, CPU)
    v = volumes.render(tuple(size), 3, 4, torch.Generator().manual_seed(seed + 1), CPU)
    return conf, state, v.numpy()[None]


def _program(conf, state, **kw):
    seg = Cardiac3DSegmenter(dataclasses.replace(conf, **kw), device="cpu")
    return seg, seg.init(state_dict=state)[0]


def _reference(conf, state, precision):
    model = reference.MODEL(types.SimpleNamespace(**dataclasses.asdict(conf)))
    model.load_state_dict(state)
    return set_precision(model, precision).eval()


def test_published_widths_on_meta():
    """19,069,955 parameters in the convolutions (the paper's count), 4,672
    in the 14 BatchNorms; a 132 x 132 x 116 tile gives 44 x 44 x 28; the
    port's and the reference's state_dicts have the same keys and shapes,
    and the reference's forward gives the same output tile."""
    conf = config.unet3d_cicek()
    with torch.device("meta"):
        net = UNet3DCicek(in_channels=3, filters=32, depth=3, out_channels=3)
        ref = reference.MODEL(types.SimpleNamespace(**dataclasses.asdict(conf)))
        out = ref(torch.zeros(1, 3, 116, 132, 132))
    norms = [m for m in net.modules() if isinstance(m, BatchNorm3d)]
    conv = sum(p.numel() for n, p in net.named_parameters() if ".bn_" not in n)
    assert conv == 19_069_955
    assert len(norms) == 14 and sum(p.numel() for m in norms for p in m.parameters()) == 4_672
    assert net.output_size((116, 132, 132)) == (28, 44, 44)
    assert tuple(out.shape) == (1, 3, 28, 44, 44)
    assert reference.output_tile(ref) == (28, 44, 44)
    assert {k: v.shape for k, v in net.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}
    with pytest.raises(ValueError, match="max pool"):
        net.output_size((115, 132, 132))


def test_init_builds_the_published_net_in_eval_mode():
    seg = Cardiac3DSegmenter(config.unet3d_cicek(), device="cpu")
    net, opt = seg.init(0)
    assert isinstance(net, UNet3DCicek) and opt is None and not net.training
    assert seg.dtype == torch.bfloat16
    assert net.analysis_0.conv_0.dtype == torch.bfloat16 and net.head.dtype is None
    assert net.analysis_3.conv_1.out_channels == 512 and net.head.in_channels == 64
    assert all(p.dtype == torch.float32 for p in net.state_dict().values())


def test_net_matches_the_reference_in_float32():
    """Two 92^3 tiles through the port's net and the reference's: within
    1e-5 of a probability (the two sum the bias and the BatchNorm in other
    orders; the net magnifies float32's round-off, 3.5e-6 at most here)."""
    conf, state, _ = _case((6, 7, 7), seed=11)
    _, net = _program(conf, state)
    x = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (2, 3, 92, 92, 92))
                         .astype(np.float32))
    with torch.no_grad():
        got = net(x)
        ref = _reference(conf, state, "float32")(x)
    assert got.shape == (2, 3, 4, 4, 4) and got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= 1e-5


def test_net_in_bf16_is_held_to_the_references_rounding():
    """Two 92^3 tiles through the port's net in bf16, against the float32
    reference: the mean absolute gap of the probabilities is of the size
    that the reference rounding at bf16 has (between a quarter and twice
    it: the two round at other points, 0.76-1.34 times on six seeds), and
    under half of the reference's at fp8 (0.08-0.17 times)."""
    conf, state, _ = _case((6, 7, 7), seed=12)
    _, net = _program(conf, state, compute_dtype="bfloat16")
    x = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (2, 3, 92, 92, 92))
                         .astype(np.float32))
    with torch.no_grad():
        got = net(x.bfloat16())
        ref32, ref16, ref8 = (_reference(conf, state, p)(x)
                              for p in ("float32", "bfloat16", "fp8"))
    program_gap = (got - ref32).abs().mean().item()
    rounding = (ref16 - ref32).abs().mean().item()
    assert got.dtype == torch.float32
    assert 0.25 * rounding <= program_gap <= 2.0 * rounding, (program_gap, rounding)
    assert program_gap < 0.5 * (ref8 - ref32).abs().mean().item()


def test_predict_matches_the_reference_overlap_tile():
    """A (6, 7, 4) volume, 2 x 2 x 1 tiles with mirror padding longer
    than the volume at the far end, by the port's predict and by the
    reference's own overlap-tile (numpy.pad, slicing): within 1e-5 in
    float32."""
    conf, state, v = _case((6, 7, 4), seed=21)
    seg, net = _program(conf, state)
    got = seg.predict(net, v)
    assert got.shape == (1, 6, 7, 4, 3) and got.dtype == torch.float32
    ref = reference.predict_volume(_reference(conf, state, "float32"), v[0], 2, CPU)
    assert np.abs(got[0].numpy() - ref).max() <= 1e-5


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_overlap_tile_equals_one_forward_of_the_padded_volume(axis):
    """A volume of 10 along `axis` (3 tiles, the last cropped) and 4 along
    the others: the tiles whose offset is a multiple of the 8 voxels of
    three poolings (0 and 8) equal one forward of the whole mirror-padded
    volume (numpy.pad 'reflect'; 100 along `axis`) within 1e-4, as valid
    convolutions make them (1.4e-5 at most here: the larger convolutions
    sum in another order, and the narrow net magnifies round-off). The
    tile at 4 meets other pooling windows than the whole forward, so no
    stitch of 44-voxel tiles equals a whole forward; the check is that
    each tile lands where it belongs, mirrored as numpy mirrors."""
    size = [4, 4, 4]
    size[axis] = 10
    conf, state, v = _case(size, seed=5)
    seg, net = _program(conf, state)
    got = seg.predict(net, v)[0]
    pad = [(44, 44 + (-(-s // 4) * 4 - s)) for s in size]
    whole = torch.from_numpy(np.pad(v[0], pad + [(0, 0)], mode="reflect"))
    with torch.no_grad():
        ref = net(whole.permute(3, 0, 1, 2)[None])[0].permute(1, 2, 3, 0)
    assert ref.shape[axis] == 12
    for start in (0, 8):
        gap = (got - ref[:size[0], :size[1], :size[2]]).narrow(axis, start, min(4, 10 - start))
        assert gap.abs().max().item() <= 1e-4, (start, gap.abs().max().item())


def test_mirror_index_is_numpys_reflect():
    for size, before, total in ((5, 3, 11), (4, 44, 100), (57, 44, 172), (2, 5, 13)):
        want = np.pad(np.arange(size), (before, total - size - before), mode="reflect")
        assert mirror_index(size, before, total, CPU).tolist() == want.tolist()
    with pytest.raises(ValueError):
        mirror_index(1, 2, 5, CPU)


def test_predict_spans_and_their_attributes():
    """Under a profiler predict records one `predict_volume` a volume (slices
    = D, tiles) with its children in order: the inputs, then a batch's
    tiles, net and stitch, then the crop's stitch; without one, nothing;
    the probabilities are the same bit for bit."""
    conf, state, v = _case((6, 4, 4), seed=31)
    seg, net = _program(conf, state, batch_size=1)
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
    assert [(s.name, s.attrs) for s in root] == [("predict_volume", {"slices": 6, "tiles": 2})]
    children = sorted((s for s in spans if s.parent_id is not None), key=lambda s: s.start_ns)
    assert [s.name for s in children] == ["predict3d.inputs"] + [
        "predict3d.tiles", "predict3d.net", "predict3d.stitch"] * 2 + ["predict3d.stitch"]
    assert all(s.parent_id == root[0].span_id == s.request_id for s in children)
    assert all(root[0].start_ns <= s.start_ns <= s.end_ns <= root[0].end_ns for s in children)
    tracing.clear()


def test_step_refuses_the_net():
    conf, state, v = _case((6, 4, 4), seed=41)
    seg, net = _program(conf, state)
    with pytest.raises(NotImplementedError, match="served by predict"):
        seg.step(net, None, torch.from_numpy(v), torch.zeros(v.shape[:4] + (2,)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_volumetric_blocks_through_the_epilogue_path(monkeypatch, dtype):
    """A ValidBlock3D in eval mode with seeded BatchNorms: the card's path
    (the epilogue over each (N, C, D, H*W) conv output, its plain version
    in the kernel's place) equals the separate operations bit for bit, the
    convolutions' bias added by a separate operation as cuDNN adds it."""
    block = ValidBlock3D(3, 6, 8, dtype=dtype).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, BatchNorm3d):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
                m.running_var.copy_(torch.rand(c, generator=g) * 2.0 + 0.05)
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.3)
            elif hasattr(m, "bias") and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.3)
    x = torch.randn(2, 3, 9, 8, 7, generator=g).to(dtype)

    def separate(conv):
        def forward(x, with_bias=True):
            y = torch.nn.functional.conv3d(x.to(dtype), conv.weight.to(dtype))
            return y + conv.bias.to(dtype).view(1, -1, 1, 1, 1) if with_bias else y
        return forward

    for conv in (block.conv_0, block.conv_1):
        monkeypatch.setattr(conv, "forward", separate(conv))
    with torch.no_grad():
        chain = block(x)
        monkeypatch.setattr(blocks, "_on_card", lambda t: True)
        monkeypatch.setattr(epilogue, "_bn_epilogue_cuda", epilogue.bn_epilogue_plain)
        fused = block(x)
    assert fused.shape == (2, 8, 5, 4, 3) and fused.dtype == dtype
    assert torch.equal(fused, chain)
    with pytest.raises(ValueError, match="channels_last_3d"):
        c = torch.zeros(2, 4, 3, 6, 5)[..., :4]
        epilogue.bn_epilogue(c, *([torch.zeros(4)] * 5), 1e-3, True)


@pytest.mark.parametrize("channels, dtype, on_card, width, takes", [
    (1, torch.bfloat16, True, 132, True), (2, torch.bfloat16, True, 132, True),
    (3, torch.bfloat16, True, 132, True), (4, torch.bfloat16, True, 6, True),
    (5, torch.bfloat16, True, 132, False), (8, torch.bfloat16, True, 132, False),
    (32, torch.bfloat16, True, 132, False), (768, torch.bfloat16, True, 132, False),
    (3, torch.float16, True, 132, False), (3, torch.float32, True, 132, False),
    (3, torch.bfloat16, False, 132, False), (3, torch.bfloat16, True, 131, False),
])
def test_thin_input_decision(channels, dtype, on_card, width, takes):
    """The thin-input convolution takes bf16 inputs on the card with 1-4
    channels and an even width (what the kernel is built for: the
    published net's 3 channels and its base-width-4 cut's 4), and nothing
    in fp16 (no configuration's), float32 or on the CPU: the decision
    reads only the input's device, channels and width and the compute
    dtype (a stand-in for a card's tensor here)."""
    x = types.SimpleNamespace(is_cuda=on_card, shape=(2, channels, 5, 5, width))
    assert unet3d._thin_input(x, dtype) is takes


def _forced_thin(monkeypatch):
    """Decide as on the card in bf16, whatever the device and dtype: every
    valid 3x3x3 convolution the kernel is built for takes the thin-input
    path, which on the CPU runs the kernel's plain version. Returns the
    list of calls that took it (on the card, launch_counts() counts
    them)."""
    calls = []

    def counted(x, weight):
        calls.append(tuple(x.shape))
        return thin_conv.thin_conv3d(x, weight)

    monkeypatch.setattr(unet3d, "_thin_input", lambda x, dt: (
        x.shape[1] <= thin_conv.MAX_CHANNELS and x.shape[-1] % 2 == 0))
    monkeypatch.setattr(unet3d, "thin_conv3d", counted)
    return calls


@pytest.mark.parametrize("with_bias", [True, False])
def test_valid_conv_through_the_thin_path_equals_the_convolution(monkeypatch, with_bias):
    """A (2, 3, 12, 12, 12) input through ValidConv3d, the thin-input path
    forced on: the unpadded convolution (in float64) within 1e-6 in
    float32 (the plain version rounds the zero-padded taps' float64 sum
    once, then adds the bias in float32); one call of the path."""
    conv = ValidConv3d(3, 32, 3)
    conv.flax_init_(torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, (2, 3, 12, 12, 12))
                         .astype(np.float32))
    with torch.no_grad():
        bias = conv.bias.double() if with_bias else None
        ref = torch.nn.functional.conv3d(x.double(), conv.weight.double(), bias).float()
        calls = _forced_thin(monkeypatch)
        got = conv(x, with_bias)
    assert calls == [(2, 3, 12, 12, 12)]
    assert got.shape == ref.shape == (2, 32, 10, 10, 10)
    assert (got - ref).abs().max().item() <= 1e-6


@pytest.mark.parametrize("with_bias", [True, False])
def test_valid_conv_gradients_through_the_thin_path(monkeypatch, with_bias):
    """While autograd records, the thin-input path's output carries the
    convolution's backward: ValidConv3d's weight, bias and input gradients
    through the path forced on equal F.conv3d's within 1e-5 in float32."""
    conv = ValidConv3d(3, 8, 3)
    conv.flax_init_(torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (2, 3, 7, 6, 8))
                         .astype(np.float32))
    g = torch.from_numpy(np.random.RandomState(5).normal(0, 1, (2, 8, 5, 4, 6))
                         .astype(np.float32))

    def grads():
        xi = x.clone().requires_grad_(True)
        conv.zero_grad()
        conv(xi, with_bias).backward(g)
        return [xi.grad, conv.weight.grad] + ([conv.bias.grad] if with_bias else [])

    ref = grads()
    calls = _forced_thin(monkeypatch)
    got = grads()
    assert calls == [(2, 3, 7, 6, 8)]
    for a, b in zip(got, ref):
        assert a is not None and a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.parametrize("channels, out_channels", [(1, 4), (2, 33), (3, 32), (4, 8), (4, 70)])
def test_thin_conv_plain_is_the_convolution(channels, out_channels):
    """The kernel's plain version against F.conv3d: within f32's round-off
    in float32, in channels_last_3d as the kernel writes it; its packed
    weights zero past (K, C * 27), rows a multiple of 32 and taps of 16."""
    r = np.random.RandomState(channels * 100 + out_channels)
    x = torch.from_numpy(r.uniform(-1, 1, (2, channels, 5, 7, 6)).astype(np.float32))
    w = torch.from_numpy(r.normal(0, 0.2, (out_channels, channels, 3, 3, 3)).astype(np.float32))
    got = thin_conv.thin_conv3d(x, w)
    assert got.shape == (2, out_channels, 3, 5, 4)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    assert (got - torch.nn.functional.conv3d(x, w)).abs().max().item() <= 1e-5
    wp = thin_conv.pack_weight(w)
    taps = channels * 27
    assert wp.shape == (-(-out_channels // 32) * 32, -(-taps // 16) * 16)
    assert torch.equal(wp[:out_channels, :taps], w.reshape(out_channels, taps))
    assert not wp[out_channels:].any() and not wp[:, taps:].any()


def _ncdhw_plain(x, weight):
    """The plain version as it was written when the kernel wrote NCDHW: the
    packed weights times the im2col matrix's transpose, (N, K, D', H', W')
    contiguous."""
    n, c, d, h, w = x.shape
    k = weight.shape[0]
    cols = x.unfold(2, 3, 1).unfold(3, 3, 1).unfold(4, 3, 1)
    cols = cols.permute(0, 2, 3, 4, 1, 5, 6, 7).reshape(n, -1, c * 27)
    cols = torch.nn.functional.pad(cols.double(), (0, -(c * 27) % 16))
    wp = thin_conv.pack_weight(weight).double()[:k]
    return (wp @ cols.transpose(1, 2)).to(x.dtype).view(n, k, d - 2, h - 2, w - 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels, out_channels", [(1, 4), (3, 32), (4, 70)])
def test_thin_conv_plain_writes_channels_last_3d(channels, out_channels, dtype):
    """The plain version gives the values it gave when it wrote NCDHW, bit
    for bit, now with channels_last_3d strides (K = 32 and K > 32 among
    them), as the kernel writes them on the card."""
    r = np.random.RandomState(channels * 10 + out_channels)
    x = torch.from_numpy(r.uniform(-1, 1, (2, channels, 6, 5, 8)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(r.normal(0, 0.2, (out_channels, channels, 3, 3, 3))
                         .astype(np.float32)).to(dtype)
    got = thin_conv.thin_conv3d_plain(x, w)
    k = out_channels
    assert got.shape == (2, k, 4, 3, 6) and got.dtype == dtype
    assert got.stride() == (4 * 3 * 6 * k, 1, 3 * 6 * k, 6 * k, k)
    assert torch.equal(got, _ncdhw_plain(x, w))


def test_forward_keeps_channels_last_3d_on_the_thin_path(monkeypatch):
    """With the thin-input path forced on (channels_last_3d out, as the
    kernel writes) and the parameters in channels_last_3d, as _init_cicek
    leaves them on the card, every ValidBlock3D's and up-convolution's
    output of a base-width-4 forward is channels_last_3d (forward hooks):
    the epilogue's view, the pools, the up-convolutions and the
    concatenations keep the layout. The probabilities keep their logical
    (N, C, D', H', W') shape."""
    conf, state, _ = _case((6, 7, 4), seed=52)
    _, net = _program(conf, state)
    net = net.to(memory_format=torch.channels_last_3d)
    _forced_thin(monkeypatch)
    seen = []
    for name, m in net.named_modules():
        if isinstance(m, (ValidBlock3D, unet3d.UpConv3d)):
            m.register_forward_hook(lambda mod, i, out, name=name: seen.append(
                (name, out.is_contiguous(memory_format=torch.channels_last_3d))))
    x = torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, (2, 3, 92, 92, 92))
                         .astype(np.float32))
    with torch.no_grad():
        out = net(x)
    assert out.shape == (2, 3, 4, 4, 4)
    names = [n for n, _ in seen]
    assert names == ["analysis_%d" % i for i in range(4)] + [
        "%s_%d" % (kind, i) for i in range(3) for kind in ("upconv", "synthesis")]
    assert all(cl for _, cl in seen), seen


def test_predict_in_channels_last_3d_equals_the_ncdhw_predict(monkeypatch):
    """The base-width-4 net's predict on a (6, 7, 4) volume through the
    thin-input path, with the net in channels_last_3d (the path's output
    and the parameters), equals predict through the same path in NCDHW
    (its output made contiguous, as the kernel wrote it before) within
    1e-5 in float32: the same arithmetic, which the CPU's convolutions sum
    in another order in the other layout. The parameters keep their keys
    and values, and only their strides change; a CPU segmenter's net
    stays NCDHW."""
    conf, state, v = _case((6, 7, 4), seed=53)
    seg, net = _program(conf, state)
    assert all(p.is_contiguous() for p in net.parameters())
    before = {k: t.clone() for k, t in net.state_dict().items()}
    _forced_thin(monkeypatch)
    monkeypatch.setattr(unet3d, "thin_conv3d",
                        lambda x, w: thin_conv.thin_conv3d(x, w).contiguous())
    ncdhw = seg.predict(net, v)
    monkeypatch.undo()
    _forced_thin(monkeypatch)
    net = net.to(memory_format=torch.channels_last_3d)
    got = seg.predict(net, v)
    assert got.shape == ncdhw.shape == (1, 6, 7, 4, 3) and got.is_contiguous()
    assert (got - ncdhw).abs().max().item() <= 1e-5
    after = net.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert after["analysis_0.conv_0.weight"].is_contiguous(memory_format=torch.channels_last_3d)


def test_predict_through_the_thin_path_equals_predict(monkeypatch):
    """The base-width-4 net's predict on a (6, 7, 4) volume (4 tiles, 2
    forwards) with the thin-input path forced on equals predict without it
    within 1e-4 in float32, as the overlap-tile test holds the same net
    (the plain version rounds an exact sum, F.conv3d a float32 one, and
    the narrow net magnifies that round-off: 1.7e-5 here); the path runs
    twice a forward (at base width 4 the first level's two convolutions
    have 3 and 4 input channels; at the published widths only the first,
    3), and not at all when it is off. The parameters and buffers keep
    their keys and shapes."""
    conf, state, v = _case((6, 7, 4), seed=51)
    seg, net = _program(conf, state)
    shapes = {k: t.shape for k, t in net.state_dict().items()}
    ref = seg.predict(net, v)
    calls = _forced_thin(monkeypatch)
    got = seg.predict(net, v)
    assert [c[1] for c in calls] == [3, 4] * 2
    assert (got - ref).abs().max().item() <= 1e-4
    assert {k: t.shape for k, t in net.state_dict().items()} == shapes
    assert shapes["analysis_0.conv_0.weight"] == (4, 3, 3, 3, 3)
    monkeypatch.undo()
    calls = _forced_thin(monkeypatch)
    monkeypatch.setattr(unet3d, "_thin_input", lambda x, dt: False)
    seg.predict(net, v)
    assert calls == []


def test_thin_path_keeps_the_published_state_dict(monkeypatch):
    """At the published widths (meta tensors) the thin-input path adds no
    parameter or buffer: the first convolution's weight stays (32, 3, 3,
    3, 3) and the convolutions 19,069,955 parameters, after a forward."""
    calls = _forced_thin(monkeypatch)
    with torch.device("meta"):
        net = UNet3DCicek(in_channels=3, filters=32, depth=3, out_channels=3).eval()
        before = {k: t.shape for k, t in net.state_dict().items()}
        with torch.no_grad():
            net.analysis_0.conv_0(torch.zeros(2, 3, 12, 12, 12))
    assert len(calls) == 1
    assert {k: t.shape for k, t in net.state_dict().items()} == before
    assert before["analysis_0.conv_0.weight"] == (32, 3, 3, 3, 3)
    assert sum(p.numel() for n, p in net.named_parameters() if ".bn_" not in n) == 19_069_955
