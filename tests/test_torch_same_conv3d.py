"""The 48-output-channel same convolution (ops/same_conv.py) on the CPU:
its plain version against F.conv3d, the packing of its weights, and the
decision in nn/unet3d.py::ValidConv3d that sends Swin UNETR's seven such
convolutions a window to it and none of the 3D U-Net's. The kernel itself
runs only on the card (tests/test_torch_gpu.py -k same_conv)."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_segmentation_torch.nn import unet3d
from multimodal_segmentation_torch.nn.swin_unetr import SwinUNETR
from multimodal_segmentation_torch.nn.unet3d import UNet3DCicek, ValidConv3d
from multimodal_segmentation_torch.ops import same_conv

torch.set_num_threads(1)


def _unpack(wp):
    """pack_weight's inverse: (C // 16, 27, 2, 6, 8, 8) back to (48, C, 3,
    3, 3)."""
    c = wp.shape[0] * 16
    return wp.permute(3, 4, 0, 2, 5, 1).reshape(48, c, 3, 3, 3)


def _case(channels, shape, seed, dtype=torch.float64):
    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.uniform(-1, 1, (shape[0], channels, *shape[1:]))).to(dtype)
    w = torch.from_numpy(r.normal(0, 0.1, (48, channels, 3, 3, 3))).to(dtype)
    return x, w


@pytest.mark.parametrize("channels", same_conv.IN_CHANNELS)
@pytest.mark.parametrize("shape", [(1, 5, 7, 9), (2, 1, 3, 4), (1, 3, 1, 2)])
def test_same_conv_plain_is_the_convolution(channels, shape):
    """The plain version (the kernel's sum over 16-channel stages and 27
    taps of the packed weights) against F.conv3d with padding 1 in
    float64, at small odd extents, 1-voxel axes among them: within
    float64's round-off, (N, 48, D, H, W) in channels_last_3d."""
    x, w = _case(channels, shape, channels + sum(shape))
    got = same_conv.same_conv3d_plain(x, same_conv.pack_weight(w))
    ref = F.conv3d(x, w, padding=1)
    assert got.shape == ref.shape == (shape[0], 48, *shape[1:])
    assert got.dtype == torch.float64
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    assert (got - ref).abs().max().item() <= 1e-12


@pytest.mark.parametrize("channels", same_conv.IN_CHANNELS)
def test_pack_weight_round_trips(channels):
    """The packed weights hold every weight once, where the kernel reads
    it: input channel 16 q + 8 kg + k and output channel 8 ng + n of tap
    9 i + 3 j + l at [q, tap, kg, ng, n, k]; unpacking gives the weights
    back bit for bit."""
    _, w = _case(channels, (1, 1, 1, 1), channels, torch.float32)
    wp = same_conv.pack_weight(w)
    assert wp.shape == (channels // 16, 27, 2, 6, 8, 8) and wp.is_contiguous()
    assert torch.equal(_unpack(wp), w)
    r = np.random.RandomState(1)
    for _ in range(20):
        q, t, kg, ng, n, k = (r.randint(s) for s in wp.shape)
        assert wp[q, t, kg, ng, n, k] == w[8 * ng + n, 16 * q + 8 * kg + k, t // 9, t // 3 % 3,
                                           t % 3]


@pytest.mark.parametrize("channels", same_conv.IN_CHANNELS)
def test_same_conv_plain_rounds_once_in_bf16(channels):
    """In bf16 the plain version is the float64 convolution of the bf16
    inputs rounded once to bf16, bit for bit."""
    x, w = _case(channels, (1, 4, 3, 5), 7, torch.bfloat16)
    got = same_conv.same_conv3d_plain(x, same_conv.pack_weight(w))
    ref = F.conv3d(x.double(), w.double(), padding=1).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref)


@pytest.mark.parametrize("cin, cout, k, padding, dtype, on_card, takes", [
    (48, 48, 3, 1, torch.bfloat16, True, True), (96, 48, 3, 1, torch.bfloat16, True, True),
    (48, 48, 3, 0, torch.bfloat16, True, False), (96, 96, 3, 1, torch.bfloat16, True, False),
    (192, 48, 3, 1, torch.bfloat16, True, False), (4, 48, 3, 1, torch.bfloat16, True, False),
    (48, 32, 3, 1, torch.bfloat16, True, False), (48, 48, 1, 0, torch.bfloat16, True, False),
    (48, 48, 3, 1, torch.float32, True, False), (48, 48, 3, 1, torch.float16, True, False),
    (48, 48, 3, 1, torch.bfloat16, False, False),
])
def test_same_c48_decision(cin, cout, k, padding, dtype, on_card, takes):
    """The same convolution takes a bf16 convolution on the card with a 3^3
    kernel, padding 1, 48 output and 48 or 96 input channels (what the
    kernel is built for: Swin UNETR's), and nothing else: no valid
    convolution, no other width, no float32 or fp16, nothing on the CPU."""
    conv = ValidConv3d(cin, cout, k, padding=padding)
    x = types.SimpleNamespace(is_cuda=on_card)  # all the decision reads of the input
    assert unet3d._same_c48(conv, x, dtype) is takes


def _forced_same(monkeypatch):
    """Decide as on the card in bf16, whatever the device and dtype, and
    count the calls that take the same convolution; the stand-in computes
    nothing on the meta device and the plain version elsewhere. Returns
    the list of (input shape, whether it was channels_last_3d)."""
    calls = []

    def counted(x, weight, wp=None):
        calls.append((tuple(x.shape), x.is_contiguous(memory_format=torch.channels_last_3d)))
        if x.is_meta:
            return torch.empty(x.shape[0], 48, *x.shape[2:], device="meta", dtype=x.dtype)
        return same_conv.same_conv3d(x, weight, wp)

    decide = unet3d._same_c48
    monkeypatch.setattr(unet3d, "_same_c48",
                        lambda conv, x, dt: decide(conv, types.SimpleNamespace(is_cuda=True),
                                                       torch.bfloat16))
    monkeypatch.setattr(unet3d, "same_conv3d", counted)
    return calls


def test_swin_unetr_routes_its_seven_convolutions(monkeypatch):
    """A published-width bf16 Swin UNETR forward of one 128^3 window (meta
    tensors): exactly its seven 48-output-channel 'same' convolutions take
    the path, in the decoder's order: encoder1's conv2 at 128^3,
    encoder2's two at 64^3, decoder2's 96 -> 48 and 48 -> 48 at 64^3,
    decoder1's at 128^3."""
    calls = _forced_same(monkeypatch)
    with torch.device("meta"), torch.no_grad():
        y = SwinUNETR(dtype=torch.bfloat16)(torch.empty(1, 4, 128, 128, 128))
    assert y.shape == (1, 3, 128, 128, 128)
    assert [shape for shape, _ in calls] == [
        (1, 48, 128, 128, 128), (1, 48, 64, 64, 64), (1, 48, 64, 64, 64),
        (1, 96, 64, 64, 64), (1, 48, 64, 64, 64), (1, 96, 128, 128, 128),
        (1, 48, 128, 128, 128)]


def test_unet3d_cicek_routes_none(monkeypatch):
    """A published-width bf16 3D U-Net forward of one 132 x 132 x 116 tile
    (meta tensors): none of its convolutions takes the path (all valid)."""
    calls = _forced_same(monkeypatch)
    with torch.device("meta"), torch.no_grad():
        net = UNet3DCicek(dtype=torch.bfloat16).eval()
        y = net(torch.empty(1, 3, 116, 132, 132))
    assert y.shape == (1, 3, 28, 44, 44)
    assert calls == []


@pytest.mark.parametrize("channels", same_conv.IN_CHANNELS)
@pytest.mark.parametrize("with_bias", [True, False])
def test_valid_conv_through_the_same_path_equals_the_convolution(monkeypatch, channels,
                                                                  with_bias):
    """A (2, C, 5, 6, 7) input through ValidConv3d(padding=1), the path
    forced on: the padded convolution (in float64) within 1e-6 in float32
    (the plain version rounds the float64 sum once, then adds the bias in
    float32); one call of the path."""
    conv = ValidConv3d(channels, 48, 3, padding=1)
    conv.flax_init_(torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, (2, channels, 5, 6, 7))
                         .astype(np.float32))
    with torch.no_grad():
        bias = conv.bias.double() if with_bias else None
        ref = F.conv3d(x.double(), conv.weight.double(), bias, padding=1).float()
        calls = _forced_same(monkeypatch)
        got = conv(x, with_bias)
    assert [shape for shape, _ in calls] == [(2, channels, 5, 6, 7)]
    assert got.shape == ref.shape == (2, 48, 5, 6, 7)
    assert (got - ref).abs().max().item() <= 1e-6


def test_valid_conv_gradients_through_the_same_path(monkeypatch):
    """While autograd records, the path's output carries the convolution's
    backward: ValidConv3d's weight, bias and input gradients through the
    path forced on equal F.conv3d's within 1e-5 in float32."""
    conv = ValidConv3d(48, 48, 3, padding=1)
    conv.flax_init_(torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (1, 48, 3, 4, 5))
                         .astype(np.float32))
    g = torch.from_numpy(np.random.RandomState(5).normal(0, 1, (1, 48, 3, 4, 5))
                         .astype(np.float32))

    def grads():
        xi = x.clone().requires_grad_(True)
        conv.zero_grad()
        conv(xi).backward(g)
        return [xi.grad, conv.weight.grad, conv.bias.grad]

    ref = grads()
    calls = _forced_same(monkeypatch)
    got = grads()
    assert len(calls) == 1
    for a, b in zip(got, ref):
        assert a is not None and a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-5


def test_packed_weight_is_kept_while_the_parameter_is(monkeypatch):
    """The module packs its weights once: a second call reuses the packed
    tensor; an in-place change of the parameter (a load_state_dict), new
    memory under it or another dtype packs them again, from the new
    values."""
    conv = ValidConv3d(48, 48, 3, padding=1)
    first = conv._packed_weight(torch.float32)
    assert conv._packed_weight(torch.float32) is first
    assert torch.equal(_unpack(first), conv.weight.detach())
    with torch.no_grad():
        conv.weight.mul_(2.0)
    again = conv._packed_weight(torch.float32)
    assert again is not first and torch.equal(again, 2.0 * first)
    bf16 = conv._packed_weight(torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, again.bfloat16())
    conv.weight.data = -conv.weight.data.clone()
    swapped = conv._packed_weight(torch.bfloat16)
    assert swapped is not bf16 and torch.equal(swapped, -bf16)
