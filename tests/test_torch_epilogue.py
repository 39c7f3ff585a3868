"""The eval-mode conv epilogue on the CPU (multimodal_segmentation_torch/
ops/epilogue.py and nn/blocks.py::conv_norm).

On the card a BatchNorm in eval mode runs with its convolution's bias and
the ReLU as one kernel over the bias-free convolution's output. Its plain
version must round as the separate operations do: cuDNN's convolution,
its bias added by a separate add_, BatchNorm.forward in eval mode, F.relu.
These tests hold the plain version to that chain bit for bit, the blocks'
and a model's wiring of it and the kernel's backward (with the kernel's
place taken by the plain version), and the decision: train mode and other
norms never reach the epilogue. The kernel itself is tested on the card
(tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_segmentation_torch.config import tiny_test_config
from multimodal_segmentation_torch.models import build_model
from multimodal_segmentation_torch.nn import blocks
from multimodal_segmentation_torch.nn.blocks import BatchNorm, Conv2d, ConvBlock, UpsampleBlock
from multimodal_segmentation_torch.nn.segmentor import Segmentor
from multimodal_segmentation_torch.ops import cuda_kernels, epilogue
from multimodal_segmentation_torch.utils.nan_checks import install_nan_checks

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]


def _randomise_(module, seed):
    """Conv biases and BatchNorm parameters and statistics away from their
    initial zeros and ones, so every step of the chain rounds."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv2d) and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.3)
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
                m.running_var.copy_(torch.rand(c, generator=g) * 2.0 + 0.05)
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.3)
    return module


def _block(kind):
    """(module, its input channels, its (conv, norm, relu) triples)."""
    if kind == "conv_block":
        m = ConvBlock(6, 16)
        return m, 6, [(m.Conv_0, m.Norm_0, True), (m.Conv_1, m.Norm_1, True)]
    if kind == "upsample_block":
        m = UpsampleBlock(6, 16)
        return m, 6, [(m.Conv_0, m.Norm_0, False)]
    m = Segmentor(in_ch=8, num_masks=4)
    return m, 8, [(m.Conv_0, m.BatchNorm_0, True), (m.Conv_1, m.BatchNorm_1, True)]


BLOCKS = ["conv_block", "upsample_block", "segmentor"]


def _x(shape, dtype, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(dtype)


def _separate_bias(monkeypatch):
    """Conv2d with its bias added by a separate operation, as PyTorch's
    cuDNN path does (the CPU's convolution adds it inside, in f32)."""
    def forward(self, x, with_bias=True):
        y = F.conv2d(x, self.weight.to(x.dtype), None, stride=self.stride, padding=self.padding)
        if with_bias and self.bias is not None:
            y = y + self.bias.to(x.dtype).view(1, -1, 1, 1)
        return y
    monkeypatch.setattr(Conv2d, "forward", forward)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("kind", BLOCKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_epilogue_equals_the_module_chain(dtype, kind, layout):
    module, _, triples = _block(kind)
    _randomise_(module, seed=1).eval()
    for i, (conv, norm, relu) in enumerate(triples):
        c = _x((3, conv.out_channels, 12, 10), dtype, seed=i) * 2.0
        if layout == "channels_last":
            c = c.contiguous(memory_format=torch.channels_last)
        chain = norm(c + conv.bias.to(dtype).view(1, -1, 1, 1))
        chain = F.relu(chain) if relu else chain
        got = epilogue.bn_epilogue_plain(c, conv.bias, norm.running_mean, norm.running_var,
                                         norm.weight, norm.bias, norm.eps, relu)
        assert got.dtype == dtype
        assert torch.equal(got, chain)


def _on_card_with_plain_kernel(monkeypatch):
    """conv_norm decides as on the card, and the kernel's place is taken by
    the plain version. Returns the list of c's shapes the kernel got."""
    calls = []
    monkeypatch.setattr(blocks, "_on_card", lambda t: True)
    monkeypatch.setattr(epilogue, "_bn_epilogue_cuda",
                        lambda *a: calls.append(a[0].shape) or epilogue.bn_epilogue_plain(*a))
    return calls


@pytest.mark.parametrize("kind", BLOCKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_blocks_through_the_epilogue_equal_the_separate_operations(monkeypatch, dtype, kind):
    """The block with its epilogue path taken (the plain version in the
    kernel's place) against the same block run op by op, both with the
    convolution's bias added separately as on the card."""
    module, cin, triples = _block(kind)
    _randomise_(module, seed=4).eval()
    if kind == "segmentor":
        module.dtype = dtype
    x = _x((3, cin, 8, 8), dtype, seed=5)
    _separate_bias(monkeypatch)
    with torch.no_grad():
        ref = module(x)
        calls = _on_card_with_plain_kernel(monkeypatch)
        got = module(x)
    assert len(calls) == len(triples)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("kind", BLOCKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_mode_gradients_through_the_epilogue_equal_the_separate_operations(
        monkeypatch, dtype, kind):
    """Eval mode while autograd records: the epilogue's output carries a
    backward that recomputes the plain chain, so the input's and the
    parameters' gradients are those of the block run op by op."""
    module, cin, triples = _block(kind)
    _randomise_(module, seed=15).eval()
    if kind == "segmentor":
        module.dtype = dtype
    x = _x((3, cin, 8, 8), dtype, seed=16)
    with torch.no_grad():
        g = _x(tuple(module(x).shape), torch.float32, seed=17)
    _separate_bias(monkeypatch)
    params = list(module.parameters())

    def grads():
        xr = x.clone().requires_grad_(True)
        y = module(xr)
        return [y, *torch.autograd.grad(y, [xr, *params], g.to(y.dtype), allow_unused=True)]

    ref = grads()
    calls = _on_card_with_plain_kernel(monkeypatch)
    got = grads()
    assert len(calls) == len(triples)
    assert got[0].requires_grad
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def _count_epilogues(monkeypatch):
    return _on_card_with_plain_kernel(monkeypatch)


@pytest.mark.parametrize("kind", BLOCKS)
def test_train_mode_never_calls_the_epilogue(monkeypatch, kind):
    module, cin, triples = _block(kind)
    _randomise_(module, seed=6)
    calls = _count_epilogues(monkeypatch)
    x = _x((4, cin, 8, 8), torch.float32, seed=7)
    module.train()
    module(x).sum().backward()
    with torch.no_grad():
        module(x)
    assert calls == []
    module.eval()
    with torch.no_grad():
        module(x)
    assert len(calls) == len(triples)


@pytest.mark.parametrize("norm", ["instance", "none"])
def test_other_norms_never_call_the_epilogue(monkeypatch, norm):
    calls = _count_epilogues(monkeypatch)
    module = ConvBlock(3, 8, norm=norm).eval()
    with torch.no_grad():
        module(_x((2, 3, 8, 8), torch.float32, seed=8))
    assert calls == []


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_mask_through_the_epilogue_is_unchanged(monkeypatch, dtype):
    """A tiny DAFNet's predict_mask (max fusion) with the epilogue path taken
    equals the op-by-op path bit for bit, and takes the epilogue once for
    each BatchNorm'd convolution: 7 * downsample + 2 in the dual encoder,
    2 in the segmentor (32 at the published depth 4)."""
    conf = tiny_test_config()
    conf.compute_dtype = dtype
    model = _randomise_(build_model(conf, device="cpu"), seed=9)
    x = [np.random.RandomState(s).rand(3, 32, 32, 1).astype(np.float32) for s in (10, 11)]
    _separate_bias(monkeypatch)
    ref = model.predict_mask(1, "max", x, device="cpu")
    calls = _count_epilogues(monkeypatch)
    got = model.predict_mask(1, "max", x, device="cpu")
    assert len(calls) == 7 * conf.anatomy_encoder.downsample + 2 + 2
    assert torch.equal(got, ref)


def test_mmsdnet_predict_mask_takes_the_epilogue_per_encoder(monkeypatch):
    """MMSDNet: two single encoders (5 * downsample + 2 each) and the
    segmentor's 2."""
    conf = tiny_test_config(model="mmsdnet")
    model = _randomise_(build_model(conf, device="cpu"), seed=12)
    x = [np.random.RandomState(s).rand(2, 32, 32, 1).astype(np.float32) for s in (13, 14)]
    _separate_bias(monkeypatch)
    ref = model.predict_mask(0, "max", x, device="cpu")
    calls = _count_epilogues(monkeypatch)
    got = model.predict_mask(0, "max", x, device="cpu")
    assert len(calls) == 2 * (5 * conf.anatomy_encoder.downsample + 2) + 2
    assert torch.equal(got, ref)


def test_cuda_wrapper_rejects_a_cpu_tensor():
    norm = BatchNorm(4)
    with pytest.raises(ValueError, match="bn_epilogue: c must be a CUDA tensor"):
        cuda_kernels.bn_epilogue(torch.zeros(1, 4, 2, 2), torch.zeros(4), norm.running_mean,
                                 norm.running_var, norm.weight, norm.bias, norm.eps, True)


@pytest.mark.parametrize("kind,catcher", [("conv_block", "ConvBlock"),
                                          ("upsample_block", "UpsampleBlock"),
                                          ("segmentor", "Conv2d")])
def test_nan_guard_names_the_block_of_an_epilogue(monkeypatch, kind, catcher):
    """Under the debug_nans guard a NaN that the last eval-mode BatchNorm
    makes (a negative running variance) raises at the next module's output
    where the epilogue runs, which calls no norm module: the block's, or
    the segmentor's last convolution's. Op by op the norm's own hook names
    the norm."""
    module, cin, triples = _block(kind)
    _randomise_(module, seed=18).eval()
    with torch.no_grad():
        triples[-1][1].running_var[0] = -1.0
    install_nan_checks(module)
    x = _x((2, cin, 8, 8), torch.float32, seed=19)
    norm_name = type(triples[-1][1]).__name__
    with torch.no_grad():
        with pytest.raises(FloatingPointError, match=r"\(%s\)" % norm_name):
            module(x)
        calls = _on_card_with_plain_kernel(monkeypatch)
        with pytest.raises(FloatingPointError, match=r"\(%s\)" % catcher):
            module(x)
    assert len(calls) == len(triples)
