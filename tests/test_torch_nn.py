"""Eval-mode CPU parity of the port's modules (multimodal_segmentation_torch/nn)
with the JAX package's, at the tiny config, on the JAX weights carried over
by utils/convert.py with seeded running statistics (tests/torch_parity.py)."""

import functools

import jax
import numpy as np
import pytest
import torch

from multimodal_segmentation_tpu import config as jconfig
from multimodal_segmentation_tpu import nn as jnn
from multimodal_segmentation_tpu.models import build_model as build_jax_model
from multimodal_segmentation_tpu.nn.unet import UNetBottleneck as JUNetBottleneck
from multimodal_segmentation_tpu.nn.unet import UNetDown as JUNetDown
from multimodal_segmentation_tpu.nn.unet import UNetUp as JUNetUp
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch import nn as tnn
from multimodal_segmentation_torch.models import build_model as build_torch_model
from multimodal_segmentation_torch.utils.convert import component_state_dict
from torch_parity import jax_dafnet, nchw, nhwc

torch.set_num_threads(1)

CONF = jconfig.tiny_test_config()
F, D = CONF.anatomy_encoder.filters, CONF.anatomy_encoder.downsample  # 4, 2
_, PARAMS, STATE = jax_dafnet(CONF)
BS = STATE["batch_stats"]


def _vars(params, stats=None):
    v = {"params": params}
    if stats is not None:
        v["batch_stats"] = stats
    return v


def _load(module, params, stats=None):
    module.load_state_dict(component_state_dict(params, stats))
    return module.eval()


def _images(shape, seed):
    return (np.random.RandomState(seed).rand(*shape).astype(np.float32) * 2 - 1)


def _anatomy(B, seed, C=8, hw=32):
    """{0,1} one-hot-ish anatomy maps like the rounded encoder output."""
    r = np.random.RandomState(seed)
    lab = r.randint(0, C + 1, size=(B, hw, hw))
    return (lab[..., None] == np.arange(C)).astype(np.float32)


def test_conv_block():
    p, s = PARAMS["enc_anatomy"]["down1"]["ConvBlock_1"], BS["enc_anatomy"]["down1"]["ConvBlock_1"]
    x = _images((2, 16, 16, F), 0)
    ref = jnn.ConvBlock(2 * F).apply(_vars(p, s), x)
    got = _load(tnn.ConvBlock(F, 2 * F), p, s)(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5)


def test_unet_down():
    p, s = PARAMS["enc_anatomy"]["down2"], BS["enc_anatomy"]["down2"]
    x = _images((2, 32, 32, 1), 1)
    ref_h, ref_skips = JUNetDown(F, D).apply(_vars(p, s), x)
    got_h, got_skips = _load(tnn.UNetDown(1, F, D), p, s)(nchw(x))
    np.testing.assert_allclose(nhwc(got_h), np.asarray(ref_h), atol=1e-5)
    for a, b in zip(got_skips, ref_skips):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=1e-5)


def test_unet_bottleneck():
    p, s = PARAMS["enc_anatomy"]["shared_bottleneck"], BS["enc_anatomy"]["shared_bottleneck"]
    x = _images((2, 8, 8, F * 2 ** (D - 1)), 2)
    ref = JUNetBottleneck(F, D).apply(_vars(p, s), x)
    got = _load(tnn.UNetBottleneck(F, D), p, s)(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5)


def test_unet_up():
    p, s = PARAMS["enc_anatomy"]["shared_up"], BS["enc_anatomy"]["shared_up"]
    x = _images((2, 8, 8, F * 2 ** D), 3)
    skips = [_images((2, 32, 32, F), 4), _images((2, 16, 16, 2 * F), 5)]
    ref = JUNetUp(F, D).apply(_vars(p, s), x, skips)
    got = _load(tnn.UNetUp(F, D), p, s)(nchw(x), [nchw(k) for k in skips])
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5)


def test_segmentor():
    p, s = PARAMS["segmentor"], BS["segmentor"]
    x = _anatomy(2, 6)
    ref = jnn.Segmentor(CONF.num_masks).apply(_vars(p, s), x)
    got = _load(tnn.Segmentor(8, CONF.num_masks), p, s)(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5)


def _dual(rounding):
    p, s = PARAMS["enc_anatomy"], BS["enc_anatomy"]
    x1, x2 = _images((3, 32, 32, 1), 7), _images((3, 32, 32, 1), 8)
    ref = jnn.DualAnatomyEncoder(F, D, rounding=rounding).apply(_vars(p, s), x1, x2)
    enc = _load(tnn.DualAnatomyEncoder(1, F, D, rounding=rounding), p, s)
    got = enc(nchw(x1), nchw(x2))
    return [np.asarray(r) for r in ref], [nhwc(g) for g in got]


def test_dual_anatomy_encoder_softmax():
    ref, got = _dual(rounding=False)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_dual_anatomy_encoder_rounded_equal_outside_ties():
    """Rounding after softmax: equal except where the JAX softmax lies
    within 1e-5 of 0.5 (such a pixel may round either way)."""
    soft, _ = _dual(rounding=False)
    ref, got = _dual(rounding=True)
    for s, a, b in zip(soft, got, ref):
        ties = np.abs(s - 0.5) < 1e-5
        assert ties.mean() < 1e-3, "tie share %.2e" % ties.mean()
        np.testing.assert_array_equal(a[~ties], b[~ties])
        assert 0.2 < (b.max(-1) == 1).mean()  # the rounded anatomy is not empty


def test_single_anatomy_encoder():
    """The one-path encoder is the same parts; checked on down1's weights."""
    p = {
        "UNetDown_0": PARAMS["enc_anatomy"]["down1"],
        "UNetBottleneck_0": PARAMS["enc_anatomy"]["shared_bottleneck"],
        "UNetUp_0": PARAMS["enc_anatomy"]["shared_up"],
        "conv_anatomy": PARAMS["enc_anatomy"]["conv_anatomy"],
    }
    bse = BS["enc_anatomy"]
    s = {"UNetDown_0": bse["down1"], "UNetBottleneck_0": bse["shared_bottleneck"],
         "UNetUp_0": bse["shared_up"]}
    x = _images((2, 32, 32, 1), 9)
    ref = jnn.AnatomyEncoder(F, D, rounding=False).apply(_vars(p, s), x)
    got = _load(tnn.AnatomyEncoder(1, F, D, rounding=False), p, s)(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5)


def test_locnet_nonzero_offsets():
    p = PARAMS["fuser"]["locnet"]
    s1, s2 = _anatomy(2, 10), _anatomy(2, 11)
    ref = np.asarray(jnn.LocNet().apply(_vars(p), s1, s2))
    got = _load(tnn.LocNet(16, (32, 32)), p)(nchw(s1), nchw(s2)).detach().numpy()
    assert got.shape == (2, 25, 2)
    assert 1e-2 < np.abs(ref).mean() < 0.1  # the warp is exercised
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_anatomy_fuser():
    p = PARAMS["fuser"]
    s1, s2 = _anatomy(2, 12), _anatomy(2, 13)
    ref_def, ref_fused = jnn.AnatomyFuser().apply(_vars(p), s1, s2)
    got_def, got_fused = _load(tnn.AnatomyFuser(8, (32, 32)), p)(nchw(s1), nchw(s2), fast=True)
    np.testing.assert_allclose(nhwc(got_def), np.asarray(ref_def), atol=2e-4)
    np.testing.assert_allclose(nhwc(got_fused), np.asarray(ref_fused), atol=2e-4)
    assert np.abs(np.asarray(ref_def) - s1).max() > 0.1  # not the identity warp


def test_batchnorm_train_mode_not_ported():
    """Train-mode BatchNorm is ported now (tests/test_torch_train_ops.py
    holds it to JAX): it normalises with the batch's statistics. The other
    normalisation kinds are ported too: a ConvBlock with norm='instance'
    holds InstanceNorms and one with norm='none' none
    (tests/test_torch_spade.py holds both to JAX)."""
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 4, 3, 3).astype(np.float32) * 3 + 1)
    y = tnn.BatchNorm(4).train()(x)
    np.testing.assert_allclose(y.mean(dim=(0, 2, 3)).detach().numpy(), 0.0, atol=1e-5)
    block = tnn.ConvBlock(4, 4, norm="instance")
    assert type(block.Norm_0) is type(block.Norm_1) is tnn.InstanceNorm
    assert not any("Norm" in k for k in tnn.ConvBlock(4, 4, norm="none").state_dict())


@functools.lru_cache(maxsize=None)
def _param_counts(preset):
    """{component: (n_jax, n_torch)} for a preset ('tiny' = tiny_test_config)."""
    if preset == "tiny":
        jconf, tconf = jconfig.tiny_test_config(), tconfig.tiny_test_config()
    else:
        jconf, tconf = jconfig.get_config(preset), tconfig.get_config(preset)
    jmodel = build_jax_model(jconf)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))[0]
    tmodel = build_torch_model(tconf, device="cpu")
    return {
        c: (sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes[c])),
            sum(p.numel() for p in getattr(tmodel, c).parameters()))
        for c in ("enc_anatomy", "fuser", "segmentor")
    }


@pytest.mark.parametrize("preset", ["tiny", "dafnet_chaos"])
@pytest.mark.parametrize("component", ["enc_anatomy", "fuser", "segmentor"])
def test_param_counts_match_jax(preset, component):
    n_jax, n_torch = _param_counts(preset)[component]
    assert n_torch == n_jax
    if preset == "dafnet_chaos":
        expect = {"enc_anatomy": 39_214_408, "fuser": 3_395_210, "segmentor": 42_181}
        assert n_torch == expect[component]
