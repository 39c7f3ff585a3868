"""CPU parity of the inference slice: the port's DAFNet.predict_mask and
ModelTester against the JAX package's, on the same (seeded) weights."""

import os

import numpy as np
import pytest
import torch
from scipy.ndimage import binary_dilation

from multimodal_segmentation_tpu import config as jconfig
from multimodal_segmentation_tpu.data.synthetic import SyntheticChaosLoader as JLoader
from multimodal_segmentation_tpu.eval import tester as jtester
from multimodal_segmentation_tpu.models import build_model as build_jax_model
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch.data.synthetic import SyntheticChaosLoader as TLoader
from multimodal_segmentation_torch.eval import tester as ttester
from multimodal_segmentation_torch.models import build_model
from torch_parity import jax_dafnet, torch_dafnet

torch.set_num_threads(1)

JCONF = jconfig.tiny_test_config()
TCONF = tconfig.tiny_test_config()
JMODEL, PARAMS, STATE = jax_dafnet(JCONF)
TMODEL = torch_dafnet(TCONF, PARAMS, STATE)


def _jax_soft_anatomy(xa, xb):
    """The JAX dual encoder's softmax before rounding, for tie detection."""
    enc = JMODEL.components.modules["enc_anatomy"].clone(rounding=False)
    variables = {"params": PARAMS["enc_anatomy"],
                 "batch_stats": STATE["batch_stats"]["enc_anatomy"]}
    return [np.asarray(s) for s in enc.apply(variables, xa, xb)]


@pytest.mark.parametrize("modality_index", [0, 1])
@pytest.mark.parametrize("fusion", ["simple", "def", "max", "maxnostn"])
def test_predict_mask_matches_jax(fusion, modality_index):
    r = np.random.RandomState(20 + modality_index)
    images = [r.rand(3, 32, 32, 1).astype(np.float32) * 2 - 1 for _ in range(2)]
    ref = np.asarray(JMODEL.predict_mask(PARAMS, STATE, modality_index, fusion, images))
    got = TMODEL.predict_mask(modality_index, fusion, images, device="cpu").numpy()
    assert got.shape == ref.shape == (3, 32, 32, 5)

    # a tie (anatomy softmax within 1e-5 of 0.5) may round either way: skip
    # pixels the segmentor's two 3x3 convs reach from it, and for the warped
    # fusions the whole slice (LocNet sees the whole anatomy)
    ties = np.zeros(got.shape[:3], bool)
    for s in _jax_soft_anatomy(images[0], images[1]):
        t = (np.abs(s - 0.5) < 1e-5).any(-1)
        ties |= binary_dilation(t, np.ones((1, 5, 5), bool))
        if fusion in ("def", "max"):
            ties[t.any((1, 2))] = True
    assert (~ties).mean() > 0.9
    np.testing.assert_allclose(got[~ties], ref[~ties], atol=1e-4)


@pytest.mark.parametrize("fusion", ["simple", "def", "max"])
def test_predict_mask_bf16_compute_close_to_jax(fusion):
    """compute_dtype='bfloat16': activations in bf16, softmax and the TPS
    flow in f32. bf16 keeps 8 mantissa bits and the two frameworks round at
    other places (and the anatomy rounds at 0.5 after a bf16 cast), so
    this holds the distribution, not each pixel: median difference < 2e-3
    and < 5 % of pixels with another argmax."""
    jconf, tconf = jconfig.tiny_test_config(), tconfig.tiny_test_config()
    jconf.compute_dtype = tconf.compute_dtype = "bfloat16"
    jmodel = build_jax_model(jconf)
    tmodel = torch_dafnet(tconf, PARAMS, STATE)
    r = np.random.RandomState(30)
    images = [r.rand(3, 32, 32, 1).astype(np.float32) * 2 - 1 for _ in range(2)]
    ref = np.asarray(jmodel.predict_mask(PARAMS, STATE, 1, fusion, images))
    got = tmodel.predict_mask(1, fusion, images, device="cpu").numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.median(np.abs(got - ref)) < 2e-3
    assert (got.argmax(-1) != ref.argmax(-1)).mean() < 0.05


class _TwoVolumes:
    """Split 0 with 2 test volumes."""

    def splits(self):
        sp = super().splits()
        sp[0] = dict(sp[0], test=[10, 22])
        return sp


class _JTwo(_TwoVolumes, JLoader):
    pass


class _TTwo(_TwoVolumes, TLoader):
    pass


def _read_results(folder):
    rows = {}
    for sub in sorted(os.listdir(folder)):
        with open(os.path.join(folder, sub, "results.csv")) as f:
            lines = f.read().splitlines()
        rows[sub] = [[float(v) for v in line.split(",")] for line in lines[1:]]
    return rows


def test_model_tester_matches_jax(tmp_path, monkeypatch):
    jconf = jconfig.tiny_test_config()
    jconf.folder, jconf.test_dataset = str(tmp_path / "jax"), "synthetic"
    tconf = tconfig.tiny_test_config()
    tconf.folder, tconf.test_dataset = str(tmp_path / "torch"), "synthetic"
    monkeypatch.setattr(jtester, "init_loader", lambda name: _JTwo())
    monkeypatch.setattr(ttester, "init_loader", lambda name: _TTwo())
    monkeypatch.setattr(jtester.ModelTester, "_plot", lambda *a, **k: None)

    jtester.ModelTester(JMODEL, jconf, PARAMS, STATE).test_modality("t2", 1)
    ttester.ModelTester(TMODEL, tconf, device="cpu").test_modality("t2", 1)

    ref, got = _read_results(jconf.folder), _read_results(tconf.folder)
    assert sorted(got) == sorted(ref) and len(got) == 6
    for k in ref:
        assert len(got[k]) == len(ref[k]) == 2
        # values are written with 3 decimals
        np.testing.assert_allclose(np.array(got[k]), np.array(ref[k]), atol=1e-3 + 1e-9)


def test_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(TCONF)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttester.ModelTester(TMODEL, TCONF)
    x = np.zeros((1, 32, 32, 1), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TMODEL.predict_mask(1, "max", [x, x])


def _bf16_eval_confs():
    jconf, tconf = jconfig.tiny_test_config(), tconfig.tiny_test_config()
    jconf.eval_dtype = tconf.eval_dtype = "bfloat16"
    return jconf, tconf


@pytest.mark.parametrize("fusion", ["simple", "def", "max"])
def test_eval_dtype_bf16_predict_mask_matches_jax(fusion):
    """eval_dtype='bfloat16': the tester rebuilds the predict model at bf16
    activations with the same f32 weights and statistics, as the JAX
    tester does, and leaves the caller's model as it was. Its masks lie
    within 3 times JAX's own bf16-to-f32 gap (largest difference over the
    masks) of the JAX tester's bf16 masks."""
    jconf, tconf = _bf16_eval_confs()
    jt = jtester.ModelTester(JMODEL, jconf, PARAMS, STATE)
    tt = ttester.ModelTester(TMODEL, tconf, device="cpu")
    assert tt.model is not TMODEL and tt.model.enc_anatomy.dtype == torch.bfloat16
    assert TMODEL.enc_anatomy.dtype == torch.float32
    for k, v in TMODEL.state_dict().items():
        assert torch.equal(tt.model.state_dict()[k], v), k
    r = np.random.RandomState(31)
    images = [r.rand(3, 32, 32, 1).astype(np.float32) * 2 - 1 for _ in range(2)]
    ref = np.asarray(jt._predict(PARAMS, STATE, 1, fusion, images))
    ref32 = np.asarray(JMODEL.predict_mask(PARAMS, STATE, 1, fusion, images))
    got = tt.model.predict_mask(1, fusion, images, device="cpu").numpy()
    assert got.dtype == ref.dtype == np.float32
    gap = np.abs(ref - ref32).max()
    print("port bf16 - JAX bf16 %.3g, JAX bf16 - JAX f32 %.3g" % (np.abs(got - ref).max(), gap))
    assert 0 < np.abs(got - ref).max() <= 3 * gap


def test_eval_dtype_bf16_model_tester_dice_matches_jax(tmp_path, monkeypatch):
    """The tester's per-volume Dice at eval_dtype='bfloat16' against the JAX
    tester's at the same setting: within 1e-3, or within 3 times JAX's own
    bf16-vs-f32 Dice gap where that is larger; the bound used for each
    folder is the assertion's message."""
    jconf, tconf = _bf16_eval_confs()
    j32 = jconfig.tiny_test_config()
    for c, name in ((jconf, "jax"), (tconf, "torch"), (j32, "jax_f32")):
        c.folder, c.test_dataset = str(tmp_path / name), "synthetic"
    monkeypatch.setattr(jtester, "init_loader", lambda name: _JTwo())
    monkeypatch.setattr(ttester, "init_loader", lambda name: _TTwo())
    monkeypatch.setattr(jtester.ModelTester, "_plot", lambda *a, **k: None)
    monkeypatch.setattr(ttester.ModelTester, "_plot", lambda *a, **k: None)

    jtester.ModelTester(JMODEL, jconf, PARAMS, STATE).test_modality("t2", 1)
    jtester.ModelTester(JMODEL, j32, PARAMS, STATE).test_modality("t2", 1)
    ttester.ModelTester(TMODEL, tconf, device="cpu").test_modality("t2", 1)

    ref, got, f32 = (_read_results(c.folder) for c in (jconf, tconf, j32))
    assert sorted(got) == sorted(ref) == sorted(f32) and len(got) == 6
    for k in ref:
        r, g = np.array(ref[k])[:, 1:], np.array(got[k])[:, 1:]
        jax_gap = np.abs(r - np.array(f32[k])[:, 1:]).max()
        which = "3x JAX's gap (%.3g)" % jax_gap if 3 * jax_gap > 1e-3 else "1e-3"
        print("%s: %.3g, bound %s" % (k, np.abs(g - r).max(), which))
        # values are written with 3 decimals
        assert np.abs(g - r).max() <= max(1e-3, 3 * jax_gap) + 1e-9, (k, which)
