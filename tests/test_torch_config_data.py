"""The port's numpy-side copies agree with the JAX package's: configuration
presets, the synthetic loader, the containers and the Dice metrics."""

import dataclasses

import numpy as np
import pytest
import torch

from multimodal_segmentation_tpu import config as jconfig
from multimodal_segmentation_tpu import losses as jlosses
from multimodal_segmentation_tpu.data.synthetic import SyntheticChaosLoader as JLoader
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch import losses as tlosses
from multimodal_segmentation_torch.data import init_loader
from multimodal_segmentation_torch.data.synthetic import SyntheticChaosLoader as TLoader

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_preset_asdict_equal(name):
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    assert dataclasses.asdict(tconfig.get_config(name)) == dataclasses.asdict(
        jconfig.get_config(name)
    )


@pytest.mark.parametrize("model,decoder", [("dafnet", "film"), ("mmsdnet", "spade")])
def test_tiny_test_config_asdict_equal(model, decoder):
    assert dataclasses.asdict(tconfig.tiny_test_config(model, decoder)) == dataclasses.asdict(
        jconfig.tiny_test_config(model, decoder)
    )
    assert tconfig.tiny_test_config(model).input_hw == jconfig.tiny_test_config(model).input_hw


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="available"):
        tconfig.get_config("nope")


def _split0_test(loader_cls, crop=None):
    loader = loader_cls()
    data = loader.load_all_modalities_concatenated(0, "test")
    if crop:
        data.crop(crop)
    return data


@pytest.mark.parametrize("crop", [None, (32, 32)])
def test_synthetic_split0_test_arrays_bit_equal(crop):
    j, t = _split0_test(JLoader, crop), _split0_test(TLoader, crop)
    assert t.volumes() == j.volumes() == [10, 22, 34]
    np.testing.assert_array_equal(t.index, j.index)
    for i in (0, 1):
        assert t.get_images_modi(i).dtype == j.get_images_modi(i).dtype
        np.testing.assert_array_equal(t.get_images_modi(i), j.get_images_modi(i))
        np.testing.assert_array_equal(t.get_masks_modi(i), j.get_masks_modi(i))


def test_randomise_pairs_bit_equal():
    j, t = _split0_test(JLoader, (32, 32)), _split0_test(TLoader, (32, 32))
    j.randomise_pairs(length=2, seed=10)
    t.randomise_pairs(length=2, seed=10)
    for v in j.volumes():
        np.testing.assert_array_equal(
            t.get_volume_images_modi(0, v), j.get_volume_images_modi(0, v)
        )
        np.testing.assert_array_equal(
            t.get_volume_masks_modi(0, v), j.get_volume_masks_modi(0, v)
        )


def test_loader_factory(tmp_path, caplog, monkeypatch):
    """'synthetic' and 'chaos' resolve as in the JAX package: a ChaosLoader
    when its folder exists, else the synthetic fixture with the JAX
    package's warning (the same text from both); 'cardiac' gives the port's
    CardiacVolumeLoader with its shape argument, as JAX's registry does."""
    from multimodal_segmentation_tpu.data.loader_factory import init_loader as jinit
    from multimodal_segmentation_torch.data import base_loader
    from multimodal_segmentation_torch.data.chaos import ChaosLoader

    assert isinstance(init_loader("synthetic"), TLoader)
    tree = tmp_path / "MR"
    tree.mkdir()
    loader = init_loader("chaos", data_folder=str(tree))
    assert type(loader) is ChaosLoader and loader.data_folder == str(tree)
    monkeypatch.setitem(base_loader.DATA_CONF, "chaos", str(tree))
    assert type(init_loader("chaos")) is ChaosLoader
    missing = str(tmp_path / "missing")
    warnings = []
    for init, cls in ((jinit, JLoader), (init_loader, TLoader)):
        caplog.clear()
        with caplog.at_level("WARNING", logger="loader_factory"):
            assert type(init("chaos", data_folder=missing)) is cls
        warnings.append([r.getMessage() for r in caplog.records])
    assert warnings[0] == warnings[1] == [
        "CHAOS data folder unavailable (%s); using synthetic fixture" % missing]
    from multimodal_segmentation_tpu.data.cardiac import CardiacVolumeLoader as JCardiac
    from multimodal_segmentation_torch.data.cardiac import CardiacVolumeLoader

    assert type(init_loader("cardiac")) is CardiacVolumeLoader
    assert type(jinit("cardiac")) is JCardiac
    loader = init_loader("cardiac", shape=(8, 32, 32))
    assert loader.input_shape == jinit("cardiac", shape=(8, 32, 32)).input_shape == (8, 32, 32, 3)
    with pytest.raises(ValueError):
        init_loader("nope")


@pytest.mark.parametrize("binarise", [False, True])
def test_dice_np_matches_jax(binarise):
    r = np.random.RandomState(0)
    y_true = (r.rand(5, 16, 16, 4) > 0.6).astype(np.float32)
    y_pred = r.rand(5, 16, 16, 5).astype(np.float32)
    assert tlosses.dice_np(y_true, y_pred, binarise) == jlosses.dice_np(y_true, y_pred, binarise)
    assert tlosses.dice_np_volume(y_true, y_pred, binarise) == jlosses.dice_np_volume(
        y_true, y_pred, binarise
    )
    empty = np.zeros_like(y_true)
    assert tlosses.dice_np_volume(empty, empty[..., :4]) == 1.0
