"""The port's experiment CLI against the JAX package's: the same folder
names and configuration, and an end-to-end run on the CPU at the tiny
config (train, then `--test` on the same folder)."""

import dataclasses
import json
import os

import pytest
import torch

from multimodal_segmentation_tpu import experiment as jexperiment
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch import experiment

torch.set_num_threads(1)


@pytest.mark.parametrize("flags", [
    ["--config", "dafnet_config_chaos", "--split", "0"],
    ["--config", "dafnet_config_chaos", "--split", "0", "--l_mix", "0.5"],
    ["--config", "dafnet_config_chaos", "--split", "2", "--l_mix", "0.25", "--randomise"],
    ["--config", "dafnet_config_chaos", "--split", "1", "--automatedpairing", "--randomise"],
    ["--config", "dafnet_spade_config_chaos", "--split", "2", "--l_mix", "1"],
    ["--config", "mmsdnet_config_chaos", "--split", "0", "--l_mix", "0", "--epochs", "7",
     "--dataset", "synthetic", "--test_dataset", "synthetic", "--compute_dtype", "bfloat16"],
])
def test_build_config_matches_jax(flags):
    """Folder name and every configuration field equal JAX build_config's;
    --device is the port's one extra flag."""
    conf = experiment.build_config(experiment.read_console_parameters(flags + ["--device", "cpu"]))
    ref = jexperiment.build_config(jexperiment.read_console_parameters(flags))
    assert conf.folder == ref.folder
    assert dataclasses.asdict(conf) == dataclasses.asdict(ref)
    assert experiment.read_console_parameters(flags).device == "cuda"


def test_save_config_writes_json_with_githash(tmp_path):
    conf = tconfig.get_config("dafnet_config_chaos")
    conf.folder = str(tmp_path)
    experiment.save_config(conf)
    with open(tmp_path / "experiment_configuration.json") as f:
        d = json.load(f)
    assert d["model"] == "dafnet" and d["githash"]
    assert {k: v for k, v in d.items() if k != "githash"} == json.loads(
        json.dumps(dataclasses.asdict(conf), default=str))


def _results(folder):
    out = {}
    for sub in sorted(os.listdir(folder)):
        path = os.path.join(folder, sub, "results.csv")
        if sub.startswith("test_results_"):
            with open(path) as f:
                out[sub] = f.read()
    return out


@pytest.fixture
def tiny_preset(monkeypatch, tmp_path):
    """The tiny config as preset 'tiny' (2 steps an epoch), run from
    tmp_path."""
    def tiny():
        return dataclasses.replace(tconfig.tiny_test_config(), steps_per_epoch=2)

    monkeypatch.setitem(tconfig.PRESETS, "tiny", tiny)
    monkeypatch.chdir(tmp_path)
    return ["--config", "tiny", "--split", "0", "--dataset", "synthetic",
            "--test_dataset", "synthetic", "--device", "cpu"]


def test_cli_trains_tests_and_restores(tiny_preset, tmp_path):
    """`--epochs 2` writes logfile.log, training.csv, the component .npz
    files, the checkpoints, 12 results.csv and the PNGs; a following
    `--test` run restores the last checkpoint and writes the same
    results.csv values."""
    ex = experiment.Experiment().run(tiny_preset + ["--epochs", "2"])
    folder = tmp_path / "tiny_l1_t1_t2_split0"
    assert ex.conf.folder == "tiny_l1_t1_t2_split0" and ex.final_state.epoch == 1
    for name in ("logfile.log", "training.csv", "test_error.txt", "experiment_configuration.json",
                 "training_loss.png"):
        assert (folder / name).exists(), name
    assert len(os.listdir(folder / "models")) == 9
    assert sorted(os.listdir(folder / "checkpoints")) == ["epoch_0.pt", "epoch_1.pt"]
    with open(folder / "logfile.log") as f:
        log = f.read()
    assert "Epoch 1/2" in log and "Evaluating model on test data for t2" in log
    first = _results(folder)
    assert len(first) == 12
    samples = folder / "test_results_synthetic_t2_max" / "samples"
    assert any(f.endswith(".png") for _, _, fs in os.walk(samples) for f in fs)
    assert (folder / "training_images" / "anatomies_epoch_001.png").exists()

    os.remove(folder / "test_results_synthetic_t1_simple" / "results.csv")
    ex = experiment.Experiment().run(tiny_preset + ["--epochs", "2", "--test"])
    assert ex.final_state.epoch == 1 and ex.final_state.step == 4
    assert _results(folder) == first


def test_cli_defaults_to_the_card_and_raises_for_unported_models(tiny_preset, tmp_path):
    """Without a card the default device raises, for the 2-D presets and
    for cardiac_3d. Automated pairing, mmsdnet_config_chaos and
    cardiac_3d_config, which raised until they were ported, run through the
    CLI on the CPU: `--test` on an empty folder restores nothing and tests
    the fresh weights (here the MMSDNet one at the tiny widths); cardiac_3d
    (tiny volumes through the run's overrides) trains an epoch, writes
    training.csv, models/cardiac3d.npz and test_results_cardiac/results.csv,
    and `--test` restores the npz with the same Dice."""
    flags = [f for f in tiny_preset if f not in ("--device", "cpu")]
    cardiac = ["--config", "cardiac_3d_config", "--split", "0", "--epochs", "1"]
    small = dict(volume_shape=(8, 32, 32, 3), filters3d=4, downsample3d=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            experiment.Experiment().run(flags + ["--epochs", "1"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            experiment.Experiment().run(cardiac, **small)
    ex = experiment.Experiment().run(cardiac + ["--device", "cpu"], **small)
    folder = tmp_path / "cardiac_3d_l1_lge_bssfp_t2_split0"
    assert type(ex).__name__ == "Cardiac3DExecutor" and ex.conf.folder == folder.name
    for name in ("logfile.log", "experiment_configuration.json", "training.csv",
                 "models/cardiac3d.npz", "test_results_cardiac/results.csv"):
        assert (folder / name).exists(), name
    with open(folder / "test_results_cardiac" / "results.csv") as f:
        first = f.read()
    experiment.Experiment().run(cardiac + ["--device", "cpu", "--test"], **small)
    with open(folder / "test_results_cardiac" / "results.csv") as f:
        assert f.read() == first
    ex = experiment.Experiment().run(tiny_preset + ["--automatedpairing", "--test"])
    assert ex.conf.automatedpairing and ex.conf.folder == "tiny_automatedpairing_l1_t1_t2_split0"
    assert type(ex).__name__ == "DAFNetExecutor" and ex.final_state.step == 0
    tconfig.PRESETS["tiny"] = lambda: dataclasses.replace(tconfig.tiny_test_config("mmsdnet"))
    ex = experiment.Experiment().run(tiny_preset + ["--test"])
    assert type(ex).__name__ == "MMSDNetExecutor" and ex.final_state.opt_zreg is not None
    assert len([f for _, _, fs in os.walk(tmp_path / ex.conf.folder) for f in fs
                if f == "results.csv"]) == 12


# ------------------------------------------------------- debug_nans (C2)

def _nan_in_segmentor(conf):
    """conf's model on the CPU with a NaN in the segmentor's first conv."""
    from multimodal_segmentation_torch.models import build_model

    model = build_model(conf, device="cpu")
    with torch.no_grad():
        model.segmentor.Conv_0.weight[0, 0, 0, 0] = float("nan")
    return model


def test_debug_nans_raises_for_a_forward_nan_under_no_grad():
    """As jax_debug_nans: under debug_nans a NaN that a forward makes under
    torch.no_grad() (predict_mask runs in inference mode) raises
    FloatingPointError at the first module whose output holds it; without
    debug_nans the same forward returns the NaNs, which anomaly mode never
    sees (it watches backward functions only)."""
    import numpy as np

    conf = dataclasses.replace(tconfig.tiny_test_config(), debug_nans=True)
    images = [np.random.RandomState(0).rand(2, 32, 32, 1).astype(np.float32)] * 2
    with torch.no_grad(), pytest.raises(FloatingPointError, match=r"segmentor\.Conv_0"):
        _nan_in_segmentor(conf).predict_mask(1, "simple", images, device="cpu")
    quiet = _nan_in_segmentor(dataclasses.replace(conf, debug_nans=False))
    with torch.no_grad(), torch.autograd.detect_anomaly():
        out = quiet.predict_mask(1, "simple", images, device="cpu")
    assert torch.isnan(out).any()


def test_debug_nans_raises_in_validation(tmp_path):
    """The executor's validation (predict_mask on the SWA weights, under
    inference mode) raises FloatingPointError for a NaN in the weights
    under debug_nans."""
    from multimodal_segmentation_torch.train import create_train_state
    from multimodal_segmentation_torch.train.executor import make_executor

    conf = dataclasses.replace(tconfig.tiny_test_config(), debug_nans=True,
                               dataset_name="synthetic", folder=str(tmp_path))
    model = _nan_in_segmentor(conf)
    ex = make_executor(conf, model, device="cpu")
    with pytest.raises(FloatingPointError, match="segmentor"):
        ex.validate(create_train_state(model, conf))
