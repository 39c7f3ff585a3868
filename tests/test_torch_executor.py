"""CPU parity of the executor slice with the JAX package, at the tiny
config: straight-through rounding (the port of round_ste_pallas), SWA,
early stopping, the validation Dice, the executor's batch assembly, its
validation, the component .npz exchange in both directions, and the port's
own epoch loop: SWA over epochs, checkpoints and resume, early stop."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multimodal_segmentation_tpu import config as jconfig
from multimodal_segmentation_tpu.losses import dice_jax
from multimodal_segmentation_tpu.ops.pallas_kernels import round_ste_pallas
from multimodal_segmentation_tpu.ops.rounding import round_ste as jround_ste
from multimodal_segmentation_tpu.train.early_stopping import EarlyStopping as JEarlyStopping
from multimodal_segmentation_tpu.train.executor import DAFNetExecutor as JExecutor
from multimodal_segmentation_tpu.train.state import create_train_state as jcreate_state
from multimodal_segmentation_tpu.train.swa import swa_update as jswa_update
from multimodal_segmentation_tpu.utils.checkpoint import CheckpointManager as JCheckpoints
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch import losses
from multimodal_segmentation_torch.data import init_loader
from multimodal_segmentation_torch.data.batches import expert_batches
from multimodal_segmentation_torch.models import build_model
from multimodal_segmentation_torch.ops.rounding import round_ste
from multimodal_segmentation_torch.train import EarlyStopping, create_train_state, swa_update
from multimodal_segmentation_torch.train.executor import DAFNetExecutor, make_executor
from multimodal_segmentation_torch.utils.checkpoint import CheckpointManager
from multimodal_segmentation_torch.utils.convert import params_by_component
from test_torch_dafnet_predict import _jax_soft_anatomy
from torch_parity import jax_dafnet, torch_dafnet

torch.set_num_threads(1)

JMODEL, PARAMS, STATE = jax_dafnet(jconfig.tiny_test_config())


def _confs(folder, **kw):
    """The tiny config of both packages on the synthetic data."""
    out = []
    for mod in (jconfig, tconfig):
        conf = mod.tiny_test_config()
        conf.dataset_name = conf.test_dataset = "synthetic"
        conf.folder = str(folder)
        for k, v in kw.items():
            setattr(conf, k, v)
        out.append(conf)
    return out


def _bits(a):
    """f32 bit patterns (a bf16 widens to f32 exactly)."""
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


# ------------------------------------------------------------ rounding (B4)

def _ties(shape, seed):
    r = np.random.RandomState(seed)
    x = (r.rand(*shape) * 8 - 4).astype(np.float32).ravel()
    x[::3] = np.floor(x[::3]) + 0.5
    x[:6] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    return x.reshape(shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 16, 16, 8), (7, 3)])
def test_round_ste_matches_jax_and_the_pallas_kernel(shape, dtype):
    """Bit-exact against JAX's round_ste and against round_ste_pallas in
    interpret mode (which, for a size that is not a multiple of 128, falls
    back to jnp.round); the gradient is exactly the identity on both."""
    x = _ties(shape, len(shape))
    w = np.random.RandomState(9).randn(*shape).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    with pltpu.force_tpu_interpret_mode():
        pallas = round_ste_pallas(jx)
        pallas_grad = jax.grad(lambda v: jnp.sum(round_ste_pallas(v).astype(jnp.float32) * w))(jx)
    ref = jround_ste(jx)
    ref_grad = jax.grad(lambda v: jnp.sum(jround_ste(v).astype(jnp.float32) * w))(jx)

    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    got = round_ste(tx)
    (got.float() * torch.from_numpy(w)).sum().backward()
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_bits(got.detach().float()), _bits(ref.astype(jnp.float32)))
    np.testing.assert_array_equal(_bits(got.detach().float()), _bits(pallas.astype(jnp.float32)))
    for g in (ref_grad, pallas_grad):
        np.testing.assert_array_equal(_bits(tx.grad.float()), _bits(g.astype(jnp.float32)))
    assert torch.equal(tx.grad, torch.from_numpy(w).to(tx.dtype))


# ---------------------------------------------------------------------- SWA

@pytest.mark.parametrize("offset", [-2, 0, 1, 3])
def test_swa_update_matches_jax(offset):
    """On the tiny model's parameters, converted to the JAX trees, at an
    epoch before, at, one after and three after the start: ≤ 1e-7."""
    model = build_model(tconfig.tiny_test_config(), device="cpu")
    r = np.random.RandomState(offset + 10)
    names = [n for n, _ in model.named_parameters()]
    live = {n: torch.from_numpy(r.randn(*p.shape).astype(np.float32))
            for n, p in model.named_parameters()}
    swa = {n: torch.from_numpy(r.randn(*live[n].shape).astype(np.float32)) for n in names}
    start = 40
    ref = jswa_update(params_by_component(swa), params_by_component(live),
                      jnp.asarray(start + offset), start)
    swa_update(swa, live, start + offset, start)
    got = params_by_component(swa)
    leaves = jax.tree_util.tree_leaves_with_path
    for (path, a), (_, b) in zip(leaves(got), leaves(ref), strict=True):
        assert np.abs(a - np.asarray(b)).max() <= 1e-7, jax.tree_util.keystr(path)
    if offset <= 0:
        assert all(torch.equal(swa[n], live[n]) for n in names)


# ----------------------------------------------------------- early stopping

def test_early_stopping_and_csv_replay_match_jax(tmp_path):
    """update() on a sequence, then replay_csv on a log whose re-run epochs
    appear twice (the last row wins) and which holds rows at and past the
    resume epoch: the same best, wait and stopped_epoch as JAX's."""
    seq = [0.9, 0.85, 0.86, 0.80, 0.80, 0.80, 0.80, 0.5]
    port, ref = EarlyStopping(min_delta=0.01, patience=3), JEarlyStopping(min_delta=0.01, patience=3)
    for epoch, v in enumerate(seq):
        a = port.update(epoch, {"val_loss_mod2_fused": v})
        b = ref.update(epoch, {"val_loss_mod2_fused": v})
        assert a == b and (port.best, port.wait, port.stopped_epoch) == (
            ref.best, ref.wait, ref.stopped_epoch)
    assert port.stopped_epoch == 6
    path = tmp_path / "training.csv"
    rows = [(0, 0.9), (1, 0.7), (2, 0.71), (1, 0.5), (2, 0.52), (3, 0.3), (3, 0.49), (4, 0.1)]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["epoch", "loss", "val_loss_mod2_fused"])
        for e, v in rows:
            w.writerow([e, 1.0, v])
        w.writerow(["", 1.0, 0.2])
    for before, want in ((3, (0.5, 1)), (4, (0.5, 2)), (5, (0.1, 0))):
        port = EarlyStopping(min_delta=0.01, patience=5)
        ref = JEarlyStopping(min_delta=0.01, patience=5)
        port.replay_csv(str(path), before)
        ref.replay_csv(str(path), before)
        assert (port.best, port.wait, port.stopped_epoch) == (ref.best, ref.wait, ref.stopped_epoch)
        assert (port.best, port.wait) == want


# ---------------------------------------------------------- validation Dice

@pytest.mark.parametrize("binarise", [False, True])
def test_dice_torch_matches_dice_jax(binarise):
    r = np.random.RandomState(5)
    y_true = (r.rand(6, 32, 32, 4) > 0.6).astype(np.float32)
    y_pred = r.rand(6, 32, 32, 5).astype(np.float32)
    got = losses.dice_torch(torch.from_numpy(y_true), torch.from_numpy(y_pred), binarise)
    assert got.dim() == 0
    assert abs(float(got) - float(dice_jax(y_true, y_pred, binarise))) <= 1e-6


# ---------------------------------------------------------- batch assembly

def _both_executors(tmp_path, **kw):
    jconf, tconf = _confs(tmp_path / "ex", **kw)
    jex = JExecutor(jconf, JMODEL)
    tex = DAFNetExecutor(tconf, build_model(tconf, device="cpu"), device="cpu")
    return jex, tex


@pytest.mark.parametrize("l_mix,randomise", [(1.0, False), (0.5, False), (0.0, False),
                                             (1.0, True), (0.5, True)])
def test_assembled_batches_bit_equal_to_jax(tmp_path, l_mix, randomise):
    """The first 5 step batches of the port executor equal the JAX
    executor's, bit for bit; the labelled / unlabelled split and the
    number of batches an epoch too."""
    jex, tex = _both_executors(tmp_path, l_mix=l_mix, randomise=randomise)
    jex.init_train_data()
    tex.init_train_data()
    assert tex.batches == jex.batches
    for data, ref in ((tex.train_data.data, jex.data), (tex.train_data.ul_data, jex.ul_data)):
        assert (data is None) == (ref is None)
        if data is not None:
            np.testing.assert_array_equal(data.index, ref.index)
    jit, tit = jex._assembled_batches(), tex.train_data.assembled_batches()
    for _ in range(5):
        j, t = next(jit), next(tit)
        assert sorted(j) == sorted(t) == sorted(["sup"] * (l_mix > 0) + ["unsup"] * (l_mix < 1))
        for path in j:
            assert sorted(j[path]) == sorted(t[path])
            for k in j[path]:
                np.testing.assert_array_equal(t[path][k], j[path][k], err_msg="%s %s" % (path, k))


def test_expert_batches_are_the_executors_supervised_batches(tmp_path):
    """data/batches.py::expert_batches is the 'sup' part of the executor's
    assembly, at l_mix = 0.5 too (the unlabelled draws in between)."""
    _, tconf = _confs(tmp_path, l_mix=0.5)
    tex = DAFNetExecutor(tconf, build_model(tconf, device="cpu"), device="cpu")
    tex.init_train_data()
    loader = init_loader("synthetic", hw=tconf.input_hw)
    it, ref = expert_batches(tconf, loader), tex.train_data.assembled_batches()
    for _ in range(3):
        a, b = next(it), next(ref)["sup"]
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in a)


# --------------------------------------------------------------- validation

def test_validate_matches_jax(tmp_path):
    """The seven validation logs of the port executor, on weights converted
    from a JAX train state (the seeded weights of tests/torch_parity.py as
    its params and SWA params), within 1e-3 of JAX's Executor.validate."""
    jex, _ = _both_executors(tmp_path)
    jts = jcreate_state(JMODEL, jex.conf, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray, PARAMS)
    jts = jts.replace(params=params, swa_params=params,
                      model_state=jax.tree_util.tree_map(jnp.asarray, STATE))
    ref = jex.validate(jts)

    _, tconf = _confs(tmp_path / "t")
    tex = DAFNetExecutor(tconf, torch_dafnet(tconf, PARAMS, STATE), device="cpu")
    got = tex.validate(create_train_state(tex.model, tconf))
    assert sorted(got) == sorted(ref) and len(got) == 7
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-3, (k, got[k], ref[k])
    assert 0.0 < got["val_loss"] < 1.0


# ------------------------------------------------------- .npz weight exchange

def _predict_images():
    r = np.random.RandomState(21)
    return [r.rand(3, 32, 32, 1).astype(np.float32) * 2 - 1 for _ in range(2)]


def _assert_predictions_close(got, ref, images, fusion):
    """Slice 1's tolerance (tests/test_torch_dafnet_predict.py): 1e-4 away
    from anatomy ties."""
    s = _jax_soft_anatomy(images[0], images[1])
    ties = np.zeros(got.shape[:3], bool)
    for a in s:
        t = (np.abs(a - 0.5) < 1e-5).any(-1)
        ties |= t.any((1, 2))[:, None, None] if fusion != "simple" else t
    assert (~ties).mean() > 0.5
    np.testing.assert_allclose(got[~ties], ref[~ties], atol=1e-4)


@pytest.mark.parametrize("fusion", ["simple", "max"])
def test_component_npz_export_loads_into_jax(tmp_path, fusion):
    """The port's export of its SWA weights loads through JAX's
    CheckpointManager.load_component_weights; JAX's predict_mask with
    those params matches the port's."""
    _, tconf = _confs(tmp_path)
    model = torch_dafnet(tconf, PARAMS, STATE)
    ts = create_train_state(model, tconf)
    CheckpointManager(tconf.folder).save_component_weights(str(tmp_path / "models"), ts.swa)
    assert len(os.listdir(tmp_path / "models")) == 9
    blank = jax.tree_util.tree_map(np.zeros_like, PARAMS)
    params, loaded = JCheckpoints(str(tmp_path / "j")).load_component_weights(
        str(tmp_path / "models"), blank)
    assert sorted(loaded) == sorted(PARAMS)
    images = _predict_images()
    ref = np.asarray(JMODEL.predict_mask(params, STATE, 1, fusion, images))
    got = model.predict_mask(1, fusion, images, device="cpu").numpy()
    _assert_predictions_close(got, ref, images, fusion)


@pytest.mark.parametrize("fusion", ["simple", "max"])
def test_component_npz_from_jax_loads_into_the_port(tmp_path, fusion):
    """JAX's export loads through the port's load_component_weights, into a
    model with other weights; the port's predict_mask then matches JAX's.
    A missing file leaves its component as it was; a file with a missing
    array raises."""
    JCheckpoints(str(tmp_path / "j")).save_component_weights(str(tmp_path / "models"), PARAMS)
    _, tconf = _confs(tmp_path)
    model = torch_dafnet(tconf, jax.tree_util.tree_map(np.zeros_like, PARAMS), STATE)
    ckpt = CheckpointManager(tconf.folder)
    assert sorted(ckpt.load_component_weights(str(tmp_path / "models"), model)) == sorted(PARAMS)
    images = _predict_images()
    ref = np.asarray(JMODEL.predict_mask(PARAMS, STATE, 1, fusion, images))
    got = model.predict_mask(1, fusion, images, device="cpu").numpy()
    _assert_predictions_close(got, ref, images, fusion)

    os.remove(tmp_path / "models" / "decoder.npz")
    bad = dict(np.load(tmp_path / "models" / "segmentor.npz"))
    bad.pop(sorted(bad)[0])
    np.savez(tmp_path / "models" / "segmentor.npz", **bad)
    with pytest.raises(KeyError):
        ckpt.load_component_weights(str(tmp_path / "models"), model)
    for f in os.listdir(tmp_path / "models"):
        if f != "fuser.npz":
            os.remove(tmp_path / "models" / f)
    assert ckpt.load_component_weights(str(tmp_path / "models"), model) == ["fuser"]


# -------------------------------------------------------------- epoch loop

def _executor(folder, epochs, **kw):
    _, conf = _confs(folder, epochs=epochs, steps_per_epoch=2, swa_start_epoch=1, **kw)
    return make_executor(conf, build_model(conf, device="cpu"), device="cpu")


def _snapshotting(ex):
    """Record the live parameters at each epoch's end, before SWA."""
    snaps = {}
    on_epoch_end = ex.on_epoch_end

    def wrapped(ts, epoch):
        snaps[epoch] = {n: p.detach().clone() for n, p in ex.model.named_parameters()}
        on_epoch_end(ts, epoch)

    ex.on_epoch_end = wrapped
    return snaps


def _es_counters(es):
    return es.best, es.wait, es.stopped_epoch


@pytest.fixture(scope="module")
def four_epochs(tmp_path_factory):
    """An uninterrupted 4-epoch run, 2 steps an epoch, SWA from epoch 1,
    with the early-stopping counters entering each epoch."""
    ex = _executor(tmp_path_factory.mktemp("run") / "four", 4, image_callback_interval=2)
    snaps = _snapshotting(ex)
    seen = []
    validate = ex.validate

    def validate_and_note(ts):
        seen.append(_es_counters(ex.early_stopping))
        return validate(ts)

    ex.validate = validate_and_note
    ts = ex.train()
    return ex, ts, snaps, seen


def test_epoch_loop_swa_is_the_mean_of_the_live_epochs(four_epochs):
    """SWA = the mean of the live parameters at the end of epochs 1-3
    (≤ 1e-6); SWA holds parameters only, swapping it in leaves the buffers
    alone and swapping back restores the live parameters bit for bit; one
    training.csv and test_error.txt row per epoch; the artifacts exist
    (the images every second epoch)."""
    ex, ts, snaps, _ = four_epochs
    model = ex.model
    assert sorted(snaps) == [0, 1, 2, 3] and ts.step == 8 and ts.epoch == 3
    assert [sorted(ex.epoch_seconds[e]) for e in range(4)] == [
        sorted(["training", "validation", "checkpoint", "export"] + ["images"] * (e % 2 == 0))
        for e in range(4)]
    assert all(s > 0 for parts in ex.epoch_seconds.values() for s in parts.values())
    assert sorted(ts.swa) == sorted(n for n, _ in model.named_parameters())
    for n, avg in ts.swa.items():
        mean = (snaps[1][n] + snaps[2][n] + snaps[3][n]) / 3
        assert (avg - mean).abs().max().item() <= 1e-6, n
        assert avg.data_ptr() != dict(model.named_parameters())[n].data_ptr()
    live = {n: p.detach().clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    with ts.swa_weights():
        assert all(torch.equal(p, ts.swa[n]) for n, p in model.named_parameters())
        assert all(torch.equal(b, buffers[n]) for n, b in model.named_buffers())
    assert all(torch.equal(p, live[n]) for n, p in model.named_parameters())
    assert any(not torch.equal(live[n], ts.swa[n]) for n in live)

    folder = ex.conf.folder
    with open(os.path.join(folder, "training.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2, 3]
    assert {"loss", "dis_M", "val_loss", "val_loss_mod2_fused", "val_loss_mod1_mod2def"} <= set(rows[0])
    with open(os.path.join(folder, "test_error.txt")) as f:
        lines = f.read().splitlines()
    assert [int(line.split(",")[0]) for line in lines] == [0, 1, 2, 3]
    assert [float(line.split(",")[1]) for line in lines] == [
        round(float(r["val_loss"]) - 1.0, 3) for r in rows]
    assert CheckpointManager(folder).epochs() == [1, 2, 3]
    assert len(os.listdir(os.path.join(folder, "models"))) == 9
    images = os.path.join(folder, "training_images")
    for name in ("segmentations_epoch_002.png", "anatomies_epoch_002.png",
                 "reconstructions_epoch_002.png", "discriminator_epoch_002.png",
                 "discriminator_image_epoch_002.png", "z_means_mod1.csv", "z_vars_mod2.csv"):
        assert os.path.exists(os.path.join(images, name)), name
    assert not os.path.exists(os.path.join(images, "anatomies_epoch_003.png"))
    with open(os.path.join(images, "z_means_mod2.csv")) as f:
        assert [line.split(",")[0] for line in f.read().splitlines()] == ["0", "2"]
    assert os.path.exists(os.path.join(folder, "training", "segmentations_epoch_2.png"))
    assert os.path.exists(os.path.join(folder, "training_loss.png"))


def _train_state_arrays(ts):
    """Everything a checkpoint holds, as comparable tensors."""
    out = {"model." + k: v for k, v in ts.model.state_dict().items()}
    out.update({"swa." + k: v for k, v in ts.swa.items()})
    for name, opt in [("gen", ts.opt_gen)] + sorted(ts.opt_disc.items()):
        for i, st in opt.state_dict()["state"].items():
            for k, v in st.items():
                out["opt.%s.%d.%s" % (name, i, k)] = torch.as_tensor(v)
    out["generator"] = ts.generator.get_state()
    out["step"], out["epoch"] = torch.tensor(ts.step), torch.tensor(ts.epoch)
    return out


def test_resume_restores_bit_for_bit_and_continues(four_epochs, tmp_path):
    """After 2 epochs a new executor restores the model's state_dict, the
    SWA average, all four Adam states, the generator's state, the step and
    the epoch bit for bit; it continues at epoch 2, with the early-stopping
    counters the uninterrupted run had entering epoch 2: the same wait and
    stopped epoch, and the same best up to training.csv's six decimals,
    from which the resumed run replays it (as in the JAX package)."""
    first = _executor(tmp_path / "resume", 2, image_callback_interval=100)
    ts = first.train()
    saved = {k: v.clone() for k, v in _train_state_arrays(ts).items()}
    assert len(first.final_state.opt_disc) == 3

    second = _executor(tmp_path / "resume", 3, image_callback_interval=100)
    restored, start = second.create_state()
    assert start == 2
    got = _train_state_arrays(restored)
    assert sorted(got) == sorted(saved)
    for k in saved:
        assert torch.equal(got[k], saved[k]), k
    # the optimizers hold the model's own parameters
    params = {id(p) for p in second.model.parameters()}
    assert all(id(p) in params for g in restored.opt_gen.param_groups for p in g["params"])

    snaps = _snapshotting(second)
    seen = []
    validate = second.validate
    second.validate = lambda ts: seen.append(_es_counters(second.early_stopping)) or validate(ts)
    second.train()
    assert sorted(snaps) == [2] and sorted(second.epoch_seconds) == [2]
    for ref in (four_epochs[3][2], _es_counters(first.early_stopping)):
        assert seen[0][1:] == ref[1:]
        assert abs(seen[0][0] - ref[0]) <= 5e-7


def test_early_stop_swaps_in_swa_and_checkpoints_the_next_epoch(tmp_path):
    """patience 1 and a min_delta no loss can beat: epoch 0 sets the best,
    epoch 1 stops. The live weights become the SWA weights, a checkpoint is
    written at epoch 2, and the profiler window over epoch 0 leaves a
    trace."""
    ex = _executor(tmp_path / "stop", 10, es_patience=1, es_min_delta=10.0,
                   image_callback_interval=100, profile_epochs=(0, 1))
    ts = ex.train()
    assert ex.early_stopping.stopped_epoch == 1 and ts.epoch == 1
    assert all(torch.equal(p, ts.swa[n]) for n, p in ex.model.named_parameters())
    assert CheckpointManager(ex.conf.folder).latest_epoch() == 2
    assert os.path.exists(os.path.join(ex.conf.folder, "profile", "trace.json"))
    with open(os.path.join(ex.conf.folder, "training.csv")) as f:
        assert len(f.read().splitlines()) == 3


def test_unported_executors_and_cuda_default_raise(tmp_path):
    """The automated-pairing and the MMSDNet executors build on the CPU
    (they raised until they were ported); the cardiac3d model still
    raises; without a card the default device raises."""
    _, conf = _confs(tmp_path)
    model = build_model(conf, device="cpu")
    conf.automatedpairing = True
    ex = make_executor(conf, model, device="cpu")
    assert isinstance(ex, DAFNetExecutor) and ex.steps.conf.automatedpairing
    conf.automatedpairing, conf.model = False, "mmsdnet"
    ex = make_executor(conf, build_model(conf, device="cpu"), device="cpu")
    assert type(ex).__name__ == "MMSDNetExecutor" and type(ex.steps).__name__ == "MMSDNetSteps"
    conf.model = "cardiac3d"
    with pytest.raises(ValueError, match="cardiac3d"):
        build_model(conf, device="cpu")
    conf.model = "dafnet"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_executor(conf, model)
