"""The port's volumetric cardiac path against the JAX package's, on the CPU.

The JAX tests' tiny config (tests/test_volumetric.py): (8, 32, 32, 3)
volumes, filters3d 4, downsample3d 2, batch 2. Both frameworks get the same
weights, drawn with numpy (converted by utils/convert.py), the same
volumes and the same rotation angles (JAX's random_rotation_angles of the
key its step uses). The JAX package's Cardiac3DSegmenter.init runs op by
op and takes ~30 s at this size on the CPU; the tests replace it with
`_numpy_init`, which returns the seeded weights in the tree structure of
that init (read with jax.eval_shape) and optax's state for them.
"""

import csv
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_segmentation_tpu.config import cardiac_3d as jcardiac_3d
from multimodal_segmentation_tpu.data.loader_factory import init_loader as jinit_loader
from multimodal_segmentation_tpu.models import volumetric as jvol
from multimodal_segmentation_tpu.nn import unet3d as junet3d
from multimodal_segmentation_tpu.ops import augment as jaugment
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch.data import init_loader
from multimodal_segmentation_torch.data.cardiac import CardiacVolumeLoader
from multimodal_segmentation_torch.models import volumetric as tvol
from multimodal_segmentation_torch.nn import unet3d as tunet3d
from multimodal_segmentation_torch.ops import augment
from multimodal_segmentation_torch.utils import convert
from torch_parity import bf16_gap_check, dtypes_by_layer

torch.set_num_threads(1)

TINY = dict(volume_shape=(8, 32, 32, 3), filters3d=4, downsample3d=2, batch_size=2)


def tiny(package_conf, **kw):
    return dataclasses.replace(package_conf(), **{**TINY, **kw})


def zero_gradient_biases(downsample):
    """The leaves whose gradient is 0 in exact arithmetic: the bias of
    every 3x3x3 conv that feeds an InstanceNorm3D (both convs of each
    ConvBlock3D; the upsampling convs and the last 1x1x1 conv feed none).
    The norm cancels the bias; each framework computes its gradient as
    roundoff of either sign, which Adam scales up to steps of up to ~lr."""
    return {"ConvBlock3D_%d.Conv_%d.bias" % (b, c)
            for b in range(2 * downsample + 1) for c in (0, 1)}


def seeded_variables(conf, seed):
    """{'params': tree} of the JAX UNet3D at `conf`, numpy leaves drawn
    from `seed`: he-normal kernels, biases ~ N(0, 0.05) (non-zero, so the
    zero-gradient biases are not trivially 0), norm scales 1 + N(0, 0.1)."""
    net = jvol.Cardiac3DSegmenter(conf).net
    D, H, W, S = conf.volume_shape
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, D, H, W, S)))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            std = math.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            return rng.normal(0.0, std, leaf.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.05 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _numpy_init(seed):
    """A stand-in for the JAX Cardiac3DSegmenter.init: the seeded weights
    and optax's state for them."""
    def init(self, rng):
        params = jax.tree_util.tree_map(jnp.asarray, seeded_variables(self.conf, seed))
        return params, self.opt.init(params)
    return init


def to_torch(variables):
    return convert.component_state_dict(variables["params"])


@pytest.fixture(scope="module")
def data():
    loader = jinit_loader("cardiac", shape=TINY["volume_shape"][:3])
    return loader.load_volumes(0, "validation")


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("split", [0, 1, 2])
def test_loader_matches_jax(split):
    """Volumes, masks and the split lists equal the JAX loader's."""
    ours = init_loader("cardiac", shape=(8, 32, 32))
    ref = jinit_loader("cardiac", shape=(8, 32, 32))
    assert type(ours) is CardiacVolumeLoader
    assert ours.splits()[split] == ref.splits()[split]
    assert (ours.num_masks, ours.input_shape, ours.modalities) == (
        ref.num_masks, ref.input_shape, ref.modalities)
    for split_type in ("training", "validation", "test"):
        for a, b in zip(ours.load_volumes(split, split_type), ref.load_volumes(split, split_type),
                        strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_loader_full_size_volume_matches_jax():
    """One study at the preset's (16, 128, 128): equal, in [-1, 1], binary
    disjoint masks; the volumetric loader refuses the 2-D API as JAX's."""
    ours, ref = init_loader("cardiac"), jinit_loader("cardiac")
    (v, m), (rv, rm) = ours._volume(112), ref._volume(112)
    assert v.shape == (16, 128, 128, 3) and np.array_equal(v, rv) and np.array_equal(m, rm)
    assert v.min() >= -1.0 and v.max() <= 1.0 and m.sum(-1).max() <= 1.0
    with pytest.raises(NotImplementedError):
        ours.load_all_modalities_concatenated(0, "training")


# ---------------------------------------------------------------- rotation

@pytest.mark.parametrize("key,range_deg", [(3, 30.0), (11, 15.0)])
def test_random_rotate_volumes_matches_jax(key, range_deg):
    """Bit for bit against the JAX CPU path given JAX's angles; one angle a
    study, shared by its slices and its masks; masks stay binary."""
    r = np.random.RandomState(key)
    vols = r.rand(2, 4, 16, 16, 3).astype(np.float32)
    msks = (r.rand(2, 4, 16, 16, 2) > 0.5).astype(np.float32)
    rng = jax.random.PRNGKey(key)
    ref_v, ref_m = jaugment.random_rotate_volumes(rng, jnp.asarray(vols), jnp.asarray(msks),
                                                  range_deg)
    th = torch.from_numpy(np.array(jaugment.random_rotation_angles(rng, 2, range_deg)))
    got_v, got_m = augment.random_rotate_volumes(th, torch.from_numpy(vols),
                                                 torch.from_numpy(msks))
    assert np.array_equal(got_v.numpy(), np.asarray(ref_v))
    assert np.array_equal(got_m.numpy(), np.asarray(ref_m))
    assert not np.array_equal(got_v.numpy(), vols)
    assert set(np.unique(got_m.numpy())) <= {0.0, 1.0}
    for b in range(2):
        for d in range(4):
            one = augment.rotate_batch(torch.from_numpy(vols[b, d][None]), th[b:b + 1])[0]
            assert torch.equal(got_v[b, d], one)
            one = augment.rotate_batch(torch.from_numpy(msks[b, d][None]), th[b:b + 1])[0]
            assert torch.equal(got_m[b, d], one)


def test_random_rotate_volumes_zero_range_is_identity():
    r = np.random.RandomState(0)
    vols = torch.from_numpy(r.rand(2, 4, 16, 16, 3).astype(np.float32))
    msks = torch.from_numpy((r.rand(2, 4, 16, 16, 2) > 0.5).astype(np.float32))
    th = augment.random_rotation_angles(torch.Generator().manual_seed(3), 2, 0.0)
    v, m = augment.random_rotate_volumes(th, vols, msks)
    assert torch.equal(v, vols) and torch.equal(m, msks)


# ---------------------------------------------------------- norm and UNet3D

def test_instance_norm3d_matches_jax():
    """f32 within 2e-5 of JAX's; bf16 (statistics in f32, JAX's operation
    order) within 3x JAX's own bf16-to-f32 gap of JAX's bf16 output."""
    r = np.random.RandomState(1)
    x = (r.randn(2, 4, 6, 5, 3) * 3 + 1).astype(np.float32)
    scale, bias = (1 + 0.1 * r.randn(3)).astype(np.float32), (0.1 * r.randn(3)).astype(np.float32)
    norm = tunet3d.InstanceNorm3D(3)
    norm.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    ref, got = {}, {}
    for dtype in ("float32", "bfloat16"):
        ref[dtype] = junet3d.InstanceNorm3D().apply(
            {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x).astype(getattr(jnp, dtype)))
        xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).to(getattr(torch, dtype))
        got[dtype] = norm(xt).permute(0, 2, 3, 4, 1)
    f32, bf16 = (got[k].detach().float().numpy() for k in ("float32", "bfloat16"))
    assert np.abs(f32 - np.asarray(ref["float32"])).max() <= 2e-5
    gap = np.abs(np.asarray(ref["bfloat16"], np.float32) - np.asarray(ref["float32"])).max()
    assert got["bfloat16"].dtype == torch.bfloat16 and not np.array_equal(bf16, f32)
    assert np.abs(bf16 - np.asarray(ref["bfloat16"], np.float32)).max() <= 3 * gap


def test_max_pool_and_upsample_match_jax():
    """max_pool_hw (even: reshape + amax, the gradient split evenly across
    ties; odd: the windowed pool) and upsample2x_hw, values and
    gradients, on (B, D, H, W, C) in JAX and (B, C, D, H, W) here."""
    r = np.random.RandomState(2)
    for shape in ((2, 3, 4, 6, 2), (1, 2, 5, 7, 3)):
        x = np.round(r.rand(*shape) * 3).astype(np.float32)  # many ties
        g_ref = jax.grad(lambda v: jnp.sum(junet3d.max_pool_hw(v) ** 2))(jnp.asarray(x))
        xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_()
        out = tunet3d.max_pool_hw(xt)
        np.testing.assert_array_equal(out.permute(0, 2, 3, 4, 1).detach().numpy(),
                                      np.asarray(junet3d.max_pool_hw(jnp.asarray(x))))
        if shape[2] % 2 == 0:
            (out ** 2).sum().backward()
            np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 4, 1).numpy(),
                                       np.asarray(g_ref), rtol=1e-6)
        up = tunet3d.upsample2x_hw(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
        np.testing.assert_array_equal(up.permute(0, 2, 3, 4, 1).numpy(),
                                      np.asarray(junet3d.upsample2x_hw(jnp.asarray(x))))


@pytest.fixture(scope="module")
def forward_refs(data):
    """JAX's UNet3D outputs at f32 and bf16, the variables and the input."""
    conf = tiny(jcardiac_3d)
    variables = seeded_variables(conf, seed=4)
    x = data[0][:2]
    out = {}
    for dtype in ("float32", "bfloat16"):
        net = jvol.Cardiac3DSegmenter(dataclasses.replace(conf, compute_dtype=dtype)).net
        out[dtype] = (net, np.asarray(jax.jit(net.apply)(variables, jnp.asarray(x))))
    return variables, x, out


def _torch_net(dtype, variables):
    conf = tiny(tconfig.cardiac_3d, compute_dtype=dtype)
    return tvol.Cardiac3DSegmenter(conf, device="cpu").init(state_dict=to_torch(variables))[0]


def test_unet3d_forward_matches_jax_f32(forward_refs):
    variables, x, ref = forward_refs
    got = _torch_net("float32", variables)(torch.from_numpy(x))
    assert got.shape == (2, 8, 32, 32, 4) and got.dtype == torch.float32
    assert np.abs(got.detach().numpy() - ref["float32"][1]).max() <= 2e-5


def test_unet3d_forward_matches_jax_bf16(forward_refs):
    """bf16 activations: within 3x JAX's own bf16-to-f32 gap of JAX's bf16
    output; every layer's output dtype is JAX's, the last 1x1x1 conv and
    the softmax f32 (Flax promotes the bf16 input and the f32 kernel)."""
    variables, x, ref = forward_refs
    net = _torch_net("bfloat16", variables)
    got = net(torch.from_numpy(x))
    got32 = _torch_net("float32", variables)(torch.from_numpy(x))
    bf16_gap_check([got], [got32], [ref["bfloat16"][1]], [ref["float32"][1]])
    ours, want = dtypes_by_layer(ref["bfloat16"][0], variables, net,
                                 (jnp.asarray(x),), (torch.from_numpy(x),))
    assert ours == want
    assert want["Conv_2"] == "float32" and want["ConvBlock3D_0.Conv_0"] == "bfloat16"


# ------------------------------------------------------------ loss and steps

def test_loss_fn_and_gradients_match_jax(data):
    """The loss within 1e-5 relative; every gradient leaf within 1e-4 of its
    largest entry, except the zero-gradient biases, which are roundoff in
    both (below 1e-5 of the largest kernel gradient)."""
    jconf, tconf = tiny(jcardiac_3d), tiny(tconfig.cardiac_3d)
    variables = seeded_variables(jconf, seed=5)
    vb, mb = data[0][:2], data[1][:2]
    (loss, _), grads = jax.jit(jax.value_and_grad(jvol.Cardiac3DSegmenter(jconf).loss_fn,
                                                  has_aux=True))(
        variables, jnp.asarray(vb), jnp.asarray(mb))
    model = tvol.Cardiac3DSegmenter(tconf, device="cpu")
    net, _ = model.init(state_dict=to_torch(variables))
    got, _ = model.loss_fn(net, torch.from_numpy(vb), torch.from_numpy(mb))
    got.backward()
    assert abs(got.item() / float(loss) - 1) <= 1e-5
    ref = to_torch(jax.tree_util.tree_map(np.asarray, grads))
    exempt = zero_gradient_biases(tconf.downsample3d)
    top = max(np.abs(g.numpy()).max() for g in ref.values())
    for name, p in net.named_parameters():
        g, r = p.grad.numpy(), ref[name].numpy()
        if name in exempt:
            assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-5 * top, name
        else:
            assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), name


def test_three_steps_match_jax(data):
    """Three steps at rotation 15 with JAX's angles: the losses within 1e-5
    relative; after them every parameter within 0.1 lr of JAX's, the
    zero-gradient biases within 2 lr a step. Adam divides each gradient
    entry by its own running RMS, so an entry near 0 turns the frameworks'
    roundoff into a step difference of a share of lr: up to 0.045 lr here
    (ConvBlock3D_1.Conv_0.weight; the zero-gradient biases up to 1.5 lr)."""
    jconf = tiny(jcardiac_3d, rotation_range=15.0)
    tconf = tiny(tconfig.cardiac_3d, rotation_range=15.0)
    variables = seeded_variables(jconf, seed=6)
    jmodel = jvol.Cardiac3DSegmenter(jconf)
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    opt_state = jmodel.opt.init(params)
    model = tvol.Cardiac3DSegmenter(tconf, device="cpu")
    net, opt = model.init(state_dict=to_torch(variables))
    vb, mb = data[0][:2], data[1][:2]
    for i in range(3):
        rng = jax.random.PRNGKey(100 + i)
        th = torch.from_numpy(np.array(jaugment.random_rotation_angles(rng, 2, 15.0)))
        params, opt_state, loss = jmodel.step(params, opt_state, jnp.asarray(vb),
                                              jnp.asarray(mb), rng)
        net, opt, got = model.step(net, opt, torch.from_numpy(vb), torch.from_numpy(mb), th)
        assert abs(got.item() / float(loss) - 1) <= 1e-5, i
    ref = to_torch(jax.tree_util.tree_map(np.asarray, params))
    exempt = zero_gradient_biases(tconf.downsample3d)
    for name, p in net.named_parameters():
        diff = np.abs(p.detach().numpy() - ref[name].numpy()).max()
        assert diff <= (2 * 3 if name in exempt else 0.1) * tconf.lr, (name, diff)


@pytest.fixture(scope="module")
def jax_trained():
    """The JAX package's train_cardiac3d over 2 epochs at rotation 0 from
    the seeded weights (seed 0): (conf, model, params, history)."""
    conf = tiny(jcardiac_3d, rotation_range=0.0)
    mp = pytest.MonkeyPatch()
    mp.setattr(jvol.Cardiac3DSegmenter, "init", _numpy_init(0))
    try:
        model, params, history = jvol.train_cardiac3d(conf, epochs=2, seed=0)
    finally:
        mp.undo()
    return conf, model, params, history


def test_train_cardiac3d_matches_jax(jax_trained, monkeypatch):
    """Two epochs (9 steps each, the permutation of RandomState(0)) from
    the same seeded weights: the epoch losses within 1e-4 relative, the
    validation Dice within 1e-3."""
    conf, _, _, ref = jax_trained
    tconf = tiny(tconfig.cardiac_3d, rotation_range=0.0)
    init = tvol.Cardiac3DSegmenter.init
    weights = to_torch(seeded_variables(conf, 0))
    monkeypatch.setattr(tvol.Cardiac3DSegmenter, "init",
                        lambda self, seed=0, state_dict=None: init(self, seed, weights))
    model, _, history = tvol.train_cardiac3d(tconf, epochs=2, seed=0, device="cpu")
    assert [h["epoch"] for h in history] == [0, 1] and len(model.epoch_seconds) == 2
    for got, want in zip(history, ref, strict=True):
        assert abs(got["loss"] / want["loss"] - 1) <= 1e-4, (got, want)
        assert abs(got["val_dice"] - want["val_dice"]) <= 1e-3, (got, want)


# ------------------------------------------------------- executor artifacts

def _results(folder):
    with open(os.path.join(folder, "test_results_cardiac", "results.csv")) as f:
        return list(csv.DictReader(f))


def test_executor_artifacts_and_restore(tmp_path):
    """train() writes training.csv, models/cardiac3d.npz and results.csv
    (volume, dice, dice_c0..2); a fresh executor's test() restores the npz
    and gives the same Dice within 1e-6."""
    conf = tiny(tconfig.cardiac_3d, epochs=1, folder=str(tmp_path / "out"))
    ex = tvol.Cardiac3DExecutor(conf, device="cpu")
    ex.train()
    d1 = ex.test()
    with open(tmp_path / "out" / "training.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and list(rows[0]) == ["epoch", "loss", "val_dice"]
    assert (tmp_path / "out" / "models" / "cardiac3d.npz").exists()
    results = _results(conf.folder)
    assert [r["volume"] for r in results] == [str(v) for v in range(104, 108)]
    assert list(results[0]) == ["volume", "dice", "dice_c0", "dice_c1", "dice_c2"]
    d2 = tvol.Cardiac3DExecutor(conf, device="cpu").test()
    assert abs(d1 - d2) < 1e-6


def test_npz_keys_and_round_trip():
    """cardiac3d.npz's keys are the JAX executor's ('/'-joined key paths of
    the variables tree) and map back to the same state_dict."""
    conf = tiny(jcardiac_3d)
    variables = seeded_variables(conf, 7)
    want = {"/".join(map(str, p)) for p, _ in jax.tree_util.tree_leaves_with_path(variables)}
    sd = to_torch(variables)
    flat = convert.unet3d_npz(sd)
    assert set(flat) == want
    back = convert.unet3d_state_dict_from_npz(flat)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    net = tvol.Cardiac3DSegmenter(tiny(tconfig.cardiac_3d), device="cpu").init()[0]
    assert set(net.state_dict()) == set(sd)


def test_each_package_reads_the_others_npz(jax_trained, tmp_path, monkeypatch):
    """The JAX executor's cardiac3d.npz, restored by the port's --test, and
    the port's, restored by the JAX executor's: the same test Dice within
    1e-3 in both directions."""
    jconf, jmodel, jparams, history = jax_trained
    monkeypatch.setattr(jvol, "train_cardiac3d", lambda *a, **k: (jmodel, jparams, history))
    monkeypatch.setattr(jvol.Cardiac3DSegmenter, "init", _numpy_init(0))
    monkeypatch.chdir(tmp_path)
    jax_folder, port_folder = str(tmp_path / "jax"), str(tmp_path / "port")

    ex = jvol.Cardiac3DExecutor(dataclasses.replace(jconf, folder=jax_folder))
    ex.train()
    d_jax = ex.test()
    d_port = tvol.Cardiac3DExecutor(tiny(tconfig.cardiac_3d, folder=jax_folder),
                                    device="cpu").test()
    assert abs(d_port - d_jax) <= 1e-3

    tex = tvol.Cardiac3DExecutor(tiny(tconfig.cardiac_3d, epochs=1, folder=port_folder),
                                 device="cpu")
    tex.train()
    d_port = tex.test()
    d_jax = jvol.Cardiac3DExecutor(dataclasses.replace(jconf, folder=port_folder)).test()
    assert abs(d_port - d_jax) <= 1e-3
    with np.load(os.path.join(jax_folder, "models", "cardiac3d.npz")) as a, \
            np.load(os.path.join(port_folder, "models", "cardiac3d.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
