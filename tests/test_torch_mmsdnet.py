"""CPU parity of MMSDNet with the JAX package, at the tiny config, on JAX
weights seeded as in tests/torch_parity.py (random running statistics, both
anatomy heads sharpened x20 on top of its gain, a non-zero LocNet head):
the weight conversion, gen_loss (value, metrics, generator gradients; f32
and bf16), the Z-regressor's anatomies and loss, the mask discriminator's
pool and loss, predict_mask for the four fusion types, one step of each
kind from the JAX state, the executor (step counts, the 4-metric
validation against JAX's on the same weights, checkpoint and resume with
the Z-regressor's Adam) and the CLI on mmsdnet_config_chaos.

Tolerances are those of the expert tests (tests/test_torch_dafnet_train.py):
losses and metrics 1e-5 relative; gradients within twice JAX's own spread
under a +-1e-6 move of LocNet's last bias plus 1e-4 of each leaf's
largest entry, and the whole vector within that spread in relative L2;
discriminator metrics after a step 2e-3 relative; bf16 within 3x JAX's
own bf16-to-f32 gap. Every f32 test asserts that no anatomy softmax value
the port rounds lies within 1e-4 of 0.5.
"""

import csv
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_segmentation_tpu import config as jconfig
from multimodal_segmentation_tpu import losses as jlosses
from multimodal_segmentation_tpu.models import build_model as build_jax_model
from multimodal_segmentation_tpu.models.base import add_residual as jadd_residual
from multimodal_segmentation_tpu.ops.augment import random_rotation_angles as jangles
from multimodal_segmentation_tpu.train.executor import MMSDNetExecutor as JExecutor
from multimodal_segmentation_tpu.train.state import create_train_state as jcreate_state
from multimodal_segmentation_tpu.train.steps import MMSDNetSteps as JSteps
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch import experiment
from multimodal_segmentation_torch.models import MMSDNet, build_model
from multimodal_segmentation_torch.train import MMSDNetSteps, create_train_state
from multimodal_segmentation_torch.train.executor import MMSDNetExecutor, make_executor
from multimodal_segmentation_torch.utils.convert import component_trees, load_jax_weights
from torch_parity import jax_mmsdnet, jax_sample_eps, nchw, nhwc, set_adam, tie_guard

torch.set_num_threads(1)

JCONF = jconfig.tiny_test_config("mmsdnet")
TCONF = tconfig.tiny_test_config("mmsdnet")
JMODEL, PARAMS, STATE = jax_mmsdnet(JCONF)
# the expert tests' sharper anatomy heads (x20 on top of
# torch_parity.ANATOMY_GAIN); the step test sharpens them twice more
for _name in ("enc_anatomy1", "enc_anatomy2"):
    PARAMS[_name]["conv_anatomy"]["kernel"] *= 20.0
B, HW, NM, NZ = JCONF.batch_size, JCONF.input_hw, JCONF.num_masks, JCONF.num_z
GEN, DISC, ZREG = JMODEL.GEN_COMPONENTS, JMODEL.DISC_COMPONENTS, JMODEL.ZREG_COMPONENTS
LR = JCONF.lr
TIE_MARGIN = 1e-4
PERTURBATION = 1e-6  # on LocNet's last bias: ~3e-5 px of sample location


def _masks(r, n=B):
    lab = r.randint(0, NM + 1, size=(n,) + HW)
    return (lab[..., None] == np.arange(NM)).astype(np.float32)


def _images(r, n=B):
    return (r.rand(n, *HW, 1) * 2 - 1).astype(np.float32)


def _batch(seed):
    """A generator batch and a discriminator batch, as the executor
    assembles them (masks without the residual channel)."""
    r = np.random.RandomState(seed)
    gen = {"x1": _images(r), "x2": _images(r), "m1": _masks(r), "m2": _masks(r)}
    disc = {"dm": _masks(r), "dx1": _images(r), "dx2": _images(r)}
    return gen, disc


def _gen_batch(seed, supervised):
    b = _batch(seed)[0]
    b["m1"] = np.asarray(jadd_residual(b["m1"]))
    b["m2"] = np.asarray(jadd_residual(b["m2"]))
    if not supervised:
        del b["m2"]
    return b


def _perturbed(params, delta):
    out = dict(params)
    out["fuser"] = jax.tree_util.tree_map(np.array, params["fuser"])
    out["fuser"]["locnet"]["Dense_1"]["bias"] = (
        params["fuser"]["locnet"]["Dense_1"]["bias"] + np.float32(delta))
    return out


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(l))
            for p, l in jax.tree_util.tree_leaves_with_path(tree)]


def _flat(tree):
    return np.concatenate([l.ravel() for _, l in _leaves(tree)])


def _model(conf=TCONF):
    return load_jax_weights(build_model(conf, device="cpu"), PARAMS, STATE)


def _grads(model, names, loss):
    params = {n: dict(getattr(model, n).named_parameters()) for n in names}
    grads = iter(torch.autograd.grad(loss, [p for n in names for p in params[n].values()],
                                     allow_unused=True))
    return {n: component_trees({k: (g if g is not None else torch.zeros_like(p))
                                for (k, p), g in zip(params[n].items(), grads)})["params"]
            for n in names}


def _assert_grads_close(got, want, rel):
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want), strict=True):
        np.testing.assert_allclose(a, b, atol=rel * np.abs(b).max(), rtol=0, err_msg=path)


def _assert_trees_close(got, want, atol):
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want), strict=True):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=path)


def _trees(model, names, col):
    return {n: component_trees(getattr(model, n).state_dict())[col] for n in names}


# ------------------------------------------------------------- conversion

def test_weight_conversion_round_trips_and_sizes_match_jax():
    """The seven components: JAX trees -> the port (strict load) -> JAX
    trees exactly, for params, batch_stats and the spectral vectors; the
    port's parameter count of each component equals JAX's at the tiny and
    the mmsdnet_chaos config."""
    model = _model()
    assert [n for n, _ in model.named_children()] == list(GEN + DISC)
    for name in GEN + DISC:
        trees = component_trees(getattr(model, name).state_dict())
        ref = {"params": PARAMS[name]}
        for col in ("batch_stats", "spectral"):
            if name in STATE.get(col, {}):
                ref[col] = STATE[col][name]
        assert sorted(trees) == sorted(ref), name
        for col, tree in ref.items():
            got, want = _leaves(trees[col]), _leaves(tree)
            assert [p for p, _ in got] == [p for p, _ in want], (name, col)
            for (p, a), (_, b) in zip(got, want):
                np.testing.assert_array_equal(a, b, err_msg=name + p)
    for jconf, tconf in ((JCONF, TCONF), (jconfig.mmsdnet_chaos(), tconfig.mmsdnet_chaos())):
        shapes = jax.eval_shape(lambda c=jconf: build_jax_model(c).init(jax.random.PRNGKey(0)))
        tmodel = build_model(tconf, device="cpu")
        for c in GEN + DISC:
            n_jax = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes[0][c]))
            assert sum(p.numel() for p in getattr(tmodel, c).parameters()) == n_jax, c


# ------------------------------------------------------------ generator loss

@functools.lru_cache(maxsize=None)
def _jax_gen_loss(supervised):
    batch = _gen_batch(40, supervised)
    key = jax.random.PRNGKey(7)
    disc = {k: PARAMS[k] for k in DISC}

    def f(g, d):
        return JMODEL.gen_loss(g, d, STATE, batch, key, supervised)

    return jax.jit(jax.value_and_grad(f, has_aux=True)), batch, key, disc


def _eps(key):
    """The one VAE call's noise: gen_loss draws it from the step key
    itself (models/mmsdnet.py:172-176)."""
    return torch.from_numpy(jax_sample_eps(PARAMS, key, 6 * B, HW))


@pytest.mark.parametrize("supervised", [True, False])
def test_gen_loss_and_gradients_match_jax(supervised):
    """Loss and metrics at 1e-5 relative; both encoders' and the
    segmentor's running statistics after the loss at 1e-6. Each generator
    leaf's gradient within twice JAX's spread under +-1e-6 plus 1e-4 of
    its largest entry and 1e-5 of its component's largest (conv biases
    ahead of a BatchNorm have a roundoff-sized gradient); the whole
    vector within JAX's spread in relative L2."""
    fn, batch, key, disc = _jax_gen_loss(supervised)
    (_, (ref_metrics, ref_state)), ref = fn({k: PARAMS[k] for k in GEN}, disc)
    spread = [fn({k: p[k] for k in GEN}, disc)[1] for p in
              (_perturbed(PARAMS, PERTURBATION), _perturbed(PARAMS, -PERTURBATION))]

    model = _model().train()
    check_ties = tie_guard(model, TIE_MARGIN)
    total, metrics = model.gen_loss({k: torch.tensor(v) for k, v in batch.items()}, _eps(key),
                                    supervised)
    got = _grads(model, GEN, total)
    check_ties()
    assert sorted(metrics) == sorted(ref_metrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(ref_metrics[k]),
                                   rtol=1e-5, err_msg=k)
    bn = ("enc_anatomy1", "enc_anatomy2", "segmentor")
    _assert_trees_close(_trees(model, bn, "batch_stats"),
                        {n: ref_state["batch_stats"][n] for n in bn}, 1e-6)
    for n in GEN:
        floor = 1e-5 * np.abs(_flat(ref[n])).max()
        for (path, g), (_, r), (_, s1), (_, s2) in zip(
                _leaves(got[n]), _leaves(ref[n]), _leaves(spread[0][n]), _leaves(spread[1][n]),
                strict=True):
            tol = (2 * max(np.abs(s1 - r).max(), np.abs(s2 - r).max())
                   + 1e-4 * np.abs(r).max() + floor)
            assert np.abs(g - r).max() <= tol, "%s%s: %.3g > %.3g" % (
                n, path, np.abs(g - r).max(), tol)
    r = _flat(ref)
    jax_l2 = min(np.linalg.norm(_flat(s) - r) for s in spread) / np.linalg.norm(r)
    assert np.linalg.norm(_flat(got) - r) / np.linalg.norm(r) <= jax_l2


# gen_loss's metrics as sums of loss terms (models/mmsdnet.py:218-262)
_TERMS = {"supervised_Mask": "restricted_dice_loss", "adv_M": "lsgan_fool", "rec_X": "mae",
          "KL": "ypred_loss"}


@functools.lru_cache(maxsize=None)
def _jax_terms(supervised, dtype):
    """(metrics, {metric: the values of its terms}) of JAX's gen_loss at
    compute dtype `dtype`, the terms recorded from the loss functions it
    calls while it is traced."""
    _, batch, key, disc = _jax_gen_loss(supervised)
    jmodel = build_jax_model(dataclasses.replace(JCONF, compute_dtype=dtype))
    originals = {name: getattr(jlosses, name) for name in _TERMS.values()}

    def traced(g, d):
        seen = {name: [] for name in originals}

        def recording(name):
            def f(*args):
                out = originals[name](*args)
                seen[name].append(out)
                return out
            return f

        try:
            for name in seen:
                setattr(jlosses, name, recording(name))
            _, (metrics, _) = jmodel.gen_loss(g, d, STATE, batch, key, supervised)
        finally:
            for name, f in originals.items():
                setattr(jlosses, name, f)
        return metrics, {k: jnp.stack(seen[name]) for k, name in _TERMS.items()}

    metrics, terms = jax.jit(traced)({k: PARAMS[k] for k in GEN}, disc)
    return ({k: float(v) for k, v in metrics.items()},
            {k: np.asarray(v, np.float64) for k, v in terms.items()})


@pytest.mark.parametrize("supervised", [True, False])
def test_gen_loss_bf16_matches_jax(supervised):
    """compute dtype bfloat16: each metric within 3 times JAX's own
    bf16-to-f32 relative gap of JAX's bf16 value, or 5e-3 relative,
    whichever is larger; the loss f32, every generator gradient finite and
    f32, every parameter f32.

    Each metric is a sum of six (or three) terms, one a map of the VAE,
    segmentor, decoder or discriminator call, and the bf16 anatomies that
    feed them round the other way at about 1 % of their pixels in either
    framework (bf16 softmax values reach 0.5). The terms' moves from f32
    partly cancel in JAX's own sum, so the sum's gap understates it: here
    the gap is taken term by term, sum_i |bf16_i - f32_i| / |f32 sum|
    (and, for the loss, over all terms with their weights), from the
    terms JAX's own run computes."""
    _, batch, key, _ = _jax_gen_loss(supervised)
    (ref32, t32), (ref16, t16) = _jax_terms(supervised, "float32"), _jax_terms(supervised,
                                                                              "bfloat16")
    weights = {"supervised_Mask": JCONF.w_sup_M, "adv_M": JCONF.w_adv_M, "rec_X": JCONF.w_rec_X,
               "KL": JCONF.w_kl}
    gap = {}
    for k in _TERMS:
        np.testing.assert_allclose(t32[k].sum(), ref32[k], rtol=1e-5, err_msg=k)
        gap[k] = np.abs(t16[k] - t32[k]).sum() / abs(t32[k].sum())
    gap["loss"] = sum(weights[k] * np.abs(t16[k] - t32[k]).sum() for k in _TERMS) / abs(
        ref32["loss"])
    model = _model(dataclasses.replace(TCONF, compute_dtype="bfloat16")).train()
    total, metrics = model.gen_loss({k: torch.tensor(v) for k, v in batch.items()}, _eps(key),
                                    supervised)
    assert total.dtype == torch.float32
    assert sorted(metrics) == sorted(ref16)
    for k, v in metrics.items():
        want = ref16[k]
        bound = max(3 * max(gap[k], abs(want / ref32[k] - 1.0)), 5e-3)
        assert abs(float(v.detach()) / want - 1.0) <= bound, (k, float(v.detach()), want, bound)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    grads = [g for g in torch.autograd.grad(total, model.component_parameters(GEN),
                                            allow_unused=True) if g is not None]
    assert grads and all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                         for g in grads)


# ---------------------------------------------------------------- Z-regressor

def test_z_regressor_anatomies_loss_and_gradients_match_jax():
    """The six eval-mode anatomies (the two fusion directions in one fuser
    call here, two in JAX): the encoders' rounded maps equal, the warped
    ones within 1e-4. z_regressor_loss on JAX's anatomies: the loss at
    1e-5 relative, the decoder's and the modality encoder's gradients
    within 1e-4 of each leaf's largest entry (the z_log_var head, which
    the loss does not reach, gets 0 on both sides)."""
    gen = _batch(41)[0]
    ref_s = jax.jit(lambda a, b: JMODEL.make_z_regressor_anatomies(PARAMS, STATE, a, b))(
        gen["x1"], gen["x2"])
    model = _model().eval()
    check_ties = tie_guard(model, TIE_MARGIN)
    got_s = model.make_z_regressor_anatomies(torch.tensor(gen["x1"]), torch.tensor(gen["x2"]))
    check_ties()
    for i, (a, r) in enumerate(zip(got_s, ref_s, strict=True)):
        if i < 2:
            np.testing.assert_array_equal(nhwc(a), np.asarray(r))
        else:
            np.testing.assert_allclose(nhwc(a), np.asarray(r), atol=1e-4, err_msg=str(i))

    r = np.random.RandomState(5)
    z_list = [r.randn(B, NZ).astype(np.float32) for _ in range(6)]
    other = {k: v for k, v in PARAMS.items() if k not in ZREG}
    (ref_loss, (ref_met, _)), ref_g = jax.jit(jax.value_and_grad(
        lambda zp, s, z: JMODEL.z_regressor_loss(zp, other, STATE, s, z, jax.random.PRNGKey(2)),
        has_aux=True))({k: PARAMS[k] for k in ZREG}, ref_s, z_list)
    total, metrics = model.train().z_regressor_loss([nchw(s) for s in ref_s],
                                                    [torch.tensor(z) for z in z_list])
    np.testing.assert_allclose(float(total.detach()), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["rec_Z"].detach()), float(ref_met["rec_Z"]),
                               rtol=1e-5)
    _assert_grads_close(_grads(model, ZREG, total), ref_g, 1e-4)
    assert not _flat(ref_g["enc_modality"]["z_log_var"]).any()


# --------------------------------------------------------- discriminator

def test_d_mask_pool_loss_and_gradients_match_jax():
    """The fake pool from the JAX key's slot draw (jax.random.randint over
    the four variants), the loss at 1e-5 relative, d_mask's gradients
    within 1e-5 of each leaf's largest entry, the new u at 1e-5."""
    _, disc = _batch(42)
    key = jax.random.PRNGKey(9)
    other = {k: v for k, v in PARAMS.items() if k != "d_mask"}
    (ref_loss, (_, ref_state)), ref_g = jax.jit(jax.value_and_grad(
        lambda d: JMODEL.d_mask_loss(d, other, STATE, disc, key), has_aux=True))(
            {"d_mask": PARAMS["d_mask"]})
    idx = torch.from_numpy(np.array(jax.random.randint(key, (B,), 0, 4)))
    model = _model().eval()
    check_ties = tie_guard(model, TIE_MARGIN)
    fake = model.make_fake_masks(torch.tensor(disc["dx1"]), torch.tensor(disc["dx2"]), idx)
    check_ties()
    assert tuple(fake.shape) == (B,) + HW + (NM,)
    loss, metrics = model.d_mask_loss(torch.tensor(disc["dm"][..., :NM]), fake)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    assert metrics["dis_M"] is loss
    _assert_grads_close(_grads(model, ["d_mask"], loss), ref_g, 1e-5)
    _assert_trees_close(_trees(model, ["d_mask"], "spectral"),
                        {"d_mask": ref_state["spectral"]["d_mask"]}, 1e-5)


# ---------------------------------------------------------------- inference

@pytest.mark.parametrize("fusion", ["simple", "def", "max", "maxnostn"])
def test_predict_mask_matches_jax(fusion):
    """Both modalities, each fusion type: within 1e-4 of JAX's
    predict_mask (slice 1's bound), every anatomy value the port rounds
    kept from 0.5."""
    r = np.random.RandomState(21)
    images = [_images(r, 3) for _ in range(2)]
    model = _model()
    check_ties = tie_guard(model, TIE_MARGIN)
    for idx in (0, 1):
        ref = np.asarray(JMODEL.predict_mask(PARAMS, STATE, idx, fusion, images))
        got = model.predict_mask(idx, fusion, images, device="cpu").numpy()
        assert got.shape == ref.shape == (3,) + HW + (NM + 1,)
        np.testing.assert_allclose(got, ref, atol=1e-4, err_msg="%d %s" % (idx, fusion))
    check_ties()
    with pytest.raises(ValueError, match="fusion_type"):
        model.predict_mask(0, "mean", images, device="cpu")


# ------------------------------------------------------------------ steps

def _jax_ts(params=PARAMS):
    jts = jcreate_state(JMODEL, JCONF, jax.random.PRNGKey(0))
    return jts.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                       model_state=jax.tree_util.tree_map(jnp.asarray, STATE))


def _gen_noise(jts):
    """The generator step's key splits (train/steps.py:237-276)."""
    rng = jax.random.fold_in(jts.rng, jts.step)
    r_aug, r_gen, r_z, _ = jax.random.split(rng, 4)
    return {"angles": [np.array(jangles(r_aug, B, JCONF.rotation_range))],
            "gen_eps": jax_sample_eps(PARAMS, r_gen, 6 * B, HW),
            "zreg_z": [np.array(jax.random.normal(jax.random.fold_in(r_z, i), (B, NZ)))
                       for i in range(6)]}


def _disc_noise(jts):
    """The discriminator step's key splits (train/steps.py:284-295)."""
    r_aug, r_dm = jax.random.split(jax.random.fold_in(jts.rng, jts.step))
    return {"angles": [np.array(jangles(k, B, JCONF.rotation_range))
                       for k in (r_aug, jax.random.fold_in(r_aug, 1))],
            "pool_idx": np.array(jax.random.randint(r_dm, (B,), 0, 4))}


def _sync_from_jax(model, tts, jts):
    params, state = jax.tree_util.tree_map(np.array, (jts.params, jts.model_state))
    load_jax_weights(model, params, state)
    set_adam(tts.opt_gen, model, GEN, jts.opt_gen[0])
    set_adam(tts.opt_zreg, model, ZREG, jts.opt_zreg[0])
    set_adam(tts.opt_disc["d_mask"], model, ("d_mask",), jts.opt_disc["d_mask"][0])
    tts.step = int(jts.step)


def test_each_step_matches_jax_from_the_same_state():
    """step_supervised, step_unsupervised and step_discriminator in turn;
    before each, the port takes the JAX train state as it stands
    (parameters, statistics, u, all three Adams' moments and counts).
    Metrics at 1e-5 relative (rec_Z and dis_M read the just-updated
    generator: 2e-3, the expert test's bound for what follows an update);
    statistics and u after each step at 1e-5; no parameter beyond 2.1 lr.

    A generator step is two Adam updates in a row: the Z-regressor's
    gradient is taken on the anatomies of the updated generator, and a
    first Adam step is lr * sign(g), so its near-zero gradient entries can
    take either sign, as in the expert test's chained steps. The share of
    parameters beyond 0.2 lr is held, as there, within twice the share by
    which JAX's own step moves under a +-1e-6 move of LocNet's last bias,
    plus 0.1 % (and at least the one-update bound, 0.5 %). Both Adams of
    the decoder and the modality encoder advance.

    The three steps run six anatomy heads a batch: at the module's weights
    one of their values came within 8e-5 of 0.5, inside the tie guard's
    margin, so both heads are sharpened twice more here."""
    params = dict(PARAMS)
    for name in ("enc_anatomy1", "enc_anatomy2"):
        params[name] = jax.tree_util.tree_map(np.array, PARAMS[name])
        params[name]["conv_anatomy"]["kernel"] *= 2.0
    jsteps = JSteps(JMODEL, JCONF)
    jts = _jax_ts(params)
    model = _model()
    check_ties = tie_guard(model, TIE_MARGIN)
    tts = create_train_state(model, TCONF)
    tsteps = MMSDNetSteps(model, TCONF)
    gen, disc = _batch(74)
    unsup = {k: v for k, v in gen.items() if k != "m2"}
    names = GEN + DISC

    def params_of(state):
        p = jax.tree_util.tree_map(np.array, state.params)
        return _flat({n: p[n] for n in names})

    for kind, batch, noise_of in (("supervised", gen, _gen_noise),
                                  ("unsupervised", unsup, _gen_noise),
                                  ("discriminator", disc, _disc_noise)):
        _sync_from_jax(model, tts, jts)
        noise = noise_of(jts)
        step = getattr(jsteps, "step_" + kind)
        # the step donates its state: each perturbed run gets copies
        moved = [step(jax.tree_util.tree_map(jnp.copy, jts).replace(
            params=jax.tree_util.tree_map(jnp.asarray, _perturbed(
                jax.tree_util.tree_map(np.array, jts.params), d))), batch)[0]
            for d in (PERTURBATION, -PERTURBATION)]
        jts, jmet = step(jts, batch)
        tts, tmet = getattr(tsteps, "step_" + kind)(tts, batch, noise)
        assert sorted(tmet) == sorted(jmet)
        for k in tmet:
            rtol = 2e-3 if k in ("rec_Z", "dis_M") else 1e-5
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=rtol,
                                       err_msg="%s %s" % (kind, k))
        _, state = jax.tree_util.tree_map(np.array, (jts.params, jts.model_state))
        for col in ("batch_stats", "spectral"):
            _assert_trees_close(_trees(model, list(state[col]), col), state[col], 1e-5)
        ref = params_of(jts)
        d = np.abs(_flat(_trees(model, names, "params")) - ref)
        jax_share = max((np.abs(params_of(m) - ref) > 0.2 * LR).mean() for m in moved)
        share = (d > 0.2 * LR).mean()
        assert d.max() <= 2.1 * LR and share <= max(5e-3, 2 * jax_share + 1e-3), \
            "%s: max %.3g lr, share %.3g (JAX %.3g)" % (kind, d.max() / LR, share, jax_share)
    check_ties()
    assert tts.step == int(jts.step) == 3
    dec = next(model.decoder.parameters())
    assert tts.opt_gen.state[dec]["step"] == tts.opt_zreg.state[dec]["step"] == 2


# --------------------------------------------------------------- executor

def _confs(folder, **kw):
    out = []
    for conf in (jconfig.tiny_test_config("mmsdnet"), tconfig.tiny_test_config("mmsdnet")):
        conf.dataset_name = conf.test_dataset = "synthetic"
        conf.folder = str(folder)
        for k, v in kw.items():
            setattr(conf, k, v)
        out.append(conf)
    return out


@pytest.mark.parametrize("l_mix,steps", [(0.0, 2), (0.5, 3)])
def test_executor_epoch_step_counts(tmp_path, l_mix, steps):
    """One epoch of one batch (tests/test_executor_variants.py:41-51): at
    l_mix 0 the unsupervised step and the discriminator step, at 0.5 both
    generator steps and the discriminator step; the artifacts of the live
    weights: seven component files, no d_image histograms, the 4-metric
    validation in training.csv; the first step batches equal the JAX
    executor's."""
    jconf, conf = _confs(tmp_path / "ex", l_mix=l_mix, epochs=1, steps_per_epoch=1)
    ex = make_executor(conf, build_model(conf, device="cpu"), device="cpu")
    assert isinstance(ex, MMSDNetExecutor)
    ts = ex.train()
    assert ts.step == steps
    assert sorted(os.listdir(os.path.join(conf.folder, "models"))) == sorted(
        "%s.npz" % n for n in GEN + DISC)
    images = os.path.join(conf.folder, "training_images")
    for name in ("anatomies", "segmentations", "reconstructions", "discriminator"):
        assert os.path.exists(os.path.join(images, "%s_epoch_000.png" % name)), name
    assert not os.path.exists(os.path.join(images, "discriminator_image_epoch_000.png"))
    with open(os.path.join(conf.folder, "training.csv")) as f:
        row = list(csv.DictReader(f))[-1]
    assert {"rec_Z", "dis_M", "val_loss_mod2_s1def", "val_loss"} <= set(row)
    assert not any(k.startswith("val_weight") or k == "val_loss_mod1_fused" for k in row)

    jex = JExecutor(jconf, JMODEL)
    jex.init_train_data()
    ex.init_train_data()
    j, t = next(jex._assembled_batches()), next(ex.train_data.assembled_batches())
    assert sorted(j) == sorted(t)
    for path in j:
        assert sorted(j[path]) == sorted(t[path])
        for k in j[path]:
            np.testing.assert_array_equal(t[path][k], j[path][k], err_msg="%s %s" % (path, k))


def test_validate_matches_jax(tmp_path):
    """The four validation logs and val_loss, on the live weights, within
    1e-3 of JAX's MMSDNetExecutor.validate on the same weights."""
    jconf, tconf = _confs(tmp_path)
    ref = JExecutor(jconf, JMODEL).validate(_jax_ts())
    ex = MMSDNetExecutor(tconf, _model(tconf), device="cpu")
    got = ex.validate(create_train_state(ex.model, tconf))
    assert sorted(got) == sorted(ref) and len(got) == 5
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-3, (k, got[k], ref[k])


def test_checkpoint_resume_restores_the_z_regressor_adam(tmp_path):
    """After one epoch a new executor restores the Z-regressor's Adam (its
    moments and step), with the other optimizers, the model and the step
    count, bit for bit, and continues at epoch 1."""
    _, conf = _confs(tmp_path / "resume", epochs=1, steps_per_epoch=1,
                     image_callback_interval=100)
    first = make_executor(conf, build_model(conf, device="cpu"), device="cpu")
    ts = first.train()
    saved = {"zreg": ts.opt_zreg.state_dict(), "gen": ts.opt_gen.state_dict(),
             "model": {k: v.clone() for k, v in ts.model.state_dict().items()}}
    assert all(st["step"] == 1 for st in saved["zreg"]["state"].values())
    conf.epochs = 2
    second = make_executor(conf, build_model(conf, device="cpu"), device="cpu")
    restored, start = second.create_state()
    assert start == 1 and restored.step == ts.step == 2
    for name, opt in (("zreg", restored.opt_zreg), ("gen", restored.opt_gen)):
        got = opt.state_dict()
        assert got["state"].keys() == saved[name]["state"].keys()
        for i, st in saved[name]["state"].items():
            for k, v in st.items():
                assert torch.equal(torch.as_tensor(got["state"][i][k]), torch.as_tensor(v)), (name, k)
    for k, v in saved["model"].items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    params = {id(p) for p in second.model.parameters()}
    assert all(id(p) in params for g in restored.opt_zreg.param_groups for p in g["params"])
    second.train()
    assert second.final_state.step == 4


def test_cli_trains_and_tests_mmsdnet(monkeypatch, tmp_path):
    """`--config mmsdnet_config_chaos` through the CLI at the tiny size (the
    preset with the tiny config's widths), one epoch of two batches then
    `--test` on the same folder: MMSDNet, 12 results.csv, the last
    checkpoint restored."""
    def tiny():
        return dataclasses.replace(tconfig.tiny_test_config("mmsdnet"), folder="mmsdnet_chaos",
                                   w_rec_X=10.0, steps_per_epoch=2)

    monkeypatch.setitem(tconfig.PRESETS, "mmsdnet_config_chaos", tiny)
    monkeypatch.chdir(tmp_path)
    flags = ["--config", "mmsdnet_config_chaos", "--split", "0", "--dataset", "synthetic",
             "--test_dataset", "synthetic", "--device", "cpu", "--epochs", "1"]
    ex = experiment.Experiment().run(flags)
    assert isinstance(ex.model, MMSDNet) and ex.final_state.step == 4
    folder = tmp_path / "mmsdnet_chaos_l1_t1_t2_split0"
    results = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(folder) for f in fs
                     if f == "results.csv")
    assert len(results) == 12
    ex = experiment.Experiment().run(flags + ["--test"])
    assert ex.final_state.step == 4 and ex.final_state.opt_zreg is not None
