"""CPU parity of DAFNet's automated pairing with the JAX package, at the tiny
config, on the seeded weights of tests/torch_parity.py (the anatomy head
sharpened as in tests/test_torch_dafnet_train.py): the per-sample losses,
the dual encoder's encode1 / encode2 and its pair_groups BatchNorm,
gen_loss_automated (value, metrics, generator gradients; f32 and bf16), the
batched-equals-per-invocation lock of the port's own components, one whole
automated step from the JAX state, the expand_pairs batches, the balancer's
validation weights, and one CPU epoch through the executor.

Tolerances are those of the expert tests: losses and metrics 1e-5
relative; gradients within twice JAX's own spread under small moves of
LocNet's last bias plus 1e-4 of each leaf's largest entry (the moves and
the L2 rule are set by JAX's own spread, measured in the test);
discriminator metrics after a step 2e-3 relative; bf16 within 3x JAX's
own bf16-to-f32 gap. Every f32
test asserts that no anatomy softmax value the port rounds lies within
1e-4 of 0.5.
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
from multimodal_segmentation_tpu.ops.batching import batch_deinterleave as jbatch_deinterleave
from multimodal_segmentation_tpu.ops.batching import batch_interleave as jbatch_interleave
from multimodal_segmentation_tpu.ops.augment import random_rotation_angles as jangles
from multimodal_segmentation_tpu.train.executor import DAFNetExecutor as JExecutor
from multimodal_segmentation_tpu.train.state import create_train_state as jcreate_state
from multimodal_segmentation_tpu.train.steps import DAFNetSteps as JSteps
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch import losses
from multimodal_segmentation_torch.models import build_model
from multimodal_segmentation_torch.ops.batching import batch_deinterleave, batch_interleave
from multimodal_segmentation_torch.train import DAFNetSteps, create_train_state
from multimodal_segmentation_torch.train.executor import DAFNetExecutor, make_executor
from multimodal_segmentation_torch.utils.convert import component_trees
from torch_parity import jax_dafnet, jax_sample_eps, nchw, nhwc, tie_guard, torch_dafnet

torch.set_num_threads(1)

JCONF = dataclasses.replace(jconfig.tiny_test_config(), automatedpairing=True)
TCONF = dataclasses.replace(tconfig.tiny_test_config(), automatedpairing=True)
JMODEL, PARAMS, STATE = jax_dafnet(JCONF, jit_init=True)
PARAMS["enc_anatomy"]["conv_anatomy"]["kernel"] *= 20.0
B, HW, NM, NZ, K = JCONF.batch_size, JCONF.input_hw, JCONF.num_masks, JCONF.num_z, JCONF.n_pairs
GEN, DISC = JMODEL.GEN_COMPONENTS, JMODEL.DISC_COMPONENTS
LR = JCONF.lr
TIE_MARGIN = 1e-4
PERTURBATION = 1e-6  # on LocNet's last bias: ~3e-5 px of sample location


def _masks(r, n=B):
    lab = r.randint(0, NM + 1, size=(n,) + HW)
    return (lab[..., None] == np.arange(NM)).astype(np.float32)


def _images(r, c=1, n=B):
    return (r.rand(n, *HW, c) * 2 - 1).astype(np.float32)


def _batch(seed):
    """An automated batch as the executor assembles it: K candidate slices
    a modality, one-hot masks without the residual channel, the pools."""
    r = np.random.RandomState(seed)
    return {"x1_pairs": _images(r, K), "x2_pairs": _images(r, K), "m1": _masks(r),
            "m2": _masks(r), "dm1": _masks(r), "dm2": _masks(r), "dx1": _images(r),
            "dx2": _images(r)}


def _gen_batch(seed, supervised):
    b = _batch(seed)
    r = np.random.RandomState(seed + 100)
    b["m1"] = np.asarray(jadd_residual(b["m1"]))
    b["m2"] = np.asarray(jadd_residual(b["m2"]))
    if not supervised:
        del b["m2"]
    b["z1"] = r.randn(B, NZ).astype(np.float32)
    b["z2"] = r.randn(B, NZ).astype(np.float32)
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


def _tensors(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


# ------------------------------------------------------- per-sample losses

def test_perbatch_losses_match_jax():
    """combined_dice_bce_perbatch (B,) and mae_perbatch (B, C), the shapes
    the automated loss weights sample by sample, at 1e-6 absolute."""
    r = np.random.RandomState(1)
    m_t = np.asarray(jadd_residual(_masks(r, 3)))
    logits = r.randn(3, *HW, NM + 1).astype(np.float32)
    m_p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ref = np.asarray(jlosses.combined_dice_bce_perbatch(m_t, m_p, NM))
    got = losses.combined_dice_bce_perbatch(torch.tensor(m_t), torch.tensor(m_p), NM)
    assert tuple(got.shape) == ref.shape == (3,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    bce = np.asarray(jlosses._reference_weighted_bce_perbatch(m_t, m_p))
    np.testing.assert_allclose(
        losses._reference_weighted_bce_perbatch(torch.tensor(m_t), torch.tensor(m_p)).numpy(),
        bce, rtol=1e-5)
    a, b = _images(r, 2, 3), _images(r, 2, 3)
    ref = np.asarray(jlosses.mae_perbatch(a, b))
    got = losses.mae_perbatch(torch.tensor(a), torch.tensor(b))
    assert tuple(got.shape) == ref.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


# --------------------------------------------------------- dual encoder

def test_encode1_encode2_match_jax():
    """Eval mode (running statistics): each modality alone through its
    private path and the shared one, rounded anatomies equal to JAX's."""
    r = np.random.RandomState(2)
    x1, x2 = _images(r, n=3), _images(r, n=3)
    model = torch_dafnet(TCONF, PARAMS, STATE).eval()
    check_ties = tie_guard(model, TIE_MARGIN)
    for method, x in (("encode1", x1), ("encode2", x2)):
        ref, _, _ = JMODEL.components.apply("enc_anatomy", PARAMS, STATE, x, method=method)
        got = getattr(model.enc_anatomy, method)(nchw(x))
        np.testing.assert_array_equal(nhwc(got), np.asarray(ref), err_msg=method)
        assert 0 < float(got.detach().sum()) < got.numel()
    check_ties()


def test_pair_groups_batchnorm_matches_jax():
    """Train mode with pair_groups = K: the K interleaved candidate pairs in
    one pass, every BatchNorm with per-(pair, modality) statistics; the
    anatomies equal JAX's and the updated running statistics agree at
    1e-6."""
    r = np.random.RandomState(3)
    x1s = [_images(r) for _ in range(K)]
    x2s = [_images(r) for _ in range(K)]
    ref1, ref2, ref_state = jax.jit(lambda a, b: JMODEL.encode_anatomies(
        PARAMS, STATE, a, b, True, True, pair_groups=K))(jbatch_interleave(x1s),
                                                         jbatch_interleave(x2s))
    x1 = batch_interleave([torch.tensor(x) for x in x1s])
    x2 = batch_interleave([torch.tensor(x) for x in x2s])
    model = torch_dafnet(TCONF, PARAMS, STATE).train()
    check_ties = tie_guard(model, TIE_MARGIN)
    s1, s2 = model.enc_anatomy(x1.permute(0, 3, 1, 2), x2.permute(0, 3, 1, 2), pair_groups=K)
    check_ties()
    np.testing.assert_array_equal(nhwc(s1), np.asarray(ref1))
    np.testing.assert_array_equal(nhwc(s2), np.asarray(ref2))
    got = component_trees(model.enc_anatomy.state_dict())["batch_stats"]
    for (path, a), (_, b) in zip(_leaves(got), _leaves(ref_state["batch_stats"]["enc_anatomy"]),
                                 strict=True):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=path)


def test_batched_equals_per_invocation():
    """The port's lock of tests/test_models.py::
    test_automated_batched_equals_per_invocation: the dual encoder with
    pair_groups = K against K dual-encoder calls, the one 2K-wide fuse
    against per-pair fuses, the grouped segmentor against per-map calls
    (train mode), and the balancer over both directions against each
    direction alone."""
    r = np.random.RandomState(11)
    model = torch_dafnet(TCONF, PARAMS, STATE).train()
    check_ties = tie_guard(model, TIE_MARGIN)
    x1s = [nchw(_images(r)) for _ in range(K)]
    x2s = [nchw(_images(r)) for _ in range(K)]
    with torch.no_grad():
        sa, sb = model.enc_anatomy(batch_interleave(x1s), batch_interleave(x2s), pair_groups=K)
        sa, sb = batch_deinterleave(sa, K), batch_deinterleave(sb, K)
        for j in range(K):
            a, b = model.enc_anatomy(x1s[j], x2s[j])
            np.testing.assert_allclose(sa[j].numpy(), a.numpy(), atol=1e-5)
            np.testing.assert_allclose(sb[j].numpy(), b.numpy(), atol=1e-5)
        s1, s2 = sa[0], sb[0]
        defs, _ = model.fuser(batch_interleave(sa + sb), batch_interleave([s2] * K + [s1] * K))
        defs = batch_deinterleave(defs, 2 * K)
        for j in range(K):
            np.testing.assert_allclose(defs[j].numpy(), model.fuser(sa[j], s2)[0].numpy(),
                                       atol=1e-4)
            np.testing.assert_allclose(defs[K + j].numpy(), model.fuser(sb[j], s1)[0].numpy(),
                                       atol=1e-4)
        stack = [s1, s2] + defs[K:] + defs[:K]
        m_all = batch_deinterleave(model.segmentor(batch_interleave(stack), groups=2 + 2 * K),
                                   2 + 2 * K)
        for j, s in enumerate(stack):
            np.testing.assert_allclose(m_all[j].numpy(), model.segmentor(s).numpy(), atol=1e-5)
        w = batch_deinterleave(model.balancer(
            batch_interleave([s2, s1]),
            [batch_interleave([defs[j], defs[K + j]]) for j in range(K)]), 2)
        np.testing.assert_allclose(w[0].numpy(), model.balancer(s2, defs[:K]).numpy(), atol=1e-6)
        np.testing.assert_allclose(w[1].numpy(), model.balancer(s1, defs[K:]).numpy(), atol=1e-6)
    check_ties()
    assert float(defs[0].abs().sum()) > 0


# ------------------------------------------------------------ generator loss

@functools.lru_cache(maxsize=None)
def _jax_gen_loss(supervised, bf16=False):
    jmodel = build_jax_model(dataclasses.replace(JCONF, compute_dtype="bfloat16")) if bf16 \
        else JMODEL
    batch = _gen_batch(40, supervised)
    key = jax.random.PRNGKey(7)
    disc = {k: PARAMS[k] for k in DISC}

    def f(g, d):
        return jmodel.gen_loss_automated(g, d, STATE, batch, key, supervised)

    fn = jax.jit(f if bf16 else jax.value_and_grad(f, has_aux=True))
    return fn, batch, key, disc


def _torch_loss(conf, batch, key, supervised, train=True):
    model = torch_dafnet(conf, PARAMS, STATE).train(train)
    eps = torch.from_numpy(jax_sample_eps(PARAMS, jax.random.split(key, 4)[0], 2 * B, HW))
    return model, model.gen_loss_automated(_tensors(batch), eps, supervised)


@pytest.mark.parametrize("supervised", [True, False])
def test_gen_loss_automated_and_gradients_match_jax(supervised):
    """Loss and metrics at 1e-5 relative; the running statistics the loss
    updates at 1e-6. The balancer, which the expert loss does not reach,
    gets a gradient here.

    Gradients. The automated loss is more sensitive to the frameworks'
    ~3e-5 px location gap than the expert loss: the balancer's Dice
    overlaps of warped anatomies weight every cross term. JAX's spread is
    measured under four moves of LocNet's last bias, +-1e-6 and +-2e-6
    (3e-5 and 6e-5 px, once and twice the gap). Each generator leaf lies
    within twice the largest of them plus 1e-4 of its largest entry and
    1e-5 of its component's largest (the conv biases ahead of a BatchNorm
    have a gradient of roundoff size). Measured: a BatchNorm bias of
    down2 lies 0.030 from JAX, 1.5 times twice JAX's +-1e-6 spread and
    0.6 times twice the four-move one. The whole vector lies within the
    larger relative L2 of JAX's +-1e-6 runs (measured: the port 5.4e-3,
    JAX 5.3e-3 and 6.4e-3; the expert test takes the smaller)."""
    fn, batch, key, disc = _jax_gen_loss(supervised)
    (_, (ref_metrics, ref_state)), ref = fn({k: PARAMS[k] for k in GEN}, disc)
    spread = [fn({k: p[k] for k in GEN}, disc)[1] for p in
              (_perturbed(PARAMS, d * PERTURBATION) for d in (1, -1, 2, -2))]

    model = torch_dafnet(TCONF, PARAMS, STATE).train()
    check_ties = tie_guard(model, TIE_MARGIN)
    eps = torch.from_numpy(jax_sample_eps(PARAMS, jax.random.split(key, 4)[0], 2 * B, HW))
    total, metrics = model.gen_loss_automated(_tensors(batch), eps, supervised)
    params = {n: dict(getattr(model, n).named_parameters()) for n in GEN}
    grads = iter(torch.autograd.grad(total, [p for n in GEN for p in params[n].values()],
                                     allow_unused=True))
    got = {n: component_trees({k: (g if g is not None else torch.zeros_like(p))
                               for (k, p), g in zip(params[n].items(), grads)})["params"]
           for n in GEN}
    check_ties()

    assert sorted(metrics) == sorted(ref_metrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(ref_metrics[k]),
                                   rtol=1e-5, err_msg=k)
    for n in ("enc_anatomy", "segmentor"):
        got_bs = component_trees(getattr(model, n).state_dict())["batch_stats"]
        for (path, a), (_, b) in zip(_leaves(got_bs), _leaves(ref_state["batch_stats"][n]),
                                     strict=True):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=n + path)
    for n in GEN:
        floor = 1e-5 * np.abs(_flat(ref[n])).max()
        for (path, g), (_, r), *moved in zip(_leaves(got[n]), _leaves(ref[n]),
                                             *(_leaves(s[n]) for s in spread), strict=True):
            tol = (2 * max(np.abs(m - r).max() for _, m in moved)
                   + 1e-4 * np.abs(r).max() + floor)
            assert np.abs(g - r).max() <= tol, "%s%s: %.3g > %.3g" % (
                n, path, np.abs(g - r).max(), tol)
    r = _flat(ref)
    jax_l2 = max(np.linalg.norm(_flat(s) - r) for s in spread[:2]) / np.linalg.norm(r)
    assert np.linalg.norm(_flat(got) - r) / np.linalg.norm(r) <= jax_l2
    assert np.abs(_flat(ref["balancer"])).max() > 0


@functools.lru_cache(maxsize=None)
def _jax_adv_m_parts(dtype):
    """The four lsgan terms that sum to JAX's adv_M in gen_loss_automated
    (models/dafnet.py:428-434) at compute dtype `dtype`: the mask
    discriminator on m1, m2, m1_def_0 and m2_def_0, recomputed stage by
    stage as the loss computes them (they depend on the images only)."""
    jmodel = build_jax_model(dataclasses.replace(JCONF, compute_dtype=dtype))
    return np.asarray(jax.jit(functools.partial(_adv_m_parts, jmodel))(
        PARAMS, _gen_batch(40, True)))


def _adv_m_parts(jmodel, P, batch):
    x1s = [batch["x1_pairs"][..., i : i + 1] for i in range(K)]
    x2s = [batch["x2_pairs"][..., i : i + 1] for i in range(K)]
    sa, sb, st = jmodel.encode_anatomies(P, STATE, jbatch_interleave(x1s),
                                         jbatch_interleave(x2s), True, True, pair_groups=K)
    s1s, s2s = jbatch_deinterleave(sa, K), jbatch_deinterleave(sb, K)
    s_def, _ = jmodel.fuse(P, st, jbatch_interleave(s1s + s2s),
                           jbatch_interleave([s2s[0]] * K + [s1s[0]] * K), True)
    defs = jbatch_deinterleave(s_def, 2 * K)
    m, _ = jmodel.segment(P, st, jbatch_interleave([s1s[0], s2s[0]] + defs[K:] + defs[:K]),
                          True, True, groups=2 + 2 * K)
    m = jbatch_deinterleave(m, 2 + 2 * K)
    adv = jmodel.discriminate(P, st, "d_mask",
                              jbatch_interleave([m[0], m[1], m[2], m[2 + K]])[..., :NM])
    return jnp.stack([jlosses.lsgan_fool(a) for a in jbatch_deinterleave(adv, 4)])


@pytest.mark.parametrize("supervised", [True, False])
def test_gen_loss_automated_bf16_matches_jax(supervised):
    """compute dtype bfloat16: each metric within 3 times JAX's own
    bf16-to-f32 relative gap of JAX's bf16 value, or 5e-3 relative,
    whichever is larger (the expert test's bound); the loss f32, every
    generator gradient finite and f32, every parameter f32.

    adv_M is a sum of four discriminator terms, and the bf16 anatomies
    that feed them round the other way at 0.4-1.0 % of their pixels, in
    either framework (bf16 softmax values reach 0.5). In JAX's own run the
    four terms move by 0.7-4 % from f32 but their sum by 0.02 %: the gap
    of the sum understates it. So adv_M's gap is taken term by term,
    sum_i |bf16_i - f32_i| / f32 (measured 2.4 %; the port's bf16 adv_M
    lies 1.7 % from JAX's)."""
    fn32, batch, key, disc = _jax_gen_loss(supervised)
    (_, (ref32, _)), _ = fn32({k: PARAMS[k] for k in GEN}, disc)
    fn16 = _jax_gen_loss(supervised, bf16=True)[0]
    loss16, (ref16, _) = fn16({k: PARAMS[k] for k in GEN}, disc)
    assert loss16.dtype == jnp.float32
    parts32, parts16 = _jax_adv_m_parts("float32"), _jax_adv_m_parts("bfloat16")
    np.testing.assert_allclose(parts32.sum(), float(ref32["adv_M"]), rtol=1e-5)
    gap = {k: abs(float(ref16[k]) / float(ref32[k]) - 1.0) for k in ref16}
    gap["adv_M"] = max(gap["adv_M"], np.abs(parts16 - parts32).sum() / parts32.sum())

    conf = dataclasses.replace(TCONF, compute_dtype="bfloat16")
    model, (total, metrics) = _torch_loss(conf, batch, key, supervised)
    assert total.dtype == torch.float32
    assert sorted(metrics) == sorted(ref16)
    for k, v in metrics.items():
        want = float(ref16[k])
        bound = max(3 * gap[k], 5e-3)
        assert abs(float(v.detach()) / want - 1.0) <= bound, (k, float(v.detach()), want, bound)
    params = model.component_parameters(GEN)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    grads = [g for g in torch.autograd.grad(total, params, allow_unused=True) if g is not None]
    assert grads and all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                         for g in grads)


# -------------------------------------------------------------- full step

def _jax_ts():
    jts = jcreate_state(JMODEL, JCONF, jax.random.PRNGKey(0))
    return jts.replace(params=jax.tree_util.tree_map(jnp.asarray, PARAMS),
                       model_state=jax.tree_util.tree_map(jnp.asarray, STATE))


def _step_noise(jts):
    """The JAX step's key splits (train/steps.py:120-162) as the port's
    explicit noise: the automated loss draws only the 2B VAE sample, so
    the parts are those of the expert step."""
    rng = jax.random.fold_in(jts.rng, jts.step)
    r_aug1, r_aug2, r_aug3, r_z, r_gen, r_dm, _ = jax.random.split(rng, 7)
    rz1, rz2 = jax.random.split(r_z)
    r = jax.random.split(r_dm, 6)
    return {
        "angles": [np.array(jangles(k, B, JCONF.rotation_range)) for k in (r_aug1, r_aug2, r_aug3)],
        "z1": np.array(jax.random.normal(rz1, (B, NZ))),
        "z2": np.array(jax.random.normal(rz2, (B, NZ))),
        "gen_eps": jax_sample_eps(PARAMS, jax.random.split(r_gen, 4)[0], 2 * B, HW),
        "pool_mask_idx": [np.array(jax.random.randint(r[i], (B,), 0, 2)) for i in (0, 1)],
        "pool_eps": jax_sample_eps(PARAMS, r[2], 2 * B, HW),
        "pool_image_idx": [np.array(jax.random.randint(r[i], (B,), 0, 3)) for i in (4, 5)],
    }


def test_automated_step_matches_jax_from_the_same_state():
    """One step_supervised under automated pairing from the same state on
    both sides (params, statistics, u, fresh Adams), the JAX key splits as
    the port's noise. Generator metrics at 1e-5 relative, discriminator
    metrics 2e-3 (they see the updated generator); the statistics and u
    after the step at 1e-5; parameters move by lr-sized Adam steps: none
    differs by more than 2.1 lr and all but 0.5 % agree within 0.2 lr (the
    expert test's bounds); the balancer moved. The batch is the expert
    test's third (seed 75): at its first (73) an anatomy value of the
    step lies 7.6e-5 from 0.5, inside the tie guard's 1e-4."""
    jsteps = JSteps(JMODEL, JCONF)
    jts = _jax_ts()
    noise = _step_noise(jts)
    batch = _batch(75)
    jts, jmet = jsteps.step_supervised(jts, batch)

    model = torch_dafnet(TCONF, PARAMS, STATE)
    check_ties = tie_guard(model, TIE_MARGIN)
    tts = create_train_state(model, TCONF)
    tts, tmet = DAFNetSteps(model, TCONF).step_supervised(tts, batch, noise)
    check_ties()
    assert sorted(tmet) == sorted(jmet)
    for k in tmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=2e-3 if k.startswith("dis_") else 1e-5, err_msg=k)
    params, state = jax.tree_util.tree_map(np.array, (jts.params, jts.model_state))
    for col in ("batch_stats", "spectral"):
        for n in state[col]:
            got = component_trees(getattr(model, n).state_dict())[col]
            for (path, a), (_, b) in zip(_leaves(got), _leaves(state[col][n]), strict=True):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=n + path)
    mine = {n: component_trees(getattr(model, n).state_dict())["params"] for n in GEN + DISC}
    d = np.abs(_flat(mine) - _flat({n: params[n] for n in GEN + DISC}))
    assert d.max() <= 2.1 * LR and (d > 0.2 * LR).mean() <= 5e-3, \
        "max %.3g lr, share %.3g" % (d.max() / LR, (d > 0.2 * LR).mean())
    assert np.abs(_flat(params["balancer"]) - _flat(PARAMS["balancer"])).max() > 0
    assert tts.step == int(jts.step) == 1


# ---------------------------------------------------------------- executor

def _confs(folder, **kw):
    out = []
    for conf in (jconfig.tiny_test_config(), tconfig.tiny_test_config()):
        conf.dataset_name = conf.test_dataset = "synthetic"
        conf.folder = str(folder)
        conf.automatedpairing = True
        for k, v in kw.items():
            setattr(conf, k, v)
        out.append(conf)
    return out


@pytest.mark.parametrize("l_mix", [1.0, 0.5])
def test_expand_pairs_batches_equal_the_jax_executors(tmp_path, l_mix):
    """The port's automated data path: expand_pairs on the labelled and
    unlabelled data (the neighbours drawn from numpy's global stream,
    seeded alike on both sides), x1_pairs / x2_pairs with n_pairs
    channels, the expert slice first; the first 4 step batches bit-equal
    to the JAX executor's BatchStream arrays."""
    jconf, tconf = _confs(tmp_path, l_mix=l_mix)
    jex = JExecutor(jconf, JMODEL)
    tex = DAFNetExecutor(tconf, build_model(tconf, device="cpu"), device="cpu")
    np.random.seed(5)
    jex.init_train_data()
    np.random.seed(5)
    tex.init_train_data()
    assert tex.batches == jex.batches
    lab = tex.train_data.gen_labelled
    np.testing.assert_array_equal(lab.arrays["x1_pairs"], jex.gen_labelled.arrays["x1_pairs"])
    assert lab.arrays["x1_pairs"].shape[-1] == K
    np.testing.assert_array_equal(lab.arrays["x1_pairs"][..., 0:1],
                                  tex.train_data.data.get_images_modi(0)[..., 0:1])
    jit, tit = jex._assembled_batches(), tex.train_data.assembled_batches()
    for _ in range(4):
        j, t = next(jit), next(tit)
        assert sorted(j) == sorted(t)
        for path in j:
            assert sorted(j[path]) == sorted(t[path])
            assert "x1_pairs" in t[path] and "x1" not in t[path]
            for k in j[path]:
                np.testing.assert_array_equal(t[path][k], j[path][k], err_msg="%s %s" % (path, k))


def test_balancer_validation_weights_match_jax(tmp_path):
    """val_weight_0 .. K-1 on the validation split, on the same live
    weights: each within 1e-5 of JAX's _validate_balancer_weights, summing
    to 1."""
    jconf, tconf = _confs(tmp_path)
    jex = JExecutor(jconf, JMODEL)
    np.random.seed(6)
    ref = jex._validate_balancer_weights(_jax_ts())
    tex = DAFNetExecutor(tconf, torch_dafnet(tconf, PARAMS, STATE), device="cpu")
    np.random.seed(6)
    got = tex.validate_balancer_weights()
    assert sorted(got) == sorted(ref) == ["val_weight_%d" % j for j in range(K)]
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5, (k, got[k], ref[k])
    assert abs(sum(got.values()) - 1.0) <= 1e-5


def test_automated_epoch_through_the_executor(tmp_path):
    """One CPU epoch of one step under automated pairing (the JAX package's
    tests/test_executor_variants.py:53-80): the step count, the image
    callback's four PNGs fed pair 0, and training.csv's val_weight_j
    columns summing to 1."""
    _, conf = _confs(tmp_path / "auto", epochs=1, steps_per_epoch=1, swa_start_epoch=0)
    ex = make_executor(conf, build_model(conf, device="cpu"), device="cpu")
    ex.init_train_data()
    assert ex.train_data.data.get_images_modi(0).shape[-1] == K
    ts = ex.train()
    assert ts.step == 1
    images = os.path.join(conf.folder, "training_images")
    for name in ("anatomies", "segmentations", "reconstructions", "discriminator"):
        assert os.path.exists(os.path.join(images, "%s_epoch_000.png" % name)), name
    with open(os.path.join(conf.folder, "training.csv")) as f:
        row = list(csv.DictReader(f))[-1]
    w = [float(row["val_weight_%d" % j]) for j in range(K)]
    assert abs(sum(w) - 1.0) < 1e-3 and min(w) > 0
