"""CPU parity of the training slice with the JAX package, at the tiny
config, on the seeded weights of tests/torch_parity.py: the expert-pairing
generator loss (value, metrics and the gradient of every generator leaf),
the fake pools, both discriminator losses, and full `step_supervised` /
`step_unsupervised` steps with the JAX key splits replayed as the port's
explicit noise; and, under compute dtype bfloat16, the generator loss
against JAX's bf16 run and two steps of the port's bf16 step.

Rounding. No failure here may come from a round_ste flip: every f32 test
asserts that each anatomy softmax value the port rounds lies farther than
TIE_MARGIN = 1e-4 from 0.5, far beyond the frameworks' ~1e-6 difference
in it. In bf16 the softmax values reach 0.5, and the bounds are JAX's own
bf16-to-f32 gaps instead.

Sensitivity. The two frameworks compute the TPS sample locations in
another f32 order and differ by up to ~3e-5 px (tests/test_torch_ops.py).
The step is sensitive to that: JAX's own generator gradient moves by about
1 % (relative L2) when LocNet's last bias moves by 1e-6, which shifts the
locations by ~3e-5 px (relu and warp-corner kinks), and Adam turns any
gradient into a step of about lr * sign(g). So:
  * single evaluations (loss, metrics, fake pools, discriminator losses)
    are held tight;
  * gradients and chained steps are held to JAX's own spread under that
    1e-6 perturbation (`_perturbed`), a bound measured in the test;
  * each step is also run from the same state on both sides (params,
    statistics, u and the Adam moments copied from JAX), which keeps the
    bound tight for one step.
"""

import collections
import contextlib
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_segmentation_tpu import config as jconfig
from multimodal_segmentation_tpu.models import build_model as build_jax_model
from multimodal_segmentation_tpu.models.base import add_residual as jadd_residual
from multimodal_segmentation_tpu.ops.augment import random_rotation_angles as jangles
from multimodal_segmentation_tpu.train.state import create_train_state as jcreate_state
from multimodal_segmentation_tpu.train.steps import DAFNetSteps as JSteps
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch.train import DAFNetSteps, create_train_state
from multimodal_segmentation_torch.utils.convert import component_trees, load_jax_weights
from torch_parity import jax_dafnet, jax_sample_eps, set_adam, tie_guard, torch_dafnet

torch.set_num_threads(1)

JCONF = jconfig.tiny_test_config()
TCONF = tconfig.tiny_test_config()
JMODEL, PARAMS, STATE = jax_dafnet(JCONF)
# a sharper anatomy head than the inference tests' (x20 on top of
# torch_parity.ANATOMY_GAIN): far fewer softmax values near 0.5, so the
# tie margin holds on every forward of these tests
PARAMS["enc_anatomy"]["conv_anatomy"]["kernel"] *= 20.0
JSTEPS = JSteps(JMODEL, JCONF)
B, HW, NM, NZ = JCONF.batch_size, JCONF.input_hw, JCONF.num_masks, JCONF.num_z
GEN, DISC = JMODEL.GEN_COMPONENTS, JMODEL.DISC_COMPONENTS
LR = JCONF.lr
TIE_MARGIN = 1e-4
STEP_SEEDS = (73, 74, 75)
PERTURBATION = 1e-6  # on LocNet's last bias: ~3e-5 px of sample location


def _masks(r):
    lab = r.randint(0, NM + 1, size=(B,) + HW)
    return (lab[..., None] == np.arange(NM)).astype(np.float32)


def _batch(seed):
    """An expert batch: images in [-1, 1], one-hot masks (label NM =
    background), as the executor assembles them (no residual channel)."""
    r = np.random.RandomState(seed)
    img = lambda: (r.rand(B, *HW, 1) * 2 - 1).astype(np.float32)  # noqa: E731
    return {"x1": img(), "x2": img(), "m1": _masks(r), "m2": _masks(r),
            "dm1": _masks(r), "dm2": _masks(r), "dx1": img(), "dx2": img()}


def _perturbed(params, delta):
    """`params` with LocNet's last bias moved by `delta`."""
    out = dict(params)
    out["fuser"] = jax.tree_util.tree_map(np.array, params["fuser"])
    out["fuser"]["locnet"]["Dense_1"]["bias"] = (
        params["fuser"]["locnet"]["Dense_1"]["bias"] + np.float32(delta))
    return out


def _tie_guard(model):
    return tie_guard(model, TIE_MARGIN)


def _pool_noise(key):
    """make_fake_pools' draws for key r_dm (models/dafnet.py:557-586)."""
    r = jax.random.split(key, 6)
    return {
        "pool_mask_idx": [np.array(jax.random.randint(r[i], (B,), 0, 2)) for i in (0, 1)],
        "pool_eps": jax_sample_eps(PARAMS, r[2], 2 * B, HW),
        "pool_image_idx": [np.array(jax.random.randint(r[i], (B,), 0, 3)) for i in (4, 5)],
    }


def _step_noise(ts):
    """The JAX step's key splits (train/steps.py:120-162) as the port's
    explicit noise."""
    rng = jax.random.fold_in(ts.rng, ts.step)
    r_aug1, r_aug2, r_aug3, r_z, r_gen, r_dm, _ = jax.random.split(rng, 7)
    rz1, rz2 = jax.random.split(r_z)
    noise = {
        "angles": [np.array(jangles(k, B, JCONF.rotation_range)) for k in (r_aug1, r_aug2, r_aug3)],
        "z1": np.array(jax.random.normal(rz1, (B, NZ))),
        "z2": np.array(jax.random.normal(rz2, (B, NZ))),
        "gen_eps": jax_sample_eps(PARAMS, jax.random.split(r_gen, 4)[0], 2 * B, HW),
    }
    noise.update(_pool_noise(r_dm))
    return noise


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(l)) for p, l in jax.tree_util.tree_leaves_with_path(tree)]


def _assert_trees_close(got, want, atol):
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want), strict=True):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=path)


def _torch_trees(model, names, col):
    return {n: component_trees(getattr(model, n).state_dict())[col] for n in names}


def _jax_state(jts):
    return jax.tree_util.tree_map(np.array, (jts.params, jts.model_state))


def _jax_ts(params, state=STATE):
    jts = jcreate_state(JMODEL, JCONF, jax.random.PRNGKey(0))
    return jts.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                       model_state=jax.tree_util.tree_map(jnp.asarray, state))


def _param_diffs(params, ref_params):
    """|params - ref_params| over every component, flattened."""
    names = GEN + DISC
    return np.concatenate([np.abs(a - b).ravel() for (_, a), (_, b) in zip(
        _leaves({n: params[n] for n in names}), _leaves({n: ref_params[n] for n in names}),
        strict=True)])


# --------------------------------------------------------- generator loss

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


@pytest.mark.parametrize("supervised", [True, False])
def test_gen_loss_expert_and_gradients_match_jax(supervised):
    """Loss and metrics at 1e-5 relative; the running statistics the loss
    updates at 1e-6. The gradient of every generator leaf within twice
    JAX's own spread under the +-1e-6 perturbation, plus 1e-4 of the
    leaf's largest entry and 1e-5 of its component's largest (the conv
    biases ahead of a BatchNorm have a gradient of exactly 0, which both
    frameworks compute as roundoff of that size); and the whole gradient
    vector within JAX's spread in relative L2."""
    batch = _gen_batch(40, supervised)
    key = jax.random.PRNGKey(7)
    disc = {k: PARAMS[k] for k in DISC}
    fn = jax.jit(jax.value_and_grad(
        lambda g, d: JMODEL.gen_loss_expert(g, d, STATE, batch, key, supervised), has_aux=True))
    (_, (ref_metrics, ref_state)), ref = fn({k: PARAMS[k] for k in GEN}, disc)
    spread = [fn({k: p[k] for k in GEN}, disc)[1] for p in
              (_perturbed(PARAMS, PERTURBATION), _perturbed(PARAMS, -PERTURBATION))]

    model = torch_dafnet(TCONF, PARAMS, STATE).train()
    check_ties = _tie_guard(model)
    eps = torch.from_numpy(jax_sample_eps(PARAMS, jax.random.split(key, 4)[0], 2 * B, HW))
    total, metrics = model.gen_loss_expert({k: torch.tensor(v) for k, v in batch.items()},
                                           eps, supervised)
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
    bn = ("enc_anatomy", "segmentor")
    _assert_trees_close(_torch_trees(model, bn, "batch_stats"),
                        {n: ref_state["batch_stats"][n] for n in bn}, 1e-6)
    flat = lambda t: np.concatenate([l.ravel() for _, l in _leaves(t)])  # noqa: E731
    for n in GEN:
        floor = 1e-5 * np.abs(flat(ref[n])).max()
        for (path, g), (_, r), (_, s1), (_, s2) in zip(
                _leaves(got[n]), _leaves(ref[n]), _leaves(spread[0][n]), _leaves(spread[1][n]),
                strict=True):
            tol = (2 * max(np.abs(s1 - r).max(), np.abs(s2 - r).max())
                   + 1e-4 * np.abs(r).max() + floor)
            assert np.abs(g - r).max() <= tol, "%s%s: %.3g > %.3g" % (
                n, path, np.abs(g - r).max(), tol)
    r = flat(ref)
    jax_l2 = min(np.linalg.norm(flat(s) - r) for s in spread) / np.linalg.norm(r)
    assert np.linalg.norm(flat(got) - r) / np.linalg.norm(r) <= jax_l2
    assert not flat(ref["balancer"]).any()


JCONF_BF16 = dataclasses.replace(JCONF, compute_dtype="bfloat16")


def _layer_dtypes(jmodel, model):
    """(record, want, got): {(component, layer path): set of output dtype
    names} of every layer a forward runs, for both frameworks. `want` fills
    while a JAX call is traced inside `record(True)` (Flax's method
    interceptor), `got` from forward hooks on every module of the port's
    components. Components of one Flax class (the discriminators) share a
    name, joined by "/", since a Flax root module knows its class only."""
    names = collections.defaultdict(list)
    for n, m in jmodel.components.modules.items():
        names[type(m)].append(n)
    joined = {t: "/".join(ns) for t, ns in names.items()}
    group = {n: j for j in joined.values() for n in j.split("/")}
    want, got = collections.defaultdict(set), collections.defaultdict(set)

    def intercept(call, args, kwargs, ctx):
        out = call(*args, **kwargs)
        if ctx.method_name == "__call__" and hasattr(out, "dtype"):
            root = ctx.module
            while isinstance(root.parent, fnn.Module):
                root = root.parent
            want[(joined[type(root)], ".".join(ctx.module.path))].add(str(out.dtype))
        return out

    def hook(key):
        def fn(module, inputs, out):
            if isinstance(out, torch.Tensor):
                got[key].add(str(out.dtype).replace("torch.", ""))
        return fn

    for c, component in model.named_children():
        for n, m in component.named_modules():
            m.register_forward_hook(hook((group[c], n)))

    def record(on):
        return fnn.intercept_methods(intercept) if on else contextlib.nullcontext()

    return record, want, got
TCONF_BF16 = dataclasses.replace(TCONF, compute_dtype="bfloat16")


@pytest.mark.parametrize("supervised", [True, False])
def test_gen_loss_expert_bf16_matches_jax(supervised):
    """compute dtype bfloat16 (the JAX package's bf16 policy, docs/DESIGN.md
    §4): each metric within 3 times JAX's own bf16-to-f32 relative gap of
    JAX's bf16 value, or 5e-3 relative, whichever is larger; the loss f32,
    every generator gradient finite and f32, every parameter f32.

    Measured: JAX's own gaps are 4.9e-4 (supervised_Mask) to 5.6e-2 (KL);
    the port's bf16 lies 4.1e-4 to 3.8e-2 from JAX's bf16, at most 1.2
    times that gap (adv_M). Anatomy values are no longer kept from 0.5
    here: bf16 softmax values reach it, so both frameworks round some of
    them either way, and the bound covers that.

    The metrics alone cannot tell the bf16 policy from f32: the port's
    f32 run sits about one JAX gap from JAX's bf16 run. So every layer
    the loss runs is also held to the output dtype of its Flax
    counterpart in this run (`_layer_dtypes`): an f32 island, or a bf16
    layer the policy keeps in f32, fails here."""
    batch = _gen_batch(40, supervised)
    key = jax.random.PRNGKey(7)
    disc = {k: PARAMS[k] for k in DISC}
    gen = {k: PARAMS[k] for k in GEN}
    ref = {}
    jmodel_bf16 = build_jax_model(JCONF_BF16)
    model = torch_dafnet(TCONF_BF16, PARAMS, STATE).train()
    record, want_dt, got_dt = _layer_dtypes(jmodel_bf16, model)
    for dt, jmodel in (("float32", JMODEL), ("bfloat16", jmodel_bf16)):
        with record(dt == "bfloat16"):
            loss, (met, _) = jax.jit(
                lambda g, d, m=jmodel: m.gen_loss_expert(g, d, STATE, batch, key, supervised))(
                    gen, disc)
        assert loss.dtype == jnp.float32
        ref[dt] = {k: float(v) for k, v in met.items()}

    eps = torch.from_numpy(jax_sample_eps(PARAMS, jax.random.split(key, 4)[0], 2 * B, HW))
    total, metrics = model.gen_loss_expert({k: torch.tensor(v) for k, v in batch.items()},
                                           eps, supervised)
    assert total.dtype == torch.float32
    for k, v in got_dt.items():
        assert want_dt.get(k) == v, (k, v, want_dt.get(k))
    # what only Flax reports: the components' roots (the port's return
    # tuples) and the BatchNorm inside each Norm (the port's Norm is one)
    assert all(not path or path.endswith(".BatchNorm_0") for _, path in want_dt.keys() - got_dt)
    bf16 = {c for (c, _), v in got_dt.items() if "bfloat16" in v}
    assert {"enc_anatomy", "segmentor", "decoder", "enc_modality", "fuser"} <= bf16, bf16
    assert sorted(metrics) == sorted(ref["bfloat16"])
    for k, v in metrics.items():
        want, f32 = ref["bfloat16"][k], ref["float32"][k]
        bound = max(3 * abs(want / f32 - 1.0), 5e-3)
        assert abs(float(v.detach()) / want - 1.0) <= bound, (k, float(v.detach()), want, bound)
    params = [p for n in GEN for p in getattr(model, n).parameters()]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    grads = [g for g in torch.autograd.grad(total, params, allow_unused=True) if g is not None]
    assert grads and all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                         for g in grads)


def test_bf16_step_supervised_runs_with_f32_state():
    """Two bf16 step_supervised steps on the CPU (the port's own draws):
    every metric finite and f32; parameters, BatchNorm statistics and the
    Adam moments stay f32 and finite; the generator's parameters move."""
    model = torch_dafnet(TCONF_BF16, PARAMS, STATE)
    ts = create_train_state(model, TCONF_BF16)
    steps = DAFNetSteps(model, TCONF_BF16)
    before = [p.detach().clone() for p in model.decoder.parameters()]
    for seed in STEP_SEEDS[:2]:
        ts, metrics = steps.step_supervised(ts, _batch(seed))
        for k, v in metrics.items():
            v = torch.as_tensor(v)
            assert v.dtype == torch.float32 and bool(torch.isfinite(v).all()), k
    tensors = [*model.parameters(), *model.buffers()]
    for opt in (ts.opt_gen, *ts.opt_disc.values()):
        tensors += [t for st in opt.state.values() for t in st.values() if t.dim() > 0]
    assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in tensors)
    assert any(not torch.equal(a, b) for a, b in zip(before, model.decoder.parameters()))
    assert ts.step == 2


# ------------------------------------------------------- fake pools and D

def test_fake_pools_match_jax():
    """The four pools at 1e-5, eval-mode generator, JAX draws replayed."""
    b = _batch(43)
    key = jax.random.PRNGKey(8)
    ref = JMODEL.make_fake_pools(PARAMS, STATE, b["dx1"], b["dx2"], key)
    model = torch_dafnet(TCONF, PARAMS, STATE).eval()
    check_ties = _tie_guard(model)
    noise = _pool_noise(key)
    got = model.make_fake_pools(
        torch.from_numpy(b["dx1"]), torch.from_numpy(b["dx2"]),
        [torch.from_numpy(i) for i in noise["pool_mask_idx"]], torch.from_numpy(noise["pool_eps"]),
        [torch.from_numpy(i) for i in noise["pool_image_idx"]])
    check_ties()
    for a, r in zip(got, ref, strict=True):
        assert tuple(a.shape) == r.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5)
    # the draws pick both variants somewhere
    assert {0, 1} <= set(np.concatenate(noise["pool_mask_idx"]).tolist())


def _disc_grads(module, loss):
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return component_trees(dict(zip(names, grads)))["params"]


def _assert_grads_close(got, want, rel):
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want), strict=True):
        np.testing.assert_allclose(a, b, atol=rel * np.abs(b).max(), rtol=0, err_msg=path)


def test_d_mask_pair_loss_matches_jax():
    """Loss at 1e-5 relative, gradients within 1e-5 of each leaf's largest
    entry, new u at 1e-5."""
    r = np.random.RandomState(3)
    real = _masks(r)
    fake = r.rand(B, *HW, NM).astype(np.float32)
    other = {k: v for k, v in PARAMS.items() if k != "d_mask"}
    fn = jax.value_and_grad(lambda d: JMODEL.d_mask_pair_loss(d, other, STATE, real, fake),
                            has_aux=True)
    (ref_loss, (_, ref_state)), ref_g = fn({"d_mask": PARAMS["d_mask"]})

    model = torch_dafnet(TCONF, PARAMS, STATE)
    loss, metrics = model.d_mask_pair_loss(torch.from_numpy(real), torch.from_numpy(fake))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    assert metrics["dis_M"] is loss
    _assert_grads_close({"d_mask": _disc_grads(model.d_mask, loss)}, ref_g, 1e-5)
    _assert_trees_close(_torch_trees(model, ["d_mask"], "spectral"),
                        {"d_mask": ref_state["spectral"]["d_mask"]}, 1e-5)


def test_d_image_pair_loss_matches_jax():
    r = np.random.RandomState(4)
    x1, x2, y1, y2 = ((r.rand(B, *HW, 1) * 2 - 1).astype(np.float32) for _ in range(4))
    names = ("d_image1", "d_image2")
    other = {k: v for k, v in PARAMS.items() if k not in names}
    fn = jax.value_and_grad(
        lambda d: JMODEL.d_image_pair_loss(d, other, STATE, x1, x2, y1, y2), has_aux=True)
    (ref_loss, (ref_metrics, ref_state)), ref_g = fn({n: PARAMS[n] for n in names})

    model = torch_dafnet(TCONF, PARAMS, STATE)
    loss, metrics = model.d_image_pair_loss(*(torch.from_numpy(a) for a in (x1, x2, y1, y2)))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    for k in ("dis_X1", "dis_X2"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(ref_metrics[k]), rtol=1e-5)
    _assert_grads_close({n: _disc_grads(getattr(model, n), loss) for n in names}, ref_g, 1e-5)
    _assert_trees_close(_torch_trees(model, names, "spectral"),
                        {n: ref_state["spectral"][n] for n in names}, 1e-5)


# ------------------------------------------------------------- full steps

_set_adam = set_adam


def _sync_from_jax(model, tts, jts):
    """The torch train state := the JAX one (params, statistics, u, Adam)."""
    params, state = _jax_state(jts)
    load_jax_weights(model, params, state)
    _set_adam(tts.opt_gen, model, GEN, jts.opt_gen[0])
    for n in DISC:
        _set_adam(tts.opt_disc[n], model, (n,), jts.opt_disc[n][0])
    tts.step = int(jts.step)


@pytest.mark.parametrize("supervised", [True, False])
def test_each_step_matches_jax_from_the_same_state(supervised):
    """Three steps; before each, the port takes the JAX train state as it
    stands (params, statistics, u, Adam moments and count). The generator
    metrics at 1e-5 relative. Parameters move by lr-sized Adam steps: all
    but 0.5 % of them agree within 0.2 lr, and none differs by more than
    2.1 lr (a gradient component near 0, such as that of a conv bias ahead
    of a BatchNorm, can take either sign). The discriminator metrics see
    the fake pools of the updated generator, and so those few lr-sized
    differences: 2e-3 relative (7e-4 measured). The statistics and u after
    the step at 1e-5."""
    step = JSTEPS.step_supervised if supervised else JSTEPS.step_unsupervised
    jts = _jax_ts(PARAMS)
    model = torch_dafnet(TCONF, PARAMS, STATE)
    check_ties = _tie_guard(model)
    tts = create_train_state(model, TCONF)
    tsteps = DAFNetSteps(model, TCONF)
    tstep = tsteps.step_supervised if supervised else tsteps.step_unsupervised
    for seed in STEP_SEEDS:
        batch = _batch(seed)
        if not supervised:
            del batch["m2"]
        _sync_from_jax(model, tts, jts)
        noise = _step_noise(jts)
        jts, jmet = step(jts, batch)
        tts, tmet = tstep(tts, batch, noise)
        assert sorted(tmet) == sorted(jmet)
        for k in tmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=2e-3 if k.startswith("dis_") else 1e-5,
                                       err_msg="seed %d %s" % (seed, k))
        params, state = _jax_state(jts)
        for col in ("batch_stats", "spectral"):
            _assert_trees_close(_torch_trees(model, list(state[col]), col), state[col], 1e-5)
        d = _param_diffs(_torch_trees(model, GEN + DISC, "params"), params)
        assert d.max() <= 2.1 * LR and (d > 0.2 * LR).mean() <= 5e-3, \
            "max %.3g lr, share %.3g" % (d.max() / LR, (d > 0.2 * LR).mean())
    check_ties()
    assert tts.step == int(jts.step) == 3


def test_three_supervised_steps_match_jax():
    """Three chained step_supervised steps on three batches from the same
    weights, against the JAX package's jitted step, with its key splits
    replayed as the port's noise.

    Step 0 metrics at 1e-4 relative. From step 1 on, both runs carry their
    own parameters, so the port is held to JAX's own spread: the JAX run
    is repeated with LocNet's last bias at +-1e-6. Each later step's
    largest relative metric difference stays within 3 times JAX's largest
    one at that step (plus 1e-4). After the three steps, the statistics and
    u within 3 times JAX's spread plus 1e-6; parameters differ by at most
    6 lr (three sign-flipped Adam steps), and no more of them by over
    0.2 lr than twice the share in the perturbed JAX runs, plus 0.1 %. The
    balancer, which the expert loss does not reach, stays exactly as it
    was."""
    runs = {}
    for name, delta in (("ref", 0.0), ("plus", PERTURBATION), ("minus", -PERTURBATION)):
        jts = _jax_ts(_perturbed(PARAMS, delta) if delta else PARAMS)
        mets, noises = [], []
        for seed in STEP_SEEDS:
            noises.append(_step_noise(jts))
            jts, m = JSTEPS.step_supervised(jts, _batch(seed))
            mets.append({k: float(v) for k, v in m.items()})
        runs[name] = (mets, noises, _jax_state(jts), int(jts.step))

    model = torch_dafnet(TCONF, PARAMS, STATE)
    check_ties = _tie_guard(model)
    tts = create_train_state(model, TCONF)
    tsteps = DAFNetSteps(model, TCONF)
    ref_mets, noises, (ref_params, ref_state), ref_step = runs["ref"]
    for i, seed in enumerate(STEP_SEEDS):
        tts, tmet = tsteps.step_supervised(tts, _batch(seed), noises[i])
        assert sorted(tmet) == sorted(ref_mets[i])
        dev = {k: abs(float(tmet[k]) / ref_mets[i][k] - 1.0) for k in tmet}
        if i == 0:
            assert max(dev.values()) <= 1e-4, dev
        else:
            jax_dev = max(abs(runs[r][0][i][k] / ref_mets[i][k] - 1.0)
                          for r in ("plus", "minus") for k in dev)
            assert max(dev.values()) <= 3 * jax_dev + 1e-4, (i, dev, jax_dev)
    check_ties()
    assert tts.step == ref_step == 3

    for col in ("batch_stats", "spectral"):
        got = _torch_trees(model, list(ref_state[col]), col)
        for (path, a), (_, r), (_, p), (_, m) in zip(
                _leaves(got), _leaves(ref_state[col]), _leaves(runs["plus"][2][1][col]),
                _leaves(runs["minus"][2][1][col]), strict=True):
            tol = 3 * max(np.abs(p - r).max(), np.abs(m - r).max()) + 1e-6
            assert np.abs(a - r).max() <= tol, path
    d = _param_diffs(_torch_trees(model, GEN + DISC, "params"), ref_params)
    jax_moved = max((_param_diffs(runs[r][2][0], ref_params) > 0.2 * LR).mean()
                    for r in ("plus", "minus"))
    assert d.max() <= 6 * LR
    assert (d > 0.2 * LR).mean() <= 2 * jax_moved + 1e-3, ((d > 0.2 * LR).mean(), jax_moved)
    _assert_trees_close(_torch_trees(model, ["balancer"], "params"),
                        {"balancer": PARAMS["balancer"]}, 0.0)
