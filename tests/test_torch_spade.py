"""CPU parity of the SPADE decoder path with the JAX package's, at the tiny
SPADE config (tiny_test_config('dafnet', 'spade'): 32x32, so the six SPADE
blocks run at 1, 2, 4, 8, 16 and 32 pixels), on the JAX weights carried
over by utils/convert.py: InstanceNorm and the 'instance' / 'none'
normalisation kinds, the decoder block by block in f32 and bf16, the
expert generator loss with its gradients, and one step_supervised from
the same state.

Bounds: f32 outputs at 1e-5 (a block's output, whose values reach ~8, at
1e-5 of its largest magnitude); bf16 within 3 times JAX's own
bf16-to-f32 gap (tests/torch_parity.py::bf16_gap_check). The loss and the
step use the bounds of the FiLM decoder's tests in
tests/test_torch_dafnet_train.py, which says why: the frameworks' TPS
sample locations differ by ~3e-5 px and the step is sensitive to that, so
gradients are held to JAX's own spread under a 1e-6 move of LocNet's last
bias, and every anatomy value the port rounds is kept 1e-4 from 0.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_segmentation_tpu import config as jconfig
from multimodal_segmentation_tpu import nn as jnn
from multimodal_segmentation_tpu.models.base import add_residual as jadd_residual
from multimodal_segmentation_tpu.ops.augment import random_rotation_angles as jangles
from multimodal_segmentation_tpu.train.state import create_train_state as jcreate_state
from multimodal_segmentation_tpu.train.steps import DAFNetSteps as JSteps
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch import nn as tnn
from multimodal_segmentation_torch.train import DAFNetSteps, create_train_state
from multimodal_segmentation_torch.utils.convert import (
    component_state_dict,
    component_trees,
)
from torch_parity import (
    bf16_gap_check,
    dtypes_by_layer,
    jax_dafnet,
    jax_sample_eps,
    nchw,
    nhwc,
    set_adam,
    tie_guard,
    torch_dafnet,
)

torch.set_num_threads(1)

JCONF = jconfig.tiny_test_config("dafnet", "spade")
TCONF = tconfig.tiny_test_config("dafnet", "spade")
JMODEL, PARAMS, STATE = jax_dafnet(JCONF, jit_init=True)
# the sharper anatomy head of tests/test_torch_dafnet_train.py: no anatomy
# value the port rounds lies within TIE_MARGIN of 0.5
PARAMS["enc_anatomy"]["conv_anatomy"]["kernel"] *= 20.0
B, HW, NM, NZ = JCONF.batch_size, JCONF.input_hw, JCONF.num_masks, JCONF.num_z
GEN, DISC = JMODEL.GEN_COMPONENTS, JMODEL.DISC_COMPONENTS
LR = JCONF.lr
TIE_MARGIN = 1e-4
PERTURBATION = 1e-6


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _anatomy_z(seed, n=3):
    r = np.random.RandomState(seed)
    s = (r.randint(0, 9, size=(n,) + HW)[..., None] == np.arange(8)).astype(np.float32)
    return s, r.randn(n, NZ).astype(np.float32)


# ---------------------------------------------------------- normalisation

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_matches_jax(affine, dtype):
    """f32 at 1e-5. bf16: the same output dtype, and within one bf16 ulp of
    the largest output (4e-3 relative): both frameworks take the f32
    statistics and round the same expressions to bf16."""
    r = np.random.RandomState(3)
    x = (r.randn(3, 6, 7, 5) * 3 + 1).astype(np.float32)
    mod = jnn.InstanceNorm(use_scale=affine, use_bias=affine)
    params = mod.init(jax.random.PRNGKey(0), x).get("params", {})
    if affine:
        params = {"scale": r.rand(5).astype(np.float32) + 0.5,
                  "bias": r.randn(5).astype(np.float32)}
    xj = jnp.asarray(x, getattr(jnp, dtype))
    ref = mod.apply({"params": params}, xj)
    norm = tnn.InstanceNorm(5, use_scale=affine, use_bias=affine)
    norm.load_state_dict(component_state_dict(params))
    got = norm(nchw(x).to(getattr(torch, dtype)))
    assert str(got.dtype) == "torch." + str(ref.dtype)
    ref = np.asarray(ref, np.float32)
    tol = 1e-5 if dtype == "float32" else 2 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(nhwc(got.float()), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("kind", ["instance", "none"])
def test_conv_block_norm_kinds_match_jax(kind):
    """ConvBlock with normalise='instance' (InstanceNorm with scale and
    bias, Norm_k/InstanceNorm_0 in the JAX tree) or 'none', at 1e-5, in
    train and in eval mode (neither keeps statistics)."""
    x = (np.random.RandomState(4).rand(2, 16, 16, 3) * 2 - 1).astype(np.float32)
    jblock = jnn.ConvBlock(4, norm=kind)
    params = jax.tree_util.tree_map(np.array, jblock.init(jax.random.PRNGKey(1), x)["params"])
    if kind == "instance":
        r = np.random.RandomState(5)
        for k in ("Norm_0", "Norm_1"):
            params[k]["InstanceNorm_0"] = {"scale": r.rand(4).astype(np.float32) + 0.5,
                                           "bias": r.randn(4).astype(np.float32)}
    block = tnn.ConvBlock(3, 4, norm=kind)
    block.load_state_dict(component_state_dict(params))
    for train in (True, False):
        ref = jblock.apply({"params": params}, x, train=train)
        got = block.train(train)(nchw(x))
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------- decoder

def _decoder_run(dtype, s, z):
    """(JAX output, JAX block outputs, port output, port block outputs, port
    decoder) at compute dtype `dtype`."""
    v = {"params": PARAMS["decoder"]}
    jdec = jnn.Decoder("spade", HW, dtype=getattr(jnp, dtype))
    ref, inter = jax.jit(lambda v, s, z: jdec.apply(v, s, z, capture_intermediates=True,
                                                    mutable=["intermediates"]))(v, s, z)
    blocks = inter["intermediates"]["SPADEDecoder_0"]
    ref_blocks = [blocks["SPADEBlock_%d" % i]["__call__"][0] for i in range(6)]
    dec = tnn.Decoder("spade", 8, NZ, getattr(torch, dtype), HW)
    dec.load_state_dict(component_state_dict(PARAMS["decoder"]))
    got_blocks = {}
    for i in range(6):
        getattr(dec.SPADEDecoder_0, "SPADEBlock_%d" % i).register_forward_hook(
            lambda m, a, o, i=i: got_blocks.__setitem__(i, o.permute(0, 2, 3, 1)))
    got = dec(nchw(s), torch.from_numpy(z)).permute(0, 2, 3, 1)
    return ref, ref_blocks, got, [got_blocks[i] for i in range(6)], dec


@pytest.mark.parametrize("seed", [7, 11, 13])
def test_spade_decoder_matches_jax(seed):
    """Every block's output (at 1, 2, 4, 8, 16 and 32 pixels) within 1e-5
    of its largest magnitude, the image at 1e-5."""
    s, z = _anatomy_z(seed)
    ref, ref_blocks, got, got_blocks, _ = _decoder_run("float32", s, z)
    for i, (a, r) in enumerate(zip(got_blocks, ref_blocks, strict=True)):
        r = np.asarray(r)
        assert a.shape == r.shape and r.shape[1] == 2 ** i
        np.testing.assert_allclose(a.detach().numpy(), r, atol=1e-5 * np.abs(r).max(), rtol=0)
    assert got.shape == (3,) + HW + (1,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("seed", [7, 11, 13])
def test_spade_decoder_bf16_matches_jax(seed):
    """compute dtype bfloat16: every layer's output dtype is the Flax
    layer's (the Dense, the SPADE convs and the instance norms in bf16, the
    1x1 tanh conv in f32); every block's output lies within 3 times JAX's
    own bf16-to-f32 gap of JAX's bf16 value (the first, at 1x1 pixel, can
    equal it), and the image passes bf16_gap_check (JAX's dtype, within 3
    times the gap, not equal to the port's f32 image)."""
    s, z = _anatomy_z(seed)
    runs = {dt: _decoder_run(dt, s, z) for dt in ("float32", "bfloat16")}
    b16, f32 = runs["bfloat16"], runs["float32"]
    for a, r, r32 in zip(b16[3], b16[1], f32[1], strict=True):
        assert str(a.dtype) == "torch." + str(r.dtype) == "torch.bfloat16"
        a, r, r32 = a.detach().float().numpy(), np.asarray(r, np.float32), np.asarray(r32)
        assert np.abs(a - r).max() <= 3 * np.abs(r - r32).max()
    bf16_gap_check([b16[2]], [f32[2]], [b16[0]], [f32[0]])
    got_dt, want_dt = dtypes_by_layer(
        jnn.Decoder("spade", HW, dtype=jnp.bfloat16), {"params": PARAMS["decoder"]}, b16[4],
        (s, z), (nchw(s), torch.from_numpy(z)))
    assert got_dt == want_dt
    assert want_dt["SPADEDecoder_0.Dense_0"] == "bfloat16"
    assert want_dt["SPADEDecoder_0.SPADEBlock_5.SPADEUnit_2.InstanceNorm_0"] == "bfloat16"
    assert want_dt["SPADEDecoder_0.Conv_0"] == "float32"


def test_spade_decoder_shortcut_and_parameter_tree():
    """The learned shortcut (a SPADE unit and a 1x1 conv without bias)
    exists where fin != fout (blocks 3-5) only, and the port's parameters
    map onto the JAX tree and back exactly."""
    dec = tnn.Decoder("spade", 8, NZ, torch.float32, HW)
    sd = component_state_dict(PARAMS["decoder"])
    dec.load_state_dict(sd)
    for i in range(6):
        block = getattr(dec.SPADEDecoder_0, "SPADEBlock_%d" % i)
        assert hasattr(block, "Conv_2") == (i >= 3) == hasattr(block, "SPADEUnit_2")
        if i >= 3:
            assert block.Conv_2.bias is None and block.Conv_2.kernel_size == (1, 1)
    back = component_trees(dec.state_dict())["params"]
    got, want = _leaves(back), _leaves(PARAMS["decoder"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=p)


# --------------------------------------------------------- generator loss

def _masks(r):
    lab = r.randint(0, NM + 1, size=(B,) + HW)
    return (lab[..., None] == np.arange(NM)).astype(np.float32)


def _batch(seed):
    r = np.random.RandomState(seed)
    img = lambda: (r.rand(B, *HW, 1) * 2 - 1).astype(np.float32)  # noqa: E731
    return {"x1": img(), "x2": img(), "m1": _masks(r), "m2": _masks(r),
            "dm1": _masks(r), "dm2": _masks(r), "dx1": img(), "dx2": img()}


def _perturbed(delta):
    out = dict(PARAMS)
    out["fuser"] = jax.tree_util.tree_map(np.array, PARAMS["fuser"])
    out["fuser"]["locnet"]["Dense_1"]["bias"] = (
        PARAMS["fuser"]["locnet"]["Dense_1"]["bias"] + np.float32(delta))
    return out


@pytest.mark.parametrize("supervised", [True, False])
def test_gen_loss_expert_spade_and_gradients_match_jax(supervised):
    """decoder_type='spade': loss and metrics at 1e-5 relative; each
    generator leaf's gradient within twice JAX's spread under the +-1e-6
    perturbation, plus 1e-4 of the leaf's largest entry and 1e-5 of its
    component's largest; the whole gradient within JAX's spread in
    relative L2 (the FiLM test's bounds)."""
    b = _batch(40)
    r = np.random.RandomState(140)
    b["m1"], b["m2"] = (np.asarray(jadd_residual(b[k])) for k in ("m1", "m2"))
    if not supervised:
        del b["m2"]
    b["z1"], b["z2"] = (r.randn(B, NZ).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(7)
    disc = {k: PARAMS[k] for k in DISC}
    fn = jax.jit(jax.value_and_grad(
        lambda g, d: JMODEL.gen_loss_expert(g, d, STATE, b, key, supervised), has_aux=True))
    (_, (ref_metrics, _)), ref = fn({k: PARAMS[k] for k in GEN}, disc)
    spread = [fn({k: p[k] for k in GEN}, disc)[1]
              for p in (_perturbed(PERTURBATION), _perturbed(-PERTURBATION))]

    model = torch_dafnet(TCONF, PARAMS, STATE).train()
    check_ties = tie_guard(model, TIE_MARGIN)
    eps = torch.from_numpy(jax_sample_eps(PARAMS, jax.random.split(key, 4)[0], 2 * B, HW))
    total, metrics = model.gen_loss_expert({k: torch.tensor(v) for k, v in b.items()},
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
    flat = lambda t: np.concatenate([v.ravel() for _, v in _leaves(t)])  # noqa: E731
    for n in GEN:
        floor = 1e-5 * np.abs(flat(ref[n])).max()
        for (path, g), (_, rf), (_, s1), (_, s2) in zip(
                _leaves(got[n]), _leaves(ref[n]), _leaves(spread[0][n]), _leaves(spread[1][n]),
                strict=True):
            tol = (2 * max(np.abs(s1 - rf).max(), np.abs(s2 - rf).max())
                   + 1e-4 * np.abs(rf).max() + floor)
            assert np.abs(g - rf).max() <= tol, "%s%s: %.3g > %.3g" % (
                n, path, np.abs(g - rf).max(), tol)
    rf = flat(ref)
    jax_l2 = min(np.linalg.norm(flat(s) - rf) for s in spread) / np.linalg.norm(rf)
    assert np.linalg.norm(flat(got) - rf) / np.linalg.norm(rf) <= jax_l2
    assert np.abs(flat(ref["decoder"])).max() > 0


# ------------------------------------------------------------------- step

def _step_noise(jts):
    """The JAX step's key splits (train/steps.py:120-162) as the port's
    explicit noise."""
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


def test_spade_step_supervised_matches_jax_from_the_same_state():
    """One SPADE step_supervised from the JAX train state (params,
    statistics, u, Adam moments and count, as after init), with the JAX
    step's draws. The FiLM test's bounds
    (test_each_step_matches_jax_from_the_same_state: generator metrics at
    1e-5 relative, discriminator metrics at 2e-3, statistics and u at 1e-5,
    parameters within 2.1 lr and all but 0.5 % within 0.2 lr), but a
    metric may also lie within twice JAX's own spread under the +-1e-6
    perturbation, and the share of parameters beyond 0.2 lr within twice
    that of the perturbed JAX runs plus 0.1 % (the chained FiLM test's
    bound): through the SPADE decoder the adversarial metrics are more
    sensitive to the sample locations (JAX's own spread reached 8e-5 on
    adv_X1 and 1.2e-2 on dis_X1 at this batch; the port lay 2.3e-5 and
    1.05e-2 from JAX, and 0.51 % of its parameters beyond 0.2 lr)."""
    jsteps = JSteps(JMODEL, JCONF)

    def jax_state(params):
        jts = jcreate_state(JMODEL, JCONF, jax.random.PRNGKey(0))
        return jts.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                           model_state=jax.tree_util.tree_map(jnp.asarray, STATE))

    batch = _batch(73)
    jts = jax_state(PARAMS)
    noise = _step_noise(jts)
    model = torch_dafnet(TCONF, PARAMS, STATE)
    check_ties = tie_guard(model, TIE_MARGIN)
    tts = create_train_state(model, TCONF)
    set_adam(tts.opt_gen, model, GEN, jts.opt_gen[0])
    for n in DISC:
        set_adam(tts.opt_disc[n], model, (n,), jts.opt_disc[n][0])
    tts.step = int(jts.step)

    jts, jmet = jsteps.step_supervised(jts, batch)
    spread_runs = [jsteps.step_supervised(jax_state(_perturbed(d)), batch)
                   for d in (PERTURBATION, -PERTURBATION)]
    spread = [m for _, m in spread_runs]
    tts, tmet = DAFNetSteps(model, TCONF).step_supervised(tts, batch, noise)
    check_ties()
    assert sorted(tmet) == sorted(jmet) and tts.step == int(jts.step) == 1
    for k in tmet:
        want = float(jmet[k])
        jax_rel = max(abs(float(m[k]) / want - 1.0) for m in spread)
        bound = max(2e-3 if k.startswith("dis_") else 1e-5, 2 * jax_rel)
        assert abs(float(tmet[k]) / want - 1.0) <= bound, (k, float(tmet[k]), want, bound)
    params, state = jax.tree_util.tree_map(np.array, (jts.params, jts.model_state))
    for col in ("batch_stats", "spectral"):
        for n in state[col]:
            got = component_trees(getattr(model, n).state_dict())[col]
            for (p, a), (_, b) in zip(_leaves(got), _leaves(state[col][n]), strict=True):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=n + p)
    def diffs(trees):
        return np.concatenate([np.abs(np.asarray(a) - b).ravel() for n in GEN + DISC
                               for (_, a), (_, b) in zip(_leaves(trees[n]), _leaves(params[n]),
                                                         strict=True)])

    d = diffs({n: component_trees(getattr(model, n).state_dict())["params"] for n in GEN + DISC})
    jax_share = max((diffs(j.params) > 0.2 * LR).mean() for j, _ in spread_runs)
    assert d.max() <= 2.1 * LR, "max %.3g lr" % (d.max() / LR)
    assert (d > 0.2 * LR).mean() <= max(5e-3, 2 * jax_share + 1e-3), \
        "share %.3g, JAX's own %.3g" % ((d > 0.2 * LR).mean(), jax_share)
