"""fused_adam on the CPU (train/state.py::adam): one multi-tensor update of
all an optimizer's parameters instead of one chain of operations each.

  * three tiny DAFNet expert steps, and one MMSDNet batch (whose
    Z-regressor has its own Adam, opt_zreg), with fused_adam True against
    False from the same weights, batches and noise: every parameter,
    buffer and Adam moment within 1e-6 of its leaf's largest entry plus
    1e-12 (the same update, its operations in another order), the metrics
    within 1e-6 relative;
  * the port's fused step against the JAX package's fused_adam=True step
    (flat_adam) from the same weights, within the bounds of
    tests/test_torch_dafnet_train.py's step test: generator metrics 1e-5
    relative, discriminator metrics 2e-3, statistics 1e-5, no parameter
    beyond 2.1 lr and at most 0.5 % beyond 0.2 lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_segmentation_tpu import config as jconfig
from multimodal_segmentation_tpu.ops.augment import random_rotation_angles as jangles
from multimodal_segmentation_tpu.train.state import create_train_state as jcreate_state
from multimodal_segmentation_tpu.train.steps import DAFNetSteps as JSteps
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch.models import build_model
from multimodal_segmentation_torch.train import create_train_state, make_steps
from multimodal_segmentation_torch.utils.convert import component_trees
from torch_parity import jax_dafnet, jax_sample_eps, torch_dafnet

torch.set_num_threads(1)


def _masks(r, conf):
    lab = r.randint(0, conf.num_masks + 1, size=(conf.batch_size,) + conf.input_hw)
    return (lab[..., None] == np.arange(conf.num_masks)).astype(np.float32)


def _images(r, conf):
    return (r.rand(conf.batch_size, *conf.input_hw, 1) * 2 - 1).astype(np.float32)


def _dafnet_batch(conf, seed):
    r = np.random.RandomState(seed)
    b = {k: _images(r, conf) for k in ("x1", "x2", "dx1", "dx2")}
    b.update({k: _masks(r, conf) for k in ("m1", "m2", "dm1", "dm2")})
    return b


def _run(conf, fused):
    conf = dataclasses.replace(conf, fused_adam=fused)
    model = build_model(conf, device="cpu")
    steps = make_steps(model, conf)
    ts = create_train_state(model, conf)
    opts = [ts.opt_gen, *ts.opt_disc.values()] + ([ts.opt_zreg] if ts.opt_zreg else [])
    assert all(o.defaults["foreach"] is (True if fused else None) for o in opts)
    metrics = []
    r = np.random.RandomState(5)
    if conf.model == "mmsdnet":
        gen = {"x1": _images(r, conf), "x2": _images(r, conf), "m1": _masks(r, conf),
               "m2": _masks(r, conf)}
        disc = {"dm": _masks(r, conf), "dx1": _images(r, conf), "dx2": _images(r, conf)}
        ts, m = steps.step_supervised(ts, gen)
        ts, d = steps.step_discriminator(ts, disc)
        metrics.append({**m, **d})
    else:
        for seed in (1, 2, 3):
            ts, m = steps.step_supervised(ts, _dafnet_batch(conf, seed))
            metrics.append(m)
    moments = [st[k].clone() for o in opts for st in o.state.values()
               for k in ("exp_avg", "exp_avg_sq")]
    return ([{k: float(v) for k, v in m.items()} for m in metrics],
            {k: v.clone() for k, v in model.state_dict().items()}, moments)


@pytest.mark.parametrize("model", ["dafnet", "mmsdnet"])
def test_fused_adam_matches_the_per_parameter_adam(model):
    m0, sd0, mom0 = _run(tconfig.tiny_test_config(model), False)
    m1, sd1, mom1 = _run(tconfig.tiny_test_config(model), True)
    for a, b in zip(m1, m0, strict=True):
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-6 * abs(b[k]), (k, a[k], b[k])
    pairs = [(sd1[k], sd0[k], k) for k in sd0 if sd0[k].is_floating_point()]
    pairs += [(a, b, "moment %d" % i) for i, (a, b) in enumerate(zip(mom1, mom0, strict=True))]
    for a, b, name in pairs:
        assert (a - b).abs().max() <= 1e-6 * b.abs().max() + 1e-12, name
    assert any(not torch.equal(mom0[i], torch.zeros_like(mom0[i])) for i in range(len(mom0)))


def test_fused_step_matches_jax_fused_step():
    jconf = dataclasses.replace(jconfig.tiny_test_config(), fused_adam=True)
    tconf = dataclasses.replace(tconfig.tiny_test_config(), fused_adam=True)
    jmodel, params, state = jax_dafnet(jconf)
    params["enc_anatomy"]["conv_anatomy"]["kernel"] *= 20.0
    B, HW, NZ, LR = jconf.batch_size, jconf.input_hw, jconf.num_z, jconf.lr
    jts = jcreate_state(jmodel, jconf, jax.random.PRNGKey(0))
    jts = jts.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                      model_state=jax.tree_util.tree_map(jnp.asarray, state))
    # the JAX step's key splits (train/steps.py:120-162) as the port's noise
    rng = jax.random.fold_in(jts.rng, jts.step)
    r_aug1, r_aug2, r_aug3, r_z, r_gen, r_dm, _ = jax.random.split(rng, 7)
    rz1, rz2 = jax.random.split(r_z)
    pool = jax.random.split(r_dm, 6)
    noise = {
        "angles": [np.array(jangles(k, B, jconf.rotation_range)) for k in (r_aug1, r_aug2, r_aug3)],
        "z1": np.array(jax.random.normal(rz1, (B, NZ))),
        "z2": np.array(jax.random.normal(rz2, (B, NZ))),
        "gen_eps": jax_sample_eps(params, jax.random.split(r_gen, 4)[0], 2 * B, HW),
        "pool_mask_idx": [np.array(jax.random.randint(pool[i], (B,), 0, 2)) for i in (0, 1)],
        "pool_eps": jax_sample_eps(params, pool[2], 2 * B, HW),
        "pool_image_idx": [np.array(jax.random.randint(pool[i], (B,), 0, 3)) for i in (4, 5)],
    }
    model = torch_dafnet(tconf, params, state)
    tts = create_train_state(model, tconf)
    batch = _dafnet_batch(tconf, 73)
    jts, jmet = JSteps(jmodel, jconf).step_supervised(jts, batch)
    tts, tmet = make_steps(model, tconf).step_supervised(tts, batch, noise)
    assert type(jts.opt_gen).__name__ == "FlatAdamState" and int(jts.opt_gen.count) == 1
    assert sorted(tmet) == sorted(jmet)
    for k in tmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=2e-3 if k.startswith("dis_") else 1e-5, err_msg=k)
    jparams, jstate = jax.tree_util.tree_map(np.array, (jts.params, jts.model_state))
    names = jmodel.GEN_COMPONENTS + jmodel.DISC_COMPONENTS
    trees = {n: component_trees(getattr(model, n).state_dict()) for n in names}
    for col in ("batch_stats", "spectral"):
        for n in jstate[col]:
            got = jax.tree_util.tree_leaves(trees[n][col])
            for a, b in zip(got, jax.tree_util.tree_leaves(jstate[col][n]), strict=True):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg="%s %s" % (col, n))
    got = np.concatenate([l.ravel() for n in names
                          for l in jax.tree_util.tree_leaves(trees[n]["params"])])
    want = np.concatenate([l.ravel() for n in names
                           for l in jax.tree_util.tree_leaves(jparams[n])])
    d = np.abs(got - want)
    assert d.max() <= 2.1 * LR and (d > 0.2 * LR).mean() <= 5e-3, \
        "max %.3g lr, share %.3g" % (d.max() / LR, (d > 0.2 * LR).mean())
