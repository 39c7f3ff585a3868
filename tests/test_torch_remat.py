"""remat_convs on the CPU: the UNet blocks and the segmentor recompute their
activations in the backward (nn/blocks.py::remat), which changes no value.

  * a tiny MMSDNet batch (a supervised generator step with its
    Z-regressor update, then a discriminator step) and a tiny DAFNet
    expert step with remat_convs True and False, from the same weights,
    batch and noise: metrics, parameters, every Adam's moments and the
    BatchNorm running statistics equal bit for bit. The statistics would
    differ if the recomputation in the backward applied their EMA again;
  * the port's MMSDNet supervised step with remat_convs against the JAX
    package's remat_convs=True step from the same state, within the
    bounds of tests/test_torch_mmsdnet.py's step test (metrics 1e-5
    relative, rec_Z 2e-3; statistics 1e-5; no parameter beyond 2.1 lr;
    the share beyond 0.2 lr within twice the share by which JAX's own
    remat step moves under a +-1e-6 move of LocNet's last bias, plus
    0.1 %, and at least 0.5 %: a first Adam step is lr * sign(g)).
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
from multimodal_segmentation_tpu.train.steps import MMSDNetSteps as JSteps
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch.models import build_model
from multimodal_segmentation_torch.nn.blocks import BatchNorm
from multimodal_segmentation_torch.train import create_train_state, make_steps
from multimodal_segmentation_torch.utils.convert import component_trees, load_jax_weights
from torch_parity import jax_mmsdnet, jax_sample_eps, set_adam

torch.set_num_threads(1)


def _masks(r, B, hw, nm):
    lab = r.randint(0, nm + 1, size=(B,) + tuple(hw))
    return (lab[..., None] == np.arange(nm)).astype(np.float32)


def _images(r, B, hw):
    return (r.rand(B, *hw, 1) * 2 - 1).astype(np.float32)


def _batches(conf, seed):
    r = np.random.RandomState(seed)
    B, hw, nm = conf.batch_size, conf.input_hw, conf.num_masks
    if conf.model == "mmsdnet":
        return [("supervised", {"x1": _images(r, B, hw), "x2": _images(r, B, hw),
                                "m1": _masks(r, B, hw, nm), "m2": _masks(r, B, hw, nm)}),
                ("discriminator", {"dm": _masks(r, B, hw, nm), "dx1": _images(r, B, hw),
                                   "dx2": _images(r, B, hw)})]
    batch = {k: _images(r, B, hw) for k in ("x1", "x2", "dx1", "dx2")}
    batch.update({k: _masks(r, B, hw, nm) for k in ("m1", "m2", "dm1", "dm2")})
    return [("supervised", batch)]


def _run(conf, remat):
    conf = dataclasses.replace(conf, remat_convs=remat)
    model = build_model(conf, device="cpu")
    assert any(getattr(m, "remat", False) for m in model.modules()) == remat
    steps = make_steps(model, conf)
    ts = create_train_state(model, conf)
    metrics = {}
    for kind, batch in _batches(conf, 3):
        ts, m = getattr(steps, "step_" + kind)(ts, batch)
        metrics.update({k: v.item() for k, v in m.items()})
    opts = [ts.opt_gen, *ts.opt_disc.values()] + ([ts.opt_zreg] if ts.opt_zreg else [])
    moments = [{k: v.clone() for k, v in st.items()} for o in opts for st in o.state.values()]
    return metrics, {k: v.clone() for k, v in model.state_dict().items()}, moments


@pytest.mark.parametrize("model", ["mmsdnet", "dafnet"])
def test_remat_changes_no_value(model):
    conf = tconfig.tiny_test_config(model)
    m0, sd0, mom0 = _run(conf, False)
    m1, sd1, mom1 = _run(conf, True)
    assert m1 == m0
    assert sd1.keys() == sd0.keys()
    for k in sd0:
        assert torch.equal(sd1[k], sd0[k]), k
    assert len(mom1) == len(mom0)
    for a, b in zip(mom1, mom0):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    # the statistics moved (once: equal to the run without remat)
    stats = [k for k in sd0 if k.endswith("running_mean")]
    assert stats and all(not torch.equal(sd0[k], torch.zeros_like(sd0[k])) for k in stats)


def test_remat_applies_the_running_statistics_once():
    """One remat'd ConvBlock call in train mode and its backward: the
    running mean moves by exactly one EMA step (the recomputation in the
    backward drops its moments)."""
    from multimodal_segmentation_torch.nn.blocks import ConvBlock

    torch.manual_seed(0)
    block = ConvBlock(2, 3, remat=True).train()
    plain = ConvBlock(2, 3, remat=False).train()
    plain.load_state_dict(block.state_dict())
    x = torch.randn(4, 2, 6, 6)
    for b in (block, plain):
        b(x.clone().requires_grad_(True), 2).square().sum().backward()
    for name, m in block.named_modules():
        if isinstance(m, BatchNorm):
            ref = dict(plain.named_modules())[name]
            assert torch.equal(m.running_mean, ref.running_mean)
            assert torch.equal(m.running_var, ref.running_var)
            assert m.deferred == ()
    for (n, p), q in zip(block.named_parameters(), plain.parameters()):
        assert torch.equal(p.grad, q.grad), n


def test_remat_step_matches_jax_remat_step():
    jconf = dataclasses.replace(jconfig.tiny_test_config("mmsdnet"), remat_convs=True)
    tconf = dataclasses.replace(tconfig.tiny_test_config("mmsdnet"), remat_convs=True)
    jmodel, params, state = jax_mmsdnet(jconf)
    for name in ("enc_anatomy1", "enc_anatomy2"):
        params[name]["conv_anatomy"]["kernel"] *= 40.0
    B, HW, NZ, LR = jconf.batch_size, jconf.input_hw, jconf.num_z, jconf.lr
    jts = jcreate_state(jmodel, jconf, jax.random.PRNGKey(0))
    jts = jts.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                      model_state=jax.tree_util.tree_map(jnp.asarray, state))
    rng = jax.random.fold_in(jts.rng, jts.step)
    r_aug, r_gen, r_z, _ = jax.random.split(rng, 4)
    noise = {"angles": [np.array(jangles(r_aug, B, jconf.rotation_range))],
             "gen_eps": jax_sample_eps(params, r_gen, 6 * B, HW),
             "zreg_z": [np.array(jax.random.normal(jax.random.fold_in(r_z, i), (B, NZ)))
                        for i in range(6)]}
    model = load_jax_weights(build_model(tconf, device="cpu"), params, state)
    tts = create_train_state(model, tconf)
    set_adam(tts.opt_gen, model, jmodel.GEN_COMPONENTS, jts.opt_gen[0])
    set_adam(tts.opt_zreg, model, jmodel.ZREG_COMPONENTS, jts.opt_zreg[0])
    batch = _batches(tconf, 74)[0][1]

    jsteps = JSteps(jmodel, jconf)

    def gen_params(p):
        return np.concatenate([l.ravel() for n in jmodel.GEN_COMPONENTS
                               for l in jax.tree_util.tree_leaves(p[n])])

    moved = []
    for delta in (1e-6, -1e-6):
        p = dict(params)
        p["fuser"] = jax.tree_util.tree_map(np.array, params["fuser"])
        p["fuser"]["locnet"]["Dense_1"]["bias"] += np.float32(delta)
        out = jsteps.step_supervised(jax.tree_util.tree_map(jnp.copy, jts).replace(
            params=jax.tree_util.tree_map(jnp.asarray, p)), batch)[0]
        moved.append(gen_params(jax.tree_util.tree_map(np.array, out.params)))
    jts, jmet = jsteps.step_supervised(jts, batch)
    tts, tmet = make_steps(model, tconf).step_supervised(tts, batch, noise)
    assert sorted(tmet) == sorted(jmet)
    for k in tmet:
        rtol = 2e-3 if k == "rec_Z" else 1e-5
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=rtol, err_msg=k)
    jparams, jstate = jax.tree_util.tree_map(np.array, (jts.params, jts.model_state))
    trees = {n: component_trees(getattr(model, n).state_dict()) for n in jparams}
    for n, tree in jstate["batch_stats"].items():
        for path, want in jax.tree_util.tree_leaves_with_path(tree):
            got = trees[n]["batch_stats"]
            for key in path:
                got = got[key.key]
            np.testing.assert_allclose(got, want, atol=1e-5)
    got = gen_params({n: trees[n]["params"] for n in jmodel.GEN_COMPONENTS})
    want = gen_params(jparams)
    d = np.abs(got - want)
    jax_share = max((np.abs(m - want) > 0.2 * LR).mean() for m in moved)
    share = (d > 0.2 * LR).mean()
    assert d.max() <= 2.1 * LR and share <= max(5e-3, 2 * jax_share + 1e-3), \
        "max %.3g lr, share %.3g (JAX %.3g)" % (d.max() / LR, share, jax_share)
