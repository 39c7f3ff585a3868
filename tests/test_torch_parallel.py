"""The port's data parallelism on the CPU: gloo ranks started with
torch.multiprocessing (tests/torch_dist.py), held against one process on
the whole batch and against the JAX package.

  * maybe_initialize_distributed from torchrun's variables, and its no-op;
  * the differentiable all-reduce and the halo exchange (both of its
    transports) under torch.autograd.gradcheck in f64;
  * halo_conv2d and halo_conv3d on 2 and 4 ranks: within 1e-5 of the
    unsharded torch conv (output and gradients), and within 1e-4 of the
    JAX package's halo_conv2d / halo_conv3d on the 8-device CPU mesh
    (tests/test_halo.py's bound);
  * grouped BatchNorm and the weighted BCE on 2 ranks: within 1e-6 of one
    process on the whole batch (outputs, gradients, running statistics);
  * the DAFNet expert and automated steps and an MMSDNet batch on 2
    ranks, two steps each, against one process on the whole batches, a
    step at a time from the same train state (`_assert_dp_matches`): the
    metrics within 1e-5 relative; every parameter, BatchNorm statistic
    and spectral u within 1e-5 of its leaf's largest entry plus 0.05 lr a
    step, and the conv biases ahead of a BatchNorm within 2 lr a step.
    Adam divides each gradient entry by its own RMS: an entry near 0
    turns the other order of the sums into a step difference of a share
    of lr, and the biases ahead of a BatchNorm, whose gradient is 0 in
    exact arithmetic and roundoff of either sign, into steps of up to lr
    either way; so do the other entries whose one-process gradient is
    within roundoff of 0 (at most 0.1 % of a leaf). The batches come
    from a fixed numpy seed (automated pairing draws its candidates from
    numpy's global state);
    The expert step on 2 ranks is also held against the JAX package's
    one-device step on the whole batch, with the bounds that
    tests/test_torch_dafnet_train.py holds the one-process port to;
  * the partition rules' promise (pallas_kernels.py:446-594 of the JAX
    package): each kernel's plain version on the halves of a batch,
    concatenated, is the whole call bit for bit;
  * the 2-D executor on 2 ranks against one process: the same
    training.csv, SWA weights and early stop, and one set of files.
"""

import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from multimodal_segmentation_tpu import config as jconfig
from multimodal_segmentation_tpu.parallel.halo import halo_conv2d as jhalo_conv2d
from multimodal_segmentation_tpu.parallel.halo import halo_conv3d as jhalo_conv3d
from multimodal_segmentation_tpu.train.state import create_train_state as jcreate_state
from multimodal_segmentation_tpu.train.steps import DAFNetSteps as JSteps
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch.nn.blocks import BatchNorm, Conv2d
from multimodal_segmentation_torch.ops import augment, tps
from multimodal_segmentation_torch.parallel import distributed, make_mesh, shard_batch
from multimodal_segmentation_torch.utils.convert import component_trees
import torch_dist
from torch_parity import jax_dafnet, torch_dafnet

torch.set_num_threads(1)


# ------------------------------------------------------------ process start

def test_maybe_initialize_distributed_from_the_environment(tmp_path):
    """Two processes with torchrun's variables: a gloo group on the CPU
    whose all-reduce of the ranks gives n(n-1)/2 (tests/test_distributed.py
    checks the same in JAX); a second call leaves it as it is."""
    res = torch_dist.run_ranks(torch_dist.init_from_environment, 2, tmp_path, torchrun_env=True)
    for r in res:
        assert r["initialised"] and not r["again"]
        assert (r["sum"], r["world"], r["backend"], r["device"]) == (1.0, 2, "gloo", "cpu")


def test_maybe_initialize_distributed_is_a_noop_without_the_variables(monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(v, raising=False)
    assert distributed.maybe_initialize_distributed() is False
    assert not dist.is_initialized()


def test_a_mesh_of_one_process_holds_everything():
    """Without torch.distributed: a mesh of one rank, axes without groups,
    shard_batch the whole batch; a larger mesh, over 'data' or over
    'model' (tests/test_torch_tp.py runs those on ranks), raises."""
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    assert mesh.axis("data").group is None and distributed.is_writer(mesh)
    a = np.arange(12.0).reshape(6, 2)
    got = shard_batch(mesh, {"sup": {"x": a}}, "cpu")["sup"]["x"]
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), a)
    with pytest.raises(ValueError):
        make_mesh(2)
    with pytest.raises(ValueError):
        make_mesh(1, 2)


# ------------------------------------------------- collectives and halo conv

def _conv_cases():
    r = np.random.RandomState(3)
    cases = {}
    for kh in (1, 3, 5):
        cases["2d k%d" % kh] = (r.rand(2, 32, 16, 4).astype(np.float32),
                                r.rand(8, 4, kh, kh).astype(np.float32),
                                r.randn(2, 32, 16, 8).astype(np.float32))
    cases["3d k3"] = (r.rand(1, 16, 8, 8, 3).astype(np.float32),
                      r.rand(4, 3, 3, 3, 3).astype(np.float32),
                      r.randn(1, 16, 8, 8, 4).astype(np.float32))
    return cases


def _norm_case():
    r = np.random.RandomState(4)
    lab = r.randint(0, 3, size=(4, 6, 5))
    return {"x": (r.randn(8, 3, 5, 4) * 2 + 1).astype(np.float32),
            "y_true": (lab[..., None] == np.arange(3)).astype(np.float32),
            "y_pred": r.dirichlet(np.ones(3), size=(4, 6, 5)).astype(np.float32),
            "probe": r.randn(8, 3, 5, 4).astype(np.float32)}


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    """{2: ranks' results, 4: ...}: the collectives job on 2 and 4 ranks."""
    jobs = {n: torch_dist.Ranks(torch_dist.collectives, n, tmp_path_factory.mktemp("c%d" % n),
                                n, _conv_cases(), _norm_case() if n == 2 else None)
            for n in (2, 4)}
    return {n: job.join() for n, job in jobs.items()}


@pytest.mark.parametrize("n", [2, 4])
def test_all_reduce_and_halo_exchange_pass_gradcheck(collective_runs, n):
    """f64 gradcheck of all_reduce_sum and of the halo exchange (halo 1
    and 2, send/recv and the zero-padded all-reduce) as functions of the
    whole input, on every rank."""
    for r in collective_runs[n]:
        assert set(r["gradcheck"]) == {"all_reduce_sum", "halo1 send/recv", "halo1 all_reduce",
                                       "halo2 send/recv", "halo2 all_reduce"}
        assert all(r["gradcheck"].values()), r["gradcheck"]
        assert r["halo_transport_cpu"] == "send/recv"


def _torch_conv(x, w, probe):
    """The unsharded SAME conv (NHWC / NDHWC), its output and the
    gradients of sum(out * probe)."""
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    perm = (0, 3, 1, 2) if x.ndim == 4 else (0, 4, 1, 2, 3)
    back = (0, 2, 3, 1) if x.ndim == 4 else (0, 2, 3, 4, 1)
    conv = torch.nn.functional.conv2d if x.ndim == 4 else torch.nn.functional.conv3d
    y = conv(xt.permute(perm), wt, padding=w.shape[-1] // 2).permute(back)
    (y * torch.from_numpy(probe)).sum().backward()
    return y.detach().numpy(), wt.grad.numpy(), xt.grad.numpy()


def _jax_halo_conv(x, w, n):
    """The JAX package's halo conv on n of the conftest's 8 CPU devices,
    the weight in JAX's (k..., C_in, C_out) layout."""
    mesh = JMesh(np.array(jax.devices()[:n]), ("space",))
    spec = P(None, "space", *([None] * (x.ndim - 2)))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
    k = jnp.asarray(np.moveaxis(np.moveaxis(w, 0, -1), 0, -2))
    fn = jhalo_conv2d if x.ndim == 4 else jhalo_conv3d
    return np.asarray(fn(xs, k, mesh))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["2d k1", "2d k3", "2d k5", "3d k3"])
def test_halo_conv_matches_unsharded_and_jax(collective_runs, n, case):
    x, w, probe = _conv_cases()[case]
    ref, ref_gw, ref_gx = _torch_conv(x, w, probe)
    jref = _jax_halo_conv(x, w, n)
    for r in collective_runs[n]:
        got = r["conv"][case]
        assert np.abs(got["out"] - ref).max() <= 1e-5 * np.abs(ref).max()
        assert np.abs(got["grad_w"] - ref_gw).max() <= 1e-5 * np.abs(ref_gw).max()
        assert np.abs(got["grad_x"] - ref_gx).max() <= 1e-5 * np.abs(ref_gx).max()
        np.testing.assert_allclose(got["out"], jref, atol=1e-4)


def test_grouped_batchnorm_and_weighted_bce_match_one_process(collective_runs):
    """Two ranks, each with half of the batch, against one process on all
    of it (f64): the BatchNorm output, its input's and parameters'
    gradients and its running statistics, the weighted BCE in both forms
    and its prediction's gradient, within 1e-6; shard_batch gives each
    rank its rows."""
    case = _norm_case()
    ref = torch_dist.norm_and_bce(None, **{k: torch.from_numpy(v) for k, v in case.items()})
    for rank, r in enumerate(collective_runs[2]):
        assert np.array_equal(r["rows"].numpy(), np.arange(8.0).reshape(4, 2)[2 * rank:2 * rank + 2])
        got = r["norm"]
        half = slice(4 * rank, 4 * rank + 4)
        pairs = [(got["out"], ref["out"][half]), (got["eval_out"], ref["eval_out"][half]),
                 (got["bce_perbatch"], ref["bce_perbatch"][2 * rank:][:2]),
                 (got["grads"]["x"], ref["grads"]["x"][half]),
                 (got["grads"]["y_pred"], ref["grads"]["y_pred"][2 * rank:][:2]),
                 (got["running_mean"], ref["running_mean"]),
                 (got["running_var"], ref["running_var"])]
        pairs += [(got["grads"][k], ref["grads"][k]) for k in ("weight", "bias")]
        for i, (a, b) in enumerate(pairs):
            assert a.shape == b.shape
            assert (a - b).abs().max().item() <= 1e-6 * max(1.0, b.abs().max().item()), i
    # each rank's BCE is the mean over its pixels, with the global masses
    bce = sum(r["norm"]["bce"] for r in collective_runs[2]) / 2
    assert abs(bce.item() - ref["bce"].item()) <= 1e-6 * abs(ref["bce"].item())


# -------------------------------------------------------------- the steps

JCONF = jconfig.tiny_test_config()
TCONF = tconfig.tiny_test_config()
LR = TCONF.lr
# numpy's global seed for the batches' assembly (automated pairing's candidates)
PAIRS_SEED = 5
# a gradient entry within this share of its leaf's largest is roundoff of 0
# (f32 sums of terms of the leaf's size: ~1e-7 a term, ~100 ulps here)
NEAR_ZERO = 1e-5


def _biases_ahead_of_batchnorm(model):
    """The bias of every conv that feeds a BatchNorm (Conv_k -> Norm_k or
    BatchNorm_k in one module): gradient 0 in exact arithmetic."""
    names = set()
    for prefix, m in model.named_modules():
        for child_name, child in m.named_children():
            if isinstance(child, BatchNorm):
                conv = getattr(m, "Conv_" + child_name.rsplit("_", 1)[1], None)
                if isinstance(conv, Conv2d) and conv.bias is not None:
                    names.add((prefix + "." if prefix else "") + conv_name(m, conv) + ".bias")
    return names


def conv_name(parent, conv):
    return next(n for n, c in parent.named_children() if c is conv)


def _training_batches(conf, n, seed=PAIRS_SEED):
    """n batches of the executor's assembly from the synthetic loader.
    Automated pairing draws its candidate pairs from numpy's global random
    state (`expand_pairs`, as the JAX package's): the assembly runs from
    the state `seed` sets, and the caller's state is restored after it."""
    from multimodal_segmentation_torch.data import init_loader
    from multimodal_segmentation_torch.data.batches import TrainingData

    saved = np.random.get_state()
    np.random.seed(seed)
    try:
        loader = init_loader("synthetic", hw=conf.input_hw)
        loader.modalities = list(conf.modality)
        it = TrainingData(conf, loader).assembled_batches()
        out = []
        for _ in range(n):
            b = next(it)
            out.append({"sup": b["sup"], "disc": b["disc"]} if conf.model == "mmsdnet"
                       else b["sup"])
    finally:
        np.random.set_state(saved)
    return out


def _assert_dp_matches(got, ref, model, steps, grads=None):
    """The bounds of the data-parallel step against one process."""
    assert got["step"] == ref["step"]
    for g, r in zip(got["metrics"], ref["metrics"], strict=True):
        assert sorted(g) == sorted(r)
        for k in r:
            assert abs(g[k] - r[k]) <= 1e-5 * abs(r[k]), (k, g[k], r[k])
    _assert_state_close(got["state"], ref["state"], model, steps, grads)


def _assert_state_close(got, ref, model, steps, grads=None):
    """Every entry within 1e-5 of its leaf's largest plus 0.05 lr a step;
    the conv biases ahead of a BatchNorm within 2 lr a step. Given `grads`
    (the one-process run's, torch_dist.train_steps), an entry whose
    gradient was within roundoff of 0 at some step (NEAR_ZERO of its leaf's
    largest entry) may differ by up to 2 lr a step too, for the biases'
    reason: Adam turns roundoff of either sign into a step of up to lr
    either way. Those admitted must be few, at most 0.1 % of any leaf."""
    biases = _biases_ahead_of_batchnorm(model)
    assert biases
    for k, r in ref.items():
        d = (got[k] - r).abs()
        if k in biases:
            assert d.max().item() <= 2 * LR * steps, (k, d.max().item() / LR)
        elif r.is_floating_point():
            over = d > 1e-5 * r.abs().max().item() + 0.05 * LR * steps
            if grads is not None and k in grads:
                near = torch.zeros_like(over)
                for g in grads[k]:
                    near |= g.abs() <= NEAR_ZERO * g.abs().max()
                wide = over & near
                assert (d[wide] <= 2 * LR * steps).all(), k
                assert wide.sum().item() <= 1e-3 * r.numel(), (k, wide.sum().item())
                over &= ~near
            assert not over.any(), (k, d.max().item() / LR)
        else:
            assert torch.equal(got[k], r), k


def _same(a, b):
    """Equal, bit for bit, through nested dicts and sequences."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


@pytest.mark.parametrize("path", ["expert", "automated", "mmsdnet"])
def test_data_parallel_steps_match_one_process(path, tmp_path):
    """Two steps (MMSDNet: two batches of a generator and a discriminator
    step) on 2 ranks, each with half of every batch and drawing the global
    noise from its own generator, against one process on the whole
    batches, a step at a time from the train state the ranks started it
    from. Two runs that are not bit for bit the same part after an update:
    an lr-sized Adam step at an entry near gradient 0 moves the next
    forward by ~lr, which can move a ReLU across its kink and so other
    entries' next gradients by percents (one draw of the automated pairs
    in 57 did: 325 entries of a segmentor conv moved by up to 0.99 lr
    after two steps from the same weights)."""
    conf = tconfig.tiny_test_config("mmsdnet" if path == "mmsdnet" else "dafnet")
    conf.automatedpairing = path == "automated"
    from multimodal_segmentation_torch.models import build_model

    model = build_model(conf, device="cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batches = _training_batches(conf, 2)
    ranks = torch_dist.Ranks(torch_dist.train_steps, 2, tmp_path, 2, conf, sd, batches,
                             [None, None])
    refs = [torch_dist.train_steps(None, 1, conf, sd, batches[:1], [None])]
    res = ranks.join()
    assert _same(res[0]["states"][0], res[1]["states"][0])
    refs.append(torch_dist.train_steps(None, 1, conf, None, batches[1:], [None],
                                       start=res[0]["states"][0]))
    for i, ref in enumerate(refs):
        for got in res:
            _assert_dp_matches({"step": got["states"][i]["step"],
                                "metrics": got["metrics"][i:i + 1],
                                "state": got["states"][i]["model"]}, ref, model, 1, ref["grads"])


@pytest.fixture(scope="module")
def jax_model():
    """The JAX comparison's model: tests/test_torch_dafnet_train.py's
    weights (the anatomy head sharpened x20), batches and key splits, at
    the tiny config's batch of 2 (one row a rank). (model, params, state)."""
    model, params, state = jax_dafnet(JCONF)
    params["enc_anatomy"]["conv_anatomy"]["kernel"] *= 20.0
    return model, params, state


def _masks(r, B):
    lab = r.randint(0, JCONF.num_masks + 1, size=(B,) + JCONF.input_hw)
    return (lab[..., None] == np.arange(JCONF.num_masks)).astype(np.float32)


def _jax_batch(seed):
    r = np.random.RandomState(seed)
    B = JCONF.batch_size

    def img():
        return (r.rand(B, *JCONF.input_hw, 1) * 2 - 1).astype(np.float32)
    return {"x1": img(), "x2": img(), "m1": _masks(r, B), "m2": _masks(r, B),
            "dm1": _masks(r, B), "dm2": _masks(r, B), "dx1": img(), "dx2": img()}


def _jax_noise(jts, params):
    from multimodal_segmentation_tpu.ops.augment import random_rotation_angles as jangles
    from torch_parity import jax_sample_eps

    B, NZ, HW = JCONF.batch_size, JCONF.num_z, JCONF.input_hw
    rng = jax.random.fold_in(jts.rng, jts.step)
    r_aug1, r_aug2, r_aug3, r_z, r_gen, r_dm, _ = jax.random.split(rng, 7)
    rz1, rz2 = jax.random.split(r_z)
    r = jax.random.split(r_dm, 6)
    return {
        "angles": [np.array(jangles(k, B, JCONF.rotation_range)) for k in (r_aug1, r_aug2, r_aug3)],
        "z1": np.array(jax.random.normal(rz1, (B, NZ))),
        "z2": np.array(jax.random.normal(rz2, (B, NZ))),
        "gen_eps": jax_sample_eps(params, jax.random.split(r_gen, 4)[0], 2 * B, HW),
        "pool_mask_idx": [np.array(jax.random.randint(r[i], (B,), 0, 2)) for i in (0, 1)],
        "pool_eps": jax_sample_eps(params, r[2], 2 * B, HW),
        "pool_image_idx": [np.array(jax.random.randint(r[i], (B,), 0, 3)) for i in (4, 5)],
    }


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(l))
            for p, l in jax.tree_util.tree_leaves_with_path(tree)]


def test_data_parallel_expert_step_matches_jax(tmp_path, jax_model):
    """One expert step on 2 ranks (one row each) against the JAX package's
    step on one device over both rows, from the same weights, batch and
    key splits, with tests/test_torch_dafnet_train.py's bounds: the
    generator metrics within 1e-5 relative, the discriminator metrics
    within 2e-3 (they see the fake pools of the updated generator); the
    BatchNorm statistics and spectral u within 1e-5; the parameters move
    by lr-sized Adam steps: none differs by more than 2.1 lr and at most
    0.5 % by more than 0.2 lr."""
    jmodel, jparams, jstate = jax_model
    jts = jcreate_state(jmodel, JCONF, jax.random.PRNGKey(0))
    jts = jts.replace(params=jax.tree_util.tree_map(jnp.asarray, jparams),
                      model_state=jax.tree_util.tree_map(jnp.asarray, jstate))
    batch = _jax_batch(73)
    noise = _jax_noise(jts, jparams)
    model = torch_dafnet(TCONF, jparams, jstate)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    ranks = torch_dist.Ranks(torch_dist.train_steps, 2, tmp_path, 2, TCONF, sd, [batch], [noise])
    jts, jmet = JSteps(jmodel, JCONF).step_supervised(jts, batch)
    res = ranks.join()
    params, state = jax.tree_util.tree_map(np.array, (jts.params, jts.model_state))
    names = jmodel.GEN_COMPONENTS + jmodel.DISC_COMPONENTS
    for got in res:
        (tmet,) = got["metrics"]
        assert sorted(tmet) == sorted(jmet)
        for k in tmet:
            np.testing.assert_allclose(tmet[k], float(jmet[k]),
                                       rtol=2e-3 if k.startswith("dis_") else 1e-5, err_msg=k)
        model.load_state_dict(got["state"])
        for col in ("batch_stats", "spectral"):
            for n in state[col]:
                ours = component_trees(getattr(model, n).state_dict())[col]
                for (path, a), (_, b) in zip(_leaves(ours), _leaves(state[col][n]), strict=True):
                    np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=n + path)
        d = np.concatenate([np.abs(a - b).ravel() for n in names for (_, a), (_, b) in zip(
            _leaves(component_trees(getattr(model, n).state_dict())["params"]),
            _leaves(params[n]), strict=True)])
        assert d.max() <= 2.1 * LR and (d > 0.2 * LR).mean() <= 5e-3, (d.max() / LR,
                                                                      (d > 0.2 * LR).mean())


# ------------------------------------------------- the partition rules' promise

def test_each_kernels_plain_version_splits_over_the_batch():
    """What the JAX package's GSPMD batch rules (pallas_kernels.py:446-594)
    promise: B1-B4 are per sample, so each plain version on the halves of
    a batch, concatenated, is the whole call bit for bit (B1 the warp, B2
    its backward, B3 rotate_group and nearest_warp, B4 the rounding)."""
    from multimodal_segmentation_torch.ops.rounding import round_ste

    r = np.random.RandomState(8)
    B, H, W = 6, 48, 40
    vol = torch.from_numpy(r.rand(B, H, W, 8).astype(np.float32))
    off = torch.from_numpy(((r.rand(B, 25, 2) - 0.5) * 0.3).astype(np.float32))
    locs = tps.tps_sample_locations(off, (H, W))
    g = torch.from_numpy(r.randn(B, H, W, 8).astype(np.float32))
    arrays = [torch.from_numpy(r.rand(B, H, W, c).astype(np.float32)) for c in (1, 1, 4)]
    th = torch.from_numpy(r.uniform(-0.35, 0.35, B).astype(np.float32))
    x = torch.from_numpy(r.rand(B, 8, H, W).astype(np.float32))
    calls = {
        "tps_warp_fwd": lambda s: [tps._tps_warp_plain(vol[s], off[s])],
        "tps_warp_bwd": lambda s: list(tps._tps_warp_bwd_plain(vol[s], locs[s], g[s])),
        "rotate_group": lambda s: augment._rotate_group_plain([a[s] for a in arrays],
                                                              torch.cos(th[s]), torch.sin(th[s])),
        "nearest_warp": lambda s: [augment._nearest_warp_plain(
            vol[s], augment.rotation_locations(th[s], H, W))],
        "round_ste": lambda s: [round_ste(x[s])],
    }
    for name, call in calls.items():
        whole = call(slice(None))
        halves = [call(slice(0, 3)), call(slice(3, 6))]
        for k, w in enumerate(whole):
            assert torch.equal(torch.cat([halves[0][k], halves[1][k]]), w), name


# ------------------------------------------------------------- the executor

def _executor_conf(folder):
    """The tiny config for 3 epochs of 2 steps, with early stopping set to
    fire at epoch 1 (a loss must fall by 10 to count as progress)."""
    return dataclasses.replace(tconfig.tiny_test_config(), dataset_name="synthetic",
                               test_dataset="synthetic", steps_per_epoch=2, epochs=3,
                               es_patience=1, es_min_delta=10.0, folder=str(folder))


def _csv(folder):
    with open(os.path.join(folder, "training.csv")) as f:
        return list(csv.DictReader(f))


def _results(folder):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(folder) for f in fs
                  if f == "results.csv")


def test_data_parallel_executor_matches_one_process(tmp_path, monkeypatch):
    """The DAFNet executor (train, then test) on 2 ranks against one
    process from the same seed: the same training.csv within 1e-5
    relative, the same early stop (epoch 1 of 3), the same SWA weights
    (the steps' bounds), and one set of files: rank 0 writes what the one
    process writes, rank 1 nothing."""
    monkeypatch.chdir(tmp_path)
    job = torch_dist.Ranks(torch_dist.run_executor, 2, tmp_path, 2, _executor_conf(tmp_path / "dp"))
    alone = torch_dist.run_executor(None, 1, _executor_conf(tmp_path / "alone"))
    ranks = job.join()
    assert alone["stopped_epoch"] == 1 and alone["epoch"] == 1 and alone["step"] == 4
    assert alone["writes"] == {"save": 3, "save_component_weights": 2, "on_epoch_end": 4,
                               "run": 1}
    assert ranks[0]["writes"] == alone["writes"] and ranks[1]["writes"] == {}
    from multimodal_segmentation_torch.models import build_model

    model = build_model(_executor_conf(tmp_path), device="cpu")
    for r in ranks:
        assert (r["epoch"], r["step"], r["stopped_epoch"]) == (1, 4, 1)
        _assert_state_close(r["swa"], alone["swa"], model, 4)
    ref, got = _csv(tmp_path / "alone"), _csv(tmp_path / "dp")
    assert len(got) == len(ref) == 2 and list(got[0]) == list(ref[0])
    for g, w in zip(got, ref):
        for k in w:
            assert abs(float(g[k]) - float(w[k])) <= 1e-5 * abs(float(w[k])), k
    assert len(_results(tmp_path / "dp")) == len(_results(tmp_path / "alone")) == 12
    assert sorted(os.listdir(tmp_path / "dp" / "checkpoints")) == \
        sorted(os.listdir(tmp_path / "alone" / "checkpoints"))
