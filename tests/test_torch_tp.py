"""The port's tensor parallelism over the mesh's 'model' axis on the CPU
(parallel/sharding.py), with gloo ranks started by tests/torch_dist.py.

  * the leaves the rule shards are JAX's: tp_shard_train_state on the
    conftest's 8-device CPU mesh, read by Flax path, for the parameters and
    opt_gen's mu and nu, at min_features 64 and 16 (5 and 17 leaves at the
    tiny DAFNet);
  * a (1, 2) mesh on 2 ranks: a DAFNet expert step supervised and one
    unsupervised, and an MMSDNet batch (a generator step with its
    Z-regressor update, and a discriminator step), then an SWA update, at
    min_features 16: the metrics and the whole state (parameters, BatchNorm
    statistics, spectral u, every Adam's moments and the SWA average)
    equal one process's bit for bit, and each rank holds half of each
    sharded leaf and of its moments;
  * checkpoints: one saved on (1, 2) restores in one process to the one
    process's state, bit for bit; one saved by one process resumes on
    (1, 2), whose next step equals the one process's next step;
  * the DAFNet executor (an epoch of 2 steps, then the test) on (1, 2)
    against one process: the same training.csv, SWA average and
    checkpoint, bit for bit;
  * a (2, 2) mesh on 4 ranks: one expert step within the data-parallel
    bounds of tests/test_torch_parallel.py (the metrics 1e-5 relative;
    every leaf within 1e-5 of its largest entry plus 0.05 lr a step, the
    conv biases ahead of a BatchNorm within 2 lr a step).
"""

import csv
import dataclasses
import os

import jax
import pytest
import torch

from multimodal_segmentation_tpu import config as jconfig
from multimodal_segmentation_tpu.models import build_model as build_jax_model
from multimodal_segmentation_tpu.parallel.mesh import make_mesh as jmake_mesh
from multimodal_segmentation_tpu.parallel.sharding import tp_shard_train_state as jshard
from multimodal_segmentation_tpu.train.state import create_train_state as jcreate_state
from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch.models import build_model
from multimodal_segmentation_torch.parallel.sharding import tp_leaf_names
from multimodal_segmentation_torch.utils.checkpoint import CheckpointManager
from multimodal_segmentation_torch.utils.convert import flax_paths, params_by_component
import torch_dist
from test_torch_parallel import _assert_dp_matches, _training_batches

torch.set_num_threads(1)

MIN_FEATURES = 16


# ------------------------------------------------------------ the leaf set

def _jax_sharded(min_features):
    """{'params' | 'mu' | 'nu': set of Flax paths} that JAX's
    tp_shard_train_state puts on 'model' at the tiny DAFNet."""
    conf = jconfig.tiny_test_config("dafnet")
    mesh = jmake_mesh(n_data=4, n_model=2)
    ts = jcreate_state(build_jax_model(conf), conf, jax.random.PRNGKey(0))
    ts = jshard(mesh, ts, min_features=min_features)

    def on_model(tree):
        return {"/".join(str(k.key) for k in path)
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
                if "model" in tuple(leaf.sharding.spec)}
    adam = ts.opt_gen[0]
    return {"params": on_model(ts.params), "mu": on_model(adam.mu), "nu": on_model(adam.nu)}


@pytest.mark.parametrize("min_features,count", [(64, 5), (16, 17)])
def test_sharded_leaves_are_jaxs(min_features, count):
    want = _jax_sharded(min_features)
    model = build_model(tconfig.tiny_test_config("dafnet"), device="cpu")
    names = tp_leaf_names(model, 2, min_features)
    params = dict(model.named_parameters())
    paths = {"%s/%s" % (comp, path)
             for comp, tree in params_by_component({n: params[n] for n in names}).items()
             for path in flax_paths(tree)}
    assert len(names) == count and paths == want["params"]
    gen = {p for p in paths if p.split("/")[0] in model.GEN_COMPONENTS}
    assert want["mu"] == want["nu"] == gen and gen
    # read off torch's shapes the rule would take other leaves
    torch_rule = {n for n, p in params.items() if p.dim() >= 2 and p.shape[-1] >= min_features
                  and p.shape[-1] % 2 == 0}
    assert torch_rule != set(names)


# ---------------------------------------------------- steps on the meshes

def _dafnet_jobs(conf, sd, batches, ckpt_one):
    sup, unsup = batches[0], {k: v for k, v in batches[1].items() if k != "m2"}
    return {
        "dafnet": (conf, sd, [("supervised", sup, None), ("unsupervised", unsup, None)],
                   MIN_FEATURES),
        "resumed": (conf, sd, [("supervised", batches[2], None)], MIN_FEATURES, ckpt_one),
    }


def _executor_conf(folder):
    return dataclasses.replace(tconfig.tiny_test_config(), dataset_name="synthetic",
                               test_dataset="synthetic", steps_per_epoch=2, epochs=1,
                               folder=str(folder))


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The (1, 2) and (2, 2) jobs, started together, and the one-process
    references computed meanwhile."""
    work = tmp_path_factory.mktemp("tp")
    conf = tconfig.tiny_test_config("dafnet")
    sd = {k: v.clone() for k, v in build_model(conf, device="cpu").state_dict().items()}
    batches = _training_batches(conf, 3)
    mconf = tconfig.tiny_test_config("mmsdnet")
    msd = {k: v.clone() for k, v in build_model(mconf, device="cpu").state_dict().items()}
    (mb,) = _training_batches(mconf, 1)
    ref = {}
    # one process: two steps, saved for the (1, 2) resume
    ref["dafnet"] = torch_dist.tp_run(None, *_dafnet_jobs(conf, sd, batches, None)["dafnet"],
                                      save=str(work / "from_one"))
    jobs = _dafnet_jobs(conf, sd, batches, str(work / "from_one"))
    jobs["mmsdnet"] = (mconf, msd, [("supervised", mb["sup"], None),
                                    ("discriminator", mb["disc"], None)], MIN_FEATURES)
    jobs["dafnet"] = jobs["dafnet"] + (None, str(work / "from_tp"))
    for d in ("r12", "r22"):
        os.makedirs(work / d)
    pair = torch_dist.Ranks(torch_dist.tp_job, 2, work / "r12", (1, 2), jobs,
                            _executor_conf(work / "exec_tp"))
    quad = torch_dist.Ranks(torch_dist.tp_job, 4, work / "r22", (2, 2),
                            {"dafnet": (conf, sd, [("supervised", batches[0], None)],
                                        MIN_FEATURES)})
    ref["resumed"] = torch_dist.tp_run(None, *jobs["resumed"])
    ref["mmsdnet"] = torch_dist.tp_run(None, *jobs["mmsdnet"])
    ref["one_step"] = torch_dist.tp_run(None, conf, sd, [("supervised", batches[0], None)],
                                        MIN_FEATURES)
    ref["executor"] = torch_dist.tp_executor(None, _executor_conf(work / "exec_one"))
    return {"work": work, "ref": ref, "pair": pair.join(), "quad": quad.join(),
            "conf": conf, "mconf": mconf}


def _assert_equal(got, ref, where=""):
    """Nested dicts / lists of tensors and numbers, bit for bit."""
    if isinstance(ref, dict):
        assert sorted(got, key=str) == sorted(ref, key=str), where
        for k in ref:
            _assert_equal(got[k], ref[k], "%s/%s" % (where, k))
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), where
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_equal(a, b, "%s/%d" % (where, i))
    elif isinstance(ref, torch.Tensor):
        assert got.shape == ref.shape and torch.equal(got, ref), where
    else:
        assert got == ref, where


@pytest.mark.parametrize("job", ["dafnet", "mmsdnet", "resumed"])
def test_one_by_two_mesh_equals_one_process(tp_runs, job):
    ref = tp_runs["ref"][job]
    conf = tp_runs["mconf" if job == "mmsdnet" else "conf"]
    names = tp_leaf_names(build_model(conf, device="cpu"), 2, MIN_FEATURES)
    for r in tp_runs["pair"]:
        got = r[job]
        assert got["count"] == len(names) > 0
        _assert_equal(got["metrics"], ref["metrics"], job + " metrics")
        _assert_equal(got["state"], ref["state"], job)
        whole = {n: tuple(t.shape) for n, t in ref["state"]["model"].items()}
        assert sorted(got["local_shapes"]) == sorted(names)
        for n, shape in got["local_shapes"].items():
            assert shape == (whole[n][0] // 2,) + whole[n][1:], n
            if n in got["moment_shapes"]:
                assert got["moment_shapes"][n] == shape
        assert got["moment_shapes"]


def test_checkpoint_from_the_mesh_restores_in_one_process(tp_runs):
    """The (1, 2) ranks saved their state after the two DAFNet steps (rank
    0 wrote it): restored in one process it is the one process's state."""
    conf = tp_runs["conf"]
    ref = tp_runs["ref"]["dafnet"]["state"]
    from multimodal_segmentation_torch.train import create_train_state

    model = build_model(conf, device="cpu")
    ts = CheckpointManager(str(tp_runs["work"] / "from_tp")).restore(
        0, create_train_state(model, conf))
    _assert_equal(torch_dist.tp_state(ts), ref, "restored")
    saved = [torch.load(os.path.join(tp_runs["work"], d, "checkpoints", "epoch_0.pt"),
                        weights_only=True) for d in ("from_tp", "from_one")]
    _assert_equal(saved[0]["model"], saved[1]["model"], "files")


def _csv(folder):
    with open(os.path.join(folder, "training.csv")) as f:
        return list(csv.DictReader(f))


def test_executor_on_the_mesh_equals_one_process(tp_runs):
    work = tp_runs["work"]
    ref = tp_runs["ref"]["executor"]
    for r in tp_runs["pair"]:
        got = r["executor"]
        assert got["step"] == ref["step"] == 2 and len(got["sharded"]) == 17
        _assert_equal(got["swa"], ref["swa"], "swa")
    assert _csv(work / "exec_tp") == _csv(work / "exec_one")
    files = [torch.load(os.path.join(work, d, "checkpoints", "epoch_0.pt"), weights_only=True)
             for d in ("exec_tp", "exec_one")]
    for key in ("model", "swa", "opt_gen", "step", "epoch"):
        _assert_equal(files[0][key], files[1][key], key)
    assert sorted(os.listdir(work / "exec_tp" / "models")) == \
        sorted(os.listdir(work / "exec_one" / "models"))


def test_two_by_two_mesh_within_the_data_parallel_bounds(tp_runs):
    ref = tp_runs["ref"]["one_step"]
    model = build_model(tp_runs["conf"], device="cpu")
    for r in tp_runs["quad"]:
        got = r["dafnet"]
        _assert_dp_matches({"step": got["state"]["step"], "metrics": got["metrics"],
                            "state": got["state"]["model"]},
                           {"step": ref["state"]["step"], "metrics": ref["metrics"],
                            "state": ref["state"]["model"]}, model, 1)
        assert len(got["local_shapes"]) == 17
