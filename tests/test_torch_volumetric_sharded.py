"""The volumetric path on a ('data', 'space') mesh, on the CPU: gloo
ranks (tests/torch_dist.py) against the port's unsharded run at the JAX
tests' tiny size ((8, 32, 32, 3) volumes, filters3d 4, downsample3d 2,
batch 2, rotation 15).

  * one Cardiac3DSegmenter.step on (1, 2), (2, 1) and (2, 2) meshes from
    the same weights, batch and angles: the loss within 2e-5 relative
    (the JAX package's bound, tests/test_volumetric.py:127-148) and every
    gradient leaf within 1e-5 of its largest entry, after the mesh's
    reduction; the zero-gradient biases (every conv bias ahead of an
    InstanceNorm3D, roundoff in both runs) within 1e-5 of the largest
    kernel gradient. A pre-activation within roundoff of 0 may take the
    other ReLU branch in the other order of the sums: each rank takes the
    unsharded run's branch there (torch_dist.volumetric_step), and the
    count is reported;
  * predict on an odd batch of 3 studies, D split over 'space';
  * the rotation of a D-slab with its study's angle is the slab of the
    whole study's rotation;
  * the 3-D executor on a (1, 2) mesh against one process: the same
    training.csv, test Dice and weights, and one set of files.
"""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

from multimodal_segmentation_torch import config as tconfig
from multimodal_segmentation_torch.data import init_loader
from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter
from multimodal_segmentation_torch.ops import augment
import torch_dist

torch.set_num_threads(1)

TINY = dict(volume_shape=(8, 32, 32, 3), filters3d=4, downsample3d=2, batch_size=2)
CONF = dataclasses.replace(tconfig.cardiac_3d(), rotation_range=15.0, **TINY)


def zero_gradient_biases(downsample):
    return {"ConvBlock3D_%d.Conv_%d.bias" % (b, c)
            for b in range(2 * downsample + 1) for c in (0, 1)}


def _weights(seed):
    """The UNet3D's state_dict with non-zero biases and norm scales (so the
    zero-gradient biases are not trivially 0)."""
    net, _ = Cardiac3DSegmenter(CONF, device="cpu").init(seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in net.named_parameters():
            if n.endswith("bias"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
            elif "InstanceNorm" in n:
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g))
    return {k: v.clone() for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The unsharded step, then the same step on each mesh."""
    xs, ys = init_loader("cardiac", shape=TINY["volume_shape"][:3]).load_volumes(0, "training")
    vb, mb = xs[:2], ys[:2]
    th = augment.random_rotation_angles(torch.Generator().manual_seed(3), 2, 15.0).numpy()
    sd = _weights(4)
    predict_batch = xs[2:5]
    ref = torch_dist.volumetric_step(None, None, CONF, sd, vb, mb, th, None, predict_batch)
    jobs = [torch_dist.Ranks(torch_dist.volumetric_on_meshes, n, tmp_path_factory.mktemp("v%d" % n),
                             shapes, CONF, sd, vb, mb, th, ref["norms"], predict_batch)
            for n, shapes in ((2, [(1, 2), (2, 1)]), (4, [(2, 2)]))]
    got = {}
    for job in jobs:
        for rank, res in enumerate(job.join()):
            for shape, r in res.items():
                got.setdefault(shape, []).append(r)
    return ref, got


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
def test_sharded_step_matches_unsharded(runs, shape):
    ref, got = runs
    exempt = zero_gradient_biases(CONF.downsample3d)
    top = max(g.abs().max().item() for g in ref["grads"].values())
    for r in got[shape]:
        assert abs(r["loss"] / ref["loss"] - 1) <= 2e-5, (r["loss"], ref["loss"])
        assert r["kinks"] <= 4, r["kinks"]
        for name, g in ref["grads"].items():
            d = (r["grads"][name] - g).abs().max().item()
            if name in exempt:
                assert d <= 1e-5 * top, (name, d)
            else:
                assert d <= 1e-5 * g.abs().max().item(), (name, d / g.abs().max().item())


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
def test_sharded_predict_takes_any_batch(runs, shape):
    """predict on 3 studies (no split over 'data'): every rank holds the
    whole prediction, within 1e-5 of the unsharded one."""
    ref, got = runs
    for r in got[shape]:
        assert r["predict"].shape == ref["predict"].shape == (3, 8, 32, 32, 4)
        assert np.abs(r["predict"] - ref["predict"]).max() <= 1e-5


def test_rotation_of_a_depth_slab_is_a_slab_of_the_rotation():
    r = np.random.RandomState(2)
    vols = torch.from_numpy(r.rand(2, 8, 16, 16, 3).astype(np.float32))
    msks = torch.from_numpy((r.rand(2, 8, 16, 16, 2) > 0.5).astype(np.float32))
    th = torch.tensor([0.2, -0.3])
    whole = augment.random_rotate_volumes(th, vols, msks)
    for b in range(2):
        for d0 in (0, 4):
            part = augment.random_rotate_volumes(th[b:b + 1], vols[b:b + 1, d0:d0 + 4],
                                                 msks[b:b + 1, d0:d0 + 4])
            for p, w in zip(part, whole):
                assert torch.equal(p, w[b:b + 1, d0:d0 + 4])


def _csv(folder):
    with open(os.path.join(folder, "training.csv")) as f:
        return list(csv.DictReader(f))


def test_sharded_executor_matches_one_process(tmp_path):
    """Cardiac3DExecutor (2 epochs, then the test) on a (1, 2) mesh
    against one process: the epoch losses within 1e-5 relative; the
    weights within 1e-5 of each leaf's largest entry plus 0.05 lr a step
    (Adam on gradients near 0, as the 2-D steps' bound), the zero-gradient
    biases within 2 lr a step (tests/test_torch_volumetric.py); the validation
    and test Dice, of binarised predictions where a pixel near 0.5 may
    round the other way, within 1e-3 (tests/test_torch_volumetric.py's
    bound against JAX); the files written once, by rank 0."""
    conf = dataclasses.replace(CONF, epochs=2)
    job = torch_dist.Ranks(torch_dist.run_volumetric_executor, 2, tmp_path, (1, 2),
                           dataclasses.replace(conf, folder=str(tmp_path / "dp")))
    alone = torch_dist.run_volumetric_executor(None, None,
                                               dataclasses.replace(conf, folder=str(tmp_path / "one")))
    ranks = job.join()
    ref, got = _csv(tmp_path / "one"), _csv(tmp_path / "dp")
    assert len(got) == len(ref) == 2
    for g, w in zip(got, ref):
        assert g["epoch"] == w["epoch"]
        assert abs(float(g["loss"]) / float(w["loss"]) - 1) <= 1e-5
        assert abs(float(g["val_dice"]) - float(w["val_dice"])) <= 1e-3
    steps = 2 * (len(init_loader("cardiac", shape=TINY["volume_shape"][:3]).load_volumes(
        0, "training")[0]) // 2)
    exempt = zero_gradient_biases(CONF.downsample3d)
    for r in ranks:
        assert abs(r["dice"] - alone["dice"]) <= 1e-3
        for k, v in alone["params"].items():
            d = (r["params"][k] - v).abs().max().item()
            if k in exempt:
                assert d <= 2 * conf.lr * steps, (k, d)
            else:
                assert d <= 1e-5 * v.abs().max().item() + 0.05 * conf.lr * steps, (k, d)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "dp")
                   for d, _, fs in os.walk(tmp_path / "dp") for f in fs)
    assert files == ["models/cardiac3d.npz", "test_results_cardiac/results.csv", "training.csv"]
