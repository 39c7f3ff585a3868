"""Volumetric multi-sequence cardiac segmentation (the 3-D model).

Port of multimodal_segmentation_tpu/models/volumetric.py:42-277: a 3-D
UNet (nn/unet3d.py) over (B, D, H, W, 3) LGE + bSSFP + T2 volumes, its
training step (in-plane rotation, Dice + weighted BCE with D folded into
the batch, optax-style Adam), whole-volume Dice evaluation, the training
loop and the executor with its artifacts (training.csv,
models/cardiac3d.npz in the JAX package's key layout,
test_results_cardiac/results.csv). One device: the JAX package's
('data', 'space') mesh layout is not ported.

A train step on the GPU launches two nearest_warp kernels (the rotation
of the volumes and of the masks) and nothing else of the port's kernels.
"""

import csv
import os
import time

import numpy as np
import torch

from multimodal_segmentation_torch.data.loader_factory import init_loader
from multimodal_segmentation_torch.losses import combined_dice_bce, dice_np_volume
from multimodal_segmentation_torch.models import full_f32_matmuls
from multimodal_segmentation_torch.models.base import resolve_device
from multimodal_segmentation_torch.nn.blocks import flax_init_
from multimodal_segmentation_torch.nn.unet3d import UNet3D
from multimodal_segmentation_torch.ops.augment import random_rotate_volumes, random_rotation_angles
from multimodal_segmentation_torch.utils.convert import unet3d_npz, unet3d_state_dict_from_npz


def _fold_depth(x):
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def adam(params, lr):
    """optax.adam(lr) (models/volumetric.py:55): beta1 0.9, beta2 0.999,
    eps 1e-8, lr * m_hat / (sqrt(v_hat) + eps). Not the 2-D path's Keras
    Adam (train/state.py), whose eps is 1e-7."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


class Cardiac3DSegmenter:
    """The 3-D UNet and its training step on one device (default the GPU).

    `params` is the UNet3D module and `opt` its Adam, as `init` returns
    them; `step` updates both in place and returns them, with the loss, in
    the JAX package's (params, opt_state, loss) order."""

    def __init__(self, conf, device="cuda"):
        self.conf = conf
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            full_f32_matmuls()
        self.dtype = torch.bfloat16 if conf.compute_dtype == "bfloat16" else torch.float32
        # the angles of step() calls that pass none
        self.generator = torch.Generator(self.device).manual_seed(0)

    # ---- setup ----

    def init(self, seed=0, state_dict=None):
        """(params, opt): a UNet3D on the device with Flax's initialisers
        drawn from a torch.Generator seeded with `seed`, or holding
        `state_dict` (e.g. the JAX package's weights through
        utils/convert.py), and a fresh Adam over it."""
        conf = self.conf
        net = UNet3D(in_channels=conf.volume_shape[-1], filters=conf.filters3d,
                     downsample=conf.downsample3d, out_channels=conf.num_masks + 1,
                     dtype=self.dtype)
        if state_dict is None:
            flax_init_(net, torch.Generator().manual_seed(seed))
        else:
            net.load_state_dict(state_dict)
        net = net.to(self.device)
        return net, adam(net.parameters(), conf.lr)

    # ---- training ----

    def loss_fn(self, params, volumes, masks):
        """Dice + weighted BCE over the classes and a background channel
        (1 - clip(sum(masks), 0, 1)), per slice: D folded into the batch
        (models/volumetric.py:81-96). Returns (loss, pred)."""
        pred = params(volumes)
        bg = 1.0 - torch.clamp(masks.sum(-1, keepdim=True), 0.0, 1.0)
        target = torch.cat([masks, bg], dim=-1)
        loss = combined_dice_bce(_fold_depth(target), _fold_depth(pred), self.conf.num_masks + 1)
        return loss, pred

    def step(self, params, opt, volumes, masks, thetas=None):
        """One update on a (B, D, H, W, 3) batch: the rotation (when
        rotation_range > 0; `thetas` (B,) radians, drawn from the
        segmenter's generator if None), the loss, its gradient and one Adam
        step. Returns (params, opt, loss) with the loss a 0-d tensor on the
        device; the gradient stays in the parameters' .grad."""
        if self.conf.rotation_range > 0:
            if thetas is None:
                thetas = random_rotation_angles(self.generator, volumes.shape[0],
                                                self.conf.rotation_range)
            volumes, masks = random_rotate_volumes(thetas.to(volumes.device), volumes, masks)
        opt.zero_grad(set_to_none=True)
        loss, _ = self.loss_fn(params, volumes, masks)
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    # ---- inference / evaluation ----

    @torch.inference_mode()
    def predict(self, params, volumes):
        """Class probabilities (B, D, H, W, num_masks + 1), f32, on the
        device, of a (B, D, H, W, 3) array or tensor."""
        return params(torch.as_tensor(volumes, device=self.device))

    def evaluate(self, params, volumes, masks, batch=2):
        """Per-study whole-volume binarised Dice of the foreground classes,
        averaged over the studies (models/volumetric.py:144-158)."""
        scores = []
        for i in range(0, volumes.shape[0], batch):
            pred = self.predict(params, volumes[i:i + batch]).cpu().numpy()
            for j in range(pred.shape[0]):
                scores.append(dice_np_volume(masks[i + j], pred[j][..., :self.conf.num_masks],
                                             binarise=True))
        return float(np.mean(scores))


def train_cardiac3d(conf, epochs=None, seed=0, device="cuda"):
    """The volumetric training loop (models/volumetric.py:240-277) over the
    cardiac loader's training split of conf.split: each epoch a
    np.random.RandomState(seed) permutation of the studies in batches of
    conf.batch_size (the tail dropped), then evaluate(batch=B) on the
    validation split. The weights start from init(seed); the angles come
    from the segmenter's generator, seeded with `seed`.
    Returns (model, params, history), history one {'epoch', 'loss',
    'val_dice'} an epoch; model.epoch_seconds holds one {'training',
    'validation'} an epoch."""
    loader = init_loader("cardiac", shape=conf.volume_shape[:3])
    xs, ys = loader.load_volumes(conf.split, "training")
    xv, yv = loader.load_volumes(conf.split, "validation")

    model = Cardiac3DSegmenter(conf, device=device)
    model.generator.manual_seed(seed)
    params, opt = model.init(seed)
    xs_dev = torch.from_numpy(xs).to(model.device)
    ys_dev = torch.from_numpy(ys).to(model.device)

    B = conf.batch_size
    rng = np.random.RandomState(seed)
    history = []
    model.epoch_seconds = []
    for epoch in range(epochs or conf.epochs):
        t = time.perf_counter()
        order = torch.from_numpy(rng.permutation(xs.shape[0])).to(model.device)
        n = (xs.shape[0] // B) * B
        losses = []
        for i in range(0, n, B):
            idx = order[i:i + B]
            params, opt, loss = model.step(params, opt, xs_dev[idx], ys_dev[idx])
            losses.append(loss)
        loss = float(np.mean(torch.stack(losses).cpu().numpy()))
        t_val = time.perf_counter()
        val_dice = model.evaluate(params, xv, yv, batch=B)
        history.append({"epoch": epoch, "loss": loss, "val_dice": val_dice})
        model.epoch_seconds.append({"training": t_val - t,
                                    "validation": time.perf_counter() - t_val})
    return model, params, history


class Cardiac3DExecutor:
    """CLI executor of the volumetric preset (models/volumetric.py:161-237),
    with the 2-D executors' artifact contract: <folder>/training.csv,
    <folder>/models/cardiac3d.npz (the JAX package's keys, so either
    package restores the other's file) and
    <folder>/test_results_cardiac/results.csv."""

    def __init__(self, conf, device="cuda"):
        self.conf = conf
        self.model = Cardiac3DSegmenter(conf, device=device)
        self.device = self.model.device
        self.params = None
        self.epoch_seconds = []

    def train(self):
        conf = self.conf
        model, self.params, history = train_cardiac3d(
            conf, epochs=conf.epochs, seed=conf.seed, device=self.device)
        self.epoch_seconds = model.epoch_seconds
        os.makedirs(conf.folder, exist_ok=True)
        with open(os.path.join(conf.folder, "training.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["epoch", "loss", "val_dice"])
            w.writeheader()
            w.writerows(history)
        os.makedirs(os.path.join(conf.folder, "models"), exist_ok=True)
        np.savez(os.path.join(conf.folder, "models", "cardiac3d.npz"),
                 **unet3d_npz(self.params.state_dict()))

    def test(self):
        """Per-study Dice of the test split (overall and per class) into
        results.csv; restores models/cardiac3d.npz when train() did not
        run. Returns the mean Dice."""
        conf = self.conf
        if self.params is None:
            with np.load(os.path.join(conf.folder, "models", "cardiac3d.npz")) as saved:
                self.params, _ = self.model.init(conf.seed, unet3d_state_dict_from_npz(saved))
        loader = init_loader("cardiac", shape=conf.volume_shape[:3])
        xs, ys = loader.load_volumes(conf.split, "test")
        vols = loader.get_volumes_for_split(conf.split, "test")
        outdir = os.path.join(conf.folder, "test_results_cardiac")
        os.makedirs(outdir, exist_ok=True)
        rows = []
        for i, vid in enumerate(vols):
            pred = self.model.predict(self.params, xs[i:i + 1]).cpu().numpy()[0]
            d = dice_np_volume(ys[i], pred[..., :conf.num_masks], binarise=True)
            per = [dice_np_volume(ys[i][..., k:k + 1], pred[..., k:k + 1], binarise=True)
                   for k in range(conf.num_masks)]
            rows.append({"volume": vid, "dice": d,
                         **{"dice_c%d" % k: per[k] for k in range(conf.num_masks)}})
        with open(os.path.join(outdir, "results.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        mean = float(np.mean([r["dice"] for r in rows]))
        print("cardiac3d - Dice score: %.3f" % mean)
        return mean
