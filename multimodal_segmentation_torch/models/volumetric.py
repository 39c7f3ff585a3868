"""Volumetric multi-sequence cardiac segmentation (the 3-D model).

Port of multimodal_segmentation_tpu/models/volumetric.py:42-277: a 3-D
UNet (nn/unet3d.py) over (B, D, H, W, 3) LGE + bSSFP + T2 volumes, its
training step (in-plane rotation, Dice + weighted BCE with D folded into
the batch, optax-style Adam), whole-volume Dice evaluation, the training
loop and the executor with its artifacts (training.csv,
models/cardiac3d.npz in the JAX package's key layout,
test_results_cardiac/results.csv).

On a ('data', 'space') mesh (models/volumetric.py:45-142 of the JAX
package; parallel/mesh.py) the studies are split over 'data' and the
slice axis D over 'space': the UNet exchanges D halos and all-reduces its
norm statistics over 'space' (nn/unet3d.py), the weighted BCE's class
masses are summed over both axes, a step's gradients are summed over
'space' and averaged over 'data', and the rotation angles, drawn for the
global batch, are cut over 'data' only, so both D-halves of a study turn
by the same angle. `predict` splits D only, so any batch size works. The
weights stay replicated; rank 0 alone writes the executor's files.

A train step on the GPU launches two nearest_warp kernels (the rotation
of the volumes and of the masks) on each rank and nothing else of the
port's kernels.

With conf.model == "unet3d" the segmenter holds the 3D U-Net of Cicek et
al. (nn/unet3d.py::UNet3DCicek, arXiv:1606.06650) instead, for inference
alone, on one device: `predict` serves a whole volume by overlap-tile.
The volume is mirrored at its borders by the net's context (44 voxels on
each side at the published tile), and by what more makes each axis a
whole number of output tiles; input tiles of conf.volume_shape[:3] are cut
from it on a stride of one output tile, run conf.batch_size at a time,
and their outputs stitched edge to edge and cropped to the volume. While
a torch.profiler session runs, `predict` records a `predict_volume` span
a volume (slices = D, tiles) with children `predict3d.inputs` (the copy
to the device and the mirror padding), `predict3d.tiles` (gathering a
batch of tiles), `predict3d.net` (the forward) and `predict3d.stitch`
(utils/tracing.py).
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
from multimodal_segmentation_torch.nn.unet3d import UNet3D, UNet3DCicek
from multimodal_segmentation_torch.ops.augment import random_rotate_volumes, random_rotation_angles
from multimodal_segmentation_torch.parallel.collectives import all_reduce_flat_, gather
from multimodal_segmentation_torch.parallel.distributed import barrier, is_writer
from multimodal_segmentation_torch.parallel.mesh import shard_batch
from multimodal_segmentation_torch.utils import tracing
from multimodal_segmentation_torch.utils.convert import unet3d_npz, unet3d_state_dict_from_npz
from multimodal_segmentation_torch.utils.nan_checks import check_finite, install_nan_checks


def _fold_depth(x):
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def adam(params, lr):
    """optax.adam(lr) (models/volumetric.py:55): beta1 0.9, beta2 0.999,
    eps 1e-8, lr * m_hat / (sqrt(v_hat) + eps). Not the 2-D path's Keras
    Adam (train/state.py), whose eps is 1e-7."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def mirror_index(size, before, total, device):
    """The indices into an axis of `size` of `total` positions starting
    `before` ahead of it, mirrored at both ends without repeating the edge
    (numpy.pad's 'reflect', which goes on mirroring where a pad is longer
    than the axis)."""
    if size < 2:
        raise ValueError("an axis of size %d cannot be mirrored" % size)
    period = 2 * (size - 1)
    r = torch.remainder(torch.arange(-before, total - before, device=device), period)
    return torch.where(r < size, r, period - r)


def tile_view(t, counts, step, size, axes):
    """The grid of tiles of `t` as a view of shape (*counts, *t.shape with
    its `axes` cut to `size`): tile (i, j, k) starts at (i, j, k) * step
    along t's (D, H, W) `axes`."""
    shape = list(t.shape)
    for a, n in zip(axes, size):
        shape[a] = n
    grid = [s * t.stride(a) for s, a in zip(step, axes)]
    return t.as_strided((*counts, *shape), (*grid, *t.stride()))


class Cardiac3DSegmenter:
    """The 3-D UNet and its training step on `device` (default the GPU),
    alone or on a ('data', 'space') `mesh`.

    `params` is the UNet3D module and `opt` its Adam, as `init` returns
    them; `step` updates both in place and returns them, with the loss, in
    the JAX package's (params, opt_state, loss) order."""

    def __init__(self, conf, device="cuda", mesh=None):
        self.conf = conf
        self.mesh = mesh
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            full_f32_matmuls()
        self.dtype = torch.bfloat16 if conf.compute_dtype == "bfloat16" else torch.float32
        # the angles of step() calls that pass none
        self.generator = torch.Generator(self.device).manual_seed(0)
        self.data = self.space = None
        if mesh is not None:
            self.data, self.space = mesh.axis("data"), mesh.axis("space")
        # the weighted BCE's class masses sum over both axes
        self.mass_groups = tuple(a.group for a in (self.data, self.space) if a is not None)

    # ---- setup ----

    def init(self, seed=0, state_dict=None):
        """(params, opt): a UNet3D on the device with Flax's initialisers
        drawn from a torch.Generator seeded with `seed`, or holding
        `state_dict` (e.g. the JAX package's weights through
        utils/convert.py), and a fresh Adam over it; for the unet3d model
        (the net in eval mode, None) (`_init_cicek`)."""
        conf = self.conf
        if conf.model == "unet3d":
            return self._init_cicek(seed, state_dict), None
        net = UNet3D(in_channels=conf.volume_shape[-1], filters=conf.filters3d,
                     downsample=conf.downsample3d, out_channels=conf.num_masks + 1,
                     dtype=self.dtype)
        if state_dict is None:
            flax_init_(net, torch.Generator().manual_seed(seed))
        else:
            net.load_state_dict(state_dict)
        if self.space is not None and self.space.size > 1:
            net.set_space(self.space)
        if conf.debug_nans:
            install_nan_checks(net)
        net = net.to(self.device)
        return net, adam(net.parameters(), conf.lr)

    def _init_cicek(self, seed, state_dict):
        """The 3D U-Net of arXiv:1606.06650 for conf.model == "unet3d": input
        tiles of conf.volume_shape, filters3d and downsample3d its base
        width and depth, in eval mode (BatchNorm on its running
        statistics), with no optimizer: it is served, not trained. On the
        card its 5-D parameters are channels_last_3d, the layout its
        activations keep there (UNet3DCicek), so cuDNN transforms no
        weight; the state_dict's keys and values are the same."""
        conf = self.conf
        if self.mesh is not None:
            raise ValueError("the unet3d model runs on one device, not on a mesh")
        net = UNet3DCicek(in_channels=conf.volume_shape[-1], filters=conf.filters3d,
                          depth=conf.downsample3d, out_channels=conf.num_masks + 1,
                          dtype=self.dtype)
        net.output_size(conf.volume_shape[:3])
        if state_dict is None:
            flax_init_(net, torch.Generator().manual_seed(seed))
        else:
            net.load_state_dict(state_dict)
        if conf.debug_nans:
            install_nan_checks(net)
        if self.device.type == "cuda":
            net = net.to(memory_format=torch.channels_last_3d)
        return net.to(self.device).eval()

    def shard_batch(self, batch):
        """This rank's part of a global host batch of (B, D, ...) arrays
        (e.g. (volumes, masks)) on the device: studies over 'data', D over
        'space'; the whole batch without a mesh."""
        if self.mesh is None:
            return tuple(torch.as_tensor(a, device=self.device) for a in batch)
        return shard_batch(self.mesh, batch, self.device, ("data", "space"))

    # ---- training ----

    def loss_fn(self, params, volumes, masks):
        """Dice + weighted BCE over the classes and a background channel
        (1 - clip(sum(masks), 0, 1)), per slice: D folded into the batch
        (models/volumetric.py:81-96). Returns (loss, pred)."""
        pred = params(volumes)
        bg = 1.0 - torch.clamp(masks.sum(-1, keepdim=True), 0.0, 1.0)
        target = torch.cat([masks, bg], dim=-1)
        loss = combined_dice_bce(_fold_depth(target), _fold_depth(pred), self.conf.num_masks + 1,
                                 self.mass_groups)
        return loss, pred

    def step(self, params, opt, volumes, masks, thetas=None):
        """One update on a (B, D, H, W, 3) batch (on a mesh, this rank's
        part of the global batch, as shard_batch gives it): the rotation
        (when rotation_range > 0; `thetas` (B,) radians of the global
        batch, drawn from the segmenter's generator if None), the loss,
        its gradient and one Adam step. Returns (params, opt, loss) with
        the loss (the global batch's) a 0-d tensor on the device; the
        gradient, reduced over the mesh, stays in the parameters' .grad.

        On a mesh each rank's loss is the mean over its slices, the global
        loss the mean over the ranks: the rank backpropagates its share,
        loss / n_space, whose gradients summed over 'space' (the halos and
        norm statistics carry each slab's part to its neighbours) and
        averaged over 'data' are the global loss's."""
        if self.conf.model == "unet3d":
            raise NotImplementedError(
                "the unet3d model (the 3D U-Net of arXiv:1606.06650) is served by predict and "
                "evaluate only: its training, the paper's weighted softmax loss on sparsely "
                "annotated slices, is not implemented")
        data, space = self.data, self.space
        if self.conf.rotation_range > 0:
            if thetas is None:
                n = volumes.shape[0] * (data.size if data is not None else 1)
                thetas = random_rotation_angles(self.generator, n, self.conf.rotation_range)
            if data is not None:
                b = volumes.shape[0]
                thetas = thetas[data.index * b:(data.index + 1) * b]
            volumes, masks = random_rotate_volumes(thetas.to(volumes.device), volumes, masks)
        opt.zero_grad(set_to_none=True)
        loss, _ = self.loss_fn(params, volumes, masks)
        if self.mesh is None:
            loss.backward()
        else:
            (loss / space.size).backward()
            grads = [p.grad for p in params.parameters()]
            all_reduce_flat_(grads, (space.group, data.group), data.size)
            loss = loss.detach().reshape(1) / space.size
            all_reduce_flat_([loss], (space.group, data.group), data.size)
            loss = loss[0]
        if self.conf.debug_nans:
            check_finite(loss, "the 3-D step's loss")
        opt.step()
        return params, opt, loss.detach()

    # ---- inference / evaluation ----

    @torch.inference_mode()
    def predict(self, params, volumes):
        """Class probabilities (B, D, H, W, num_masks + 1), f32, on the
        device, of a (B, D, H, W, 3) array or tensor. On a mesh with D
        split over 'space' each rank runs its D-slab of every study and
        the slabs are gathered: any batch size works, as the JAX
        package's predict shards the depth only (:138-142). The unet3d
        model serves each volume by overlap-tile (`predict_tiled`)."""
        if self.conf.model == "unet3d":
            out = [self.predict_tiled(params, volumes[i:i + 1]) for i in range(len(volumes))]
            return out[0] if len(out) == 1 else torch.cat(out)
        if self.space is None or self.space.size == 1:
            return params(torch.as_tensor(volumes, device=self.device))
        x = shard_batch(self.mesh, volumes, self.device, (None, "space"))
        return gather(params(x), 1, self.space)

    @torch.inference_mode()
    def predict_tiled(self, net, volume):
        """(1, D, H, W, num_masks + 1) f32 class probabilities on the device
        of a (1, D, H, W, C) volume (array or tensor) by overlap-tile
        through the unet3d model `net` (module docstring): every axis of D,
        H and W at least 2."""
        tile_in = tuple(self.conf.volume_shape[:3])
        tile_out = net.output_size(tile_in)
        shape = tuple(volume.shape[1:4])
        # output tiles along each axis, the context on each side of one, and
        # the mirror-padded extent that the input tiles span
        counts = tuple(-(-s // o) for s, o in zip(shape, tile_out))
        margin = tuple((i - o) // 2 for i, o in zip(tile_in, tile_out))
        padded = tuple(c * o + i - o for c, o, i in zip(counts, tile_out, tile_in))
        n = counts[0] * counts[1] * counts[2]
        dev = self.device
        with tracing.span("predict_volume", slices=int(shape[0]), tiles=n):
            with tracing.span("predict3d.inputs"):
                x = torch.as_tensor(volume, device=dev)[0].to(self.dtype).permute(3, 0, 1, 2)
                d, h, w = (mirror_index(s, m, p, dev) for s, m, p in zip(shape, margin, padded))
                x = x[:, d[:, None, None], h[None, :, None], w[None, None, :]].contiguous()
                tiles = tile_view(x, counts, tile_out, tile_in, (1, 2, 3))
                out = torch.empty((*(c * o for c, o in zip(counts, tile_out)),
                                   net.head.out_channels), device=dev)
                stitched = tile_view(out, counts, tile_out, tile_out, (0, 1, 2))
                k = torch.arange(n, device=dev)
                grid = (k // (counts[1] * counts[2]), k // counts[2] % counts[1], k % counts[2])
            for b in range(0, n, self.conf.batch_size):
                at = tuple(g[b:b + self.conf.batch_size] for g in grid)
                with tracing.span("predict3d.tiles"):
                    batch = tiles[at]
                with tracing.span("predict3d.net"):
                    probs = net(batch)
                with tracing.span("predict3d.stitch"):
                    stitched[at] = probs.permute(0, 2, 3, 4, 1)
            with tracing.span("predict3d.stitch"):
                return out[:shape[0], :shape[1], :shape[2]].contiguous()[None]

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


def train_cardiac3d(conf, epochs=None, seed=0, device="cuda", mesh=None):
    """The volumetric training loop (models/volumetric.py:240-277) over the
    cardiac loader's training split of conf.split: each epoch a
    np.random.RandomState(seed) permutation of the studies in batches of
    conf.batch_size (the tail dropped), then evaluate(batch=B) on the
    validation split. The weights start from init(seed); the angles come
    from the segmenter's generator, seeded with `seed`. On `mesh` every
    rank reads the same global batches and copies only its part to its
    device. Returns (model, params, history), history one {'epoch',
    'loss', 'val_dice'} an epoch; model.epoch_seconds holds one
    {'training', 'validation'} an epoch."""
    loader = init_loader("cardiac", shape=conf.volume_shape[:3])
    xs, ys = loader.load_volumes(conf.split, "training")
    xv, yv = loader.load_volumes(conf.split, "validation")

    model = Cardiac3DSegmenter(conf, device=device, mesh=mesh)
    model.generator.manual_seed(seed)
    params, opt = model.init(seed)
    if mesh is None:
        # the whole training split on the device, batches indexed there
        xs, ys = torch.from_numpy(xs).to(model.device), torch.from_numpy(ys).to(model.device)

    B = conf.batch_size
    rng = np.random.RandomState(seed)
    history = []
    model.epoch_seconds = []
    for epoch in range(epochs or conf.epochs):
        t = time.perf_counter()
        order = rng.permutation(xs.shape[0])
        if mesh is None:
            order = torch.from_numpy(order).to(model.device)
        n = (xs.shape[0] // B) * B
        losses = []
        for i in range(0, n, B):
            idx = order[i:i + B]
            vb, mb = model.shard_batch((xs[idx], ys[idx]))
            params, opt, loss = model.step(params, opt, vb, mb)
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
    <folder>/test_results_cardiac/results.csv. On `mesh` every rank
    trains and predicts, rank 0 alone writes the files and the others
    wait for it."""

    def __init__(self, conf, device="cuda", mesh=None):
        self.conf = conf
        self.mesh = mesh
        self.model = Cardiac3DSegmenter(conf, device=device, mesh=mesh)
        self.device = self.model.device
        self.params = None
        self.epoch_seconds = []

    def train(self):
        conf = self.conf
        model, self.params, history = train_cardiac3d(
            conf, epochs=conf.epochs, seed=conf.seed, device=self.device, mesh=self.mesh)
        self.epoch_seconds = model.epoch_seconds
        if is_writer(self.mesh):
            os.makedirs(conf.folder, exist_ok=True)
            with open(os.path.join(conf.folder, "training.csv"), "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=["epoch", "loss", "val_dice"])
                w.writeheader()
                w.writerows(history)
            os.makedirs(os.path.join(conf.folder, "models"), exist_ok=True)
            np.savez(os.path.join(conf.folder, "models", "cardiac3d.npz"),
                     **unet3d_npz(self.params.state_dict()))
        barrier(self.mesh)

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
        rows = []
        for i, vid in enumerate(vols):
            pred = self.model.predict(self.params, xs[i:i + 1]).cpu().numpy()[0]
            d = dice_np_volume(ys[i], pred[..., :conf.num_masks], binarise=True)
            per = [dice_np_volume(ys[i][..., k:k + 1], pred[..., k:k + 1], binarise=True)
                   for k in range(conf.num_masks)]
            rows.append({"volume": vid, "dice": d,
                         **{"dice_c%d" % k: per[k] for k in range(conf.num_masks)}})
        mean = float(np.mean([r["dice"] for r in rows]))
        if is_writer(self.mesh):
            os.makedirs(outdir, exist_ok=True)
            with open(os.path.join(outdir, "results.csv"), "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
                w.writeheader()
                w.writerows(rows)
            print("cardiac3d - Dice score: %.3f" % mean)
        barrier(self.mesh)
        return mean
