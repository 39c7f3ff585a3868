"""Training steps.

Port of multimodal_segmentation_tpu/train/steps.py:103-299. DAFNet
(expert or automated pairing): one call runs one batch: three rotations
on the device, the generator update, one shared fake-pool forward with
the updated generator, two sequential Adam steps of the mask
discriminator and one step of both image discriminators
(model_executors/dafnet_executor.py:369-387). MMSDNet: a generator step
with its Z-regressor update, and a separate mask-discriminator step
(mmsdnet_executor.py:242-331). PyTorch runs them eagerly; there is no jit.

Every random draw of a step is in `noise` (see `draw_noise`,
`draw_mmsdnet_noise`, `draw_mmsdnet_disc_noise`). When the caller passes
none, it is drawn from the train state's torch.Generator. The JAX package
draws the same parts from its key splits; its streams cannot be replayed
in torch, so the tests rebuild them there and pass them in as `noise`.

Data parallelism (train/steps.py:34-56 of the JAX package): with a `mesh`
(parallel/mesh.py) the batch holds this rank's rows of the global batch
(shard_batch), the model is put on the mesh (global BatchNorm statistics
and class masses), and the step is the one-process step on the global
batch: the noise is drawn, or taken, at the global batch size and cut to
this rank's rows; each optimizer's gradients are averaged over 'data' in
one flat all-reduce before its Adam step, and so are the metrics. The
train state stays replicated: parameters, Adam moments, BatchNorm
statistics, spectral `u` and the generator.

Tensor parallelism (a mesh with 'model' > 1, the train state sharded by
parallel/sharding.py::tp_shard_train_state): the ranks of a 'model' row
hold the same rows and draw the same noise, and each computes the whole
step, gathering the sharded weights in the forward. The gradient of a
sharded slice is averaged over 'data' only; that of a replicated leaf over
'data' and 'model' (identical in exact arithmetic, so the replicated
leaves stay identical across 'model' however the card orders its sums).
"""

import torch

from multimodal_segmentation_torch.models.base import add_residual
from multimodal_segmentation_torch.parallel.collectives import all_reduce_flat_
from multimodal_segmentation_torch.utils.nan_checks import check_finite
from multimodal_segmentation_torch.ops.augment import random_rotate_batch, random_rotation_angles


def draw_noise(generator, batch, num_z, rotation_range):
    """The random inputs of one DAFNet expert step, drawn from `generator`
    on its device. Parts, with the JAX key each replaces
    (rng = fold_in(ts.rng, ts.step), split 7):
      angles          3 x (B,) radians in [-range, range) degrees (r_aug1-3)
      z1, z2          (B, num_z) N(0, 1), the Z-regressor inputs (r_z)
      gen_eps         (2B, num_z) the VAE sample of the generator loss (r_gen)
      pool_mask_idx   2 x (B,) slots in {0, 1} of the mask pools (r_dm)
      pool_eps        (2B, num_z) the VAE sample of the fake pools (r_dm)
      pool_image_idx  2 x (B,) slots in {0, 1, 2} of the image pools (r_dm)
    """
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def slots(k):
        return torch.randint(0, k, (batch,), generator=generator, device=dev)

    return {
        "angles": [random_rotation_angles(generator, batch, rotation_range) for _ in range(3)],
        "z1": normal(batch, num_z),
        "z2": normal(batch, num_z),
        "gen_eps": normal(2 * batch, num_z),
        "pool_mask_idx": [slots(2), slots(2)],
        "pool_eps": normal(2 * batch, num_z),
        "pool_image_idx": [slots(3), slots(3)],
    }


def draw_mmsdnet_noise(generator, batch, num_z, rotation_range):
    """The random inputs of one MMSDNet generator step, drawn from
    `generator` on its device. Parts, with the JAX key each replaces
    (rng = fold_in(ts.rng, ts.step), split 4, train/steps.py:237-276):
      angles   1 x (B,) radians (r_aug)
      gen_eps  (6B, num_z) the VAE sample over the six anatomies (r_gen)
      zreg_z   6 x (B, num_z) N(0, 1), the Z-regressor's z (r_z)
    """
    dev = generator.device
    return {
        "angles": [random_rotation_angles(generator, batch, rotation_range)],
        "gen_eps": torch.randn((6 * batch, num_z), generator=generator, device=dev),
        "zreg_z": [torch.randn((batch, num_z), generator=generator, device=dev)
                   for _ in range(6)],
    }


def draw_mmsdnet_disc_noise(generator, batch, rotation_range):
    """The random inputs of one MMSDNet discriminator step (rng split 2,
    train/steps.py:284-295): angles, 2 x (B,) radians of dm and of dx1 and
    dx2 (r_aug and fold_in(r_aug, 1)); pool_idx, (B,) slots in {0..3} of
    the fake pool (r_dm)."""
    return {
        "angles": [random_rotation_angles(generator, batch, rotation_range) for _ in range(2)],
        "pool_idx": torch.randint(0, 4, (batch,), generator=generator, device=generator.device),
    }


def _noise_on(noise, dev):
    """`noise` with every part a tensor on `dev` (arrays are accepted)."""
    out = {}
    for k, v in noise.items():
        dt = torch.long if k.endswith("_idx") else torch.float32
        if isinstance(v, (list, tuple)):
            out[k] = [torch.as_tensor(a, dtype=dt, device=dev) for a in v]
        else:
            out[k] = torch.as_tensor(v, dtype=dt, device=dev)
    return out


def _on_device(model, batch):
    """(the model's device, `batch` as f32 tensors there)."""
    dev = next(model.parameters()).device
    return dev, {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in batch.items()}


def _adam_step(opt, params, grads, data=None, model_axis=None):
    """One optimizer step with `grads`, first averaged over mesh axis
    `data` when there is one (one flat all-reduce for the list); under
    tensor parallelism (`model_axis`) the replicated parameters' gradients
    over 'model' too, and the sharded slices' over 'data' alone. A
    parameter that the loss does not reach gets a zero gradient, as
    jax.grad gives it, so its Adam step count advances with the others
    and its value stays. For the fused Adam, which requires it, a gradient
    that autograd hands back in another memory layout (cuDNN's weight
    gradient of a channels-last input) is made contiguous, the layout of
    its parameter and Adam moments."""
    fused = opt.defaults.get("fused")
    grads = [torch.zeros_like(p) if g is None else g.contiguous() if fused else g
             for p, g in zip(params, grads)]
    if model_axis is not None:
        sharded = [getattr(p, "model_axis", None) is not None for p in params]
        all_reduce_flat_([g for g, s in zip(grads, sharded) if s], data.group, data.size)
        all_reduce_flat_([g for g, s in zip(grads, sharded) if not s],
                         (data.group, model_axis.group), data.size * model_axis.size)
    elif data is not None:
        all_reduce_flat_(grads, data.group, data.size)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


class _Steps:
    """What the steps of both models share: the model, the configuration
    and, under a mesh, its 'data' axis and, where it has more than one
    rank, its 'model' axis."""

    def __init__(self, model, conf, mesh=None):
        self.model = model
        self.conf = conf
        self.data = None if mesh is None else mesh.axis("data")
        self.model_axis = None
        if mesh is not None and mesh.shape.get("model", 1) > 1:
            self.model_axis = mesh.axis("model")
        model.set_mesh(mesh)

    def _global(self, rows):
        """The global batch size of a batch of `rows` on this rank."""
        return rows if self.data is None else rows * self.data.size

    def _local(self, noise):
        """This rank's rows of global `noise`: a part of k x B_global rows
        (k = 1, 2 or 6: samples stacked sample-major, ops/batching.py)
        gives rows [k r b, k (r + 1) b), b = B_global / ranks."""
        if self.data is None:
            return noise
        i, n = self.data.index, self.data.size

        def cut(t):
            k = t.shape[0] // n
            return t[i * k:(i + 1) * k]
        return {key: [cut(t) for t in v] if isinstance(v, list) else cut(v)
                for key, v in noise.items()}

    def _adam(self, opt, params, grads):
        _adam_step(opt, params, grads, self.data, self.model_axis)

    def _metrics(self, metrics):
        """The detached metrics; under a mesh in f32, averaged over 'data'
        (one all-reduce). Under conf.debug_nans a non-finite one raises."""
        if self.data is None:
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            values = torch.stack([v.detach().float() for v in metrics.values()])
            all_reduce_flat_([values], self.data.group, self.data.size)
            metrics = dict(zip(metrics, values.unbind()))
        if self.conf.debug_nans:
            check_finite(metrics, "the step's metrics")
        return metrics


class DAFNetSteps(_Steps):
    """DAFNet steps: `step_supervised(ts, batch, noise=None)` and
    `step_unsupervised(...)` each return (ts, metrics), with the metric
    names of the JAX package's step. `ts` is updated in place.

    batch: NHWC arrays or tensors x1, x2 (B, H, W, 1), or under
    conf.automatedpairing x1_pairs, x2_pairs (B, H, W, n_pairs) with the
    expert pair first; m1 and, supervised, m2 (B, H, W, num_masks) without
    the residual channel; dm1, dm2 (real masks of the mask discriminator)
    and dx1, dx2 (pool images of the image discriminators and the fake
    pools); under `mesh`, this rank's rows of each, and `noise` that of
    the global batch. The model is left in eval mode.
    """

    def step_supervised(self, ts, batch, noise=None):
        return self._step(ts, batch, True, noise)

    def step_unsupervised(self, ts, batch, noise=None):
        return self._step(ts, batch, False, noise)

    def _step(self, ts, batch, supervised, noise):
        conf = self.conf
        model = ts.model
        dev, batch = _on_device(model, batch)
        B = self._global(batch["dx1"].shape[0])
        if noise is None:
            noise = draw_noise(ts.generator, B, conf.num_z, conf.rotation_range)
        noise = self._local(_noise_on(noise, dev))

        # rotation augmentation: one shared angle per sample across the
        # images and masks of one draw (base_executor.py:103-110)
        if conf.rotation_range > 0:
            pairs = ["x1_pairs", "x2_pairs"] if conf.automatedpairing else ["x1", "x2"]
            keys = pairs + ["m1"] + (["m2"] if supervised else [])
            for group, angles in ((keys, noise["angles"][0]),
                                  (["dm1", "dm2"], noise["angles"][1]),
                                  (["dx1", "dx2"], noise["angles"][2])):
                rotated = random_rotate_batch([batch[k] for k in group], angles)
                batch.update(zip(group, rotated))
        # the +background residual channel (dafnet_executor.py:493-494)
        batch["m1"] = add_residual(batch["m1"])
        if supervised:
            batch["m2"] = add_residual(batch["m2"])
        batch["z1"], batch["z2"] = noise["z1"], noise["z2"]

        # generator update: gradients of the generator components only
        model.train()
        gen_params = model.component_parameters(model.GEN_COMPONENTS)
        gen_loss = model.gen_loss_automated if conf.automatedpairing else model.gen_loss_expert
        total, gen_metrics = gen_loss(batch, noise["gen_eps"], supervised)
        self._adam(ts.opt_gen, gen_params,
                   torch.autograd.grad(total, gen_params, allow_unused=True))

        # fake pools for every discriminator from one forward of the
        # updated generator, with its updated running statistics
        model.eval()
        fake_m1, fake_m2, fake_y1, fake_y2 = model.make_fake_pools(
            batch["dx1"], batch["dx2"], noise["pool_mask_idx"], noise["pool_eps"],
            noise["pool_image_idx"])

        # D_Mask: two sequential Adam steps, one per modality
        # (dafnet_executor.py:534, 544)
        nm = conf.num_masks
        d_params = list(model.d_mask.parameters())
        dis_m = []
        for real, fake in ((batch["dm1"], fake_m1), (batch["dm2"], fake_m2)):
            loss, m = model.d_mask_pair_loss(real[..., :nm], fake)
            self._adam(ts.opt_disc["d_mask"], d_params, torch.autograd.grad(loss, d_params))
            dis_m.append(m["dis_M"])

        # both image discriminators, each with its own Adam
        p1 = list(model.d_image1.parameters())
        p2 = list(model.d_image2.parameters())
        loss, di_metrics = model.d_image_pair_loss(batch["dx1"], batch["dx2"], fake_y1, fake_y2)
        grads = torch.autograd.grad(loss, p1 + p2)
        self._adam(ts.opt_disc["d_image1"], p1, grads[: len(p1)])
        self._adam(ts.opt_disc["d_image2"], p2, grads[len(p1):])

        metrics = {**gen_metrics, "dis_M": (dis_m[0] + dis_m[1]) / 2.0, **di_metrics}
        ts.step += 1
        return ts, self._metrics(metrics)


class MMSDNetSteps(_Steps):
    """MMSDNet steps (train/steps.py:222-299): `step_supervised(ts, batch,
    noise=None)` and `step_unsupervised(...)` each run one generator update
    and then one Z-regressor update on the detached, eval-mode anatomies
    of the updated generator; `step_discriminator(ts, batch, noise=None)`
    runs one mask-discriminator update. Each returns (ts, metrics) and
    advances ts.step by one, as in the JAX package. `ts` is updated in
    place and the model is left in eval mode.

    Generator batches: NHWC x1, x2 (B, H, W, 1), m1 and, supervised, m2
    (B, H, W, num_masks) without the residual channel. Discriminator
    batches: dm (B, H, W, num_masks), the real masks, and dx1, dx2, the
    images of the fake pool. `noise` is draw_mmsdnet_noise's for the
    generator steps and draw_mmsdnet_disc_noise's for the discriminator.
    Under `mesh` as DAFNetSteps.
    """

    def __init__(self, model, conf, mesh=None):
        if conf.automatedpairing:
            raise ValueError("automated pairing is a DAFNet path; MMSDNet trains on the "
                             "expert pairs")
        super().__init__(model, conf, mesh)

    def step_supervised(self, ts, batch, noise=None):
        return self._gen_step(ts, batch, True, noise)

    def step_unsupervised(self, ts, batch, noise=None):
        return self._gen_step(ts, batch, False, noise)

    def _gen_step(self, ts, batch, supervised, noise):
        conf = self.conf
        model = ts.model
        dev, batch = _on_device(model, batch)
        if noise is None:
            noise = draw_mmsdnet_noise(ts.generator, self._global(batch["x1"].shape[0]),
                                       conf.num_z, conf.rotation_range)
        noise = self._local(_noise_on(noise, dev))
        if conf.rotation_range > 0:
            keys = ["x1", "x2", "m1"] + (["m2"] if supervised else [])
            batch.update(zip(keys, random_rotate_batch([batch[k] for k in keys],
                                                       noise["angles"][0])))
        batch["m1"] = add_residual(batch["m1"])
        if supervised:
            batch["m2"] = add_residual(batch["m2"])

        model.train()
        gen_params = model.component_parameters(model.GEN_COMPONENTS)
        total, gen_metrics = model.gen_loss(batch, noise["gen_eps"], supervised)
        self._adam(ts.opt_gen, gen_params,
                   torch.autograd.grad(total, gen_params, allow_unused=True))

        # the Z-regressor: its own Adam over the decoder and the modality
        # encoder, on the updated generator's eval-mode anatomies
        # (mmsdnet_executor.py:267-276)
        model.eval()
        s_list = model.make_z_regressor_anatomies(batch["x1"], batch["x2"])
        zreg_params = model.component_parameters(model.ZREG_COMPONENTS)
        z_total, z_metrics = model.z_regressor_loss(s_list, noise["zreg_z"])
        self._adam(ts.opt_zreg, zreg_params,
                   torch.autograd.grad(z_total, zreg_params, allow_unused=True))
        ts.step += 1
        return ts, self._metrics({**gen_metrics, **z_metrics})

    def step_discriminator(self, ts, batch, noise=None):
        conf = self.conf
        model = ts.model
        dev, batch = _on_device(model, batch)
        if noise is None:
            noise = draw_mmsdnet_disc_noise(ts.generator, self._global(batch["dm"].shape[0]),
                                            conf.rotation_range)
        noise = self._local(_noise_on(noise, dev))
        if conf.rotation_range > 0:
            for group, angles in ((["dm"], noise["angles"][0]),
                                  (["dx1", "dx2"], noise["angles"][1])):
                batch.update(zip(group, random_rotate_batch([batch[k] for k in group], angles)))
        model.eval()
        fake = model.make_fake_masks(batch["dx1"], batch["dx2"], noise["pool_idx"])
        d_params = list(model.d_mask.parameters())
        loss, metrics = model.d_mask_loss(batch["dm"][..., : conf.num_masks], fake)
        self._adam(ts.opt_disc["d_mask"], d_params, torch.autograd.grad(loss, d_params))
        ts.step += 1
        return ts, self._metrics(metrics)


def make_steps(model, conf, mesh=None):
    if conf.model == "mmsdnet":
        return MMSDNetSteps(model, conf, mesh)
    return DAFNetSteps(model, conf, mesh)
