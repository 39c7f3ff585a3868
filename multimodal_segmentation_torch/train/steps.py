"""Training steps.

Port of multimodal_segmentation_tpu/train/steps.py:103-219 (DAFNetSteps,
expert pairing). One call runs one batch: three rotations on the device,
the generator update, one shared fake-pool forward with the updated
generator, two sequential Adam steps of the mask discriminator and one
step of both image discriminators (model_executors/dafnet_executor.py:
369-387). PyTorch runs it eagerly; there is no jit.

Every random draw of a step is in `noise` (see `draw_noise`). When the
caller passes none, it is drawn from the train state's torch.Generator.
The JAX package draws the same parts from its key splits
(train/steps.py:120-121); its streams cannot be replayed in torch, so the
tests rebuild them there and pass them in as `noise`.
"""

import torch

from multimodal_segmentation_torch.models.base import add_residual
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


def _adam_step(opt, params, grads):
    """One optimizer step with `grads`. A parameter that the loss does not
    reach gets a zero gradient, as jax.grad gives it, so its Adam step
    count advances with the others and its value stays."""
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()
    for p in params:
        p.grad = None


class DAFNetSteps:
    """DAFNet expert-pairing steps: `step_supervised(ts, batch, noise=None)`
    and `step_unsupervised(...)` each return (ts, metrics), with the metric
    names of the JAX package's step. `ts` is updated in place.

    batch: NHWC arrays or tensors x1, x2 (B, H, W, 1), m1 and, supervised,
    m2 (B, H, W, num_masks) without the residual channel; dm1, dm2 (real
    masks of the mask discriminator) and dx1, dx2 (pool images of the image
    discriminators and the fake pools). The model is left in eval mode.
    """

    def __init__(self, model, conf):
        if conf.automatedpairing:
            raise NotImplementedError(
                "automated pairing is not ported yet (ROADMAP.md, queue A, item 5)"
            )
        self.model = model
        self.conf = conf

    def step_supervised(self, ts, batch, noise=None):
        return self._step(ts, batch, True, noise)

    def step_unsupervised(self, ts, batch, noise=None):
        return self._step(ts, batch, False, noise)

    def _step(self, ts, batch, supervised, noise):
        conf = self.conf
        model = ts.model
        dev = next(model.parameters()).device
        batch = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for k, v in batch.items()}
        B = batch["dx1"].shape[0]
        if noise is None:
            noise = draw_noise(ts.generator, B, conf.num_z, conf.rotation_range)
        noise = _noise_on(noise, dev)

        # rotation augmentation: one shared angle per sample across the
        # images and masks of one draw (base_executor.py:103-110)
        if conf.rotation_range > 0:
            keys = ["x1", "x2", "m1"] + (["m2"] if supervised else [])
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
        total, gen_metrics = model.gen_loss_expert(batch, noise["gen_eps"], supervised)
        _adam_step(ts.opt_gen, gen_params,
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
            _adam_step(ts.opt_disc["d_mask"], d_params, torch.autograd.grad(loss, d_params))
            dis_m.append(m["dis_M"])

        # both image discriminators, each with its own Adam
        p1 = list(model.d_image1.parameters())
        p2 = list(model.d_image2.parameters())
        loss, di_metrics = model.d_image_pair_loss(batch["dx1"], batch["dx2"], fake_y1, fake_y2)
        grads = torch.autograd.grad(loss, p1 + p2)
        _adam_step(ts.opt_disc["d_image1"], p1, grads[: len(p1)])
        _adam_step(ts.opt_disc["d_image2"], p2, grads[len(p1):])

        metrics = {**gen_metrics, "dis_M": (dis_m[0] + dis_m[1]) / 2.0, **di_metrics}
        ts.step += 1
        return ts, {k: v.detach() for k, v in metrics.items()}


class MMSDNetSteps:
    def __init__(self, model, conf):
        raise NotImplementedError("MMSDNet training is not ported yet (ROADMAP.md, queue A, item 4)")


def make_steps(model, conf):
    if conf.model == "mmsdnet":
        return MMSDNetSteps(model, conf)
    return DAFNetSteps(model, conf)
