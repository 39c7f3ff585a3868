"""The training steps of both models in plain PyTorch, float32: a frozen
copy of the port's train/steps.py and train/state.py on one device.

DAFNet's `step_supervised` / `step_unsupervised`: three rotations, the
generator update, one fake-pool forward of the updated generator, two
Adam steps of the mask discriminator and one of each image discriminator.
MMSDNet's: the generator update and the Z-regressor's own Adam step on
the updated generator's eval-mode anatomies; `step_discriminator`: the
mask discriminator's step. Each optimizer is Keras' Adam (beta1 0.9,
beta2 0.999, epsilon 1e-7). A parameter the loss does not reach gets a
zero gradient, so its Adam count advances and its value stays.
"""

import torch

from benchmark.reference.models import MODELS, add_residual
from benchmark.reference.precision import set_precision
from benchmark.reference.warp import rotate


def adam(params, lr):
    return torch.optim.Adam(list(params), lr=lr, betas=(0.9, 0.999), eps=1e-7)


def _adam_step(opt, params, grads):
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()
    for p in params:
        p.grad = None


class Trainer:
    """The model and its optimizers. `optimizers` maps a name to (the
    optimizer, its parameters): 'gen', one a discriminator, and MMSDNet's
    'zreg'."""

    def __init__(self, conf, state_dict, device, precision="float32"):
        self.conf = conf
        with torch.device(device):
            model = MODELS[conf.model](conf)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = set_precision(model, precision).eval()
        self.optimizers = {"gen": model.component_parameters(model.GEN_COMPONENTS)}
        for name in model.DISC_COMPONENTS:
            self.optimizers[name] = list(getattr(model, name).parameters())
        if hasattr(model, "ZREG_COMPONENTS"):
            self.optimizers["zreg"] = model.component_parameters(model.ZREG_COMPONENTS)
        self.opt = {}
        for name, params in self.optimizers.items():
            lr = conf.lr
            if name == "d_mask":
                lr = conf.d_mask_params.lr
            elif name.startswith("d_image"):
                lr = conf.d_image_params.lr
            self.opt[name] = adam(params, lr)

    def _adam(self, name, grads):
        _adam_step(self.opt[name], self.optimizers[name], grads)

    def _rotate(self, batch, groups):
        if self.conf.rotation_range > 0:
            for keys, angles in groups:
                batch.update(zip(keys, rotate([batch[k] for k in keys], angles)))

    # ------------------------------------------------------------- DAFNet

    def step_supervised(self, batch, noise):
        return self._step(batch, noise, True)

    def step_unsupervised(self, batch, noise):
        return self._step(batch, noise, False)

    def _step(self, batch, noise, supervised):
        if self.conf.model == "mmsdnet":
            return self._mmsdnet_gen_step(batch, noise, supervised)
        conf, model = self.conf, self.model
        batch = {k: v.float() for k, v in batch.items()}
        pairs = ["x1_pairs", "x2_pairs"] if conf.automatedpairing else ["x1", "x2"]
        keys = pairs + ["m1"] + (["m2"] if supervised else [])
        self._rotate(batch, ((keys, noise["angles"][0]), (["dm1", "dm2"], noise["angles"][1]),
                             (["dx1", "dx2"], noise["angles"][2])))
        batch["m1"] = add_residual(batch["m1"])
        if supervised:
            batch["m2"] = add_residual(batch["m2"])
        batch["z1"], batch["z2"] = noise["z1"], noise["z2"]

        model.train()
        gen_loss = model.gen_loss_automated if conf.automatedpairing else model.gen_loss_expert
        total, metrics = gen_loss(batch, noise["gen_eps"], supervised)
        self._adam("gen", torch.autograd.grad(total, self.optimizers["gen"], allow_unused=True))

        model.eval()
        fake_m1, fake_m2, fake_y1, fake_y2 = model.make_fake_pools(
            batch["dx1"], batch["dx2"], noise["pool_mask_idx"], noise["pool_eps"],
            noise["pool_image_idx"])
        nm = conf.num_masks
        dis_m = []
        for real, fake in ((batch["dm1"], fake_m1), (batch["dm2"], fake_m2)):
            loss = model.d_mask_pair_loss(real[..., :nm], fake)
            self._adam("d_mask", torch.autograd.grad(loss, self.optimizers["d_mask"]))
            dis_m.append(loss)
        p1, p2 = self.optimizers["d_image1"], self.optimizers["d_image2"]
        loss, di = model.d_image_pair_loss(batch["dx1"], batch["dx2"], fake_y1, fake_y2)
        grads = torch.autograd.grad(loss, p1 + p2)
        self._adam("d_image1", grads[:len(p1)])
        self._adam("d_image2", grads[len(p1):])
        return {**metrics, "dis_M": (dis_m[0] + dis_m[1]) / 2.0, **di}

    # ------------------------------------------------------------ MMSDNet

    def _mmsdnet_gen_step(self, batch, noise, supervised):
        model = self.model
        batch = {k: v.float() for k, v in batch.items()}
        keys = ["x1", "x2", "m1"] + (["m2"] if supervised else [])
        self._rotate(batch, ((keys, noise["angles"][0]),))
        batch["m1"] = add_residual(batch["m1"])
        if supervised:
            batch["m2"] = add_residual(batch["m2"])
        model.train()
        total, metrics = model.gen_loss(batch, noise["gen_eps"], supervised)
        self._adam("gen", torch.autograd.grad(total, self.optimizers["gen"], allow_unused=True))
        model.eval()
        s_list = model.make_z_regressor_anatomies(batch["x1"], batch["x2"])
        z_total, z_metrics = model.z_regressor_loss(s_list, noise["zreg_z"])
        self._adam("zreg", torch.autograd.grad(z_total, self.optimizers["zreg"],
                                               allow_unused=True))
        return {**metrics, **z_metrics}

    def step_discriminator(self, batch, noise):
        model = self.model
        batch = {k: v.float() for k, v in batch.items()}
        self._rotate(batch, ((["dm"], noise["angles"][0]), (["dx1", "dx2"], noise["angles"][1])))
        model.eval()
        fake = model.make_fake_masks(batch["dx1"], batch["dx2"], noise["pool_idx"])
        loss, metrics = model.d_mask_loss(batch["dm"][..., :self.conf.num_masks], fake)
        self._adam("d_mask", torch.autograd.grad(loss, self.optimizers["d_mask"]))
        return metrics
