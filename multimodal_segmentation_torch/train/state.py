"""Train state: the model (parameters, BatchNorm statistics, spectral
vectors), one Adam per parameter group, the step count and the random
generator of the step's noise.

Port of multimodal_segmentation_tpu/train/state.py:30-44, 88-118 for
DAFNet. SWA comes with the executor slice (ROADMAP.md, queue A).
"""

import dataclasses

import torch


def adam(params, lr):
    """Keras 2.1.6 Adam defaults: beta1 0.9, beta2 0.999, epsilon 1e-7.
    torch.optim.Adam computes the same bias-corrected update as optax.adam,
    lr * m_hat / (sqrt(v_hat) + eps)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-7)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    opt_gen: torch.optim.Optimizer                # the six generator components
    opt_disc: dict                                # one Adam per discriminator
    generator: torch.Generator                    # noise of the steps
    step: int = 0


def create_train_state(model, conf, seed=None):
    """A TrainState around `model`: one Adam for its GEN_COMPONENTS and one
    for each of its DISC_COMPONENTS (lr from d_mask_params or
    d_image_params), and a torch.Generator on the model's device seeded
    with `seed` (default conf.seed)."""
    dev = next(model.parameters()).device
    opt_gen = adam(model.component_parameters(model.GEN_COMPONENTS), conf.lr)
    opt_disc = {}
    for name in model.DISC_COMPONENTS:
        lr = (conf.d_mask_params if name == "d_mask" else conf.d_image_params).lr
        opt_disc[name] = adam(getattr(model, name).parameters(), lr)
    gen = torch.Generator(device=dev).manual_seed(conf.seed if seed is None else seed)
    return TrainState(model=model, opt_gen=opt_gen, opt_disc=opt_disc, generator=gen)
