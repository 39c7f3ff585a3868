"""Train state: the model (parameters, BatchNorm statistics, spectral
vectors), one Adam per parameter group, the SWA running average of the
parameters, the step and epoch counts and the random generator of the
step's noise.

Port of multimodal_segmentation_tpu/train/state.py:17-44, 88-118.
MMSDNet's state adds `opt_zreg`, the Adam of its Z-regressor over the
decoder and the modality encoder: parameters that opt_gen updates too, so
two Adams with moments of their own update them in turn
(train/state.py:102-114).
"""

import contextlib
import dataclasses

import torch


def adam(params, lr, fused=False):
    """Keras 2.1.6 Adam defaults: beta1 0.9, beta2 0.999, epsilon 1e-7.
    torch.optim.Adam computes the same bias-corrected update as optax.adam,
    lr * m_hat / (sqrt(v_hat) + eps).

    fused=True is the JAX package's adam(fused=True) (train/state.py:30-84,
    flat_adam): the same update over all the optimizer's parameters in one
    fused call instead of a chain of small operations a parameter, with
    PyTorch's fused CUDA implementation on the card and its multi-tensor
    (foreach) one on the CPU. The moments stay one per parameter, so the
    state_dict, and so the checkpoint, keeps its format."""
    params = list(params)
    if not fused:
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-7)
    on_card = params[0].device.type == "cuda"
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-7,
                            fused=on_card, foreach=not on_card)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    opt_gen: torch.optim.Optimizer                # the six generator components
    opt_disc: dict                                # one Adam per discriminator
    generator: torch.Generator                    # noise of the steps
    swa: dict                                     # {parameter name: SWA average}
    step: int = 0
    epoch: int = 0
    opt_zreg: torch.optim.Optimizer = None        # MMSDNet's Z-regressor, else None

    @contextlib.contextmanager
    def swa_weights(self):
        """Within the block the model's parameters hold the SWA values;
        after it, the live ones again. The values are copied in place, so
        the optimizers keep their references to the parameters. Buffers
        (BatchNorm statistics, spectral `u`) stay live, as in the JAX
        package's params_for_eval."""
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            live = {n: p.detach().clone() for n, p in params.items()}
            for n, p in params.items():
                p.copy_(self.swa[n])
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(live[n])


def swa_copy(model):
    """{name: a copy of the parameter}: the SWA average's starting value,
    never aliasing the parameters."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def create_train_state(model, conf, seed=None):
    """A TrainState around `model`: one Adam for its GEN_COMPONENTS, one
    for each of its DISC_COMPONENTS (lr from d_mask_params or
    d_image_params) and, where the model has ZREG_COMPONENTS, one for them,
    each fused under conf.fused_adam;
    the SWA average started at the parameters, and a torch.Generator on the
    model's device seeded with `seed` (default conf.seed)."""
    dev = next(model.parameters()).device
    fused = conf.fused_adam
    opt_gen = adam(model.component_parameters(model.GEN_COMPONENTS), conf.lr, fused)
    opt_disc = {}
    for name in model.DISC_COMPONENTS:
        lr = (conf.d_mask_params if name == "d_mask" else conf.d_image_params).lr
        opt_disc[name] = adam(getattr(model, name).parameters(), lr, fused)
    opt_zreg = None
    if hasattr(model, "ZREG_COMPONENTS"):
        opt_zreg = adam(model.component_parameters(model.ZREG_COMPONENTS), conf.lr, fused)
    gen = torch.Generator(device=dev).manual_seed(conf.seed if seed is None else seed)
    return TrainState(model=model, opt_gen=opt_gen, opt_disc=opt_disc, generator=gen,
                      swa=swa_copy(model), opt_zreg=opt_zreg)
