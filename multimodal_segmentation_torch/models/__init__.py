"""Model assemblies: DAFNet and MMSDNet, each with its training losses
and the `predict_mask` fusion API."""

import torch

from multimodal_segmentation_torch.models.base import resolve_device
from multimodal_segmentation_torch.models.dafnet import DAFNet
from multimodal_segmentation_torch.models.mmsdnet import MMSDNet
from multimodal_segmentation_torch.utils.nan_checks import install_nan_checks

MODELS = {"dafnet": DAFNet, "mmsdnet": MMSDNet}


def full_f32_matmuls():
    """f32 compute stays f32 on the card: no TF32 in matmuls or cuDNN
    convolutions (the TPS flow cancels heavily; ops/tps.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_model(conf, device="cuda", seed=None):
    """Instantiate conf.model on `device`, its weights drawn from a
    torch.Generator seeded with `seed` (default conf.seed); under
    conf.debug_nans every module's output is checked for NaNs
    (utils/nan_checks.py)."""
    dev = resolve_device(device)
    if conf.model not in MODELS:
        raise ValueError("Unknown model: %s" % conf.model)
    if dev.type == "cuda":
        full_f32_matmuls()
    gen = torch.Generator().manual_seed(conf.seed if seed is None else seed)
    model = MODELS[conf.model](conf, generator=gen).to(dev).eval()
    if conf.debug_nans:
        install_nan_checks(model)
    return model


__all__ = ["DAFNet", "MMSDNet", "build_model", "full_f32_matmuls", "resolve_device"]
