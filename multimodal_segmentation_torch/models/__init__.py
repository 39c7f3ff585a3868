"""Model assemblies. The port has DAFNet (inference and the expert-pairing
training losses); MMSDNet is still to be ported (ROADMAP.md, queue A)."""

import torch

from multimodal_segmentation_torch.models.dafnet import DAFNet, resolve_device


def full_f32_matmuls():
    """f32 compute stays f32 on the card: no TF32 in matmuls or cuDNN
    convolutions (the TPS flow cancels heavily; ops/tps.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_model(conf, device="cuda", seed=None):
    """Instantiate conf.model on `device`, its weights drawn from a
    torch.Generator seeded with `seed` (default conf.seed)."""
    dev = resolve_device(device)
    if conf.model == "mmsdnet":
        raise NotImplementedError("MMSDNet is not ported yet (ROADMAP.md, queue A)")
    if conf.model != "dafnet":
        raise ValueError("Unknown model: %s" % conf.model)
    if dev.type == "cuda":
        full_f32_matmuls()
    gen = torch.Generator().manual_seed(conf.seed if seed is None else seed)
    return DAFNet(conf, generator=gen).to(dev).eval()


__all__ = ["DAFNet", "build_model", "full_f32_matmuls"]
