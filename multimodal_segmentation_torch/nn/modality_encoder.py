"""Modality (intensity) VAE encoder.

Port of multimodal_segmentation_tpu/nn/modality_encoder.py:19-52
(reference model_components/modality_encoder.py:13-52). Takes the anatomy
map and the image (NCHW) and returns (z, z_mean, z_log_var, kl). The
reparameterisation noise `eps` is an argument, drawn by the caller (the JAX
package draws it from the module's 'sample' RNG stream); without it z is
z_mean, as with sample=False.
"""

import torch
from torch import nn

from multimodal_segmentation_torch.nn.blocks import Conv2d, Linear, leaky_relu


class ModalityEncoder(nn.Module):
    """Four 3x3 stride-2 VALID convs (he_normal) with LeakyReLU 0.3, an
    NHWC flatten, Dense(32) + LeakyReLU, and f32 z_mean / z_log_var heads."""

    def __init__(self, in_ch, input_hw, num_z=8, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        h, w = input_hw
        for i, f in enumerate((16, 32, 64, 128)):
            self.add_module("Conv_%d" % i, Conv2d(in_ch, f, 3, padding="VALID",
                                                 init="he_normal", stride=2))
            in_ch, h, w = f, (h - 3) // 2 + 1, (w - 3) // 2 + 1
        self.Dense_0 = Linear(h * w * in_ch, 32, init="he_normal")
        self.z_mean = Linear(32, num_z)
        self.z_log_var = Linear(32, num_z)

    def forward(self, anatomy, image, eps=None):
        """anatomy (B, S, H, W), image (B, 1, H, W), eps (B, num_z) or None.
        Returns z, z_mean, z_log_var (B, num_z) f32 and the per-sample KL
        divergence (B, 1) (costs.py:186-189)."""
        x = torch.cat([anatomy.to(self.dtype), image.to(self.dtype)], dim=1)
        for i in range(4):
            x = leaky_relu(getattr(self, "Conv_%d" % i)(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = leaky_relu(self.Dense_0(x.to(self.dtype)))
        # VAE heads in f32: exp(log_var) and the KL need the range
        x = x.float()
        z_mean = self.z_mean(x)
        z_log_var = self.z_log_var(x)
        z = z_mean if eps is None else z_mean + torch.exp(0.5 * z_log_var) * eps
        kl = -0.5 * torch.sum(1.0 + z_log_var - z_mean.square() - torch.exp(z_log_var), dim=-1)
        return z, z_mean, z_log_var, kl[:, None]
