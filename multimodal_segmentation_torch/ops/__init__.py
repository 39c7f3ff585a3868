"""Compute ops: plain PyTorch versions and the CUDA kernels that replace
the JAX package's Pallas kernels."""

from multimodal_segmentation_torch.ops.batching import batch_deinterleave, batch_interleave
from multimodal_segmentation_torch.ops.resample import bilinear_sample
from multimodal_segmentation_torch.ops.rounding import round_ste
from multimodal_segmentation_torch.ops.tps import (
    control_grid,
    tps_coefficients,
    tps_sample_locations,
    tps_warp,
)

__all__ = [
    "batch_deinterleave",
    "batch_interleave",
    "bilinear_sample",
    "round_ste",
    "control_grid",
    "tps_coefficients",
    "tps_sample_locations",
    "tps_warp",
]
