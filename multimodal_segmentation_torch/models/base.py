"""Helpers shared by the models: the training losses' mask residual and
fake-pool select (multimodal_segmentation_tpu/models/base.py:122-167), the
device rule of the entry points, the `predict_mask` fusion API of both
models (models/dafnet.py:657-685, models/mmsdnet.py:334-351) and their
placement on a data-parallel mesh (`set_mesh`). `predict_mask` records
its spans (utils/tracing.py) while a torch.profiler session runs.
"""

import torch

from multimodal_segmentation_torch.nn.blocks import BatchNorm
from multimodal_segmentation_torch.utils import tracing


def add_residual(masks):
    """Append a background channel = 1 - union of the mask channels to an
    NHWC (B, H, W, num_masks) {0,1} mask batch
    (model_executors/base_executor.py:83-87)."""
    hit = (masks == 1.0).to(masks.dtype)
    residual = 1.0 - torch.amax(hit, dim=-1, keepdim=True)
    return torch.cat([masks, residual], dim=-1)


def subsample_pool(slot_idx, variants):
    """Fake-pool subsample as a per-slot select (models/base.py:132-167):
    slot b of the result is variants[slot_idx[b]][b].

    Args:
      slot_idx: (B,) integer tensor with values in [0, len(variants)); the
        caller draws it (the JAX package draws jax.random.randint).
      variants: list of K equally-shaped (B, ...) tensors.
    """
    if len(variants) == 1:
        return variants[0]
    shape = (slot_idx.shape[0],) + (1,) * (variants[0].dim() - 1)
    idx = slot_idx.to(variants[0].device).reshape(shape)
    out = variants[0]
    for j in range(1, len(variants)):
        out = torch.where(idx == j, variants[j], out)
    return out


FUSION_TYPES = ("simple", "def", "max", "maxnostn")


class MeshMember:
    """`set_mesh(mesh)` for a 2-D model: the one place that puts it on a
    data-parallel mesh (parallel/mesh.py). It hands the mesh's 'data'
    process group to every BatchNorm (global-batch statistics) and keeps
    it as `data_group`, which the model's losses pass to the weighted
    BCE (global class masses). Nothing else in a model knows the mesh.
    set_mesh(None) takes the model off it."""

    data_group = None

    def set_mesh(self, mesh):
        self.data_group = None if mesh is None else mesh.axis("data").group
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = self.data_group


def resolve_device(device):
    """torch.device for `device`; 'cuda' without an index means the current
    card. Raises when CUDA is asked for and there is none: nothing here
    moves to the CPU unless the caller says device='cpu'."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class MaskPredictor:
    """`predict_mask` for a model with `encode_anatomies(x_mod0, x_mod1)`
    (NCHW, both anatomies), `fuser` and `segmentor`."""

    @torch.inference_mode()
    def predict_mask(self, modality_index, fusion_type, images, device="cuda"):
        """Segment modality `modality_index` from both modalities' images
        (models/mmsdnet.py:210-232).

        Args:
          modality_index: 0 or 1, the modality to segment.
          fusion_type: 'simple' | 'def' | 'max' | 'maxnostn'.
          images: [x_mod0, x_mod1], each (B, H, W, 1) numpy array or tensor.
          device: where the model's weights are and the work runs.

        Returns:
          (B, H, W, num_masks + 1) f32 mask probabilities on `device`.
        """
        if fusion_type not in FUSION_TYPES:
            raise ValueError("fusion_type must be one of %s, got %r"
                             % (FUSION_TYPES, fusion_type))
        dev = resolve_device(device)
        w_dev = next(self.parameters()).device
        if w_dev != dev:
            raise ValueError("the model's weights are on %s, not on %s" % (w_dev, dev))
        with tracing.span("predict_mask", slices=int(images[0].shape[0]), fusion=fusion_type):
            with tracing.span("predict.inputs"):
                x = [torch.as_tensor(im, dtype=torch.float32, device=dev).permute(0, 3, 1, 2)
                     for im in images]
            with tracing.span("predict.encode"):
                anatomies = self.encode_anatomies(x[0], x[1])
            # s2: the modality to segment, s1: the other one
            s1, s2 = anatomies[1 - modality_index], anatomies[modality_index]
            if fusion_type == "simple":
                s = s2
            else:
                with tracing.span("predict.fuse"):
                    if fusion_type == "maxnostn":
                        s = torch.maximum(s1, s2)
                    else:
                        s_def, s_fused = self.fuser(s1, s2, fast=True)
                        s = s_def if fusion_type == "def" else s_fused
            with tracing.span("predict.segment"):
                return self.segmentor(s).permute(0, 2, 3, 1)
