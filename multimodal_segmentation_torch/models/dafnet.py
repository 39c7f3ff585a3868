"""DAFNet inference: dual anatomy encoder, TPS fuser, segmentor, and the
`predict_mask` fusion API.

Port of the inference side of multimodal_segmentation_tpu/models/dafnet.py
(components :49-100, predict_mask :657-685). The modality encoder, the
decoders, the discriminators, the balancer and the loss functions come
with the training slice (ROADMAP.md, queue A).
"""

import torch
from torch import nn

from multimodal_segmentation_torch.nn import AnatomyFuser, DualAnatomyEncoder, Segmentor
from multimodal_segmentation_torch.nn.blocks import flax_init_

FUSION_TYPES = ("simple", "def", "max", "maxnostn")


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


class DAFNet(nn.Module):
    """The inference components of DAFNet, initialised from `generator`
    as Flax initialises them."""

    def __init__(self, conf, generator=None):
        super().__init__()
        self.conf = conf
        ae = conf.anatomy_encoder
        dtype = getattr(torch, conf.compute_dtype)
        self.modalities = list(conf.modality)
        self.enc_anatomy = DualAnatomyEncoder(
            in_ch=conf.input_shape[-1],
            filters=ae.filters,
            downsample=ae.downsample,
            norm=ae.normalise,
            out_channels=ae.out_channels,
            rounding=ae.rounding,
            dtype=dtype,
        )
        self.fuser = AnatomyFuser(
            ae.out_channels, conf.input_hw, dtype=dtype,
            eval_blend_bf16=conf.eval_warp == "bf16",
        )
        self.segmentor = Segmentor(ae.out_channels, conf.num_masks, dtype=dtype)
        flax_init_(self, generator)

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
        x = [torch.as_tensor(im, dtype=torch.float32, device=dev).permute(0, 3, 1, 2)
             for im in images]
        idx2 = modality_index
        idx1 = 1 - idx2
        # encoder 1 is tied to modality 0's private path
        if idx1 == 0:
            s1, s2 = self.enc_anatomy(x[idx1], x[idx2])
        else:
            s2, s1 = self.enc_anatomy(x[idx2], x[idx1])

        if fusion_type == "simple":
            s = s2
        elif fusion_type == "maxnostn":
            s = torch.maximum(s1, s2)
        else:
            s_def, s_fused = self.fuser(s1, s2, fast=True)
            s = s_def if fusion_type == "def" else s_fused
        return self.segmentor(s).permute(0, 2, 3, 1)
