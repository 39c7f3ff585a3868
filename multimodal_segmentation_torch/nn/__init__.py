"""Model components as torch.nn.Modules (NCHW inside)."""

from multimodal_segmentation_torch.nn.anatomy_encoder import AnatomyEncoder, DualAnatomyEncoder
from multimodal_segmentation_torch.nn.blocks import BatchNorm, ConvBlock, UpsampleBlock
from multimodal_segmentation_torch.nn.fuser import AnatomyFuser, LocNet
from multimodal_segmentation_torch.nn.segmentor import Segmentor
from multimodal_segmentation_torch.nn.unet import UNetBottleneck, UNetDown, UNetUp

__all__ = [
    "AnatomyEncoder",
    "AnatomyFuser",
    "BatchNorm",
    "ConvBlock",
    "DualAnatomyEncoder",
    "LocNet",
    "Segmentor",
    "UNetBottleneck",
    "UNetDown",
    "UNetUp",
    "UpsampleBlock",
]
