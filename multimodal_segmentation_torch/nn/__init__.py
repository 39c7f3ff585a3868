"""Model components as torch.nn.Modules (NCHW inside)."""

from multimodal_segmentation_torch.nn.anatomy_encoder import AnatomyEncoder, DualAnatomyEncoder
from multimodal_segmentation_torch.nn.balancer import Balancer
from multimodal_segmentation_torch.nn.blocks import BatchNorm, ConvBlock, UpsampleBlock
from multimodal_segmentation_torch.nn.decoder import Decoder, FiLMDecoder, FiLMLayer
from multimodal_segmentation_torch.nn.discriminator import Discriminator, SpectralConv
from multimodal_segmentation_torch.nn.fuser import AnatomyFuser, LocNet
from multimodal_segmentation_torch.nn.modality_encoder import ModalityEncoder
from multimodal_segmentation_torch.nn.segmentor import Segmentor
from multimodal_segmentation_torch.nn.unet import UNetBottleneck, UNetDown, UNetUp

__all__ = [
    "AnatomyEncoder",
    "AnatomyFuser",
    "Balancer",
    "BatchNorm",
    "ConvBlock",
    "Decoder",
    "Discriminator",
    "DualAnatomyEncoder",
    "FiLMDecoder",
    "FiLMLayer",
    "LocNet",
    "ModalityEncoder",
    "Segmentor",
    "SpectralConv",
    "UNetBottleneck",
    "UNetDown",
    "UNetUp",
    "UpsampleBlock",
]
