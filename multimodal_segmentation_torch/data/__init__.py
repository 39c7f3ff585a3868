"""Data layer: numpy containers, the CHAOS DICOM loader and the synthetic
CHAOS-shaped fixture."""

from multimodal_segmentation_torch.data.containers import Data, MultimodalPairedData
from multimodal_segmentation_torch.data.loader_factory import init_loader

__all__ = ["Data", "MultimodalPairedData", "init_loader"]
