"""Dataset loader abstraction (reference loaders/base_loader.py:10-89).

The port's own copy of multimodal_segmentation_tpu/data/base_loader.py.
Implement a Loader subclass and register it in loader_factory to add a
dataset.
"""

import os
from abc import ABC, abstractmethod

import numpy as np

# reference loaders/base_loader.py:5-7; the variable and default of the
# JAX package's data/base_loader.py, so one setting serves both packages
DATA_CONF = {
    "chaos": os.environ.get("MMSEG_TPU_CHAOS_DIR", "../../data/Chaos/MR"),
}


class Loader(ABC):
    def __init__(self, volumes=None):
        self.volumes = volumes or []
        self.num_masks = 0
        self.input_shape = None
        self.modalities = []

    @abstractmethod
    def splits(self):
        """List of {'training': [...], 'validation': [...], 'test': [...]}."""

    @abstractmethod
    def load_all_modalities_concatenated(self, split, split_type, downsample=1):
        """Returns a MultimodalPairedData for the given split."""

    def get_volumes_for_split(self, split, split_type):
        if split_type == "all":
            return self.volumes
        return self.splits()[split][split_type]

    # --- single-modality views (reference loaders/chaos.py:50-100) ---

    def load_labelled_data(self, split, split_type, modality, downsample=1):
        """Flatten the paired container into a single-modality Data object
        ('all' concatenates both modalities)."""
        from multimodal_segmentation_torch.data.containers import Data

        data = self.load_all_modalities_concatenated(split, split_type, downsample)
        i1, i2 = data.get_images_modi(0), data.get_images_modi(1)
        m1, m2 = data.get_masks_modi(0), data.get_masks_modi(1)
        if modality == "all":
            images = np.concatenate([i1, i2], axis=0)
            masks = np.concatenate([m1, m2], axis=0)
            index = np.concatenate([data.index, data.index.copy()], axis=0)
        elif modality == self.modalities[0]:
            images, masks, index = i1, m1, data.index
        elif modality == self.modalities[1]:
            images, masks, index = i2, m2, data.index
        else:
            raise ValueError("Unknown modality: %s" % modality)
        return Data(images, masks, index, 1)

    def load_unlabelled_data(self, split, split_type, modality, downsample=1):
        return self.load_labelled_data(split, split_type, modality, downsample)

    def load_all_data(self, split, split_type, modality, downsample=1):
        return self.load_labelled_data(split, split_type, modality, downsample)
