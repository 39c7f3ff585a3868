"""CHAOS abdominal-MR loader: DICOM -> resample -> align -> [-1,1] -> 192².

Reference: loaders/chaos.py. Pipeline parity:
* T1 = T1DUAL/OutPhase DICOMs, T2 = T2SPIR DICOMs; files sorted by the
  numeric suffix descending (chaos.py:276-298).
* In-plane resample to 1.89 mm (bilinear for images, nearest for masks;
  chaos.py:324-343).
* Hand-curated T1<->T2 slice alignment, ported as data
  (chaos_alignment.ALIGNMENT_OPS; reference chaos.py:110-240).
* Per-slice rescale to [-1, 1] (chaos.py:242-243).
* Ground-truth greyscale split into 4 binary masks at values 63/126/189/252
  (liver, right kidney, left kidney, spleen; chaos.py:303-319).
* Crop/pad to 192x192 (chaos.py:255-256).

The port's own copy of multimodal_segmentation_tpu/data/chaos.py. DICOMs
are read by pydicom when it is installed, else by the native C++ reader
(data/dicom_native.py). When the data folder is missing, loader_factory
gives the synthetic CHAOS-shaped fixture, with a warning, as the JAX
package does. Decoded volumes are cached as .npz so DICOM decode happens
once.
"""

import logging
import os

import numpy as np
from scipy import ndimage

from multimodal_segmentation_torch.data.base_loader import DATA_CONF, Loader
from multimodal_segmentation_torch.data.chaos_alignment import aligned_indices
from multimodal_segmentation_torch.data.containers import (
    MultimodalPairedData,
    crop_same,
    rescale,
)

from multimodal_segmentation_torch.data.dicom_native import read_dicom

log = logging.getLogger("chaos")


def resample_slices(stack, old_res, binary=False, new_res=1.89):
    """Resample (N, H, W, C) slices to 1.89 mm in-plane (chaos.py:324-343);
    bilinear (order 1) for images, nearest (order 0) for masks."""
    zoom = (old_res[0] / new_res, old_res[1] / new_res)
    order = 0 if binary else 1
    out = []
    for i in range(stack.shape[0]):
        chans = [
            ndimage.zoom(stack[i, :, :, c], zoom, order=order, mode="constant")
            for c in range(stack.shape[-1])
        ]
        out.append(np.stack(chans, axis=-1)[None])
    return np.concatenate(out, axis=0)


def _read_png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


class ChaosLoader(Loader):
    """Real-CHAOS loader (reference loaders/chaos.py:20-343)."""

    def __init__(self, data_folder=None, cache_dir=None):
        super().__init__(
            [1, 2, 3, 5, 8, 10, 13, 15, 19, 20, 21, 22, 31, 32, 33, 34, 36, 37, 38, 39]
        )
        self.num_masks = 4  # liver, right kidney, left kidney, spleen
        self.input_shape = (192, 192, 1)
        self.data_folder = data_folder or DATA_CONF["chaos"]
        self.cache_dir = cache_dir or os.path.join(self.data_folder, ".npz_cache")
        self.num_volumes = len(self.volumes)
        self.modalities = ["t1", "t2"]

    def available(self):
        # DICOM decode works without pydicom via the native C++ reader
        # (data/dicom_native.py); only the data folder is required.
        return os.path.isdir(self.data_folder)

    def splits(self):
        # reference loaders/chaos.py:32-48
        return [
            {
                "validation": [31, 36, 13],
                "test": [10, 22, 34],
                "training": [5, 3, 1, 15, 19, 2, 20, 37, 32, 38, 8, 39, 21, 33],
            },
            {
                "validation": [13, 3, 20],
                "test": [5, 15, 39],
                "training": [33, 8, 38, 34, 36, 31, 32, 37, 22, 2, 1, 10, 19, 21],
            },
            {
                "validation": [37, 13, 33],
                "test": [1, 19, 32],
                "training": [5, 20, 31, 2, 38, 3, 8, 15, 22, 10, 34, 39, 36, 21],
            },
        ]

    # ------------------------------------------------------------- loading

    def _load_volume(self, volume, modality):
        """Load one modality of one volume: (images, masks) after resampling
        and mask binarisation (chaos.py:276-321)."""
        cache = os.path.join(self.cache_dir, "vol%d_%s.npz" % (volume, modality))
        if os.path.exists(cache):
            z = np.load(cache)
            return z["images"], z["labels"]

        if modality == "t1":
            folder = os.path.join(self.data_folder, "%d" % volume, "T1DUAL")
            image_folder = os.path.join(folder, "DICOM_anon", "OutPhase")
        else:
            folder = os.path.join(self.data_folder, "%d" % volume, "T2SPIR")
            image_folder = os.path.join(folder, "DICOM_anon")
        labels_folder = os.path.join(folder, "Ground")

        image_files = sorted(
            os.listdir(image_folder), key=lambda x: x.split("-")[-1], reverse=True
        )
        dcms = [read_dicom(os.path.join(image_folder, f)) for f in image_files]
        images = np.stack([d.image for d in dcms])[..., None]
        res = list(dcms[0].resolution[:2])

        label_files = sorted(
            os.listdir(labels_folder), key=lambda x: x.split("-")[-1], reverse=True
        )
        labels = np.stack(
            [_read_png(os.path.join(labels_folder, f)) for f in label_files]
        ).astype(np.float32)[..., None]

        images = resample_slices(images, res, binary=False)
        labels = resample_slices(labels, res, binary=True)

        # greyscale -> 4 binary organ masks (chaos.py:303-319)
        masks = np.concatenate(
            [(labels == v).astype(np.float32) for v in (63, 126, 189, 252)],
            axis=-1,
        )

        os.makedirs(self.cache_dir, exist_ok=True)
        np.savez_compressed(cache, images=images, labels=masks)
        return images, masks

    def load_all_modalities_concatenated(self, split, split_type, downsample=1):
        vols = self.get_volumes_for_split(split, split_type)
        all_i1, all_m1, all_i2, all_m2, all_idx = [], [], [], [], []
        for v in vols:
            images_t1, labels_t1 = self._load_volume(v, "t1")
            images_t2, labels_t2 = self._load_volume(v, "t2")
            idx1, idx2 = aligned_indices(v, images_t1.shape[0], images_t2.shape[0])
            images_t1, labels_t1 = images_t1[idx1], labels_t1[idx1]
            images_t2, labels_t2 = images_t2[idx2], labels_t2[idx2]

            images_t1 = np.concatenate(
                [rescale(images_t1[i : i + 1], -1, 1) for i in range(len(images_t1))]
            )
            images_t2 = np.concatenate(
                [rescale(images_t2[i : i + 1], -1, 1) for i in range(len(images_t2))]
            )
            all_i1.append(images_t1)
            all_m1.append(labels_t1)
            all_i2.append(images_t2)
            all_m2.append(labels_t2)
            all_idx.append(np.array([v] * images_t1.shape[0]))

        all_i1, all_m1 = crop_same(all_i1, all_m1, self.input_shape[:-1])
        all_i2, all_m2 = crop_same(all_i2, all_m2, self.input_shape[:-1])
        images = np.concatenate(
            [np.concatenate(all_i1), np.concatenate(all_i2)], axis=-1
        )
        masks = np.concatenate(
            [np.concatenate(all_m1), np.concatenate(all_m2)], axis=-1
        )
        if self.modalities == ["t2", "t1"]:
            images = images[..., ::-1]
            masks = np.concatenate(
                [masks[..., self.num_masks :], masks[..., : self.num_masks]],
                axis=-1,
            )
        index = np.concatenate(all_idx)
        return MultimodalPairedData(images, masks, index, downsample=downsample)
