"""Loader registry (reference loaders/loader_factory.py:4-10).

Port of multimodal_segmentation_tpu/data/loader_factory.py. 'chaos'
resolves to the real DICOM loader when its data folder exists (DATA_CONF,
MMSEG_TPU_CHAOS_DIR), otherwise to the synthetic CHAOS-shaped fixture with
the JAX package's warning; 'cardiac' to the synthetic multi-sequence
cardiac volumes (data/cardiac.py).
"""

import logging

log = logging.getLogger("loader_factory")


def init_loader(name, **kwargs):
    if name == "chaos":
        from multimodal_segmentation_torch.data.chaos import ChaosLoader

        loader = ChaosLoader(**kwargs)
        if loader.available():
            return loader
        log.warning(
            "CHAOS data folder unavailable (%s); using synthetic fixture",
            loader.data_folder,
        )
        from multimodal_segmentation_torch.data.synthetic import SyntheticChaosLoader

        return SyntheticChaosLoader()
    if name == "synthetic":
        from multimodal_segmentation_torch.data.synthetic import SyntheticChaosLoader

        return SyntheticChaosLoader(**kwargs)
    if name == "cardiac":
        from multimodal_segmentation_torch.data.cardiac import CardiacVolumeLoader

        return CardiacVolumeLoader(**kwargs)
    raise ValueError("Unknown loader: %s" % name)
