"""Loader registry (reference loaders/loader_factory.py:4-10).

The port carries the synthetic CHAOS-shaped fixture only. The CHAOS DICOM
and cardiac loaders are still to be ported (ROADMAP.md, queue A).
"""


def init_loader(name, **kwargs):
    if name == "synthetic":
        from multimodal_segmentation_torch.data.synthetic import SyntheticChaosLoader

        return SyntheticChaosLoader(**kwargs)
    if name in ("chaos", "cardiac"):
        raise NotImplementedError(
            "the '%s' loader is not ported yet (ROADMAP.md, queue A); "
            "use the 'synthetic' loader" % name
        )
    raise ValueError("Unknown loader: %s" % name)
