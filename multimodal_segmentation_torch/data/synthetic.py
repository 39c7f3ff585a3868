"""Synthetic CHAOS-shaped dataset (numpy).

The port's own copy of multimodal_segmentation_tpu/data/synthetic.py; its
test arrays are bit-equal to the JAX package's.

The real CHAOS data path is external to the repo (reference
loaders/base_loader.py:5-7 points at ../../data/Chaos/MR), so tests and
benchmarks run against a deterministic synthetic dataset with the same
shape contract: 20 volumes, ~16 paired T1/T2 slices each, 4 organ masks,
images in [-1, 1], 3 cross-validation splits (SURVEY.md §4).

Each volume is a shared smooth "anatomy" (4 ellipsoidal organs whose size
varies along the slice axis) rendered into two modalities with different
intensity transfer functions and noise; T1 is slightly warped relative to
T2 so the TPS fuser has real registration work to do.
"""

import numpy as np

from multimodal_segmentation_torch.data.base_loader import Loader
from multimodal_segmentation_torch.data.containers import (
    MultimodalPairedData,
    crop_same,
    rescale,
)

_VOLUME_IDS = [1, 2, 3, 5, 8, 10, 13, 15, 19, 20, 21, 22, 31, 32, 33, 34, 36, 37, 38, 39]


def _render_volume(vol_id, n_slices, hw, rng):
    """Render (images_t1, masks_t1, images_t2, masks_t2) for one volume."""
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    yy = (yy - H / 2) / (H / 2)
    xx = (xx - W / 2) / (W / 2)

    # organ centres/sizes with per-volume jitter
    organs = [
        (-0.25, -0.30, 0.45, 0.35),  # liver-ish
        (0.30, -0.25, 0.16, 0.13),   # right kidney
        (0.30, 0.25, 0.16, 0.13),    # left kidney
        (-0.05, 0.45, 0.20, 0.15),   # spleen
    ]
    jit = rng.uniform(-0.05, 0.05, size=(4, 4))
    # Per-organ anatomy drift along the slice axis: organ centres move with
    # z, so neighbouring slices show genuinely displaced anatomy. This is
    # what gives the automated-pairing candidates (expand_pairs stacks
    # neighbour slices as pairing candidates, reference
    # loaders/MultimodalPairedData.py:91-141) materially DIFFERENT
    # alignment quality — the expert pair matches, the |offset|=1,2
    # neighbours are progressively misaligned — so the Balancer
    # (model_components/balancer.py:11-38) has real signal to rank them.
    # At ~16 slices a +/-1 neighbour displaces organ centres by ~0.04
    # normalised units (~4 px at 192^2), ~2x that for |offset|=2.
    drift = rng.uniform(0.15, 0.3, size=(4, 2)) * rng.choice([-1, 1], size=(4, 2))

    imgs1, msks1, imgs2, msks2 = [], [], [], []
    for s in range(n_slices):
        z = (s / max(n_slices - 1, 1)) * 2 - 1  # slice position in [-1, 1]
        zscale = np.sqrt(max(1.0 - 0.6 * z * z, 0.05))
        masks = []
        for k, (cy, cx, ry, rx) in enumerate(organs):
            cy = cy + jit[k, 0] + drift[k, 0] * z
            cx = cx + jit[k, 1] + drift[k, 1] * z
            ry = (ry + jit[k, 2] * 0.3) * zscale
            rx = (rx + jit[k, 3] * 0.3) * zscale
            d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
            masks.append((d < 1.0).astype(np.float32))
        masks = np.stack(masks, axis=-1)  # (H, W, 4)

        body = (((yy / 0.9) ** 2 + (xx / 0.95) ** 2) < 1.0).astype(np.float32)
        base = 0.3 * body + masks @ np.array([0.5, 0.35, 0.35, 0.45], np.float32)

        t2 = base + 0.05 * rng.randn(H, W).astype(np.float32)
        # T1: different transfer function + small rigid warp vs T2
        shift = rng.randint(-3, 4, size=2)
        t1 = np.tanh(1.5 * base) + 0.05 * rng.randn(H, W).astype(np.float32)
        t1 = np.roll(t1, shift, axis=(0, 1))
        m1 = np.roll(masks, shift, axis=(0, 1))

        imgs1.append(t1[None, :, :, None])
        msks1.append(m1[None])
        imgs2.append(t2[None, :, :, None])
        msks2.append(masks[None])

    out = (
        np.concatenate(imgs1),
        np.concatenate(msks1),
        np.concatenate(imgs2),
        np.concatenate(msks2),
    )
    return out


class SyntheticChaosLoader(Loader):
    """CHAOS-shaped synthetic loader with identical split structure
    (reference loaders/chaos.py:20-48)."""

    def __init__(self, hw=(192, 192), seed=42):
        super().__init__(list(_VOLUME_IDS))
        self.num_masks = 4
        self.input_shape = (hw[0], hw[1], 1)
        self.hw = hw
        self.seed = seed
        self.num_volumes = len(self.volumes)
        self.modalities = ["t1", "t2"]
        self._cache = {}

    def splits(self):
        # same split structure as reference loaders/chaos.py:32-48
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

    def _volume(self, v):
        if v not in self._cache:
            rng = np.random.RandomState(self.seed + v)
            n_slices = rng.randint(14, 22)
            self._cache[v] = _render_volume(v, n_slices, self.hw, rng)
        return self._cache[v]

    def load_all_modalities_concatenated(self, split, split_type, downsample=1):
        vols = self.get_volumes_for_split(split, split_type)
        i1, m1, i2, m2, index = [], [], [], [], []
        for v in vols:
            a, b, c, d = self._volume(v)
            a = np.concatenate(
                [rescale(a[i : i + 1], -1, 1) for i in range(a.shape[0])]
            )
            c = np.concatenate(
                [rescale(c[i : i + 1], -1, 1) for i in range(c.shape[0])]
            )
            i1.append(a)
            m1.append(b)
            i2.append(c)
            m2.append(d)
            index.append(np.array([v] * a.shape[0]))
        i1, m1 = crop_same(i1, m1, self.input_shape[:-1])
        i2, m2 = crop_same(i2, m2, self.input_shape[:-1])
        images = np.concatenate(
            [np.concatenate(i1), np.concatenate(i2)], axis=-1
        )
        masks = np.concatenate(
            [np.concatenate(m1), np.concatenate(m2)], axis=-1
        )
        if self.modalities == ["t2", "t1"]:
            images = images[..., ::-1]
            masks = np.concatenate(
                [masks[..., self.num_masks :], masks[..., : self.num_masks]],
                axis=-1,
            )
        index = np.concatenate(index)
        return MultimodalPairedData(images, masks, index, downsample=downsample)
