"""Multi-sequence cardiac volume loader (the volumetric dataset).

The port's own copy of multimodal_segmentation_tpu/data/cardiac.py:30-132,
numpy only: the same deterministic synthetic fixture (an LV blood pool,
a myocardium ring and an RV crescent whose radius varies base to apex,
rendered through per-sequence intensity transfer functions: bSSFP bright
blood, LGE a bright scar wedge in the myocardium, T2 a bright edema rim),
the same 25 studies, three splits and `load_volumes`. Volumes are
(D, H, W, 3) float32 in [-1, 1] (sequences last: LGE, bSSFP, T2), masks
(D, H, W, 3) binary (LV blood, myocardium, RV).
"""

import numpy as np

from multimodal_segmentation_torch.data.base_loader import Loader

SEQUENCES = ["lge", "bssfp", "t2"]
NUM_CLASSES = 3  # LV blood pool, myocardium, RV

_VOLUME_IDS = list(range(101, 126))  # 25 studies


class CardiacVolumeLoader(Loader):
    """Synthetic multi-sequence cardiac volumes.

    Volumes are (D, H, W, 3) float32 in [-1, 1] (sequence-last like the
    2-D loaders' modality-last concatenation); masks are (D, H, W, 3)
    binary. D defaults to 16 slices, anisotropic (thick-slice) like real
    LGE stacks.
    """

    def __init__(self, shape=(16, 128, 128), seed=7):
        super().__init__(list(_VOLUME_IDS))
        self.num_masks = NUM_CLASSES
        self.depth, self.height, self.width = shape
        self.input_shape = (self.depth, self.height, self.width, len(SEQUENCES))
        self.modalities = list(SEQUENCES)
        self.seed = seed
        self._cache = {}

    def splits(self):
        v = self.volumes
        return [
            {"validation": v[0:3], "test": v[3:7], "training": v[7:]},
            {"validation": v[3:6], "test": v[6:10], "training": v[10:] + v[0:3]},
            {"validation": v[6:9], "test": v[9:13], "training": v[13:] + v[0:6]},
        ]

    # ---- synthesis ----

    def _volume(self, vid):
        if vid in self._cache:
            return self._cache[vid]
        rng = np.random.RandomState(self.seed + vid)
        D, H, W = self.depth, self.height, self.width
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        yy = (yy - H / 2) / (H / 2)
        xx = (xx - W / 2) / (W / 2)

        cy, cx = rng.uniform(-0.08, 0.08, 2)
        r_lv = rng.uniform(0.16, 0.22)        # LV blood pool radius (mid)
        wall = rng.uniform(0.07, 0.11)        # myocardial wall thickness
        scar_ang = rng.uniform(0, 2 * np.pi)  # scar wedge centre angle
        scar_w = rng.uniform(0.5, 1.2)        # wedge half-width (radians)
        has_scar = rng.rand() > 0.3

        imgs = np.zeros((D, H, W, 3), np.float32)
        msks = np.zeros((D, H, W, 3), np.float32)
        for s in range(D):
            z = (s / max(D - 1, 1)) * 2 - 1          # base -1 .. apex +1
            taper = np.sqrt(max(1.0 - 0.55 * (z + 0.2) ** 2, 0.05))
            rl = r_lv * taper
            rm = (r_lv + wall) * taper
            r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
            lv = (r < rl).astype(np.float32)
            myo = ((r >= rl) & (r < rm)).astype(np.float32)
            # RV: crescent left of the LV
            rv_c = ((yy - cy) ** 2 / (0.22 * taper) ** 2
                    + (xx - cx + 0.38 * taper) ** 2 / (0.30 * taper) ** 2)
            rv = ((rv_c < 1.0) & (r >= rm)).astype(np.float32)

            ang = np.arctan2(yy - cy, xx - cx)
            d_ang = np.abs((ang - scar_ang + np.pi) % (2 * np.pi) - np.pi)
            scar = myo * (d_ang < scar_w) * float(has_scar)

            body = (((yy / 0.92) ** 2 + (xx / 0.92) ** 2) < 1.0).astype(np.float32)
            n = lambda: 0.04 * rng.randn(H, W).astype(np.float32)
            # bSSFP: bright blood, mid-grey myocardium
            imgs[s, :, :, 1] = 0.25 * body + 0.7 * (lv + rv) + 0.35 * myo + n()
            # LGE: nulled myocardium, bright blood, bright scar
            imgs[s, :, :, 0] = (0.2 * body + 0.55 * (lv + rv) + 0.05 * myo
                                + 0.8 * scar + n())
            # T2: bright edema rim around the scar, grey otherwise
            edema = myo * (d_ang < scar_w * 1.4) * float(has_scar)
            imgs[s, :, :, 2] = 0.2 * body + 0.4 * (lv + rv) + 0.25 * myo \
                + 0.55 * edema + n()
            msks[s, :, :, 0] = lv
            msks[s, :, :, 1] = myo
            msks[s, :, :, 2] = rv

        # rescale each sequence to [-1, 1] like the 2-D path
        for c in range(3):
            ch = imgs[..., c]
            lo, hi = ch.min(), ch.max()
            imgs[..., c] = (ch - lo) / max(hi - lo, 1e-6) * 2 - 1
        self._cache[vid] = (imgs, msks)
        return self._cache[vid]

    # ---- volumetric API ----

    def load_volumes(self, split, split_type):
        """Returns (volumes (N, D, H, W, 3), masks (N, D, H, W, 3))."""
        vols = self.get_volumes_for_split(split, split_type)
        imgs, msks = zip(*[self._volume(v) for v in vols])
        return np.stack(imgs), np.stack(msks)

    # ---- 2-D Loader ABC compatibility: expose mid-stack slices ----

    def load_all_modalities_concatenated(self, split, split_type, downsample=1):
        raise NotImplementedError(
            "CardiacVolumeLoader is volumetric; use load_volumes()"
        )
