"""Host-side batch streams feeding the training steps.

The port's copy of multimodal_segmentation_tpu/data/batches.py:14-45, and
the expert-pairing batch assembly of its executor (train/executor.py:
110-127, 144-177, 430-448): labelled x1, x2, m1, m2, then dm1, dm2 from the
real-mask pool, then dx1, dx2 from the image pool. Batches are always full
(wraparound at the epoch's end).
"""

import numpy as np


class BatchStream:
    """Infinite shuffled batch iterator over a dict of equal-length arrays."""

    def __init__(self, arrays, batch_size, seed=0, shuffle=True):
        self.arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
        lengths = {k: len(v) for k, v in self.arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError("arrays of unequal length: %s" % lengths)
        self.n = next(iter(lengths.values()))
        if self.n == 0:
            raise ValueError("empty batch stream")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self._order = np.arange(self.n)
        self._pos = self.n  # force a reshuffle on the first draw

    def __iter__(self):
        return self

    def __next__(self):
        idx = []
        need = self.batch_size
        while need > 0:
            if self._pos >= self.n:
                if self.shuffle:
                    self.rng.shuffle(self._order)
                self._pos = 0
            take = min(need, self.n - self._pos)
            idx.append(self._order[self._pos : self._pos + take])
            self._pos += take
            need -= take
        idx = np.concatenate(idx)
        return {k: v[idx] for k, v in self.arrays.items()}


def expert_batches(conf, loader):
    """Infinite iterator of supervised expert-pairing batches
    {x1, x2, m1, m2, dm1, dm2, dx1, dx2} from `loader`'s training split
    `conf.split`, for l_mix = 1 (every volume labelled), as the JAX
    package's DAFNetExecutor assembles them."""
    if conf.l_mix != 1:
        raise NotImplementedError(
            "only l_mix = 1 is ported (the executor slice, ROADMAP.md, queue A)")
    data = loader.load_all_modalities_concatenated(conf.split, "training", conf.image_downsample)
    data.crop(conf.input_hw)
    data.sample(int(np.round(conf.l_mix * data.num_volumes)), seed=conf.seed)
    labelled = BatchStream({
        "x1": data.get_images_modi(0), "x2": data.get_images_modi(1),
        "m1": data.get_masks_modi(0), "m2": data.get_masks_modi(1),
    }, conf.batch_size, conf.seed)
    masks = BatchStream(
        {"m": np.concatenate([data.get_masks_modi(0), data.get_masks_modi(1)], axis=0)},
        conf.batch_size, conf.seed + 2)
    full = loader.load_all_modalities_concatenated(conf.split, "training", conf.image_downsample)
    full.crop(conf.input_hw)
    images = BatchStream({"dx1": full.get_images_modi(0), "dx2": full.get_images_modi(1)},
                         conf.batch_size, conf.seed + 3)
    while True:
        batch = dict(next(labelled))
        dm1 = next(masks)["m"]
        dm2 = next(masks)["m"]
        batch.update(next(images))
        batch["dm1"], batch["dm2"] = dm1, dm2
        yield batch
