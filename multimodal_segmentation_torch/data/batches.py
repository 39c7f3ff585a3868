"""Host-side batch streams and the batch assembly of the training
executors.

The port's copy of multimodal_segmentation_tpu/data/batches.py:14-45 and
of the data half of its executor (train/executor.py:63-194, 430-448,
519-530): the l_mix labelled subset and its unlabelled complement (with
`randomise`, or with `automatedpairing`'s candidate neighbours), the
real-mask pool of the mask discriminator, the image pool of the image
discriminators, and per step one batch per active path: labelled x1, x2,
m1, m2 ('sup') and unlabelled x1, x2, m1 ('unsup'). DAFNet's batches each
carry dm1, dm2 from the mask pool and dx1, dx2 from the image pool;
MMSDNet's step has one 'disc' batch of dm, dx1, dx2 instead. Batches are
always full (wraparound at the epoch's end). Everything here is numpy.
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


class TrainingData:
    """The training split of `loader` cut as conf says, and the batch
    streams over it, seeded as the JAX executor seeds them: labelled
    conf.seed, unlabelled seed + 1, mask pool seed + 2, image pool seed + 3.
    Under conf.automatedpairing each slice carries its n_pairs candidate
    neighbours along channels (expand_pairs, executor.py:76-78, 95-97), and
    the image keys are x1_pairs, x2_pairs.

    Attributes after construction: data / ul_data (the labelled and
    unlabelled MultimodalPairedData, or None), data_len (slices of the
    larger), gen_labelled / gen_unlabelled / disc_masks / disc_images (the
    BatchStreams, the first two None when their path is off).
    """

    def __init__(self, conf, loader):
        self.conf = conf
        self.loader = loader
        self.data = self._load_labelled()
        self.data_len = self.data.size() if self.data is not None else 0
        self.ul_data = self._load_unlabelled()
        if self.ul_data is not None and (self.data is None or self.ul_data.size() > self.data_len):
            self.data_len = self.ul_data.size()

        x1, x2 = ("x1_pairs", "x2_pairs") if conf.automatedpairing else ("x1", "x2")
        self.gen_labelled = self.gen_unlabelled = None
        if self.data is not None:
            self.gen_labelled = BatchStream({
                x1: self.data.get_images_modi(0), x2: self.data.get_images_modi(1),
                "m1": self.data.get_masks_modi(0), "m2": self.data.get_masks_modi(1),
            }, conf.batch_size, conf.seed)
        if self.ul_data is not None:
            self.gen_unlabelled = BatchStream({
                x1: self.ul_data.get_images_modi(0), x2: self.ul_data.get_images_modi(1),
                "m1": self.ul_data.get_masks_modi(0),
            }, conf.batch_size, conf.seed + 1)
        self.disc_masks = BatchStream({"m": self._disc_mask_pool()}, conf.batch_size,
                                      conf.seed + 2)
        dx1, dx2 = self._disc_image_pool()
        self.disc_images = BatchStream({"dx1": dx1, "dx2": dx2}, conf.batch_size,
                                       conf.seed + 3)

    def _expand(self, data):
        """The n_pairs - 1 neighbours of each slice, modality 0 then 1."""
        n = self.conf.n_pairs
        data.expand_pairs(n - 1, 0, neighborhood=n)
        data.expand_pairs(n - 1, 1, neighborhood=n)

    def _training_split(self):
        conf = self.conf
        data = self.loader.load_all_modalities_concatenated(
            conf.split, "training", conf.image_downsample)
        data.crop(conf.input_hw)
        return data

    def _load_labelled(self):
        """The l_mix volume-level labelled subset (executor.py:63-81)."""
        conf = self.conf
        if conf.l_mix == 0:
            return None
        data = self._training_split()
        data.sample(int(np.round(conf.l_mix * data.num_volumes)), seed=conf.seed)
        if conf.randomise:
            data.randomise_pairs(conf.n_pairs - 1, seed=conf.seed)
        elif conf.automatedpairing:
            self._expand(data)
        return data

    def _load_unlabelled(self):
        """The unlabelled complement of the labelled volumes
        (executor.py:83-108)."""
        conf = self.conf
        if conf.l_mix == 1:
            return None
        ul = self._training_split()
        if conf.randomise:
            ul.randomise_pairs(length=conf.n_pairs - 1)
        elif conf.automatedpairing:
            self._expand(ul)
        if conf.l_mix > 0:
            num_lb = int(np.round(conf.l_mix * ul.num_volumes))
            np.random.seed(conf.seed)
            lb_vols = set(np.random.choice(ul.volumes(), size=num_lb, replace=False).tolist())
            ul.filter_volumes([v for v in ul.volumes() if v not in lb_vols])
        return ul

    def _disc_mask_pool(self):
        """Real masks of the mask discriminator (executor.py:110-118)."""
        masks = []
        if self.data is not None:
            masks += [self.data.get_masks_modi(0), self.data.get_masks_modi(1)]
        if self.ul_data is not None:
            masks.append(self.ul_data.get_masks_modi(0))
        return np.concatenate(masks, axis=0)

    def _disc_image_pool(self):
        """Per-modality images of the image discriminators and the fake
        pools: the full training split (executor.py:120-127)."""
        full = self._training_split()
        return full.get_images_modi(0), full.get_images_modi(1)

    def _with_pools(self, batch):
        dm1 = next(self.disc_masks)["m"]
        dm2 = next(self.disc_masks)["m"]
        batch.update(next(self.disc_images))
        batch["dm1"], batch["dm2"] = dm1, dm2
        return batch

    def assembled_batches(self):
        """Infinite iterator of one step's batches, with the paths that
        l_mix turns on. DAFNet: {'sup': ..., 'unsup': ...}, each with its
        own draws from both pools (executor.py:430-448). MMSDNet:
        {'sup': ..., 'unsup': ..., 'disc': {dm, dx1, dx2}}, the pools drawn
        once, for the one discriminator step (executor.py:519-530)."""
        conf = self.conf
        mmsdnet = conf.model == "mmsdnet"
        while True:
            out = {}
            if conf.l_mix > 0:
                out["sup"] = dict(next(self.gen_labelled))
            if conf.l_mix < 1:
                out["unsup"] = dict(next(self.gen_unlabelled))
            if mmsdnet:
                out["disc"] = {"dm": next(self.disc_masks)["m"], **next(self.disc_images)}
            else:
                for path in out:
                    self._with_pools(out[path])
            yield out


def expert_batches(conf, loader):
    """Infinite iterator of the supervised expert-pairing batches {x1, x2,
    m1, m2, dm1, dm2, dx1, dx2} of `loader`'s training split conf.split:
    the 'sup' part of the training executor's batch assembly. For l_mix < 1
    the unlabelled batches are drawn in between, as the executor draws
    them, and skipped."""
    if conf.l_mix == 0:
        raise ValueError("l_mix = 0 has no labelled volumes, so no supervised batches")
    for out in TrainingData(conf, loader).assembled_batches():
        yield out["sup"]
