"""In-memory dataset containers (numpy).

The port's own copy of multimodal_segmentation_tpu/data/containers.py:
behavioural equivalents of the reference's loaders/data.py (Data) and
loaders/MultimodalPairedData.py (paired T1/T2 container), including
volume-level selection (the basis of the l_mix labelled/unlabelled split),
pair expansion for automated pairing, and pair randomisation.
"""

import logging

import numpy as np

log = logging.getLogger("containers")


# ---------------------------------------------------------------- utilities

def rescale(array, min_value=-1.0, max_value=1.0):
    """Rescale to [min, max] (utils/data_utils.py:7-20)."""
    if array.max() == array.min():
        return (array * 0) + min_value
    return (max_value - min_value) * (array - float(array.min())) / (
        array.max() - array.min()
    ) + min_value


def normalise_iqr(image):
    """Median / inter-quartile normalisation (utils/data_utils.py:22-34)."""
    m = np.percentile(image, 50)
    s = np.percentile(image, 75) - np.percentile(image, 25)
    out = (image - m) / (s + 1e-12)
    assert not np.any(np.isnan(out))
    return out


def _crop_dim(x, dim, target, mode="equal"):
    diff = x.shape[dim] - target
    l = int(np.ceil(diff / 2))
    r = x.shape[dim] - l
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(l, r)
    return x[tuple(sl)]


def _pad_dim(x, dim, target, pad_mode="edge"):
    diff = target - x.shape[dim]
    l = int(diff / 2)
    r = diff - l
    pad = [(0, 0)] * x.ndim
    pad[dim] = (l, r)
    if pad_mode == "edge":
        return np.pad(x, pad, "edge")
    return np.pad(x, pad, "constant", constant_values=np.min(x))


def crop_same(image_list, mask_list, size=(None, None), pad_mode="edge"):
    """Crop/pad image and mask lists to a common (H, W)
    (utils/data_utils.py:37-79)."""
    h = (
        np.min([m.shape[1] for m in mask_list]) if size[0] is None else size[0]
    )
    w = (
        np.min([m.shape[2] for m in mask_list]) if size[1] is None else size[1]
    )
    imgs, msks = [], []
    for im, m in zip(image_list, mask_list):
        for dim, target in ((1, h), (2, w)):
            if m.shape[dim] > target:
                m = _crop_dim(m, dim, target)
            if im.shape[dim] > target:
                im = _crop_dim(im, dim, target)
            if m.shape[dim] < target:
                m = _pad_dim(m, dim, target, pad_mode)
            if im.shape[dim] < target:
                im = _pad_dim(im, dim, target, pad_mode)
        imgs.append(im)
        msks.append(m)
    return imgs, msks


def block_mean_downsample(x, ratio):
    """Mean-pool spatial downsample (replaces skimage block_reduce,
    loaders/data.py:156-162)."""
    if ratio == 1:
        return x
    n, h, w, c = x.shape
    h2, w2 = h // ratio, w // ratio
    x = x[:, : h2 * ratio, : w2 * ratio, :]
    return x.reshape(n, h2, ratio, w2, ratio, c).mean(axis=(2, 4))


def sample_array(data, nb_samples, rng=None):
    """Random subsample without replacement (utils/data_utils.py:125-129)."""
    rng = rng or np.random
    idx = rng.choice(len(data), size=nb_samples, replace=False)
    return np.array([data[i] for i in idx])


# ---------------------------------------------------------------- Data

class Data:
    """Single-modality dataset with volume indexing (loaders/data.py:13)."""

    def __init__(self, images, masks, index, downsample=1):
        assert images.shape[:-1] == masks.shape[:-1]
        assert images.shape[0] == index.shape[0]
        self.images = block_mean_downsample(images, downsample)
        self.masks = block_mean_downsample(masks, downsample)
        self.index = index
        self.image_shape = self.images.shape[1:]
        self.mask_shape = self.masks.shape[1:]
        self.num_volumes = len(self.volumes())

    def volumes(self):
        return sorted(set(self.index.tolist()))

    def get_images(self, vol):
        return self.images[self.index == vol]

    def get_masks(self, vol):
        return self.masks[self.index == vol]

    def size(self):
        return len(self.images)

    def crop(self, shape):
        [im], [m] = crop_same(
            [self.images], [self.masks], size=shape, pad_mode="constant"
        )
        self.images, self.masks = im, m

    def shuffle(self, seed=None):
        rng = np.random.RandomState(seed)
        idx = rng.permutation(self.images.shape[0])
        self.images = self.images[idx]
        self.masks = self.masks[idx]
        self.index = self.index[idx]

    def get_sample_volumes(self, num, seed=-1):
        """Volume-level sampling (loaders/data.py:120-127)."""
        if seed > -1:
            np.random.seed(seed)
        return np.random.choice(self.volumes(), size=num, replace=False)

    def sample(self, num, seed=-1):
        """Keep a random subset of volumes (loaders/data.py:131-137) —
        this is what the l_mix labelled fraction selects."""
        if num == self.num_volumes:
            return
        self.filter_volumes(self.get_sample_volumes(num, seed))

    def filter_volumes(self, volumes):
        if len(volumes) == 0:
            self.images = np.zeros((0,) + self.images.shape[1:])
            self.masks = np.zeros((0,) + self.masks.shape[1:])
            self.index = np.zeros((0,))
            self.num_volumes = 0
            return
        self.images = np.concatenate([self.get_images(v) for v in volumes], axis=0)
        self.masks = np.concatenate([self.get_masks(v) for v in volumes], axis=0)
        self.index = np.concatenate(
            [self.index[self.index == v] for v in volumes], axis=0
        )
        self.num_volumes = len(volumes)

    def merge(self, other):
        self.images = np.concatenate([self.images, other.images], axis=0)
        self.masks = np.concatenate([self.masks, other.masks], axis=0)
        self.index = np.concatenate([self.index, other.index], axis=0)
        self.num_volumes = len(self.volumes())


# ------------------------------------------------- MultimodalPairedData

class MultimodalPairedData(Data):
    """Paired T1/T2 container (loaders/MultimodalPairedData.py:8).

    Construction concatenates the two modalities channel-wise; internally
    images/masks are kept per modality.
    """

    def __init__(self, images, masks, index, downsample=1):
        super().__init__(images, masks, index, downsample)
        self.num_modalities = self.images.shape[-1]
        self.masks_per_mod = self.masks.shape[-1] // 2
        self.image_dict = {
            0: self.images[..., 0:1],
            1: self.images[..., 1:2],
        }
        self.masks_dict = {
            0: self.masks[..., 0 : self.masks_per_mod],
            1: self.masks[..., self.masks_per_mod :],
        }
        del self.images
        del self.masks

    def get_images_modi(self, i):
        return self.image_dict[i]

    def get_masks_modi(self, i):
        return self.masks_dict[i]

    def set_images_modi(self, i, images):
        self.image_dict[i] = images

    def set_masks_modi(self, i, masks):
        self.masks_dict[i] = masks

    def get_volume_images_modi(self, i, vol):
        return self.image_dict[i][self.index == vol]

    def get_volume_masks_modi(self, i, vol):
        return self.masks_dict[i][self.index == vol]

    def size(self):
        return int(
            np.max(
                [self.image_dict[i].shape[0] for i in range(self.num_modalities)]
            )
        )

    def crop(self, shape):
        for i in range(self.num_modalities):
            [im], [m] = crop_same(
                [self.image_dict[i]],
                [self.masks_dict[i]],
                size=shape,
                pad_mode="constant",
            )
            self.image_dict[i], self.masks_dict[i] = im, m

    def filter_volumes(self, volumes):
        if len(volumes) == 0:
            for i in range(self.num_modalities):
                self.image_dict[i] = np.zeros((0,) + self.image_shape)
                self.masks_dict[i] = np.zeros((0,) + self.mask_shape)
            self.index = np.zeros((0,))
            self.num_volumes = 0
            return
        for i in range(self.num_modalities):
            self.image_dict[i] = np.concatenate(
                [self.get_volume_images_modi(i, v) for v in volumes], axis=0
            )
            self.masks_dict[i] = np.concatenate(
                [self.get_volume_masks_modi(i, v) for v in volumes], axis=0
            )
        self.index = np.concatenate(
            [self.index[self.index == v] for v in volumes], axis=0
        )
        self.num_volumes = len(volumes)

    def expand_pairs(self, offsets, mod_i, neighborhood=2):
        """Stack neighbour slices channel-wise as pairing candidates, the
        expert pair first (loaders/MultimodalPairedData.py:91-141)."""
        all_images = []
        for vol in self.volumes():
            img_mod1 = self.get_volume_images_modi(mod_i, vol)
            img_mod2 = self.get_volume_images_modi(1 - mod_i, vol)
            num_images = img_mod2.shape[0]
            vol_imgs = []
            for i in range(num_images):
                if img_mod1.shape[0] < 2 * offsets + 1:
                    value_range = list(range(0, img_mod1.shape[0])) + [0] * (
                        2 * offsets + 1 - img_mod1.shape[0]
                    )
                elif i < offsets:
                    value_range = list(range(0, 2 * offsets + 1))
                elif i + offsets >= num_images:
                    value_range = list(
                        range(num_images - (2 * offsets + 1), num_images)
                    )
                else:
                    value_range = list(range(i - offsets, i + offsets + 1))
                value_range.insert(0, value_range.pop(value_range.index(i)))
                if len(value_range) > neighborhood:
                    value_range = [value_range[0]] + list(
                        np.random.choice(
                            value_range[1:], size=neighborhood - 1, replace=False
                        )
                    )
                vol_imgs.append(
                    np.concatenate(
                        [img_mod1[j : j + 1] for j in value_range], axis=-1
                    )
                )
            all_images.append(np.concatenate(vol_imgs, axis=0))
        self.set_images_modi(mod_i, np.concatenate(all_images, axis=0))

    def randomise_pairs(self, length=3, seed=None):
        """Break expert pairing by shifting modality-0 slices within a
        volume (loaders/MultimodalPairedData.py:143-167)."""
        if seed is not None:
            np.random.seed(seed)
        new_images, new_masks = [], []
        for vol in self.volumes():
            images = self.get_volume_images_modi(0, vol)
            masks = self.get_volume_masks_modi(0, vol)
            n = images.shape[0]
            offsets = np.random.randint(-length, length, size=n)
            for off in range(min(length, n)):
                if offsets[off] + off < 0:
                    offsets[off] = np.random.randint(-off, length, size=1)[0]
            for i in range(1, min(length, n)):
                if offsets[-i] + (n - i) >= n:
                    offsets[-i] = np.random.randint(-length, i, size=1)[0]
            new_pair_index = np.clip(np.arange(n) + offsets, 0, n - 1)
            new_images.append(images[new_pair_index])
            new_masks.append(masks[new_pair_index])
        self.set_images_modi(0, np.concatenate(new_images, axis=0))
        self.set_masks_modi(0, np.concatenate(new_masks, axis=0))

    def merge(self, other):
        for i in range(self.num_modalities):
            self.image_dict[i] = np.concatenate(
                [self.image_dict[i], other.image_dict[i]], axis=0
            )
            self.masks_dict[i] = np.concatenate(
                [self.masks_dict[i], other.masks_dict[i]], axis=0
            )
        self.index = np.concatenate([self.index, other.index], axis=0)
        self.num_volumes = len(self.volumes())
