"""The training batches of a step, worked out again from the raw studies.

A frozen copy of the port's data/batches.py (BatchStream, TrainingData's
l_mix split, automated pairing's candidate neighbours, the real-mask pool
and the image pool) and of the parts of data/containers.py it calls, in
numpy. Given the same studies, the same conf.seed and the same state of
numpy's global generator (which the neighbour draw and the volume sample
read), it yields the same batches as the program's assembly.
"""

import numpy as np


class BatchStream:
    """Infinite shuffled batches over equal-length arrays; a fresh shuffle
    from RandomState(seed) at each pass, batches always full."""

    def __init__(self, arrays, batch_size, seed):
        self.arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
        self.n = len(next(iter(self.arrays.values())))
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self._order = np.arange(self.n)
        self._pos = self.n

    def __next__(self):
        idx, need = [], self.batch_size
        while need > 0:
            if self._pos >= self.n:
                self.rng.shuffle(self._order)
                self._pos = 0
            take = min(need, self.n - self._pos)
            idx.append(self._order[self._pos:self._pos + take])
            self._pos += take
            need -= take
        idx = np.concatenate(idx)
        return {k: v[idx] for k, v in self.arrays.items()}


class Paired:
    """Both modalities' images and masks of a split, with volume ids."""

    def __init__(self, images, masks, index):
        nm = masks.shape[-1] // 2
        self.images = {0: images[..., 0:1], 1: images[..., 1:2]}
        self.masks = {0: masks[..., :nm], 1: masks[..., nm:]}
        self.index = index

    def volumes(self):
        return sorted(set(self.index.tolist()))

    def filter_volumes(self, volumes):
        sel = np.concatenate([np.nonzero(self.index == v)[0] for v in volumes])
        for i in (0, 1):
            self.images[i] = self.images[i][sel]
            self.masks[i] = self.masks[i][sel]
        self.index = self.index[sel]

    def sample(self, num, seed):
        """Keep `num` volumes drawn by numpy's global generator, seeded."""
        if num == len(self.volumes()):
            return
        np.random.seed(seed)
        self.filter_volumes(np.random.choice(self.volumes(), size=num, replace=False))

    def expand_pairs(self, offsets, mod_i, neighborhood):
        """Stack each slice's candidate neighbours along channels, the
        expert pair first; the others drawn by numpy's global generator."""
        out = []
        for vol in self.volumes():
            img = self.images[mod_i][self.index == vol]
            n = self.images[1 - mod_i][self.index == vol].shape[0]
            rows = []
            for i in range(n):
                if img.shape[0] < 2 * offsets + 1:
                    rng = list(range(0, img.shape[0])) + [0] * (2 * offsets + 1 - img.shape[0])
                elif i < offsets:
                    rng = list(range(0, 2 * offsets + 1))
                elif i + offsets >= n:
                    rng = list(range(n - (2 * offsets + 1), n))
                else:
                    rng = list(range(i - offsets, i + offsets + 1))
                rng.insert(0, rng.pop(rng.index(i)))
                if len(rng) > neighborhood:
                    rng = [rng[0]] + list(np.random.choice(rng[1:], size=neighborhood - 1,
                                                           replace=False))
                rows.append(np.concatenate([img[j:j + 1] for j in rng], axis=-1))
            out.append(np.concatenate(rows, axis=0))
        self.images[mod_i] = np.concatenate(out, axis=0)


def training_batches(conf, split):
    """Infinite iterator of a step's batches {'sup': ..., 'unsup': ...,
    'disc': ...}, as the program's TrainingData.assembled_batches yields
    them. `split()` returns a fresh Paired of the training studies."""
    if conf.randomise:
        raise ValueError("the reference does not randomise pairs")
    x1k, x2k = ("x1_pairs", "x2_pairs") if conf.automatedpairing else ("x1", "x2")

    def expand(d):
        if conf.automatedpairing:
            d.expand_pairs(conf.n_pairs - 1, 0, conf.n_pairs)
            d.expand_pairs(conf.n_pairs - 1, 1, conf.n_pairs)

    data = ul = None
    if conf.l_mix > 0:
        data = split()
        data.sample(int(np.round(conf.l_mix * len(data.volumes()))), conf.seed)
        expand(data)
    if conf.l_mix < 1:
        ul = split()
        expand(ul)
        if conf.l_mix > 0:
            num_lb = int(np.round(conf.l_mix * len(ul.volumes())))
            np.random.seed(conf.seed)
            lb = set(np.random.choice(ul.volumes(), size=num_lb, replace=False).tolist())
            ul.filter_volumes([v for v in ul.volumes() if v not in lb])
    streams = {}
    if data is not None:
        streams["sup"] = BatchStream({x1k: data.images[0], x2k: data.images[1],
                                      "m1": data.masks[0], "m2": data.masks[1]},
                                     conf.batch_size, conf.seed)
    if ul is not None:
        streams["unsup"] = BatchStream({x1k: ul.images[0], x2k: ul.images[1], "m1": ul.masks[0]},
                                       conf.batch_size, conf.seed + 1)
    pool = [data.masks[0], data.masks[1]] if data is not None else []
    if ul is not None:
        pool.append(ul.masks[0])
    masks = BatchStream({"m": np.concatenate(pool, axis=0)}, conf.batch_size, conf.seed + 2)
    full = split()
    images = BatchStream({"dx1": full.images[0], "dx2": full.images[1]}, conf.batch_size,
                         conf.seed + 3)
    while True:
        out = {path: dict(next(s)) for path, s in streams.items()}
        if conf.model == "mmsdnet":
            out["disc"] = {"dm": next(masks)["m"], **next(images)}
        else:
            for path in out:
                dm1, dm2 = next(masks)["m"], next(masks)["m"]
                out[path].update(next(images))
                out[path]["dm1"], out[path]["dm2"] = dm1, dm2
        yield out
