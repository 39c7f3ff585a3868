"""Checkpoint / resume, and the per-component .npz weight export.

Port of multimodal_segmentation_tpu/utils/checkpoint.py:26-108. One
torch.save file per epoch under <folder>/checkpoints/, the newest
MAX_TO_KEEP kept, each written under a temporary name and then renamed,
so a file that exists is whole. A file holds the whole train state: the
model's state_dict (parameters, BatchNorm statistics, spectral `u`), the
SWA average, the state_dict of every optimizer (MMSDNet's Z-regressor
Adam among them), the state of the step noise's generator, and the step
and epoch counts. It is not an orbax
checkpoint, and the JAX package cannot read it.

The component export writes <folder>/<component>.npz with the component's
parameters in the JAX package's layout (Flax paths joined by '/', HWIO
conv kernels, (in, out) dense kernels), so either package reads the
other's files.

Under tensor parallelism (parallel/sharding.py) both hold whole tensors:
`state_of` gathers the sharded parameters, their Adam moments and SWA
copies (a collective: every rank calls it, and the writer passes the
result to `save`), and `restore` cuts each whole tensor to this rank's
part. So a checkpoint saved on a mesh resumes in one process, and one
saved in one process resumes on a mesh.
"""

import logging
import os
import re

import numpy as np
import torch

from multimodal_segmentation_torch.parallel.sharding import (
    local_optimizer_state,
    local_part,
    whole_named,
    whole_optimizer_state,
)
from multimodal_segmentation_torch.utils.convert import (
    component_state_dict,
    flax_paths,
    from_flax_paths,
    params_by_component,
)

log = logging.getLogger("checkpoint")

_NAME = re.compile(r"^epoch_(\d+)\.pt$")
MAX_TO_KEEP = 3


class CheckpointManager:
    def __init__(self, folder):
        self.directory = os.path.abspath(os.path.join(folder, "checkpoints"))
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch):
        return os.path.join(self.directory, "epoch_%d.pt" % epoch)

    def epochs(self):
        """The epochs that have a checkpoint, oldest first."""
        found = (_NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_epoch(self):
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    @staticmethod
    def state_of(ts):
        """What a checkpoint of `ts` holds, every sharded leaf whole: the
        model's state_dict, the SWA average, the state_dict of every
        optimizer, the step noise generator's state, the step and epoch
        counts. Under tensor parallelism a collective."""
        model = ts.model
        return {
            "model": whole_named(model, model.state_dict()),
            "swa": whole_named(model, ts.swa),
            "opt_gen": whole_optimizer_state(ts.opt_gen),
            "opt_disc": {n: whole_optimizer_state(o) for n, o in ts.opt_disc.items()},
            "opt_zreg": None if ts.opt_zreg is None else whole_optimizer_state(ts.opt_zreg),
            "generator": ts.generator.get_state(),
            "step": ts.step,
            "epoch": ts.epoch,
        }

    def save(self, epoch, ts, state=None):
        """Write `ts` as the checkpoint of `epoch`, from `state` (state_of
        its train state, which the caller gathered on every rank) or, by
        default, state_of(ts); returns its path."""
        if state is None:
            state = self.state_of(ts)
        path = self._path(epoch)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.epochs()[:-MAX_TO_KEEP]:
            os.remove(self._path(old))
        return path

    def restore(self, epoch, ts):
        """Load the checkpoint of `epoch` into `ts`: into its model, its SWA
        tensors and the optimizers it already holds (their parameter order
        is the one they were saved with), so nothing is rebound; a sharded
        leaf takes this rank's part of the whole."""
        state = torch.load(self._path(epoch), map_location="cpu", weights_only=True)
        params = dict(ts.model.named_parameters())

        def local(named):
            return {n: local_part(t, params[n]) if n in params else t for n, t in named.items()}
        ts.model.load_state_dict(local(state["model"]))
        swa = local(state["swa"])
        with torch.no_grad():
            for n, t in ts.swa.items():
                t.copy_(swa[n])
        ts.opt_gen.load_state_dict(local_optimizer_state(ts.opt_gen, state["opt_gen"]))
        for n, opt in ts.opt_disc.items():
            opt.load_state_dict(local_optimizer_state(opt, state["opt_disc"][n]))
        if (ts.opt_zreg is None) != (state.get("opt_zreg") is None):
            raise ValueError("%s: the checkpoint's Z-regressor Adam does not match the "
                             "train state's" % self._path(epoch))
        if ts.opt_zreg is not None:
            ts.opt_zreg.load_state_dict(local_optimizer_state(ts.opt_zreg, state["opt_zreg"]))
        ts.generator.set_state(state["generator"])
        ts.step = state["step"]
        ts.epoch = state["epoch"]
        return ts

    def save_component_weights(self, folder, params):
        """Write <folder>/<component>.npz for every component in `params`
        ({'<component>.<torch key>': whole tensors, such as a TrainState's
        swa, through sharding.whole_named under tensor parallelism}), in
        the JAX key layout (dafnet_executor.py:292-301)."""
        os.makedirs(folder, exist_ok=True)
        for name, tree in params_by_component(params).items():
            np.savez_compressed(os.path.join(folder, "%s.npz" % name), **flax_paths(tree))

    def load_component_weights(self, folder, model):
        """Inverse of save_component_weights, into `model`'s parameters in
        place: every top-level module of `model` that has a file; the others
        are left as they are, as the reference loads each sub-model on its
        own (models/dafnet.py:54-73). A file must hold exactly the
        component's parameters, with their shapes.

        Returns the names of the components loaded.
        """
        loaded = []
        for name, _ in model.named_children():
            path = os.path.join(folder, "%s.npz" % name)
            if not os.path.exists(path):
                continue
            with np.load(path) as saved:
                sd = component_state_dict(from_flax_paths(dict(saved)))
            params = dict(getattr(model, name).named_parameters())
            if sorted(sd) != sorted(params):
                raise KeyError("%s: arrays %s do not match the component's parameters %s"
                               % (path, sorted(sd), sorted(params)))
            for k, p in params.items():
                if tuple(sd[k].shape) != tuple(p.shape):
                    raise ValueError("%s: %r shape %s does not match model shape %s"
                                     % (path, k, tuple(sd[k].shape), tuple(p.shape)))
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(sd[k])
            loaded.append(name)
        if loaded:
            log.info("Loaded component weights: %s", ", ".join(loaded))
        return loaded
