"""What the benchmark takes from the program under test, the PyTorch port
`multimodal_segmentation_torch`: its configuration type, its models, train
state and steps, its host data layer (TrainingData, prefetch_to_device),
fed through its own Loader interface, and its kernel launch counters. The
benchmark makes the studies and the weights; the program gets them here.
"""

import dataclasses

import numpy as np
import torch

from multimodal_segmentation_torch import config as port_config
from multimodal_segmentation_torch.data.base_loader import Loader
from multimodal_segmentation_torch.data.batches import TrainingData
from multimodal_segmentation_torch.data.containers import MultimodalPairedData
from multimodal_segmentation_torch.data.prefetch import prefetch_to_device
from multimodal_segmentation_torch.models import MODELS
from multimodal_segmentation_torch.ops import cuda_kernels
from multimodal_segmentation_torch.train import create_train_state, make_steps

NESTED = {"anatomy_encoder": port_config.AnatomyEncoderConfig,
          "d_mask_params": port_config.DiscriminatorConfig,
          "d_image_params": port_config.DiscriminatorConfig}


def experiment_config(fields):
    """The program's ExperimentConfig holding the configuration file's
    `model` fields."""
    known = {f.name for f in dataclasses.fields(port_config.ExperimentConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError("configuration keys the program does not know: %s" % sorted(unknown))
    kw = {}
    for k, v in fields.items():
        if k in NESTED:
            v = NESTED[k](**v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return port_config.ExperimentConfig(**kw)


class StudyLoader(Loader):
    """The program's Loader interface over the benchmark's studies: one
    split whose training part is every study."""

    def __init__(self, images, masks, index, num_masks):
        super().__init__(sorted(set(index.tolist())))
        self.images, self.masks, self.index = images, masks, index
        self.num_masks = num_masks
        self.input_shape = images.shape[1:3] + (1,)
        self.modalities = ["t1", "t2"]

    def splits(self):
        return [{"training": list(self.volumes), "validation": [], "test": []}]

    def load_all_modalities_concatenated(self, split, split_type, downsample=1):
        return MultimodalPairedData(self.images, self.masks, self.index, downsample=downsample)


def build_model(conf, state, device):
    """conf.model of the program on `device`, holding the benchmark's
    weights `state` (no initialisation of its own), in eval mode."""
    with torch.device("meta"):
        model = MODELS[conf.model](conf)
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model.eval()


def train_setup(conf, state, studies, np_seed, device):
    """(model, train state, steps, the executor's batch iterator). The
    iterator is prefetch_to_device(TrainingData(conf, loader)
    .assembled_batches()), as the executor builds it; numpy's global
    generator is seeded first, since the data layer draws from it."""
    model = build_model(conf, state, device)
    ts = create_train_state(model, conf)
    steps = make_steps(model, conf)
    np.random.seed(np_seed)
    loader = StudyLoader(*studies, num_masks=conf.num_masks)
    batches = prefetch_to_device(TrainingData(conf, loader).assembled_batches(), device)
    return model, ts, steps, batches


def optimizers(model, ts):
    """{name: (optimizer, its parameters)} of the train state, named as the
    reference names them: 'gen', each discriminator, 'zreg'."""
    out = {"gen": (ts.opt_gen, model.component_parameters(model.GEN_COMPONENTS))}
    for name, opt in ts.opt_disc.items():
        out[name] = (opt, list(getattr(model, name).parameters()))
    if ts.opt_zreg is not None:
        out["zreg"] = (ts.opt_zreg, model.component_parameters(model.ZREG_COMPONENTS))
    return out


def launch_counts():
    return cuda_kernels.launch_counts()


def reset_launch_counts():
    cuda_kernels.reset_launch_counts()
