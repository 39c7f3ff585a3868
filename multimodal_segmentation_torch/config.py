"""Typed experiment configuration with the reference's presets.

The port's own copy of multimodal_segmentation_tpu/config.py:14-233: the
same dataclasses, field names, defaults and presets, so a configuration
serialises identically in both packages (dataclasses.asdict).
"""

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass
class AnatomyEncoderConfig:
    """configuration/*_config_chaos.py anatomy_encoder_params."""

    normalise: str = "batch"   # 'batch' | 'instance' | 'none'
    downsample: int = 4
    filters: int = 64
    out_channels: int = 8
    rounding: bool = True


@dataclasses.dataclass
class DiscriminatorConfig:
    """configuration/*_config_chaos.py d_mask_params / d_image_params."""

    filters: int = 64
    lr: float = 1e-4
    downsample_blocks: int = 3
    spectral_alpha: float = 10.0


@dataclasses.dataclass
class ExperimentConfig:
    """Top-level config (configuration/dafnet_config_chaos.py:3-28)."""

    seed: int = 10
    folder: str = "dafnet_chaos"
    epochs: int = 500
    batch_size: int = 6
    split: int = 0
    dataset_name: str = "chaos"
    test_dataset: str = "chaos"
    input_shape: Tuple[int, int, int] = (192, 192, 1)
    image_downsample: int = 1
    modality: Tuple[str, str] = ("t1", "t2")
    model: str = "dafnet"            # 'mmsdnet' | 'dafnet'
    executor: str = "dafnet"
    l_mix: float = 1.0
    decoder_type: str = "film"       # 'film' | 'spade'
    num_z: int = 8
    num_masks: int = 4
    n_pairs: int = 3
    w_sup_M: float = 10.0
    w_adv_M: float = 1.0
    w_rec_X: float = 1.0
    w_adv_X: float = 1.0
    w_rec_Z: float = 1.0
    w_kl: float = 0.1
    lr: float = 1e-4
    randomise: bool = False
    automatedpairing: bool = False
    # SWA starts averaging at this epoch (model_executors/dafnet_executor.py:45)
    swa_start_epoch: int = 40
    # Early stopping (dafnet_executor.py:222): monitor val_loss_mod2_fused
    es_patience: int = 60
    es_min_delta: float = 0.01
    # Augmentation (base_executor.py:103-110)
    rotation_range: float = 20.0
    # Activation dtype of the compute path; params stay f32.
    compute_dtype: str = "float32"
    # Kept so the configuration serialises like the JAX package's. The port
    # does not read it: the device picks the warp implementation (the CUDA
    # kernel for a tensor on the GPU, the plain PyTorch version on the CPU).
    tps_impl: str = "auto"
    # Inference ('def'/'max' fusion) warp precision: 'bf16' warps a bf16
    # copy of the anatomy on the GPU (the anatomy is {0,1} after rounding,
    # so the cast is exact; the kernel blends in f32); 'f32' warps in f32.
    eval_warp: str = "bf16"
    # Inference activation dtype. Empty = same as compute_dtype.
    eval_dtype: str = ""
    # Training-step options. fused_adam: each optimizer updates all its
    # parameters in one fused call (train/state.py::adam); remat_convs: the
    # UNet blocks and the segmentor recompute their activations in the
    # backward (nn/blocks.py::remat), lowering peak memory.
    fused_adam: bool = False
    remat_convs: bool = False
    steps_per_epoch: int = 0
    profile_epochs: Tuple[int, int] = (0, 0)   # (start, end), end=0 disables
    debug_nans: bool = False
    image_callback_interval: int = 1
    component_save_interval: int = 1
    checkpoint_interval: int = 1
    # Volumetric path: (D, H, W, sequences) per study and the 3-D UNet
    # width/depth. Unused by the 2-D CHAOS presets.
    volume_shape: Tuple[int, int, int, int] = (16, 128, 128, 3)
    filters3d: int = 16
    downsample3d: int = 3

    anatomy_encoder: AnatomyEncoderConfig = dataclasses.field(
        default_factory=AnatomyEncoderConfig
    )
    d_mask_params: DiscriminatorConfig = dataclasses.field(
        default_factory=DiscriminatorConfig
    )
    d_image_params: DiscriminatorConfig = dataclasses.field(
        default_factory=DiscriminatorConfig
    )

    @property
    def input_hw(self):
        h, w, _ = self.input_shape
        r = self.image_downsample
        return (int(h / r), int(w / r))

    def to_json(self):
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def mmsdnet_chaos() -> ExperimentConfig:
    """configuration/mmsdnet_config_chaos.py (w_rec_X=10, D_Mask filters=4)."""
    return ExperimentConfig(
        folder="mmsdnet_chaos",
        model="mmsdnet",
        executor="mmsdnet",
        w_rec_X=10.0,
        d_mask_params=DiscriminatorConfig(filters=4),
    )


def dafnet_chaos() -> ExperimentConfig:
    """configuration/dafnet_config_chaos.py."""
    return ExperimentConfig(folder="dafnet_chaos", model="dafnet", executor="dafnet")


def dafnet_spade_chaos() -> ExperimentConfig:
    """configuration/dafnet_spade_config_chaos.py (SPADE decoder)."""
    return ExperimentConfig(
        folder="dafnet_spade_chaos",
        model="dafnet",
        executor="dafnet",
        decoder_type="spade",
    )


def cardiac_3d() -> ExperimentConfig:
    """Multi-sequence cardiac 3-D volumes (16, 128, 128, 3): LGE, bSSFP, T2."""
    return ExperimentConfig(
        folder="cardiac_3d",
        model="cardiac3d",
        executor="cardiac3d",
        dataset_name="cardiac",
        test_dataset="cardiac",
        modality=("lge", "bssfp", "t2"),
        batch_size=2,
        epochs=100,
        num_masks=3,
        input_shape=(128, 128, 3),
        volume_shape=(16, 128, 128, 3),
        filters3d=16,
        downsample3d=3,
        rotation_range=15.0,
    )


def unet3d_cicek() -> ExperimentConfig:
    """The 3D U-Net of Cicek et al. (arXiv:1606.06650, section 2 and Fig.
    1) at its published widths, served by overlap-tile
    (models/volumetric.py, model 'unet3d'): 132 x 132 x 116 input tiles
    of 3 channels (volume_shape as (D, H, W, C)), 44 x 44 x 28 output
    tiles of 3 classes (num_masks + the background), base width 32, 3
    pooling levels, 16 tiles a forward (batch_size), bf16 activations.
    Not a preset: the JAX package has no such model, and PRESETS keeps
    the JAX package's."""
    return ExperimentConfig(
        folder="unet3d_cicek",
        model="unet3d",
        executor="cardiac3d",
        dataset_name="cardiac",
        test_dataset="cardiac",
        batch_size=16,
        num_masks=2,
        input_shape=(132, 132, 3),
        volume_shape=(116, 132, 132, 3),
        filters3d=32,
        downsample3d=3,
        compute_dtype="bfloat16",
    )


# the swin_unetr model's sliding-window overlap (models/volumetric.py):
# Swin UNETR's BraTS inference, 0.5 (MONAI's default is 0.25)
SWIN_UNETR_OVERLAP = 0.5


def swin_unetr_brats() -> ExperimentConfig:
    """Swin UNETR (arXiv:2201.01266) at its published BraTS 2021 widths,
    served by MONAI's sliding window (models/volumetric.py, model
    'swin_unetr', overlap SWIN_UNETR_OVERLAP): 128^3 windows of 4 MRI
    sequences (volume_shape as (D, H, W, C)), feature size 48 (filters3d),
    depths 2-2-2-2, heads 3-6-12-24, window 7^3 (nn/swin_unetr.py), 3
    sigmoid outputs (num_masks: TC, WT, ET), 4 windows a forward
    (batch_size), bf16 activations. Not a preset, as unet3d_cicek."""
    return ExperimentConfig(
        folder="swin_unetr_brats",
        model="swin_unetr",
        executor="cardiac3d",
        dataset_name="brats",
        test_dataset="brats",
        batch_size=4,
        num_masks=3,
        input_shape=(128, 128, 4),
        volume_shape=(128, 128, 128, 4),
        filters3d=48,
        compute_dtype="bfloat16",
    )


PRESETS = {
    "mmsdnet_config_chaos": mmsdnet_chaos,
    "dafnet_config_chaos": dafnet_chaos,
    "dafnet_spade_config_chaos": dafnet_spade_chaos,
    "cardiac_3d_config": cardiac_3d,
    # short aliases
    "mmsdnet_chaos": mmsdnet_chaos,
    "dafnet_chaos": dafnet_chaos,
    "dafnet_spade_chaos": dafnet_spade_chaos,
    "cardiac_3d": cardiac_3d,
}


def get_config(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise ValueError(
            "Unknown config '%s'; available: %s" % (name, sorted(PRESETS))
        )
    return PRESETS[name]()


def tiny_test_config(model: str = "dafnet", decoder_type: str = "film") -> ExperimentConfig:
    """A miniature config for fast unit tests (32x32 inputs, thin nets)."""
    return ExperimentConfig(
        folder="tiny",
        model=model,
        executor=model,
        input_shape=(32, 32, 1),
        batch_size=2,
        decoder_type=decoder_type,
        anatomy_encoder=AnatomyEncoderConfig(downsample=2, filters=4),
        d_mask_params=DiscriminatorConfig(filters=4, downsample_blocks=2),
        d_image_params=DiscriminatorConfig(filters=4, downsample_blocks=2),
    )
