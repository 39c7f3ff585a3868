"""Test-time evaluation (reference model_tester.py:13-102).

Port of multimodal_segmentation_tpu/eval/tester.py: per modality x fusion
type {simple, def, max} x {expert-paired, randomised pairs}, per-volume
binarised Dice (overall and per organ) written to results.csv, and PNG
sample grids per volume (when PIL is installed). Volumes are zero-padded to
the split's longest, as in the JAX package, and the padding is stripped
before the Dice. `conf.eval_dtype` (e.g. 'bfloat16') runs inference at
that activation dtype; `conf.eval_warp` still decides the warp's blend.
"""

import dataclasses
import logging
import os

import numpy as np

from multimodal_segmentation_torch import losses
from multimodal_segmentation_torch.data.loader_factory import init_loader
from multimodal_segmentation_torch.models import build_model, full_f32_matmuls
from multimodal_segmentation_torch.models.base import resolve_device
from multimodal_segmentation_torch.utils.nan_checks import check_finite
from multimodal_segmentation_torch.utils.observability import save_image_grid

log = logging.getLogger("model_tester")


class ModelTester:
    def __init__(self, model, conf, device="cuda"):
        self.conf = conf
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            full_f32_matmuls()
        # eval_dtype: the predict model rebuilt at that activation dtype,
        # holding the same f32 parameters and statistics (each module casts
        # them to its compute dtype), as the JAX package's tester does
        if conf.eval_dtype and conf.eval_dtype != conf.compute_dtype:
            eval_model = build_model(dataclasses.replace(conf, compute_dtype=conf.eval_dtype),
                                     device=self.device)
            eval_model.load_state_dict(model.state_dict())
            model = eval_model
        self.model = model

    def run(self):
        for modi, mod in enumerate(self.model.modalities):
            log.info("Evaluating model on test data for %s", mod)
            self.test_modality(mod, modi)

    def _folder(self, modality, suffix=""):
        folder = os.path.join(
            self.conf.folder,
            "test_results_%s_%s_%s" % (self.conf.test_dataset, modality, suffix),
        )
        os.makedirs(folder, exist_ok=True)
        return folder

    def test_modality(self, modality, modality_index):
        conf = self.conf
        test_loader = init_loader(conf.test_dataset)
        test_loader.modalities = list(conf.modality)
        test_data = test_loader.load_all_modalities_concatenated(
            conf.split, "test", conf.image_downsample
        )
        test_data.crop(conf.input_hw)

        for t in ("simple", "def", "max"):
            self.test_modality_type(
                self._folder(modality, t), modality_index, t, test_loader, test_data
            )

        test_data.randomise_pairs(length=2, seed=conf.seed)
        for t in ("simple", "def", "max"):
            self.test_modality_type(
                self._folder(modality, t + "_rand"),
                modality_index,
                t,
                test_loader,
                test_data,
            )

    def test_modality_type(self, folder, modality_index, ftype, test_loader, test_data):
        conf = self.conf
        samples = os.path.join(folder, "samples")
        os.makedirs(samples, exist_ok=True)
        vols = test_data.volumes()
        max_len = max(
            test_data.get_volume_images_modi(0, v).shape[0] for v in vols
        )

        im_dice = {}
        with open(os.path.join(folder, "results.csv"), "w") as f:
            f.write(
                "Vol, Dice, "
                + ", ".join("Dice%d" % i for i in range(test_loader.num_masks))
                + "\n"
            )
            for v in vols:
                x1 = test_data.get_volume_images_modi(0, v)
                x2 = test_data.get_volume_images_modi(1, v)
                vol_mask = test_data.get_volume_masks_modi(modality_index, v)
                n = x1.shape[0]
                pad = max_len - n
                x1p = np.pad(x1, ((0, pad), (0, 0), (0, 0), (0, 0)))
                x2p = np.pad(x2, ((0, pad), (0, 0), (0, 0), (0, 0)))
                prd = self.model.predict_mask(
                    modality_index, ftype, [x1p, x2p], device=self.device
                )
                if conf.debug_nans:
                    check_finite(prd, "the %s prediction of volume %s" % (ftype, v))
                prd = prd.cpu().numpy()[:n]

                im_dice[v] = losses.dice_np(vol_mask, prd, binarise=True)
                sep = [
                    losses.dice_np(
                        vol_mask[..., i : i + 1], prd[..., i : i + 1], binarise=True
                    )
                    for i in range(test_loader.num_masks)
                ]
                f.write(
                    "%s, %.3f, " % (v, im_dice[v])
                    + ", ".join("%.3f" % s for s in sep)
                    + "\n"
                )
                self._plot(samples, v, modality_index, prd, vol_mask, [x1, x2])

        print("%s - Dice score: %.3f" % (ftype, np.mean(list(im_dice.values()))))
        return im_dice

    def _plot(self, samples, vol, modality_index, prd_mask, vol_mask, image_list):
        """Per-slice grids: prediction row over ground-truth row
        (model_tester.py:87-102)."""
        vol_folder = os.path.join(samples, "vol_%s" % vol)
        os.makedirs(vol_folder, exist_ok=True)
        img = image_list[modality_index]
        for i in range(img.shape[0]):
            row1 = [img[i, :, :, 0]] + [prd_mask[i, :, :, j] for j in range(vol_mask.shape[-1])]
            row2 = [img[i, :, :, 0]] + [vol_mask[i, :, :, j] for j in range(vol_mask.shape[-1])]
            save_image_grid(os.path.join(vol_folder, "test_vol%s_im%d.png" % (vol, i)),
                            [row1, row2])
