"""Observability: the loss CSV and plots, and qualitative image grids.

Port of multimodal_segmentation_tpu/utils/observability.py:19-365, same
artifacts (reference callbacks/loss_callback.py:27-55,
callbacks/dafnet_image_callback.py): <folder>/training.csv,
training_loss.png and training_discr_loss.png; training_images/ grids of
segmentations, anatomy channels, reconstructions and discriminator outputs
with the z_means_* / z_vars_* CSVs; training/ epoch grids. The PNGs need
matplotlib or PIL; where one is missing its PNGs are skipped, as in the
JAX package, and the log says so once. The CSVs are always written.

The callback calls the model's components directly (NCHW inside, NHWC at
predict_mask). The JAX noise keys PRNGKey(k) become torch.Generators
seeded with k; the draws differ from JAX's.
"""

import csv
import functools
import importlib
import logging
import os

import numpy as np
import torch

from multimodal_segmentation_torch.ops.augment import random_brightness_contrast

log = logging.getLogger("observability")


@functools.lru_cache(maxsize=None)
def _optional(name):
    """The module `name`, or None (logged once) when it is not installed."""
    try:
        return importlib.import_module(name)
    except ImportError:
        log.warning("%s is not installed: its PNGs are skipped", name.split(".")[0])
        return None


def _pyplot():
    matplotlib = _optional("matplotlib")
    if matplotlib is None:
        return None
    matplotlib.use("Agg")
    return _optional("matplotlib.pyplot")


class LossLogger:
    """CSV + matplotlib loss curves (SaveLoss + CSVLogger parity)."""

    def __init__(self, folder):
        self.folder = folder
        os.makedirs(folder, exist_ok=True)
        self.csv_path = os.path.join(folder, "training.csv")
        self.values = {}

    def on_epoch_end(self, epoch, logs):
        for k, v in logs.items():
            self.values.setdefault(k, []).append(float(v))

        keys = sorted(logs.keys())
        write_header = not os.path.exists(self.csv_path)
        with open(self.csv_path, "a", newline="") as f:
            w = csv.writer(f)
            if write_header:
                w.writerow(["epoch"] + keys)
            w.writerow([epoch] + ["%.6f" % float(logs[k]) for k in keys])

        self._plot()

    def _plot(self):
        plt = _pyplot()
        if plt is None:
            return
        # generator losses, then the adversarial and discriminator ones
        # (loss_callback.py:27-54)
        for adversarial, name in ((False, "training_loss.png"), (True, "training_discr_loss.png")):
            plt.figure()
            plt.suptitle("Training loss", fontsize=16)
            for k, vals in self.values.items():
                if ("dis" in k or "adv" in k) == adversarial:
                    plt.plot(range(len(vals)), vals, label=k)
            plt.xlabel("Epochs")
            plt.ylabel("Loss")
            plt.legend(loc="best", fontsize=6)
            plt.savefig(os.path.join(self.folder, name))
            plt.close()


def _to_img(x):
    x = np.asarray(x, np.float32)
    lo, hi = x.min(), x.max()
    if hi - lo < 1e-8:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def save_image_grid(path, rows):
    """Save a grid of 2-D arrays: rows = list of lists of (H, W) images."""
    pil = _optional("PIL.Image")
    if pil is None:
        return
    row_imgs = [np.concatenate([_to_img(c) for c in r], axis=1) for r in rows]
    grid = np.concatenate(row_imgs, axis=0)
    pil.fromarray((grid * 255).astype(np.uint8)).save(path)


def _np(t):
    return t.detach().float().cpu().numpy()


def _nhwc(t):
    return _np(t.permute(0, 2, 3, 1))


class TrainingImageCallback:
    """Per-epoch qualitative diagnostics of the disentanglement
    (callbacks/dafnet_image_callback.py:19-282) for DAFNet and MMSDNet. It
    shows the weights the model holds when it is called; the executor
    swaps its eval weights in (DAFNet's SWA average, MMSDNet's live
    weights), as the JAX package passes params_for_eval."""

    def __init__(self, folder, model, sample_batch, device):
        self.folder = os.path.join(folder, "training_images")
        os.makedirs(self.folder, exist_ok=True)
        self.model = model
        self.batch = sample_batch
        self.device = torch.device(device)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _generator(self, seed):
        return torch.Generator(device=self.device).manual_seed(seed)

    def _normal(self, shape, seed):
        return torch.randn(shape, generator=self._generator(seed), device=self.device)

    @torch.inference_mode()
    def on_epoch_end(self, epoch):
        self.model.eval()
        x1 = self._tensor(self.batch["x1"][:2])
        x2 = self._tensor(self.batch["x2"][:2])
        # DAFNet's dual encoder, or MMSDNet's two private ones
        # (observability.py:114-121)
        s1, s2 = self.model.encode_anatomies(x1.permute(0, 3, 1, 2), x2.permute(0, 3, 1, 2))
        self._plot_segmentations(epoch, x1, x2)
        self._plot_latent_representation(epoch, x1, x2, s1, s2)
        self._plot_reconstructions(epoch, x1, x2, s1, s2)
        self._plot_discriminator_outputs(epoch, x1, x2, s1, s2)
        self._plot_epoch_grid(epoch)

    def _plot_epoch_grid(self, epoch):
        """Intensity-augmented training-batch segmentation grid
        (callbacks/image_callback.py:69-123): images beside the
        value-scaled true and predicted mask overlays, under
        <folder>/training/."""
        folder = os.path.join(os.path.dirname(self.folder), "training")
        os.makedirs(folder, exist_ok=True)
        n = min(4, len(self.batch["x1"]))  # image_callback.py:101 caps at 4
        x1 = random_brightness_contrast(self._generator(epoch), self._tensor(self.batch["x1"][:n]),
                                        brightness=0.01, contrast=0.01)
        x2 = random_brightness_contrast(self._generator(epoch + 1),
                                        self._tensor(self.batch["x2"][:n]),
                                        brightness=0.01, contrast=0.01)
        y = _np(self.model.predict_mask(1, "simple", [x1, x2], device=self.device))
        m = np.asarray(self.batch.get("m2", self.batch["m1"])[:n])
        nm = m.shape[-1]
        # value-scaled mask overlays (save_multiimage_segmentation :109-112)
        m_img = sum(m[..., j] * (j + 1) / nm for j in range(nm))
        y_img = sum(y[..., j] * (j + 1) / nm for j in range(nm))
        x2 = _np(x2)
        rows = [[x2[i, :, :, 0], m_img[i], y_img[i]] for i in range(n)]
        save_image_grid(os.path.join(folder, "segmentations_epoch_%d.png" % epoch), rows)

    def _plot_segmentations(self, epoch, x1, x2):
        m = _np(self.model.predict_mask(1, "max", [x1, x2], device=self.device))
        m_simple = _np(self.model.predict_mask(1, "simple", [x1, x2], device=self.device))
        img = _np(x2)
        rows = []
        for i in range(m.shape[0]):
            rows.append([img[i, :, :, 0]] + [m_simple[i, :, :, j] for j in range(m.shape[-1] - 1)])
            rows.append([img[i, :, :, 0]] + [m[i, :, :, j] for j in range(m.shape[-1] - 1)])
        save_image_grid(os.path.join(self.folder, "segmentations_epoch_%03d.png" % epoch), rows)

    def _plot_latent_representation(self, epoch, x1, x2, s1, s2):
        """Anatomy-channel grids + z mean/var CSVs
        (dafnet_image_callback.py:95-130)."""
        rows = []
        for img, s in ((_np(x1), _nhwc(s1)), (_np(x2), _nhwc(s2))):
            for i in range(s.shape[0]):
                rows.append([img[i, :, :, 0]] + [s[i, :, :, c] for c in range(s.shape[-1])])
        save_image_grid(os.path.join(self.folder, "anatomies_epoch_%03d.png" % epoch), rows)

        for name, s, x in (("mod1", s1, x1), ("mod2", s2, x2)):
            _, mu, lv, _ = self.model.enc_modality(s, x.permute(0, 3, 1, 2))
            for kind, v in (("means", _np(mu)), ("vars", np.exp(_np(lv)))):
                with open(os.path.join(self.folder, "z_%s_%s.csv" % (kind, name)), "a") as f:
                    f.write("%d,%s\n" % (epoch, ",".join("%.5f" % a for a in v.mean(0))))

    def _plot_reconstructions(self, epoch, x1, x2, s1, s2):
        """Reconstruction + z-ablation grid (dafnet_image_callback.py:
        237-282): rows of [x, dec(s, z), dec(s, 0), dec(s, z~N(0,1))]."""
        num_z = self.model.conf.num_z
        rows = []
        for img, s in ((x1, s1), (x2, s2)):
            eps = self._normal((img.shape[0], num_z), 1)
            z, _, _, _ = self.model.enc_modality(s, img.permute(0, 3, 1, 2), eps)
            recs = [_nhwc(self.model.decoder(s, zz))
                    for zz in (z, torch.zeros_like(z), self._normal(z.shape, 2))]
            x = _np(img)
            for i in range(x.shape[0]):
                rows.append([x[i, :, :, 0]] + [r[i, :, :, 0] for r in recs])
        save_image_grid(os.path.join(self.folder, "reconstructions_epoch_%03d.png" % epoch), rows)

    def _plot_discriminator_outputs(self, epoch, x1, x2, s1, s2):
        """Real-vs-fake discriminator diagnostics
        (dafnet_image_callback.py:193-235): real masks beside predicted
        masks, each titled with the mean D_Mask score, and real/fake output
        histograms of both image discriminators on reconstructions."""
        plt = _pyplot()
        if plt is None:
            return
        model = self.model
        pred_m = _nhwc(model.segmentor(torch.cat([s1, s2], dim=0)))
        nm = pred_m.shape[-1] - 1
        real_m = np.asarray(self.batch.get("m2", self.batch["m1"]), np.float32)[..., :nm]
        pred_m = pred_m[..., :nm]

        def score(disc, x):
            return _np(disc(self._tensor(x).permute(0, 3, 1, 2))[0])

        n = min(4, len(real_m), len(pred_m))
        fig = plt.figure()
        for i in range(n):
            for col, masks in ((1, real_m), (2, pred_m)):
                plt.subplot(n, 2, 2 * i + col)
                plt.imshow(np.concatenate([masks[i, :, :, c] for c in range(nm)], axis=1),
                           cmap="gray")
                plt.xticks([])
                plt.yticks([])
                plt.title("Pred: %.3f" % score(model.d_mask, masks[i : i + 1]).mean(), fontsize=8)
        plt.tight_layout()
        plt.savefig(os.path.join(self.folder, "discriminator_epoch_%03d.png" % epoch))
        plt.close(fig)

        # the image discriminators: DAFNet only
        if not hasattr(model, "d_image1"):
            return
        num_z = model.conf.num_z
        fig = plt.figure()
        for j, (disc, x, s, seed) in enumerate(((model.d_image1, x1, s1, 3),
                                               (model.d_image2, x2, s2, 4))):
            z, _, _, _ = model.enc_modality(s, x.permute(0, 3, 1, 2),
                                            self._normal((x.shape[0], num_z), seed))
            rec = model.decoder(s, z)
            plt.subplot(1, 2, j + 1)
            plt.hist(_np(disc(x.permute(0, 3, 1, 2))[0]).ravel(), bins=20, alpha=0.6, label="real")
            plt.hist(_np(disc(rec)[0]).ravel(), bins=20, alpha=0.6, label="fake")
            plt.title("d_image%d" % (j + 1), fontsize=8)
            plt.legend(fontsize=6)
        plt.tight_layout()
        plt.savefig(os.path.join(self.folder, "discriminator_image_epoch_%03d.png" % epoch))
        plt.close(fig)
