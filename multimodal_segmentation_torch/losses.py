"""Loss functions and evaluation metrics.

The port's copy of multimodal_segmentation_tpu/losses.py, formula for
formula (reference costs.py): the numpy evaluation metrics (:50-83) and
the training losses (:88-221). Mask and image tensors are NHWC with the
channels last, as in the JAX package; losses accumulate in f32.

The reference's `make_combined_dice_bce` (costs.py:129-136) calls its
weighted BCE with SWAPPED arguments; `_reference_weighted_bce` reproduces
that math: the class weights come from the predicted mass and the log is
taken of the ground truth.
"""

import numpy as np
import torch

LAMBDA_BCE = 0.01  # costs.py:10


def dice_np(y_true, y_pred, binarise=False, smooth=1e-12):
    """Volume-mean Dice (numpy eval metric, costs.py:31-41)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)[..., 0 : y_true.shape[-1]]
    if binarise:
        y_pred = np.round(y_pred)
    y_int = y_true * y_pred
    return np.mean(
        (2 * np.sum(y_int, axis=(1, 2, 3)) + smooth)
        / (np.sum(y_true, axis=(1, 2, 3)) + np.sum(y_pred, axis=(1, 2, 3)) + smooth)
    )


def dice_np_volume(y_true, y_pred, binarise=False, smooth=1e-12):
    """Whole-volume per-class Dice for a single (D, H, W, C) study.

    Unlike dice_np (the 2-D eval metric, which treats axis 0 as a batch of
    slices and averages per-slice scores), this sums intersections/unions
    over ALL spatial axes per class, then averages over classes present in
    truth or prediction. Volumes where no foreground exists at all score
    1.0 iff the prediction is also empty.
    """
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)[..., 0 : y_true.shape[-1]]
    if binarise:
        y_pred = np.round(y_pred)
    spatial = tuple(range(y_true.ndim - 1))
    inter = np.sum(y_true * y_pred, axis=spatial)
    union = np.sum(y_true, axis=spatial) + np.sum(y_pred, axis=spatial)
    present = union > 0
    if not np.any(present):
        return 1.0
    return float(np.mean((2.0 * inter[present]) / (union[present] + smooth)))


# ---------------- segmentation losses ----------------

def dice_coef_perbatch(y_true, y_pred, eps=1e-12):
    """Per-sample (1 - dice), shape (B,) (costs.py:43-48)."""
    y_true, y_pred = y_true.float(), y_pred.float()
    inter = torch.sum(y_true * y_pred, dim=(1, 2, 3))
    union = torch.sum(y_true, dim=(1, 2, 3)) + torch.sum(y_pred, dim=(1, 2, 3))
    return 1.0 - (2.0 * inter + eps) / (union + eps)


def dice_loss(y_true, y_pred):
    """Mean over the batch of the per-sample dice loss (costs.py:50-56)."""
    return torch.mean(dice_coef_perbatch(y_true, y_pred))


def restricted_dice_loss(y_true, y_pred, restrict_chn):
    """Dice on the first `restrict_chn` channels only (costs.py:59-67)."""
    return dice_loss(y_true[..., :restrict_chn], y_pred[..., :restrict_chn])


def _reference_weighted_bce(y_true, y_pred, eps=1e-12):
    """The math of costs.py:70-85 as combined_dice_bce calls it:
      n_c = sum(pred_c);  w_c = n_tot / (n_c + eps)
      loss = mean_px( -sum_c pred_c * log(true_c + eps) * w_c )."""
    num_classes = y_true.shape[-1]
    n = torch.sum(y_pred.float(), dim=(0, 1, 2))  # (C,) predicted mass
    weights = torch.sum(n) / (n + eps)
    pred = y_pred.reshape(-1, num_classes)
    true = y_true.reshape(-1, num_classes).float()
    wce = -torch.sum(pred * torch.log(true + eps) * weights, dim=1)
    return torch.mean(wce)


def combined_dice_bce(y_true, y_pred, num_classes):
    """dice(first num_classes channels) + 0.01 * swapped-argument weighted
    BCE (costs.py:129-136)."""
    return restricted_dice_loss(y_true, y_pred, num_classes) + LAMBDA_BCE * (
        _reference_weighted_bce(y_true, y_pred)
    )


# ---------------- reconstruction and GAN / VAE losses ----------------

def mae(y_true, y_pred):
    """Mean absolute error (Keras 'mae')."""
    return torch.mean(torch.abs(y_true.float() - y_pred.float()))


def lsgan_fool(d_out):
    """Generator-side LSGAN: push D output toward 1."""
    return torch.mean(torch.square(d_out.float() - 1.0))


def lsgan_disc(d_real, d_fake):
    """Discriminator-side LSGAN: real -> 1, fake -> 0, the two terms summed
    like the Keras two-output trainer (models/mmsdnet.py:76)."""
    return torch.mean(torch.square(d_real.float() - 1.0)) + torch.mean(
        torch.square(d_fake.float())
    )


def ypred_loss(y_pred):
    """The reference's pass-through loss for in-graph losses: Keras reduces
    the returned tensor with a mean (costs.py:194-195)."""
    return torch.mean(y_pred)
