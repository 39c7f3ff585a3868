"""Loss functions and evaluation metrics.

The port's copy of multimodal_segmentation_tpu/losses.py, formula for
formula (reference costs.py): the numpy evaluation metrics (:50-83) and
the on-device validation Dice (:33-47), the training losses (:88-221),
and the functions no training path calls (similarity_weighted_dice :162,
similarity_weighted_mae :184, mse :192, kl_from_stats :210 and the numpy
distance_correlation :224).
Mask and image tensors are NHWC with the channels last, as in the JAX
package; losses accumulate in f32.

The reference's `make_combined_dice_bce` (costs.py:129-136) calls its
weighted BCE with SWAPPED arguments; `_reference_weighted_bce` reproduces
that math: the class weights come from the predicted mass and the log is
taken of the ground truth.
"""

import numpy as np
import torch

from multimodal_segmentation_torch.parallel.collectives import all_reduce_sum

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


def dice_torch(y_true, y_pred, binarise=False, smooth=1e-12):
    """On-device dice_np (losses.py:33-47): the same math on tensors, a 0-d
    f32 tensor out, so only the scalar leaves the device."""
    y_true = y_true.float()
    y_pred = y_pred.float()[..., 0 : y_true.shape[-1]]
    if binarise:
        y_pred = torch.round(y_pred)
    inter = torch.sum(y_true * y_pred, dim=(1, 2, 3))
    union = torch.sum(y_true, dim=(1, 2, 3)) + torch.sum(y_pred, dim=(1, 2, 3))
    return torch.mean((2.0 * inter + smooth) / (union + smooth))


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


def _reference_weighted_bce(y_true, y_pred, eps=1e-12, group=None):
    """The math of costs.py:70-85 as combined_dice_bce calls it:
      n_c = sum(pred_c);  w_c = n_tot / (n_c + eps)
      loss = mean_px( -sum_c pred_c * log(true_c + eps) * w_c ).
    The masses n_c sum over the batch axis too: with `group` (data
    parallelism) they are all-reduced over it, differentiably, so they
    are the global batch's, and the gradient flows through them as in
    the JAX package (no stop-gradient)."""
    num_classes = y_true.shape[-1]
    n = all_reduce_sum(torch.sum(y_pred.float(), dim=(0, 1, 2)), group)  # (C,) predicted mass
    weights = torch.sum(n) / (n + eps)
    pred = y_pred.reshape(-1, num_classes)
    true = y_true.reshape(-1, num_classes).float()
    wce = -torch.sum(pred * torch.log(true + eps) * weights, dim=1)
    return torch.mean(wce)


def combined_dice_bce(y_true, y_pred, num_classes, group=None):
    """dice(first num_classes channels) + 0.01 * swapped-argument weighted
    BCE (costs.py:129-136); `group` as _reference_weighted_bce's."""
    return restricted_dice_loss(y_true, y_pred, num_classes) + LAMBDA_BCE * (
        _reference_weighted_bce(y_true, y_pred, group=group)
    )


def _reference_weighted_bce_perbatch(y_true, y_pred, eps=1e-12, group=None):
    """Per-sample variant of the swapped-argument weighted BCE (costs.py:
    88-108 as costs.py:142 calls it): the class weights from the
    predicted mass of the whole batch (with `group`, the global batch's,
    as in _reference_weighted_bce), the softmax of the ground truth under
    the log; shape (B,).
      loss_b = mean_px( -sum_c pred_c * log(softmax(true)_c + eps) * w_c )."""
    B, H, W, C = y_true.shape
    n = all_reduce_sum(torch.sum(y_pred, dim=(0, 1, 2)), group)
    weights = torch.sum(n) / (n + eps)
    pred = y_pred.reshape(B, H * W, C)
    true = y_true.reshape(B, H * W, C).float()
    softmax_t = torch.exp(true) / torch.sum(torch.exp(true), dim=-1, keepdim=True)
    wce = -torch.sum(pred * torch.log(softmax_t + eps) * weights, dim=2)
    return torch.mean(wce, dim=1)


def combined_dice_bce_perbatch(y_true, y_pred, num_classes, eps=1e-12, group=None):
    """Per-sample combined loss, shape (B,) (costs.py:138-143)."""
    d = dice_coef_perbatch(y_true[..., :num_classes], y_pred[..., :num_classes], eps)
    return d + LAMBDA_BCE * _reference_weighted_bce_perbatch(y_true, y_pred, group=group)


def similarity_weighted_dice(weights, y_true, y_pred, restrict_chn, eps=1e-5):
    """Dice on the first `restrict_chn` channels, each sample's (1 - dice)
    scaled by its similarity weight, averaged (costs.py:111-126).
    weights: (B,)."""
    t = y_true[..., :restrict_chn]
    p = y_pred[..., :restrict_chn]
    inter = torch.sum(t * p, dim=(1, 2, 3))
    union = torch.sum(t, dim=(1, 2, 3)) + torch.sum(p, dim=(1, 2, 3))
    d = (2.0 * inter + eps) / (union + eps)
    return torch.mean(weights * (1.0 - d))


# ---------------- reconstruction and GAN / VAE losses ----------------

def mae(y_true, y_pred):
    """Mean absolute error (Keras 'mae')."""
    return torch.mean(torch.abs(y_true.float() - y_pred.float()))


def mae_perbatch(y1, y2):
    """Per-sample, per-channel MAE over H and W, shape (B, C) (costs.py:
    24-27): a (B, 1) weight column multiplies it sample by sample."""
    return torch.mean(torch.abs(y1.float() - y2.float()), dim=(1, 2))


def similarity_weighted_mae(weights, y_true, y_pred):
    """MAE with each (sample, channel) scaled by its weight (costs.py:
    14-21). weights: (B, C). In the inputs' dtype, as the JAX package's."""
    w = weights[:, None, None, :]
    return torch.mean(torch.abs(y_true - y_pred) * w)


def mse(y_true, y_pred):
    """Mean squared error (Keras 'mse'), in f32 as `mae`."""
    return torch.mean(torch.square(y_true.float() - y_pred.float()))


def lsgan_fool(d_out):
    """Generator-side LSGAN: push D output toward 1."""
    return torch.mean(torch.square(d_out.float() - 1.0))


def lsgan_disc(d_real, d_fake):
    """Discriminator-side LSGAN: real -> 1, fake -> 0, the two terms summed
    like the Keras two-output trainer (models/mmsdnet.py:76)."""
    return torch.mean(torch.square(d_real.float() - 1.0)) + torch.mean(
        torch.square(d_fake.float())
    )


def kl_from_stats(z_mean, z_log_var):
    """KL(q(z|x) || N(0, I)) per sample, shape (B, 1) (costs.py:186-189)."""
    kl = -0.5 * torch.sum(1.0 + z_log_var - torch.square(z_mean) - torch.exp(z_log_var), dim=-1)
    return kl[:, None]


def ypred_loss(y_pred):
    """The reference's pass-through loss for in-graph losses: Keras reduces
    the returned tensor with a mean (costs.py:194-195)."""
    return torch.mean(y_pred)


def distance_correlation(a, b):
    """Distance correlation between two sample matrices, in float64 numpy
    (an analysis utility; costs.py:198-218 defines it and no training path
    calls it)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = a.shape[0]
    if b.shape[0] != n:
        raise ValueError("Number of samples must match")

    def centred(x):
        d = np.sqrt(np.maximum(np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1), 0.0))
        return d - d.mean(axis=0)[None, :] - d.mean(axis=1)[:, None] + d.mean()

    A, B = centred(a), centred(b)
    dcov2_xy = (A * B).sum() / float(n * n)
    dcov2_xx = (A * A).sum() / float(n * n)
    dcov2_yy = (B * B).sum() / float(n * n)
    return np.sqrt(dcov2_xy) / np.sqrt(np.sqrt(dcov2_xx) * np.sqrt(dcov2_yy))
