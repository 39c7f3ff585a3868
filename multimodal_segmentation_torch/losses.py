"""Evaluation metrics (numpy), the port's copy of
multimodal_segmentation_tpu/losses.py:50-83 (reference costs.py:31-41).

The training losses come with the training slice (ROADMAP.md, queue A).
"""

import numpy as np


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
