"""Batch stacking in sample-major interleaved order.

Port of multimodal_segmentation_tpu/ops/batching.py:21-41. Row b*K + k of
the stacked batch is variant k of sample b; grouped BatchNorm (training
slice) uses the same layout.
"""

import torch


def batch_interleave(xs):
    """Batch-axis concatenation in sample-major interleaved order."""
    if len(xs) == 1:
        return xs[0]
    y = torch.stack(xs, dim=1)
    return y.reshape((xs[0].shape[0] * len(xs),) + tuple(xs[0].shape[1:]))


def batch_deinterleave(y, K):
    """Inverse of batch_interleave: the K variant tensors."""
    if K == 1:
        return [y]
    B = y.shape[0] // K
    yr = y.reshape((B, K) + tuple(y.shape[1:]))
    return [yr[:, k] for k in range(K)]
