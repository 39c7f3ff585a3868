"""Stochastic Weight Averaging as a running mean of the parameters.

Port of multimodal_segmentation_tpu/train/swa.py:14-22 (reference
callbacks/swa.py:27-38). With n = epoch - swa_epoch: while n <= 0 the
average tracks the live weights; afterwards
  swa <- (swa * n + live) / (n + 1).
It averages parameters only, as the JAX package's swa_params (the params
tree): BatchNorm running statistics and the spectral vectors `u` are not
averaged, and validation uses the live ones.
"""

import torch


@torch.no_grad()
def swa_update(swa, live, epoch, swa_epoch):
    """Update the SWA tensors in place.

    Args:
      swa: {name: tensor}, the running averages.
      live: {name: tensor}, the live parameters under the same names.
      epoch: the epoch just finished.
      swa_epoch: the epoch from which the average starts.
    """
    n = float(epoch - swa_epoch)
    for name, avg in swa.items():
        if n <= 0:
            avg.copy_(live[name])
        else:
            avg.mul_(n).add_(live[name]).div_(n + 1.0)
