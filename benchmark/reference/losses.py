"""The training losses of both models, float32, NHWC masks and images."""

import torch

LAMBDA_BCE = 0.01


def dice_coef_perbatch(y_true, y_pred, eps=1e-12):
    inter = torch.sum(y_true * y_pred, dim=(1, 2, 3))
    union = torch.sum(y_true, dim=(1, 2, 3)) + torch.sum(y_pred, dim=(1, 2, 3))
    return 1.0 - (2.0 * inter + eps) / (union + eps)


def restricted_dice_loss(y_true, y_pred, restrict_chn):
    return torch.mean(dice_coef_perbatch(y_true[..., :restrict_chn], y_pred[..., :restrict_chn]))


def _weighted_bce(y_true, y_pred, eps=1e-12):
    """The reference's swapped-argument weighted cross entropy: class
    weights from the predicted mass over the batch, the log of the truth."""
    c = y_true.shape[-1]
    n = torch.sum(y_pred, dim=(0, 1, 2))
    weights = torch.sum(n) / (n + eps)
    wce = -torch.sum(y_pred.reshape(-1, c) * torch.log(y_true.reshape(-1, c) + eps) * weights,
                     dim=1)
    return torch.mean(wce)


def combined_dice_bce(y_true, y_pred, num_classes):
    return restricted_dice_loss(y_true, y_pred, num_classes) + LAMBDA_BCE * _weighted_bce(
        y_true, y_pred)


def combined_dice_bce_perbatch(y_true, y_pred, num_classes, eps=1e-12):
    """Per-sample combined loss (B,): the cross entropy against the
    softmax of the truth, class weights from the whole batch."""
    B, H, W, C = y_true.shape
    d = dice_coef_perbatch(y_true[..., :num_classes], y_pred[..., :num_classes], eps)
    n = torch.sum(y_pred, dim=(0, 1, 2))
    weights = torch.sum(n) / (n + eps)
    true = y_true.reshape(B, H * W, C)
    softmax_t = torch.exp(true) / torch.sum(torch.exp(true), dim=-1, keepdim=True)
    wce = -torch.sum(y_pred.reshape(B, H * W, C) * torch.log(softmax_t + eps) * weights, dim=2)
    return d + LAMBDA_BCE * torch.mean(wce, dim=1)


def mae(y_true, y_pred):
    return torch.mean(torch.abs(y_true - y_pred))


def mae_perbatch(y1, y2):
    return torch.mean(torch.abs(y1 - y2), dim=(1, 2))


def lsgan_fool(d_out):
    return torch.mean(torch.square(d_out - 1.0))


def lsgan_disc(d_real, d_fake):
    return torch.mean(torch.square(d_real - 1.0)) + torch.mean(torch.square(d_fake))
