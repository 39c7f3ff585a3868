"""Spectral-norm regularisation penalty by power iteration.

Port of multimodal_segmentation_tpu/ops/spectral.py:21-45 (reference
layers/spectralnorm.py:199-246):

  x = the kernel flattened to (prod(leading), out_ch);
  3 power iterations from the stored u estimate sigma_max;
  penalty = alpha * mean(|stop_grad(x / sigma) - x|).

The JAX kernel is HWIO, so x is (kh * kw * in, out) in that order, and
the stored u (kh * kw * in, 1) follows it. A torch OIHW weight must be
permuted to (kh, kw, in, out) before the reshape (`hwio_matrix`);
otherwise sigma and the penalty differ from the JAX package's.
"""

import torch


def hwio_matrix(weight):
    """(out, in, kh, kw) conv weight -> (kh * kw * in, out), the JAX
    package's reshape of its HWIO kernel."""
    return weight.permute(2, 3, 1, 0).reshape(-1, weight.shape[0])


def spectral_penalty(x, u, alpha=10.0, iters=3, eps=1e-12):
    """Penalty of one (dim, out) weight matrix and its new power-iteration
    vector.

    Args:
      x: (dim, out) weight matrix (`hwio_matrix` of a conv weight).
      u: (dim, 1) power-iteration state; no gradient flows into it.

    Returns:
      (penalty, new_u): the scalar penalty, whose gradient flows through
      the raw x term only, and the detached (dim, 1) vector to store.
    """
    u = u.detach()
    for _ in range(iters):
        wtu = x.T @ u
        v = wtu / torch.sqrt(torch.sum(wtu.square()) + eps)
        wv = x @ v
        u = wv / torch.sqrt(torch.sum(wv.square()) + eps)
    sigma = (u.T @ x @ v)[0, 0]
    target = (x / sigma).detach()
    penalty = alpha * torch.mean(torch.abs(target - x))
    return penalty, u.detach()
