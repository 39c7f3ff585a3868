"""Paired T1/T2 abdominal MR studies at the CHAOS MR profile, made from a
seed: the benchmark's frozen copy of the port's synthetic CHAOS generator
(data/synthetic.py), vectorised over every slice and run on the device.

A study is n slices of H x W: four ellipsoidal organs (liver, right and
left kidney, spleen) whose centres drift along the slice axis and whose
size shrinks towards the ends, inside a body ellipse. T2 is the anatomy's
intensity plus noise; T1 is another transfer function of the same anatomy,
moved by a whole-pixel shift of up to 3 px a slice (so the fuser has
registration work), plus noise. Each slice is rescaled to [-1, 1]. Masks
are {0, 1}, four channels a modality.

Every seed gives the same set of slice counts, in another order: the work
of a run does not depend on the seed, only its content does.
"""

import numpy as np
import torch

# (cy, cx, ry, rx) of liver, right kidney, left kidney, spleen, normalised
ORGANS = ((-0.25, -0.30, 0.45, 0.35), (0.30, -0.25, 0.16, 0.13),
          (0.30, 0.25, 0.16, 0.13), (-0.05, 0.45, 0.20, 0.15))
INTENSITY = (0.5, 0.35, 0.35, 0.45)


def seed_words(seed, n):
    """n 32-bit words from any whole number, for numpy's generators."""
    return [int(w) for w in np.random.SeedSequence(abs(int(seed))).generate_state(n)]


def slice_counts(count, lo, hi):
    """`count` slice counts spread evenly over [lo, hi]."""
    if count == 1:
        return [hi]
    return [lo + (hi - lo) * i // (count - 1) for i in range(count)]


def render(sizes, hw, seed, device):
    """Studies of the given slice counts. Returns (images (N, H, W, 2) with
    T1 then T2, masks (N, H, W, 8) with T1's four then T2's, index (N,) the
    study of each slice), float32 numpy arrays."""
    H, W = hw
    g = torch.Generator(device=device).manual_seed(abs(int(seed)) % 2 ** 63)
    S = len(sizes)
    N = int(sum(sizes))
    index = torch.repeat_interleave(torch.arange(S, device=device),
                                    torch.tensor(sizes, device=device))
    # slice position z in [-1, 1] within its study
    first = torch.cumsum(torch.tensor([0] + list(sizes[:-1]), device=device), 0)[index]
    n = torch.tensor(sizes, device=device, dtype=torch.float32)[index]
    z = (torch.arange(N, device=device) - first).float() / torch.clamp(n - 1, min=1) * 2 - 1

    jit = (torch.rand((S, 4, 4), generator=g, device=device) - 0.5) * 0.1
    drift = (torch.rand((S, 4, 2), generator=g, device=device) * 0.15 + 0.15) * (
        torch.randint(0, 2, (S, 4, 2), generator=g, device=device) * 2 - 1)
    shift = torch.randint(-3, 4, (N, 2), generator=g, device=device).float()
    noise = torch.randn((2, N, H, W), generator=g, device=device) * 0.05

    base = torch.tensor(ORGANS, device=device)                       # (4, 4)
    zscale = torch.sqrt(torch.clamp(1.0 - 0.6 * z * z, min=0.05))[:, None]
    cy = base[:, 0] + jit[index, :, 0] + drift[index, :, 0] * z[:, None]       # (N, 4)
    cx = base[:, 1] + jit[index, :, 1] + drift[index, :, 1] * z[:, None]
    ry = (base[:, 2] + jit[index, :, 2] * 0.3) * zscale
    rx = (base[:, 3] + jit[index, :, 3] * 0.3) * zscale
    yy = ((torch.arange(H, device=device).float() - H / 2) / (H / 2))[None, None, :, None]
    xx = ((torch.arange(W, device=device).float() - W / 2) / (W / 2))[None, None, None, :]
    weights = torch.tensor(INTENSITY, device=device)

    def anatomy(dy, dx):
        """Masks (N, 4, H, W) and intensity (N, H, W), moved by (dy, dx)
        in normalised units."""
        y = yy - dy[:, None, None, None]
        x = xx - dx[:, None, None, None]
        d = ((y - cy[..., None, None]) / ry[..., None, None]) ** 2 + (
            (x - cx[..., None, None]) / rx[..., None, None]) ** 2
        masks = (d < 1.0).float()
        body = (((y[:, 0] / 0.9) ** 2 + (x[:, 0] / 0.95) ** 2) < 1.0).float()
        return masks, 0.3 * body + torch.einsum("nkhw,k->nhw", masks, weights)

    zero = torch.zeros(N, device=device)
    m2, base2 = anatomy(zero, zero)
    m1, base1 = anatomy(shift[:, 0] * (2.0 / H), shift[:, 1] * (2.0 / W))
    t2 = base2 + noise[0]
    t1 = torch.tanh(1.5 * base1) + noise[1]

    def rescale(t):
        lo = t.amin(dim=(1, 2), keepdim=True)
        hi = t.amax(dim=(1, 2), keepdim=True)
        return 2.0 * (t - lo) / (hi - lo) - 1.0

    images = torch.stack([rescale(t1), rescale(t2)], dim=-1)
    masks = torch.cat([m1, m2], dim=1).permute(0, 2, 3, 1)
    return (images.cpu().numpy(), np.ascontiguousarray(masks.cpu().numpy()),
            index.cpu().numpy().astype(np.int64))


def training_studies(traffic, seed, device):
    """The training split of a train cell: traffic['studies'] studies with
    slice counts spread over traffic['slices'], in a seeded order."""
    sizes = slice_counts(traffic["studies"], *traffic["slices"])
    order = np.random.RandomState(seed_words(seed, 1)[0]).permutation(len(sizes))
    return render([sizes[i] for i in order], traffic["hw"], seed, device)


def request_pool(traffic, seed, device):
    """One study of each slice count in traffic['slices'] (inclusive), each
    as (x1 (n, H, W, 1), x2 (n, H, W, 1)) float32 numpy arrays, in the
    order of their counts."""
    lo, hi = traffic["slices"]
    sizes = list(range(lo, hi + 1))
    images, _, index = render(sizes, traffic["hw"], seed, device)
    return [(np.ascontiguousarray(images[index == i][..., 0:1]),
             np.ascontiguousarray(images[index == i][..., 1:2])) for i in range(len(sizes))]


def request_order(pool_size, seed):
    """Endless study indices: each pass over the pool in a fresh seeded
    order, so every pass holds every slice count once."""
    rng = np.random.RandomState(seed_words(seed, 2)[1])
    while True:
        yield from rng.permutation(pool_size).tolist()
