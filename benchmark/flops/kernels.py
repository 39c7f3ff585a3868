"""The least time the chip could take for one call of each of the port's
kernels (B1-B4), from the work's shapes: the larger of the bytes that the
work must move over the HBM rate and its operations over the float32
rate. Each input is read once and each output written once, whatever the
kernel reads again. The arithmetic is the port's chip_smoke.py's
(`fwd_measure`, `bwd_measure`, the rotation and rounding phases), copied.
"""

from benchmark.flops import peaks

ELEMENT_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8}


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def _bound(moved, flops):
    return max(moved / peaks.HBM_BYTES_PER_S, flops / peaks.F32_FLOPS)


def call_bound_s(op, shapes, dtypes):
    """Seconds of a call of operator `op` (mmseg_cuda::<entry>) with its
    input `shapes` and `dtypes` as the profiler recorded them, or None
    where its work cannot be read from them."""
    entry = op.split("::")[-1]
    try:
        size = ELEMENT_BYTES[dtypes[0]]
    except (KeyError, IndexError):
        return None
    if entry in ("tps_warp_fwd", "tps_warp_fwd_general"):
        (B, H, W, C), wv, cp = shapes[0], shapes[1], shapes[2]
        n_cp = cp[-2]
        # the basis once a point (n_cp terms of ~9), per point and image
        # the flow's sums (n_cp x 4), ~20 for the affine term and corner
        # weights, and 8 per channel for the blend
        return _bound(2 * B * H * W * C * size + 4 * (_numel(wv) + _numel(cp)),
                      H * W * n_cp * 9 + B * H * W * (n_cp * 4 + 20 + 8 * C))
    if entry == "tps_warp_bwd":
        (B, H, W, C), locs = shapes[0], shapes[1]
        # vol, g and locs read once, grad_vol and grad_locs written once;
        # per point and channel 4 weighted scatters and the two location
        # terms (~16), per point ~20 for the weights
        return _bound(3 * B * H * W * C * size + 2 * 4 * _numel(locs),
                      B * H * W * (16 * C + 20))
    if entry == "round_ste":
        n = _numel(shapes[0])
        return _bound(2 * n * size, n)
    if entry == "nearest_warp":
        (B, H, W, C), locs = shapes[0], shapes[1]
        return _bound(2 * B * H * W * C * size + 4 * _numel(locs), B * H * W * 26)
    return None


def rotation_bound_s(batch, hw, channels, size=4):
    """Seconds of rotating `channels` channels of a (batch, H, W) batch
    (rotate_group, whose array list the profiler does not record): each
    read once and written once, ~26 operations a pixel for the location."""
    pixels = batch * hw[0] * hw[1]
    return _bound(2 * pixels * channels * size, pixels * 26)
