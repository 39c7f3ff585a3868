"""The least time of Swin UNETR's window attention, from a configuration's
shapes alone, whatever implements it: for each Swin block the larger of
its attention half's FLOP time and byte time.

  FLOPs  the qkv map (C -> 3C), q k^T, the probabilities times v and the
         projection (C -> C), on the padded tokens (each axis padded to a
         multiple of its window), 2 a multiply-add, at the bf16 dense peak
  bytes  the block's input tokens read and its output written once, in
         bf16, at the HBM rate

The shapes follow nn/swin_unetr.py: stage i at (roi / 2^(i + 1)) voxels a
axis, width feature_size * 2^i, two blocks a stage, windows of 7 a axis
or the axis's size where it is no longer.
"""

import math

from benchmark.flops import peaks

WINDOW = 7
STAGES = 4
BLOCKS = 2


def block_least_s(size, width):
    """(least s, FLOPs, bytes) of one window's attention half of one block
    at `size` (D, H, W) tokens of `width` channels."""
    ws = [s if s <= WINDOW else WINDOW for s in size]
    tokens = math.prod(-(-s // w) * w for s, w in zip(size, ws))
    n = math.prod(ws)
    flops = 2 * tokens * (3 * width * width + width * width) + 4 * tokens * n * width
    moved = 2 * math.prod(size) * width * 2
    return max(flops / peaks.BF16_FLOPS, moved / peaks.HBM_BYTES_PER_S), flops, moved


def least_s_per_window(conf):
    """Σ over the blocks of one window (conf.volume_shape[:3]) of their
    attention halves' least time."""
    roi, f = conf.volume_shape[:3], conf.filters3d
    total = 0.0
    for i in range(STAGES):
        size = [r // 2 ** (i + 1) for r in roi]
        total += BLOCKS * block_least_s(size, f * 2 ** i)[0]
    return total
