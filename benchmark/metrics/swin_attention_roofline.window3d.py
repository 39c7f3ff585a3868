"""swin_attention_roofline.window3d: % of the device time of the program's
`predict3d.attention` spans that the attention's least time takes: the
served windows times each window's Σ over the Swin blocks of the larger
of the FLOP time and the byte time of the block's attention half
(benchmark/flops/swin_attention.py), over the spans' device seconds."""

from benchmark.flops.swin_attention import least_s_per_window
from benchmark.harness.volume_spans import device_ms_per_tile


def read(ctx):
    conf = getattr(ctx, "model_conf", None)
    ms = device_ms_per_tile(ctx, ("predict3d.attention",))
    if conf is None or not ms:
        return None
    return 100.0 * least_s_per_window(conf) * 1e3 / ms
