"""The weights of a Swin UNETR (reference/swin_unetr.py's MODEL), made from a
seed on the device and handed to the program and to the reference alike.

MONAI's initialisation, but for the attention: every other linear map's
weight N(0, 0.02^2) cut at +-2 (trunc_normal_ with std 0.02), their
biases 0; LayerNorms weight 1 and bias 0; every convolution's kernel (the
patch embedding's, the transposed ones' and the head's too) he_normal, a
unit normal cut at +-2 scaled by sqrt(2 / fan_in) / 0.8796, fan_in the
terms that sum into one output (in channels x kernel volume; for a 2x2x2
stride-2 transposed convolution, whose output voxels each take one tap,
the in channels); the patch embedding's bias 0.

The attention is drawn as a trained one acts, not as MONAI starts it. At
MONAI's 0.02 a block of width C gives scores of standard deviation about
0.02^2 C (0.02 at C = 48), so each window's softmax is nearly uniform and
the attention half adds almost nothing to the residual stream: a fault in
it would not show in the outputs. So the qkv and proj weights are
N(0, ATTENTION_GAIN^2 / C), which gives q, k and v entries a standard
deviation of ATTENTION_GAIN and the scores of every head at every width
one of about ATTENTION_GAIN^2 (2.25): each window's softmax is peaked.
Each relative-position table is N(0, TABLE_STD^2) cut at +-2, a bias of
the order of the scores' spread, so that the offsets matter as they do
in trained Swin models. Their biases stay 0. (On the CPU cut a gain of 1
read the attention's faults lower above a sound bfloat16 run, and one of
2 made a bfloat16 forward's outputs chaotic: their mean gap from float32
4 times this draw's, PERF.md.)

The head's bias is then drawn so that each output's sigmoid is neither
saturated nor flat over a study: the reference, in float32, gives the
logits of one window at the centre of a seeded study of the traffic's
smallest size, and output c's bias is minus the u_c quantile of its
logits there, u_c drawn U(0.5, 0.9), so that 10-50 % of that window's
voxels read over 0.5 in each output. With zero biases the outputs' shares
over 0.5 would fall wherever the random features put them.
"""

import math

import torch

from benchmark.traffic.volumes import render

_TRUNC_STD = 0.87962566103423978
# the attention's draw (module docstring)
ATTENTION_GAIN = 1.5
TABLE_STD = 1.0


def make_weights(model_cls, conf, traffic, seed, device):
    """{state_dict key: float32 tensor on `device`} of a `model_cls(conf)`
    (module docstring); conf.volume_shape is the window's (D, H, W,
    channels)."""
    roi, channels = tuple(conf.volume_shape[:3]), conf.volume_shape[3]
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in model_cls(conf).state_dict().items()}
    g = torch.Generator(device=device).manual_seed(abs(int(seed)) % 2 ** 63)
    state = {}
    for key, shape in shapes.items():
        n = math.prod(shape)
        if len(shape) == 2:
            std = 0.02
            if key.endswith(("attn.qkv.weight", "attn.proj.weight")):
                std = ATTENTION_GAIN / math.sqrt(shape[1])
            elif key.endswith("relative_position_bias_table"):
                std = TABLE_STD
            t = (torch.randn(n, generator=g, device=device) * std).clamp(-2.0, 2.0)
        elif len(shape) == 5:
            fan_in = shape[0] if "transp_conv" in key else math.prod(shape[1:])
            t = torch.randn(n, generator=g, device=device).clamp(-2.0, 2.0) * (
                math.sqrt(2.0 / fan_in) / _TRUNC_STD)
        elif "norm" in key and key.endswith("weight"):
            t = torch.ones(n, device=device)
        else:
            t = torch.zeros(n, device=device)
        state[key] = t.view(shape)
    model = model_cls(conf).to(device).eval()
    model.load_state_dict(state)
    size = (traffic["depths"][0], traffic["hw"][0], traffic["hw"][0])
    volume = render(size, channels, traffic["blobs"], g, device)
    at = [max((s - r) // 2, 0) for s, r in zip(size, roi)]
    window = volume[at[0]:at[0] + roi[0], at[1]:at[1] + roi[1], at[2]:at[2] + roi[2]]
    with torch.no_grad():
        logits = model(window.permute(3, 0, 1, 2)[None].contiguous())[0].flatten(1)
    bias = state["out.conv.conv.bias"]
    for c in range(bias.numel()):
        u = float(torch.rand(1, generator=g, device=device)) * 0.4 + 0.5
        ordered = logits[c].sort().values
        bias[c] = -ordered[min(int(u * ordered.numel()), ordered.numel() - 1)]
    del model, logits
    return state
