"""What the reference computes its activations in.

The reference holds and accumulates every value in float32 (TF32 off).
At the configuration's compute dtype it rounds every value that the
program holds in that dtype, at the points where the program holds it (a
convolution's or a compute-dtype dense layer's operands and output,
BatchNorm's centred and scaled values, activations, the anatomy head's
softmax before its rounding, the warped anatomy), in the forward pass and,
through the same points, the gradient in the backward pass; the
program's float32 islands (statistics, softmax, losses, the VAE heads,
the offset head and the flow, the last decoder conv, the discriminators'
dense heads) stay float32. Products of two bfloat16 values are exact in
float32, so only the order of the sums differs from the program's.

  float32   no rounding (configurations computing in float32; a witness)
  bfloat16  the configurations' stated compute dtype: the reference
  fp8       the control of the output check, the nearest precision below
            bfloat16: float8 e4m3 forward and e5m2 backward, each tensor
            scaled so its largest magnitude is the format's largest, as
            fp8 training scales them
"""

import torch


def exact(x):
    return x


def _scaled(x, dtype):
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _fp8_fwd(x):
    return _scaled(x, torch.float8_e4m3fn)


def _fp8_bwd(g):
    return _scaled(g, torch.float8_e5m2)


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def fp8(x):
    return _Round.apply(x, _fp8_fwd, _fp8_bwd)


def bfloat16(x):
    return _Round.apply(x, _bf16, _bf16)


POLICIES = {"float32": exact, "fp8": fp8, "bfloat16": bfloat16}


def set_precision(model, name):
    """Give every module of `model` that the program runs in its compute
    dtype the rounding of policy `name`."""
    q = POLICIES[name]
    for m in model.modules():
        if getattr(m, "compute", False):
            m.q = q
    return model
