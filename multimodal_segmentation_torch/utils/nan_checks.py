"""The debug configuration's NaN guard (conf.debug_nans).

The JAX package sets jax_debug_nans (experiment.py:122-124), which raises
at the first NaN any operation makes, the forward pass and work under no
gradient included. torch.autograd.set_detect_anomaly raises only for a
NaN a backward function returns, so under debug_nans the port also hooks
every module of the model: the first module whose output holds a NaN or
an infinity raises FloatingPointError, in training, validation and test
alike. The steps check their metrics and the tester its predictions the
same way. Each check waits for the device: the guard is for debugging,
and no preset sets it. On the GPU an eval-mode BatchNorm, its
convolution's bias and its ReLU run as one kernel that calls no norm
module (nn/blocks.py::conv_norm), so a NaN made there is named by the
next module's hook: the next convolution or the enclosing block.
"""

import numpy as np
import torch


def check_finite(value, what):
    """Raise FloatingPointError if a floating tensor or array in `value`
    (or in a list, tuple or dict of them) holds a NaN or an infinity."""
    if isinstance(value, dict):
        for k, v in value.items():
            check_finite(v, "%s[%r]" % (what, k))
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            check_finite(v, "%s[%d]" % (what, i))
    elif torch.is_tensor(value) and value.is_floating_point():
        if not bool(torch.isfinite(value).all()):
            raise FloatingPointError("non-finite value in %s" % what)
    elif isinstance(value, np.ndarray) and np.issubdtype(value.dtype, np.floating):
        if not np.isfinite(value).all():
            raise FloatingPointError("non-finite value in %s" % what)


def install_nan_checks(model):
    """A forward hook on every module of `model` (itself included) that
    checks its output with check_finite. Returns the hook handles."""
    def hook(name):
        def check(module, inputs, output):
            check_finite(output, "the output of %s (%s)" % (name or "the model",
                                                            type(module).__name__))
        return check
    return [m.register_forward_hook(hook(n)) for n, m in model.named_modules()]
