"""Faults planted under the timed path, for the control readings
(control.py) and the tests that see `correct` come out false. None of
them is reachable from run.py.

  unchanged   a step that returns its state as it found it
  half_batch  half of the batch left out, the mean taken over the rest
  altered     every answer's classes turned by one where produced
  moved       every answer's mask mirrored left to right within each slice,
              which keeps each class's volume
"""

import copy


class _Steps:
    """The program's steps with each method called through `fault`."""

    def __init__(self, steps, fault):
        self._steps = steps
        self._fault = fault

    def __getattr__(self, name):
        method = getattr(self._steps, name)
        return lambda ts, batch, noise: self._fault(method, ts, batch, noise)


def _unchanged(method, ts, batch, noise):
    model = copy.deepcopy(ts.model.state_dict())
    opts = [(o, copy.deepcopy(o.state_dict())) for o in
            [ts.opt_gen, *ts.opt_disc.values()] + ([ts.opt_zreg] if ts.opt_zreg else [])]
    out = method(ts, batch, noise)
    ts.model.load_state_dict(model)
    for o, state in opts:
        o.state.clear()
        o.load_state_dict(state)
    return out


def _half(t):
    return t[: t.shape[0] // 2]


def _half_batch(method, ts, batch, noise):
    batch = {k: _half(v) for k, v in batch.items()}
    noise = {k: [_half(t) for t in v] if isinstance(v, list) else _half(v)
             for k, v in noise.items()}
    return method(ts, batch, noise)


def unchanged(steps):
    return _Steps(steps, _unchanged)


def half_batch(steps):
    return _Steps(steps, _half_batch)


def altered(predict):
    """Every answer's class channels turned by one: each pixel's most
    likely class becomes another."""
    return lambda *args, **kw: predict(*args, **kw).roll(1, dims=-1)


def moved(predict):
    """Every answer's (n, H, W, C) mask mirrored along W."""
    return lambda *args, **kw: predict(*args, **kw).flip(-2)


STEP_FAULTS = {"unchanged": unchanged, "half_batch": half_batch}

# the reference in the program's place, by control.py's mode: the control
# (fp8, the nearest precision below the configurations' bfloat16), and the
# reference in float32 (a witness of what the stated bfloat16 costs)
IN_PLACE = {"control": "fp8", "float32": "float32"}
