"""The plain reference against the port at the tiny sizes on the CPU, in
float32: the first three training steps of each training cell (losses,
first gradients, parameters after) and predict_mask's masks."""

import time

import pytest
import torch

from benchmark import control
from benchmark.harness import infer
from benchmark.tests import tiny

TRAIN_CELLS = ["dafnet-train-expert", "mmsdnet-train", "dafnet-train-automated"]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_training_steps_match_the_port(name):
    torch.set_num_threads(1)
    _, _, workload, config = tiny.cell(name)
    nums, where = control.training_reading("sound", tiny.SEED, workload, config, tiny.CPU)
    assert nums["loss_gap"] < 1e-5, nums
    assert nums["stats_gap"] < 1e-5, nums
    # every part's first gradient: its direction, the sign of each entry and
    # each leaf's norm; MMSDNet's Z-regressor (zreg-*) takes its gradient
    # after the generator's first update, whose entries near 0 move by +-lr
    limits = {"grad_turn.": 1e-4, "grad_sign.": 1e-3, "grad_gap.": 1e-2}
    for k, v in nums.items():
        for prefix, limit in limits.items():
            if k.startswith(prefix) and ".zreg-" not in k:
                assert v < limit, (k, v, where["worst"].get(k))


def test_predict_mask_matches_the_port():
    torch.set_num_threads(1)
    _, _, workload, config = tiny.cell("dafnet-infer-volumes")
    res = infer.run(tiny.SEED, 1.0, False, workload, config, time.perf_counter(), tiny.CPU)
    assert res.numbers["mask_mismatch"] == 0.0
    assert res.numbers["region_gap"] < 1e-5
