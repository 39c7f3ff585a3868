"""The output check catches what it must, at the tiny sizes on the CPU:
the control (the reference in fp8 put in the program's place) and every
fault that a cell can have, planted under the timed path of a whole run
(the look for a card skipped), come out as not correct under the cell's
own limits."""

import time

import pytest
import torch

from benchmark.harness import check, faults, infer, train
from benchmark.tests import tiny

TRAIN_CELLS = ["dafnet-train-expert", "mmsdnet-train", "dafnet-train-automated"]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_control_is_not_correct(name):
    torch.set_num_threads(1)
    _, _, workload, config = tiny.cell(name)
    nums, _ = train.reading("control", tiny.SEED, 0, workload, config, tiny.CPU)
    assert not check.verdict(nums, workload["checks"])[0], nums


@pytest.mark.parametrize("fault", sorted(faults.STEP_FAULTS))
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_training_fault_is_not_correct(name, fault):
    torch.set_num_threads(1)
    _, _, workload, config = tiny.cell(name)
    res = train.run(tiny.SEED, 0.5, False, workload, config, time.perf_counter(), tiny.CPU,
                    wrap_steps=faults.STEP_FAULTS[fault])
    assert res.correct is False, res.numbers


def test_inference_control_is_not_correct():
    torch.set_num_threads(1)
    _, _, workload, config = tiny.cell("dafnet-infer-volumes")
    nums, _ = infer.reading("control", tiny.SEED, 1.0, workload, config, tiny.CPU)
    assert not check.verdict(nums, workload["checks"])[0], nums


@pytest.mark.parametrize("fault", ["altered", "moved"])
def test_inference_fault_is_not_correct(fault):
    torch.set_num_threads(1)
    _, _, workload, config = tiny.cell("dafnet-infer-volumes")
    res = infer.run(tiny.SEED, 1.0, False, workload, config, time.perf_counter(), tiny.CPU,
                    wrap_predict=getattr(faults, fault))
    assert res.correct is False, res.numbers
