"""Training: the train state, the per-batch training steps, SWA, early
stopping and the executor's epoch loop (train/executor.py, imported from
there)."""

from multimodal_segmentation_torch.train.early_stopping import EarlyStopping
from multimodal_segmentation_torch.train.state import TrainState, adam, create_train_state
from multimodal_segmentation_torch.train.steps import (
    DAFNetSteps,
    MMSDNetSteps,
    draw_mmsdnet_disc_noise,
    draw_mmsdnet_noise,
    draw_noise,
    make_steps,
)
from multimodal_segmentation_torch.train.swa import swa_update

__all__ = ["DAFNetSteps", "EarlyStopping", "MMSDNetSteps", "TrainState", "adam",
           "create_train_state", "draw_mmsdnet_disc_noise", "draw_mmsdnet_noise", "draw_noise",
           "make_steps", "swa_update"]
