"""Training: the train state and the per-batch training steps."""

from multimodal_segmentation_torch.train.state import TrainState, adam, create_train_state
from multimodal_segmentation_torch.train.steps import DAFNetSteps, MMSDNetSteps, draw_noise, make_steps

__all__ = ["DAFNetSteps", "MMSDNetSteps", "TrainState", "adam", "create_train_state",
           "draw_noise", "make_steps"]
