"""Evaluation: ModelTester parity with the reference test protocol."""

from multimodal_segmentation_torch.eval.tester import ModelTester

__all__ = ["ModelTester"]
