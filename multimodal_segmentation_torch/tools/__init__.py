"""Command-line tools of the port, each run with `python -m
multimodal_segmentation_torch.tools.<name>`."""
