"""multimodal_segmentation_torch: the PyTorch/CUDA port of
multimodal_segmentation_tpu (MMSDNet / DAFNet multimodal MRI segmentation).

Plain tensor code is PyTorch; every Pallas kernel of the JAX package on a
ported path is a CUDA kernel written for Hopper (ops/cuda_kernels.py,
csrc/). Entry points run on the GPU unless the caller passes device="cpu".
The package imports torch, numpy and the standard library only.
"""

__version__ = "0.1.0"
