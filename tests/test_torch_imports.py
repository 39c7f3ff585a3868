"""The port imports no JAX: every module of multimodal_segmentation_torch,
imported in a fresh interpreter, leaves neither jax nor the JAX package in
sys.modules."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, pkgutil, sys
import multimodal_segmentation_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    __import__(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "multimodal_segmentation_tpu"))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_every_port_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["leaked"] == []
    assert {"multimodal_segmentation_torch.experiment",
            "multimodal_segmentation_torch.ops.cuda_kernels",
            "multimodal_segmentation_torch.tools.debug_warp_kernel",
            "multimodal_segmentation_torch.data.chaos",
            "multimodal_segmentation_torch.data.dicom_native",
            "multimodal_segmentation_torch.tools.dress_rehearsal",
            "multimodal_segmentation_torch.data.cardiac",
            "multimodal_segmentation_torch.nn.unet3d",
            "multimodal_segmentation_torch.models.volumetric",
            "multimodal_segmentation_torch.parallel.distributed",
            "multimodal_segmentation_torch.parallel.mesh",
            "multimodal_segmentation_torch.parallel.collectives",
            "multimodal_segmentation_torch.parallel.halo",
            "multimodal_segmentation_torch.parallel.sharding",
            "multimodal_segmentation_torch.tools.gloo_probe",
            "multimodal_segmentation_torch.utils.nan_checks"} <= set(res["modules"])
