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
            "multimodal_segmentation_torch.tools.debug_warp_kernel"} <= set(res["modules"])
