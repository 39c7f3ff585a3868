"""The reference model of configurations whose model is `dafnet`
(models.py)."""

from benchmark.reference.models import DAFNet as MODEL  # noqa: F401
