"""The reference model of configurations whose model is `mmsdnet`
(models.py)."""

from benchmark.reference.models import MMSDNet as MODEL  # noqa: F401
