"""Config-driven data pipelines (the ``PIPELINES`` registry): the loading
steps on the host, the transforms and the formatting on tensors, and
``MultiScaleFlipAug`` (``data/coco_det.py``)."""

from . import formatting, loading, transforms  # noqa: F401 (registration)
from .. import coco_det  # noqa: F401 (registers MultiScaleFlipAug)
from .loading import Compose, to_device  # noqa: F401
