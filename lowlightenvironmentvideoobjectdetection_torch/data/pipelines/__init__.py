"""Config-driven data pipelines (the ``PIPELINES`` registry): the loading
steps and AutoAugment's transforms on the host, the transforms and the
formatting on tensors, and ``MultiScaleFlipAug`` (``data/coco_det.py``)."""

from . import auto_augment, formatting, loading, transforms  # noqa: F401
from .. import coco_det  # noqa: F401 (registers MultiScaleFlipAug)
from .loading import Compose, to_device  # noqa: F401
