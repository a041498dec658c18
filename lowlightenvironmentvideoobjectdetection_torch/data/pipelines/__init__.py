"""Config-driven data pipelines (the ``PIPELINES`` registry): the loading
steps on the host, the transforms and the formatting on tensors."""

from . import formatting, loading, transforms  # noqa: F401 (registration)
from .loading import Compose, to_device  # noqa: F401
