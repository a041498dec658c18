"""Registries of the port, the counterpart of the JAX package's
``registry.py``: a config dict's ``type`` names a registered factory.
``PIPELINES`` holds the data transforms (``data/pipelines``), ``MODELS``
the model builders (``models/builder.py``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._registry: Dict[str, Callable] = {}

    def register(self, name: Optional[str] = None):
        def deco(fn):
            key = name or fn.__name__
            if key in self._registry:
                raise KeyError(f"{key} already registered in {self.name}")
            self._registry[key] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable:
        if name not in self._registry:
            raise KeyError(f"{name!r} is not registered in {self.name}; "
                           f"known: {sorted(self._registry)}")
        return self._registry[name]

    def __contains__(self, name: str) -> bool:
        return name in self._registry

    def keys(self):
        return self._registry.keys()


MODELS = Registry("models")
PIPELINES = Registry("pipelines")
