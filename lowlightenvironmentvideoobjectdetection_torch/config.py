"""Python-file configs with ``_base_`` inheritance, the port's copy of the JAX
package's ``config.py`` (``Config``, ``load_config``, ``deep_merge``,
``apply_cli_options``): a config file is executed and its top-level names
become a dict; ``_base_`` files merge under it, dicts recursively, and
``_delete_=True`` replaces a base dict instead of merging into it;
``--cfg-options key.subkey=value`` overrides follow.

It reads the repository's ``configs/`` as they are and gives the same dicts
as the JAX package's ``load_config``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional


class Config(dict):
    """A nested dict whose keys also read as attributes."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def _wrap(obj):
        if isinstance(obj, dict) and not isinstance(obj, Config):
            return Config({k: Config._wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config._wrap(v) for v in obj]
        return obj

    @staticmethod
    def fromfile(path: str) -> "Config":
        return Config._wrap(load_config(path))


def _exec_config_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        code = f.read()
    ns: Dict[str, Any] = {"__file__": path, "os": os}
    exec(compile(code, path, "exec"), ns)
    return {k: v for k, v in ns.items()
            if not k.startswith("__") and k != "os" and not callable(v)}


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Dicts merge recursively; ``_delete_=True`` in the override replaces
    the base's subtree; any other value overwrites."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k == "_delete_":
            continue
        if (isinstance(v, dict) and isinstance(out.get(k), dict)
                and not v.get("_delete_", False)):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
            if isinstance(out[k], dict):
                out[k].pop("_delete_", None)
    return out


def load_config(path: str) -> Dict[str, Any]:
    """The config at ``path`` as a plain dict, its ``_base_`` files (paths
    relative to it) merged under it in order."""
    cfg = _exec_config_file(path)
    bases = cfg.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        merged = deep_merge(merged, load_config(
            os.path.join(os.path.dirname(path), b)))
    return deep_merge(merged, cfg)


def apply_cli_options(cfg: Dict, options: Optional[List[str]]) -> Dict:
    """Apply ``key.subkey=value`` overrides in place; a value that evaluates
    as a Python expression (number, tuple, bool, string in quotes,
    ``dict(...)``) is its value, anything else the raw string."""
    for opt in options or ():
        key, _, raw = opt.partition("=")
        try:
            value = eval(raw, {}, {})
        except Exception:  # not a literal: keep the text
            value = raw
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return cfg
