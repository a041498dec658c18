"""JAX (flax) variables -> port ``state_dict``.

Takes the SELSA variable tree as nested dicts of numpy arrays
(``{"params": ..., "batch_stats": ...}``, e.g. ``jax.tree.map(np.asarray,
variables)``) and returns a ``state_dict`` for ``SelsaDetector``. Module
names match the flax names, so a leaf's key is its path joined by dots with
the leaf renamed:

- conv ``kernel`` [kh, kw, in, out] -> ``weight`` [out, in, kh, kw];
- dense ``kernel`` [in, out] -> ``weight`` [out, in] (``shared_fc0``'s
  rows stay in the (7, 7, C) order of the [N, 7, 7, C] roi features);
- ``bias`` -> ``bias``; FrozenBN ``scale`` -> ``weight``;
- ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.

Any other collection or leaf raises. Needs numpy only.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for coll, tree in variables.items():
        if coll == "params":
            names = _PARAM_LEAVES
        elif coll == "batch_stats":
            names = _STAT_LEAVES
        else:
            raise KeyError(f"unknown variable collection {coll!r}")
        for path, leaf in _walk(tree):
            *mods, leaf_name = path
            if leaf_name not in names or not mods:
                raise KeyError(f"unconsumed leaf {coll}/{'/'.join(path)}")
            a = np.asarray(leaf, dtype=np.float32)
            if leaf_name == "kernel":
                if a.ndim == 4:
                    a = a.transpose(3, 2, 0, 1)
                elif a.ndim == 2:
                    a = a.T
                else:
                    raise ValueError(f"kernel {'/'.join(path)} has rank "
                                     f"{a.ndim}")
            key = ".".join(mods + [names[leaf_name]])
            if key in out:
                raise KeyError(f"two leaves map to {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out
