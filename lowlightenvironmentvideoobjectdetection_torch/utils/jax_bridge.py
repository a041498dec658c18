"""JAX (flax) variables -> port ``state_dict``.

Takes the SELSA (or darkfarm, FastDVD, FGFA or DFF) variable tree as nested
dicts of numpy arrays (``{"params": ..., "batch_stats": ...}``, e.g.
``jax.tree.map(np.asarray, variables)``) and returns a ``state_dict`` for
``SelsaDetector`` (or ``SelsaDarkfarmDetector``, whose ``selsa`` and
``cleaner.resnet`` modules are named as the flax ones,
``FastDVDSelsaDetector``, ``denoiser`` and ``selsa``, or ``FGFA`` and
``DFF``, ``detector``, ``motion`` and ``aggregator``; for tracking,
``FasterRCNN``, ``BaseReID`` (``backbone``, ``head.fc0``,
``head.fc_out``, with a classifier ``head.classifier``) and ``SiamRPN``,
whose flax ``LayerNorm`` scale and bias become ``weight`` and ``bias`` and
whose root parameters ``cls_weights`` / ``reg_weights`` keep their names;
for the image detectors ``FPNFasterRCNN`` (``neck.lateral{i}``,
``neck.fpn_conv{i}``, ``rpn_head``, ``bbox_head``; GA-RPN's
``rpn_head.feature_adaption`` (a DCN ``kernel`` [3, 3, in, out], as any
conv kernel), ``offset_conv``, ``conv_loc``, ``conv_shape``,
``conv_cls``, ``conv_reg``; GRoIE's ``roi_extractor.pre_module`` and
``post_module.{query,value,proj}_conv``, ``appr_geom_fc_{x,y}`` (dense);
Libra's ``bfp.refine.{theta,phi,g,conv_out}``), ``RetinaNet``
(``neck.extra_conv{k}``, ``bbox_head.{cls,reg}_conv{i}``,
``bbox_head.retina_cls`` / ``retina_reg``), ``GARetinaNet`` (the same
and ``bbox_head.feature_adaption_{cls,reg}``, ``conv_loc``,
``conv_shape``), ``FastRCNN`` / ``RPN`` (``base.*``, the wrapped
Faster R-CNN) and the dense heads FCOS / NAS-FCOS, ATSS / PAA, GFL and
VFNet (``bbox_head.{cls,reg}_conv{i}``, their output convs, each level's
``Scale`` ``scale{li}`` / ``scale_refine{li}``, whose 0-d ``scale``
becomes ``weight``, VFNet's ``reg_refine_dconv`` and ``cls_dconv``, DCN
``kernel`` leaves at the module's root), FSAF, FoveaBox, SABL and
RepPoints (``reppoints_{cls,pts_refine}_conv``: DCN ``kernel`` leaves at
the module's root), and NAS-FPN RetinaNet (``neck.adapt{i}``,
``neck.s{s}_{cell}.conv``; ``RetinaSepBNHead``'s per-level affines
``bbox_head.{cls,reg}_bn{level}_{i}_scale`` / ``_bias`` at the head's
root, which keep their names, as a ``MomentTransfer``'s
``moment_transfer`` does), and the two-stage families on the DC5 trunk
(Cascade RPN's raw ``crpn.s2_weight`` and the trident blocks' shared
``conv{1,2,3}_kernel`` / ``ds_kernel``, HWIO to OIHW under their own
names; Grid R-CNN's grouped 4x4 ``deconv{1,2}_w``, re-laid and flipped
for ``conv_transpose2d``; its GroupNorms' ``scale`` / ``bias``)). Module
names match
the flax names, so a leaf's key is its path joined by dots with the leaf
renamed:

- conv ``kernel`` [kh, kw, in, out] -> ``weight`` [out, in, kh, kw];
- a ``ConvTranspose`` ``kernel`` [kh, kw, in, out] (where ``model``, the
  port module the state dict is for, has an ``nn.ConvTranspose2d``: the
  denoisers' up-convolutions, FlowNetSimple's ``upsample_flow*`` and
  ``deconv*``) -> ``weight`` [in, out, kh, kw] flipped in
  both spatial axes: flax's transposed conv (``transpose_kernel=False``)
  does not flip its kernel, PyTorch's (the adjoint of a convolution) does;
- dense ``kernel`` [in, out] -> ``weight`` [out, in] (``shared_fc0``'s
  rows stay in the (7, 7, C) order of the [N, 7, 7, C] roi features);
- ``bias`` -> ``bias``; FrozenBN ``scale`` -> ``weight``;
- a ``ModulatedDCNPack``'s raw ``weight`` [3, 3, in, out] (a ``weight``
  beside a ``conv_offset``: the aggregators' and plugins' ``dcn_pack``,
  the ConvLSTM's ``dcn_f`` / ``dcn_b``) -> ``weight`` [out, in, 3, 3];
- ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.

Any other collection or leaf raises. ``grads_from_jax`` maps a JAX gradient
tree (the structure of ``params``) the same way, so gradients compare leaf
by leaf with the port's ``.grad``. ``video_state_from_jax`` turns a JAX
``VideoState`` (single or batched) into the port's, ``fgfa_state_from_jax``
and ``dff_state_from_jax`` an ``FGFAState`` and a ``DFFState`` (their
int32 counters become host ints). Needs numpy only.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from ..models.vid.fgfa import DFFState, FGFAState
from ..models.vid.selsa import VideoState

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
# parameters that keep their flax names: SiamRPN's level weights at the
# root, RetinaSepBNHead's per-level affines, RepPoints' moment transfer
_OWN_NAMES = re.compile(r"cls_weights|reg_weights|(cls|reg)_bn\d+_\d+_"
                        r"(scale|bias)|moment_transfer|s2_bias|deconv\d_b")
# raw HWIO conv kernels that keep their names, as OIHW: Cascade RPN's DCN
# weight, the trident blocks' shared kernels
_RAW_KERNELS = re.compile(r"s2_weight|conv\d_kernel|ds_kernel")
# Grid R-CNN's grouped transposed convs: HWIO [4, 4, in / 9, out] of a
# conv_general_dilated with lhs_dilation 2 (``_gdeconv``)
_GROUPED_DECONVS = re.compile(r"deconv\d_w")
GRID_GROUPS = 9


def _grouped_deconv(a: np.ndarray, groups: int = GRID_GROUPS) -> np.ndarray:
    """The JAX ``_gdeconv`` kernel [kh, kw, in / g, out] -> the
    ``conv_transpose2d(stride=2, padding=1, groups=g)`` weight [in, out /
    g, kh, kw]: the same map with the taps flipped in both axes (the
    dilated convolution correlates, the transposed one scatters)."""
    kh, kw, cin_g, cout = a.shape
    a = a[::-1, ::-1].reshape(kh, kw, cin_g, groups, cout // groups)
    return a.transpose(3, 2, 4, 0, 1).reshape(groups * cin_g, cout // groups,
                                              kh, kw)
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _node(tree: Mapping, path) -> Mapping:
    for k in path:
        tree = tree[k]
    return tree


def from_jax_variables(variables: Mapping,
                       model: Optional[nn.Module] = None
                       ) -> Dict[str, torch.Tensor]:
    transposed = set() if model is None else {
        name for name, m in model.named_modules()
        if isinstance(m, nn.ConvTranspose2d)}
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
            a = np.asarray(leaf, dtype=np.float32)
            if (coll == "params" and leaf_name == "weight" and mods
                    and "conv_offset" in _node(tree, mods) and a.ndim == 4
                    and a.shape[:2] == (3, 3)):
                a = a.transpose(3, 2, 0, 1)  # the DCN's raw [3, 3, in, out]
            elif coll == "params" and _OWN_NAMES.fullmatch(leaf_name):
                pass
            elif (coll == "params" and _RAW_KERNELS.fullmatch(leaf_name)
                  and a.ndim == 4):
                a = a.transpose(3, 2, 0, 1)
            elif (coll == "params" and _GROUPED_DECONVS.fullmatch(leaf_name)
                  and a.ndim == 4):
                a = _grouped_deconv(a)
            elif leaf_name not in names or not mods:
                raise KeyError(f"unconsumed leaf {coll}/{'/'.join(path)}")
            elif leaf_name == "kernel":
                if a.ndim == 4 and ".".join(mods) in transposed:
                    a = a[::-1, ::-1].transpose(2, 3, 0, 1)
                elif a.ndim == 4:
                    a = a.transpose(3, 2, 0, 1)
                elif a.ndim == 2:
                    a = a.T
                else:
                    raise ValueError(f"kernel {'/'.join(path)} has rank "
                                     f"{a.ndim}")
            key = ".".join(mods + [names.get(leaf_name, leaf_name)])
            if key in out:
                raise KeyError(f"two leaves map to {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def grads_from_jax(grads: Mapping, model: Optional[nn.Module] = None
                   ) -> Dict[str, torch.Tensor]:
    """A gradient tree with the structure of the ``params`` collection ->
    port parameter name -> gradient in the port's layout (``model`` as in
    ``from_jax_variables``)."""
    return from_jax_variables({"params": grads}, model)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes, which torch cannot read
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def video_state_from_jax(state) -> VideoState:
    """A JAX ``VideoState`` as numpy arrays (``ref_kv``, ``ref_valid``,
    ``next_slot``, ``ref_maps``; e.g. ``jax.tree.map(np.asarray, state)``)
    -> the port's ``VideoState`` on the CPU, in the same layout. A 0-d
    ``next_slot`` gives a single-stream state (an int slot), a [S] one a
    batched state (an int64 tensor). The TemporalRoIAlign maps stay NHWC,
    [R, h, w, C] or [S, R, h, w, C], or None."""
    slot = np.asarray(state.next_slot)
    kv = tuple((_tensor(k), _tensor(v)) for k, v in state.ref_kv)
    valid = _tensor(state.ref_valid).bool()
    maps = getattr(state, "ref_maps", None)
    maps = None if maps is None else _tensor(maps)
    if slot.ndim == 0:
        return VideoState(kv, valid, int(slot), maps)
    return VideoState(kv, valid, torch.from_numpy(slot.astype(np.int64)),
                      maps)


def fgfa_state_from_jax(state) -> FGFAState:
    """A JAX ``FGFAState`` as numpy arrays -> the port's, on the CPU."""
    return FGFAState(_tensor(state.ref_imgs), _tensor(state.ref_feats),
                     int(np.asarray(state.next_slot)))


def dff_state_from_jax(state) -> DFFState:
    """A JAX ``DFFState`` as numpy arrays -> the port's, on the CPU."""
    return DFFState(_tensor(state.key_img), _tensor(state.key_feat),
                    int(np.asarray(state.frames_since_key)))
