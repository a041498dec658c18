"""The original code's PyTorch checkpoints -> the port's ``state_dict``s, the
counterpart of the JAX package's ``utils/torch_import.py``
(``import_resnet``, ``import_selsa_checkpoint``): the same tensors as the
JAX import followed by ``jax_bridge.from_jax_variables``.

The port keeps PyTorch's layouts, so conv and linear weights pass as they
are. Two things change:

- names: the port's modules carry the flax names (``layer1_0``,
  ``downsample_conv`` / ``downsample_bn``, ``neck.conv0``,
  ``bbox_head.shared_fc0``, ``bbox_head.aggregator0``), and BN statistics
  become the FrozenBN buffers ``running_mean`` / ``running_var``
  (``num_batches_tracked`` is dropped);
- the first shared FC after RoIAlign: the original flattens a roi's
  features as (C, 7, 7), the port as (7, 7, C) (its roi features are
  [N, 7, 7, C]), so that weight's input columns are permuted from CHW to
  HWC order.

The result holds float32 CPU tensors, so ``torch.save`` of it loads with
``torch.load(..., weights_only=True)``, and ``init_model(checkpoint=...)``
takes the saved file.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

R50_STAGE_BLOCKS = (3, 4, 6, 3)
_AGGREGATOR_FCS = ("fc_embed", "ref_fc_embed", "fc", "ref_fc")


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).contiguous().clone()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _fc_chw_to_hwc(w: torch.Tensor, spatial=(7, 7)) -> torch.Tensor:
    """[out, C * H * W] (torch's flatten) -> [out, H * W * C] (the port's)."""
    out_dim, in_dim = w.shape
    h, wd = spatial
    return (w.reshape(out_dim, in_dim // (h * wd), h, wd).permute(0, 2, 3, 1)
            .reshape(out_dim, in_dim).contiguous())


def _bn(sd: Mapping, src: str, dst: str, out: Dict) -> None:
    for a, b in (("weight", "weight"), ("bias", "bias"),
                 ("running_mean", "running_mean"),
                 ("running_var", "running_var")):
        out[f"{dst}.{b}"] = _tensor(sd[f"{src}.{a}"])


def import_resnet(sd: Mapping, stage_blocks=R50_STAGE_BLOCKS,
                  prefix: str = "") -> Dict[str, torch.Tensor]:
    """A torchvision / mmdet ResNet ``state_dict`` (keys under ``prefix``)
    -> the port's ``ResNet`` state dict. Blocks absent from ``sd`` are left
    out, as in JAX; a block's ``conv3`` only where it has one."""
    out: Dict[str, torch.Tensor] = {
        "conv1.weight": _tensor(sd[prefix + "conv1.weight"])}
    _bn(sd, prefix + "bn1", "bn1", out)
    for i, nblocks in enumerate(stage_blocks):
        for j in range(nblocks):
            src = f"{prefix}layer{i + 1}.{j}."
            dst = f"layer{i + 1}_{j}."
            for k in (1, 2, 3):
                if src + f"conv{k}.weight" not in sd:
                    continue  # a BasicBlock has conv1 and conv2
                out[dst + f"conv{k}.weight"] = _tensor(
                    sd[src + f"conv{k}.weight"])
                _bn(sd, src + f"bn{k}", dst + f"bn{k}", out)
            if src + "downsample.0.weight" in sd:
                out[dst + "downsample_conv.weight"] = _tensor(
                    sd[src + "downsample.0.weight"])
                _bn(sd, src + "downsample.1", dst + "downsample_bn", out)
    return out


def import_selsa_checkpoint(sd: Mapping, num_shared_fcs: int = 2
                            ) -> Dict[str, torch.Tensor]:
    """An mmtrack SELSA checkpoint's ``state_dict`` (``detector.`` keys, or
    the detector's own) -> the port's ``SelsaDetector`` state dict. The
    aggregators come along where the checkpoint has them."""
    d = {k[len("detector."):]: v for k, v in sd.items()
         if k.startswith("detector.")} or dict(sd)
    out = {f"backbone.{k}": v
           for k, v in import_resnet(d, prefix="backbone.").items()}
    for src, dst in (("neck.convs.0.conv", "neck.conv0"),
                     ("rpn_head.rpn_conv", "rpn_head.rpn_conv"),
                     ("rpn_head.rpn_cls", "rpn_head.rpn_cls"),
                     ("rpn_head.rpn_reg", "rpn_head.rpn_reg")):
        out[f"{dst}.weight"] = _tensor(d[f"{src}.weight"])
        out[f"{dst}.bias"] = _tensor(d[f"{src}.bias"])
    bh = "roi_head.bbox_head."
    for i in range(num_shared_fcs):
        w = _tensor(d[bh + f"shared_fcs.{i}.weight"])
        out[f"bbox_head.shared_fc{i}.weight"] = (
            _fc_chw_to_hwc(w) if i == 0 else w)
        out[f"bbox_head.shared_fc{i}.bias"] = _tensor(
            d[bh + f"shared_fcs.{i}.bias"])
        agg = f"{bh}aggregator.{i}."
        if agg + "fc_embed.weight" in d:
            for name in _AGGREGATOR_FCS:
                for leaf in ("weight", "bias"):
                    out[f"bbox_head.aggregator{i}.{name}.{leaf}"] = _tensor(
                        d[f"{agg}{name}.{leaf}"])
    for name in ("fc_cls", "fc_reg"):
        for leaf in ("weight", "bias"):
            out[f"bbox_head.{name}.{leaf}"] = _tensor(d[f"{bh}{name}.{leaf}"])
    return out
