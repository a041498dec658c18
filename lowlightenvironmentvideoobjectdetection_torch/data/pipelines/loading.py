"""Pipeline composition and the loading steps, the counterpart of the JAX
package's ``Compose``, ``_SeqMixin``, ``LoadImageFromFile``,
``LoadMultiImagesFromFile``, ``LoadImagePairsFromFile``,
``LoadMultiImagePairsFromFile`` (and the original's misspelled
``LoadMutiImagePairsFromFile``) and ``SeqLoadAnnotations``
(``data/pipelines/transforms.py:41-180``).

A pipeline splits in two. The loading steps run on the host (in a
``DataLoader`` worker): they read frames with ``data/image_io.py`` and give
numpy arrays. ``to_device`` moves a clip's images and annotations to
tensors on a device, and every later step works on tensors where they
lie. Every step is called as ``step(results, rng)``, ``results`` one
frame's dict or a clip's list of them and ``rng`` the sample's
``random.Random``, which the steps with random draws use in the JAX
package's order.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ...registry import PIPELINES
from ...utils.device import resolve_device
from ..image_io import imread


class _SeqMixin:
    """Applies ``transform`` to one frame's dict or to each of a clip's."""

    def __call__(self, results, rng=None):
        if isinstance(results, dict):
            return self.transform(results)
        return [self.transform(r) for r in results]

    def transform(self, results):  # pragma: no cover - overridden
        raise NotImplementedError


def _frames(results):
    return [results] if isinstance(results, dict) else results


def to_device(results, device):
    """Move each frame's image fields, boxes, labels and instance ids to
    tensors on ``device`` (in place; returns ``results``)."""
    for r in _frames(results):
        for key in (list(r.get("img_fields", ["img"]))
                    + list(r.get("bbox_fields", []))
                    + ["gt_labels", "gt_instance_ids"]):
            if key in r:
                r[key] = torch.as_tensor(r[key]).to(device, non_blocking=True)
    return results


class Compose:
    """A chain of steps, each a callable or a ``dict(type=...)`` built from
    ``PIPELINES``. ``host`` runs the leading loading steps,
    ``device_stage`` the rest on tensors; a call runs both, moving the clip
    to ``device`` in between: the card when None (raising without one),
    or the device given, ``"cpu"`` for the CPU."""

    def __init__(self, transforms: Sequence, device=None):
        steps = []
        for t in transforms:
            if isinstance(t, dict):
                cfg = dict(t)
                t = PIPELINES.get(cfg.pop("type"))(**cfg)
            steps.append(t)
        n = 0
        while n < len(steps) and getattr(steps[n], "on_host", False):
            n += 1
        if any(getattr(t, "on_host", False) for t in steps[n:]):
            raise ValueError("loading steps must lead the pipeline")
        self.host_steps, self.device_steps = steps[:n], steps[n:]
        self.device = resolve_device(device)

    @staticmethod
    def _run(steps, results, rng):
        for t in steps:
            results = t(results, rng)
            if results is None:
                return None
        return results

    def host(self, results, rng):
        return self._run(self.host_steps, results, rng)

    def device_stage(self, results, rng):
        return self._run(self.device_steps, results, rng)

    def __call__(self, results, rng=None):
        results = self.host(results, rng)
        if results is None:
            return None
        return self.device_stage(to_device(results, self.device), rng)


@PIPELINES.register("LoadImageFromFile")
class LoadImageFromFile(_SeqMixin):
    """The frame at ``img_prefix / filename``, PNG or JPEG (told apart by
    the file's signature, ``data/image_io.imread``), as BGR uint8
    [H, W, 3], cv2's pixels."""

    on_host = True

    def __init__(self, to_float32: bool = False):
        self.to_float32 = to_float32

    @staticmethod
    def path(results):
        info = results["img_info"]
        return os.path.join(results.get("img_prefix", ""),
                            info.get("filename") or info["file_name"])

    def load(self, path):
        return imread(path)

    def transform(self, results):
        img = self.load(self.path(results))
        if self.to_float32:
            img = img.astype(np.float32)
        results["img"] = img
        results["img_shape"] = img.shape[:2]
        results["ori_shape"] = img.shape[:2]
        results.setdefault("img_fields", ["img"])
        return results


@PIPELINES.register("LoadMultiImagesFromFile")
class LoadMultiImagesFromFile(LoadImageFromFile):
    pass


def gt_sibling_path(path: str) -> str:
    """The original's path surgery: the clean frame of
    ``<video>/<noisy dir>/<name>`` is ``<video>/GT/<name>`` (DarkFarm's
    ``<video>/low/<name>.JPG`` -> ``<video>/GT/<name>.JPG``)."""
    d, fname = os.path.split(path)
    return os.path.join(os.path.dirname(d), "GT", fname)


@PIPELINES.register("LoadImagePairsFromFile")
class LoadImagePairsFromFile(LoadImageFromFile):
    """The noisy frame and its clean ``GT/`` sibling (PNG or JPEG, as
    ``LoadImageFromFile`` reads them), concatenated on the channels: BGR
    uint8 [H, W, 6], noisy first."""

    def load(self, path):
        return np.concatenate([imread(path), imread(gt_sibling_path(path))],
                              axis=-1)


@PIPELINES.register("LoadMutiImagePairsFromFile")  # the original's spelling
@PIPELINES.register("LoadMultiImagePairsFromFile")
class LoadMultiImagePairsFromFile(LoadImagePairsFromFile):
    pass


@PIPELINES.register("SeqLoadAnnotations")
@PIPELINES.register("LoadAnnotations")
class SeqLoadAnnotations(_SeqMixin):
    """The dataset's parsed annotations as ``gt_bboxes`` (f32 [n, 4]),
    ``gt_labels`` and ``gt_instance_ids`` (int64)."""

    on_host = True

    def __init__(self, with_bbox: bool = True, with_ins_id: bool = True):
        self.with_bbox = with_bbox
        self.with_ins_id = with_ins_id

    def transform(self, results):
        ann = results.get("ann", {})
        if self.with_bbox:
            results["gt_bboxes"] = np.asarray(
                ann.get("bboxes", np.zeros((0, 4))), np.float32)
            results.setdefault("bbox_fields", []).append("gt_bboxes")
            results["gt_labels"] = np.asarray(ann.get("labels", []),
                                              np.int64)
        if self.with_ins_id:
            results["gt_instance_ids"] = np.asarray(
                ann.get("instance_ids", []), np.int64)
        return results
