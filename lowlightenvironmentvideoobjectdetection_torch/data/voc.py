"""Pascal VOC (XML-style) detection datasets, the counterpart of the JAX
package's ``data/voc.py`` (mmdet's ``datasets/xml_style.py`` and
``voc.py``): ``XMLDataset`` reads an image-set txt of ids and, per id,
``<img_prefix>/Annotations/<id>.xml`` (the image is
``JPEGImages/<id>.jpg`` under ``img_prefix``); ``VOCDataset`` has the 20
VOC classes and infers the year from ``img_prefix`` (``VOC2007`` or
``VOC2012``; 0 otherwise, where mmdet raises).

An object of an unknown class is skipped; a ``difficult`` one, or in
training one whose side is below ``min_size``, goes to ``bboxes_ignore``.
Boxes are VOC's 1-based inclusive pixel coordinates less 1 (mmdet's
``xml_style.py``). ``evaluate`` gives ``eval_map`` (``core/eval/
mean_ap.py``) at ``iou_thr`` with the 11-point AP for 2007 and the area
AP otherwise. The XML is read with the standard library's
``xml.etree``. Registered in ``data/datasets.py``'s ``DATASETS``; samples
are ``dict(img_info, ann)`` as ``CocoDataset``'s.
"""

from __future__ import annotations

import os
import random
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np
from torch.utils.data import Dataset

from ..core.eval.mean_ap import eval_map

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
    "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class XMLDataset(Dataset):
    CLASSES: Sequence[str] = ()
    is_video = False
    year = 0  # VOCDataset's from its prefix: 2007 takes the 11-point AP

    def __init__(self, ann_file: str, img_prefix: str = "",
                 min_size: Optional[int] = None, test_mode: bool = False,
                 classes: Optional[Sequence[str]] = None,
                 ref_img_sampler: Optional[dict] = None):
        if ref_img_sampler:
            raise ValueError(f"{type(self).__name__} is an image dataset: it "
                             f"samples no reference frames")
        if classes is not None:
            self.CLASSES = tuple(classes)
        if not self.CLASSES:
            raise ValueError("CLASSES in XMLDataset can not be empty")
        self.img_prefix = img_prefix
        self.min_size = min_size
        self.test_mode = test_mode
        self.cat2label = {c: i for i, c in enumerate(self.CLASSES)}
        with open(ann_file) as f:
            ids = [line.strip() for line in f if line.strip()]
        self.data_infos: List[dict] = []
        for img_id in ids:
            filename = os.path.join("JPEGImages", f"{img_id}.jpg")
            width = height = 0
            path = self._xml_path(img_id)
            if os.path.exists(path):
                size = ET.parse(path).getroot().find("size")
                if size is not None:
                    width = int(size.find("width").text)
                    height = int(size.find("height").text)
            self.data_infos.append(dict(id=img_id, filename=filename,
                                        file_name=filename, width=width,
                                        height=height))

    def _xml_path(self, img_id: str) -> str:
        return os.path.join(self.img_prefix, "Annotations", f"{img_id}.xml")

    def __len__(self):
        return len(self.data_infos)

    def get_ann_info(self, img_info: dict) -> Dict[str, np.ndarray]:
        boxes, labels, boxes_ig, labels_ig = [], [], [], []
        root = ET.parse(self._xml_path(img_info["id"])).getroot()
        for obj in root.findall("object"):
            name = obj.find("name").text
            if name not in self.cat2label:
                continue
            label = self.cat2label[name]
            difficult = obj.find("difficult")
            difficult = 0 if difficult is None else int(difficult.text)
            bnd = obj.find("bndbox")
            bbox = [int(float(bnd.find(k).text)) - 1
                    for k in ("xmin", "ymin", "xmax", "ymax")]
            small = (self.min_size is not None and not self.test_mode and (
                bbox[2] - bbox[0] < self.min_size
                or bbox[3] - bbox[1] < self.min_size))
            if difficult or small:
                boxes_ig.append(bbox)
                labels_ig.append(label)
            else:
                boxes.append(bbox)
                labels.append(label)
        return dict(
            bboxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            bboxes_ignore=np.asarray(boxes_ig, np.float32).reshape(-1, 4),
            labels_ignore=np.asarray(labels_ig, np.int64))

    def get_sample(self, idx: int, rng: Optional[random.Random] = None
                   ) -> dict:
        info = dict(self.data_infos[idx])
        return dict(img_info=info, ann=self.get_ann_info(info))

    def __getitem__(self, idx: int) -> dict:
        return self.get_sample(idx)

    def evaluate(self, det_lists, iou_thr: float = 0.5) -> dict:
        """VOC mAP of per-image, per-class detections in dataset order."""
        annotations = [self.get_ann_info(d) for d in self.data_infos]
        mode = "11points" if self.year == 2007 else "area"
        mean_ap, results = eval_map(det_lists, annotations, iou_thr=iou_thr,
                                    mode=mode)
        return {"mAP": mean_ap, "per_class": results}


class VOCDataset(XMLDataset):
    CLASSES = VOC_CLASSES

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if "VOC2007" in self.img_prefix:
            self.year = 2007
        elif "VOC2012" in self.img_prefix:
            self.year = 2012
        else:
            self.year = 0
