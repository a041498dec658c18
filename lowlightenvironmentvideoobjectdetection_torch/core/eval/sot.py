"""SOT one-pass evaluation (OPE): success / precision / normalized
precision, the port's copy of the JAX package's ``core/eval/sot.py``.

Parity target: mmtracking/mmtrack/core/evaluation/eval_sot_ope.py (success
AUC over IoU thresholds 0..1, precision at center-error 20px, norm precision
at normalized error 0.2).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .mean_ap import bbox_overlaps


def eval_sot_ope(
    results: Sequence[Sequence[np.ndarray]],
    annotations: Sequence[Sequence[np.ndarray]],
) -> Dict[str, float]:
    """results/annotations: per video, per frame [4] xyxy boxes."""
    all_ious: List[np.ndarray] = []
    all_err: List[np.ndarray] = []
    all_norm_err: List[np.ndarray] = []
    for res, ann in zip(results, annotations):
        res = np.asarray(res, np.float64).reshape(-1, 4)
        ann = np.asarray(ann, np.float64).reshape(-1, 4)
        ious = np.diag(bbox_overlaps(res, ann))
        all_ious.append(ious)
        rc = np.stack([(res[:, 0] + res[:, 2]) / 2, (res[:, 1] + res[:, 3]) / 2], -1)
        ac = np.stack([(ann[:, 0] + ann[:, 2]) / 2, (ann[:, 1] + ann[:, 3]) / 2], -1)
        err = np.linalg.norm(rc - ac, axis=1)
        all_err.append(err)
        wh = np.stack([ann[:, 2] - ann[:, 0], ann[:, 3] - ann[:, 1]], -1)
        norm = np.linalg.norm((rc - ac) / np.maximum(wh, 1e-6), axis=1)
        all_norm_err.append(norm)

    ious = np.concatenate(all_ious)
    err = np.concatenate(all_err)
    norm_err = np.concatenate(all_norm_err)

    # success AUC over 21 IoU thresholds
    thrs = np.linspace(0, 1, 21)
    success = np.array([(ious > t).mean() for t in thrs])
    precision = (err <= 20).mean()
    norm_precision = (norm_err <= 0.2).mean()
    return dict(
        success=float(success.mean() * 100),
        precision=float(precision * 100),
        norm_precision=float(norm_precision * 100),
    )
