"""Detection losses, the counterpart of the JAX package's ``core/losses.py``
(``smooth_l1_loss``, ``l1_loss``, ``mse_loss``, ``softmax_cross_entropy``,
``binary_cross_entropy``, ``sigmoid_focal_loss``, ``bounded_iou_loss``,
``balanced_l1_loss``, ``accuracy``):
per-element ``weight`` and an ``avg_factor`` (clamped to at least 1), so
masked fixed-size samples reduce as mmdet's dynamic lists do; without
either, a plain mean.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _reduce(loss, weight=None, avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / torch.as_tensor(avg_factor, dtype=loss.dtype,
                                        device=loss.device).clamp_min(1.0)


def smooth_l1_loss(pred, target, beta=1.0, weight=None, avg_factor=None):
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return _reduce(loss, weight, avg_factor)


def l1_loss(pred, target, weight=None, avg_factor=None):
    return _reduce((pred - target).abs(), weight, avg_factor)


def mse_loss(pred, target, weight=None, avg_factor=None):
    return _reduce((pred - target).square(), weight, avg_factor)


def softmax_cross_entropy(logits, labels, weight=None, avg_factor=None):
    """Cross entropy with integer labels, clamped into range; padded rows
    carry weight 0."""
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    logp = F.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return _reduce(loss, weight, avg_factor)


def binary_cross_entropy(logits, labels, weight=None, avg_factor=None):
    """Sigmoid cross entropy with {0, 1} labels, in the stable form."""
    labels = labels.to(logits.dtype)
    loss = (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))
    return _reduce(loss, weight, avg_factor)


def sigmoid_focal_loss(logits, labels, gamma=2.0, alpha=0.25, weight=None,
                       avg_factor=None):
    """Per-class sigmoid focal loss with one-hot (float) ``labels`` of the
    logits' shape: alpha_t (1 - p_t)^gamma times the stable sigmoid cross
    entropy."""
    p = torch.sigmoid(logits)
    ce = (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * labels + (1 - p) * (1 - labels)
    alpha_t = alpha * labels + (1 - alpha) * (1 - labels)
    return _reduce(alpha_t * (1 - p_t) ** gamma * ce, weight, avg_factor)


def bounded_iou_loss(pred, target, weight=None, avg_factor=None, beta=0.2,
                     eps=1e-3):
    """mmdet's BoundedIoULoss: a smooth L1 (``beta``) on the four bounded
    IoU deficits of the centre offsets and the sizes of boxes [N, 4],
    summed a box; the target carries no gradient."""
    pcx = (pred[:, 0] + pred[:, 2]) * 0.5
    pcy = (pred[:, 1] + pred[:, 3]) * 0.5
    pw = pred[:, 2] - pred[:, 0] + eps
    ph = pred[:, 3] - pred[:, 1] + eps
    target = target.detach()
    tcx = (target[:, 0] + target[:, 2]) * 0.5
    tcy = (target[:, 1] + target[:, 3]) * 0.5
    tw = target[:, 2] - target[:, 0] + eps
    th = target[:, 3] - target[:, 1] + eps
    dx, dy = (tcx - pcx).abs(), (tcy - pcy).abs()
    comps = torch.stack([
        1.0 - ((tw - 2.0 * dx) / (tw + 2.0 * dx)).clamp_min(0.0),
        1.0 - ((th - 2.0 * dy) / (th + 2.0 * dy)).clamp_min(0.0),
        1.0 - torch.minimum(tw / pw, pw / tw),
        1.0 - torch.minimum(th / ph, ph / th)], dim=-1)
    loss = torch.where(comps < beta, 0.5 * comps * comps / beta,
                       comps - 0.5 * beta).sum(-1)
    return _reduce(loss, weight, avg_factor)


def balanced_l1_loss(pred, target, weight=None, avg_factor=None, beta=1.0,
                     alpha=0.5, gamma=1.5):
    """Libra R-CNN's balanced L1: alpha / b (b |d| + 1) log(b |d| / beta +
    1) - alpha |d| below ``beta``, gamma |d| + gamma / b - alpha beta
    above, with b = e^(gamma / alpha) - 1."""
    diff = (pred - target).abs()
    b = math.e ** (gamma / alpha) - 1
    loss = torch.where(
        diff < beta,
        alpha / b * (b * diff + 1) * torch.log(b * diff / beta + 1)
        - alpha * diff,
        gamma * diff + gamma / b - alpha * beta)
    return _reduce(loss, weight, avg_factor)


def accuracy(logits, labels, mask=None):
    correct = (torch.argmax(logits, dim=-1) == labels).float()
    if mask is not None:
        return (correct * mask).sum() / mask.sum().clamp_min(1.0)
    return correct.mean()
