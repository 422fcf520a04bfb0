"""Evaluation metrics, numerically matching the reference definitions.

mae is the L1 metric of the ZINC regression reference (LPE/train/
metrics.py:11-14) and accuracy_graph the plain argmax accuracy of the TU
graph classifiers (LPE/train/metrics.py:16-19). accuracy_sbm is the
class-balanced accuracy of the SBM node-classification reference
(LPE/train/metrics.py:34-51): per-class recall from the confusion matrix,
averaged over the classes that appear in the targets or the predictions.
roc_auc and average_precision are the OGB Evaluator's molecular metrics
(rank-based AUC with midrank ties; the precision-recall step integral with
tied thresholds collapsed), multitask_mean their mean over the tasks with
both classes labelled. numpy only, as in the JAX package.
"""

from __future__ import annotations

import numpy as np


def mae(pred, target) -> float:
    """Mean absolute error."""
    return float(np.abs(np.asarray(pred) - np.asarray(target)).mean())


def accuracy_graph(logits, labels) -> float:
    """Plain argmax accuracy."""
    pred = np.argmax(np.asarray(logits), axis=-1)
    return float((pred == np.asarray(labels)).mean())


def accuracy_sbm(logits, labels, mask=None) -> float:
    """Class-balanced node accuracy.

    Args:
      logits: [..., C]; labels: [...] ints (padded entries < 0 ignored);
      mask: optional bool validity mask matching labels.
    """
    pred = np.argmax(np.asarray(logits), axis=-1).ravel()
    lab = np.asarray(labels).ravel()
    valid = lab >= 0
    if mask is not None:
        valid &= np.asarray(mask).ravel()
    pred, lab = pred[valid], lab[valid]
    # the confusion matrix spans classes present in targets OR predictions:
    # a class predicted but never true adds 0 to the numerator and still
    # widens the denominator
    present = np.union1d(np.unique(lab), np.unique(pred))
    recalls = 0.0
    for c in present:
        in_c = lab == c
        if in_c.sum() > 0:
            recalls += (pred[in_c] == c).mean()
    return float(recalls / max(len(present), 1))


def binary_f1(pred, target) -> float:
    """F1 of boolean predictions against boolean targets (0 where there is
    no positive in either)."""
    pred = np.asarray(pred).astype(bool).ravel()
    target = np.asarray(target).astype(bool).ravel()
    tp = (pred & target).sum()
    fp = (pred & ~target).sum()
    fn = (~pred & target).sum()
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else 0.0


def _labelled(scores, labels):
    """Scores (float64) and labels of the entries with a score that is not
    NaN and a label >= 0."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel()
    keep = ~np.isnan(scores) & (labels >= 0)
    return scores[keep], labels[keep]


def roc_auc(scores, labels) -> float:
    """Binary ROC-AUC by the rank statistic, tied scores at their midrank;
    NaN without both classes."""
    scores, labels = _labelled(scores, labels)
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    # the last index of each run of equal scores, and each run's midrank
    ends = np.flatnonzero(np.r_[sorted_scores[1:] != sorted_scores[:-1],
                                True])
    starts = np.r_[0, ends[:-1] + 1]
    ranks = np.empty_like(scores)
    ranks[order] = np.repeat((starts + ends) / 2.0 + 1.0, ends - starts + 1)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def average_precision(scores, labels) -> float:
    """AP = sum_k (R_k - R_{k-1}) P_k over the descending score thresholds,
    tied scores one threshold (so the result does not depend on the input
    order); NaN without a positive."""
    scores, labels = _labelled(scores, labels)
    n_pos = int((labels == 1).sum())
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    s = scores[order]
    tp = np.cumsum(labels[order] == 1, dtype=np.float64)
    counts = np.arange(1, len(s) + 1, dtype=np.float64)
    boundary = np.flatnonzero(np.r_[s[1:] != s[:-1], True])
    tp_t = tp[boundary]
    d_rec = np.diff(np.r_[0.0, tp_t / n_pos])
    return float((tp_t / counts[boundary] * d_rec).sum())


def multitask_mean(metric_fn, scores, labels) -> float:
    """`metric_fn` per task (last axis), the mean over the tasks whose
    labelled entries (not NaN) hold both classes; NaN if none does."""
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    vals = []
    for t in range(scores.shape[-1]):
        lab = labels[..., t]
        valid = ~np.isnan(lab.astype(np.float64))
        lab_v = lab[valid]
        if (lab_v == 1).sum() == 0 or (lab_v == 0).sum() == 0:
            continue
        vals.append(metric_fn(scores[..., t][valid], lab_v))
    return float(np.mean(vals)) if vals else float("nan")
