"""Evaluation metrics, numerically matching the reference definitions.

mae is the L1 metric of the ZINC regression reference (LPE/train/
metrics.py:11-14). accuracy_sbm is the class-balanced accuracy of the SBM node-classification
reference (LPE/train/metrics.py:34-51): per-class recall from the
confusion matrix, averaged over the classes that appear in the targets or
the predictions. numpy only, as in the JAX package.
"""

from __future__ import annotations

import numpy as np


def mae(pred, target) -> float:
    """Mean absolute error."""
    return float(np.abs(np.asarray(pred) - np.asarray(target)).mean())


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
