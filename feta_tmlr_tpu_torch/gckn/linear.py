"""The L-BFGS-fit linear classifier on GCKN features.

The counterpart of the JAX package's `gckn/linear.py` (the reference's
`Linear` head, gckn/layers.py:213-302): a linear model fit by scipy's
L-BFGS-B on the sum-reduced loss plus the penalty 0.5 * alpha * ||W||^2
(the kernel only), with sklearn's decision_function / predict /
predict_proba. The objective and its gradient are one float64 torch
evaluation on the CPU (the problem is pooled graph features by classes:
small, and scipy calls it once an iteration); the losses are
`train/losses.py`'s, the reference's {'ce', 'hinge'}.
"""

from __future__ import annotations

import numpy as np
import torch

from feta_tmlr_tpu_torch.train.losses import cross_entropy, hinge_loss


def _sum_loss(kind: str, logits, y, n_classes: int):
    if kind == "ce":
        if logits.shape[-1] == 1:
            # binary BCE with logits (the reference's default criterion)
            yf = y.to(logits.dtype)
            z = logits[..., 0]
            per = torch.clamp(z, min=0) - z * yf + torch.log1p(
                torch.exp(-torch.abs(z)))
            return per.sum()
        # the losses are means over the batch; the reference sums
        # (layers.py:229-230), which sets alpha's scale
        return cross_entropy(logits, y, n_classes) * y.shape[0]
    if kind == "hinge":
        return hinge_loss(logits, y, n_classes) * y.shape[0]
    raise ValueError(f"unknown loss {kind!r} (choose 'ce' or 'hinge')")


class LinearClassifier:
    """Linear head fit by L-BFGS; the weights are an [out, in] matrix and
    an [out] bias (float32)."""

    def __init__(self, in_features: int, out_features: int,
                 alpha: float = 0.0, fit_bias: bool = True,
                 loss: str = "ce"):
        self.in_features = in_features
        self.out_features = out_features
        self.alpha = float(alpha)
        self.fit_bias = fit_bias
        self.loss = loss
        self.weight = np.zeros((out_features, in_features), np.float32)
        self.bias = np.zeros((out_features,), np.float32) if fit_bias \
            else None

    def _objective(self, x, y):
        d = self.in_features

        def value_grad(wflat64):
            w = torch.tensor(wflat64, dtype=torch.float64,
                             requires_grad=True)
            wm = w.reshape(self.out_features, -1)
            kernel, b = (wm[:, :d], wm[:, d]) if self.fit_bias else (wm, 0.0)
            logits = x @ kernel.T + b
            loss = _sum_loss(self.loss, logits, y, self.out_features)
            # the penalty on the kernel only (layers.py:253)
            loss = loss + 0.5 * self.alpha * torch.sum(kernel ** 2)
            (g,) = torch.autograd.grad(loss, w)
            return loss.item(), g.numpy().astype(np.float64)

        return value_grad

    def fit(self, x, y, max_iter: int = 1000):
        from scipy import optimize

        x = torch.as_tensor(np.asarray(x, np.float32), dtype=torch.float64)
        y = torch.as_tensor(np.asarray(y))
        w0 = self.weight
        if self.fit_bias:
            w0 = np.concatenate([w0, self.bias[:, None]], axis=1)
        w, _, _ = optimize.fmin_l_bfgs_b(
            self._objective(x, y), w0.astype(np.float64).ravel(),
            maxiter=max_iter)
        w = w.reshape(self.out_features, -1).astype(np.float32)
        if self.fit_bias:
            self.weight, self.bias = w[:, :-1], w[:, -1]
        else:
            self.weight = w
        return self

    def decision_function(self, x):
        out = np.asarray(x, np.float32) @ self.weight.T
        if self.fit_bias:
            out = out + self.bias
        return out

    def predict(self, x):
        scores = self.decision_function(x)
        if self.out_features == 1:
            return (scores[:, 0] > 0).astype(np.int64)
        return scores.argmax(-1)

    def predict_proba(self, x):
        scores = self.decision_function(x)
        if self.out_features == 1:
            p = 1.0 / (1.0 + np.exp(-scores[:, 0]))
            return np.stack([1 - p, p], axis=-1)
        e = np.exp(scores - scores.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    @property
    def coef_(self):
        return self.weight

    @property
    def intercept_(self):
        return self.bias
