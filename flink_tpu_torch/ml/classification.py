"""Classification (port of ``flink_tpu/ml/classification.py``; FlinkML's
linear soft-margin SVM and exact k-nearest neighbours).

- ``SVM``: hinge-loss subgradient descent with the Pegasos step
  schedule, full batch, a loop of GEMVs as torch ops on the card (the
  reference's ``fori_loop`` of matmuls, which XLA computes outside any
  kernel of its own);
- ``KNN``: the all-pairs products ``Q X^T`` are one float32 GEMM
  (``torch.matmul``; ``torch.backends.cuda.matmul.allow_tf32`` stays
  off, its default), and the distances and the k smallest per query
  are the ``knn_topk`` kernel, ties to the lower index as ``lax.top_k``
  breaks them.

Fitted state is host numpy as in the reference (``params_from_numpy``
sets it); ``decision_function`` and ``predict`` of the SVM are host
numpy too.  ``fit`` and ``kneighbors`` run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.kernels import knn_topk
from flink_tpu_torch.ml.pipeline import Predictor


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)


class SVM(Predictor):
    """Linear soft-margin SVM; labels in {-1, +1} (ref: FlinkML
    classification/SVM.scala: regularization constant, iterations,
    stepsize)."""

    fitted_params = ("weights", "intercept")

    def __init__(self, iterations: int = 300, stepsize: float = 0.5,
                 regularization: float = 0.01, device: DeviceLike = None):
        self.iterations = iterations
        self.stepsize = stepsize
        self.regularization = regularization
        self.device = device
        self.weights = None
        self.intercept = 0.0
        self.threshold = 0.0  # decision threshold on the margin

    def fit(self, X, y=None):
        assert y is not None
        assert set(np.unique(np.asarray(y, np.float32))) <= {-1.0, 1.0}, \
            "SVM labels must be -1/+1"
        dev = resolve_device(self.device)
        X, y = _f32(X, dev), _f32(y, dev)
        n, d = X.shape
        lam = np.float32(self.regularization)
        step = np.float32(self.stepsize)
        w = torch.zeros(d, dtype=torch.float32, device=dev)
        b = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(self.iterations):
            margins = y * (torch.mv(X, w) + b)
            active_y = (margins < 1.0).to(torch.float32) * y
            eta = float(step / (lam * np.float32(i + 1.0)))  # Pegasos
            grad_w = lam * w - torch.mv(X.t(), active_y) / n
            grad_b = -active_y.mean()
            w = w - eta * grad_w
            b = b - eta * grad_b
        self.weights = w.cpu().numpy()
        self.intercept = float(b)
        return self

    def decision_function(self, X) -> np.ndarray:
        return np.asarray(X, np.float32) @ self.weights + self.intercept

    def predict(self, X) -> np.ndarray:
        return np.where(self.decision_function(X) >= self.threshold,
                        1.0, -1.0)


class KNN(Predictor):
    """Exact k-NN (ref: FlinkML nn/KNN.scala, the exact blockwise
    solution; here the products of all pairs are one GEMM)."""

    fitted_params = ("_X", "_y")

    def __init__(self, k: int = 3, device: DeviceLike = None):
        self.k = k
        self.device = device
        self._X = None
        self._y = None

    def fit(self, X, y=None):
        self._X = np.asarray(X, np.float32)
        self._y = None if y is None else np.asarray(y)
        return self

    def kneighbors(self, Q) -> np.ndarray:
        """Indices [m, k] (int32) of the k nearest training points per
        query, nearest first, the lower index first on equal distances."""
        dev = resolve_device(self.device)
        Q, X = _f32(Q, dev), _f32(self._X, dev)
        qx = torch.matmul(Q, X.t())
        return knn_topk(qx, torch.sum(Q * Q, 1), torch.sum(X * X, 1),
                        self.k).cpu().numpy()

    def predict(self, Q) -> np.ndarray:
        assert self._y is not None, "fit with labels to predict"
        idx = self.kneighbors(Q)
        neighbor_labels = self._y[idx]  # [m, k]
        if neighbor_labels.dtype.kind in "fc":
            return neighbor_labels.mean(axis=1)  # regression: average
        # classification: majority vote
        out = []
        for row in neighbor_labels:
            vals, counts = np.unique(row, return_counts=True)
            out.append(vals[np.argmax(counts)])
        return np.asarray(out)
