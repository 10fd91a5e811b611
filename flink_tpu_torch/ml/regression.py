"""Linear regression (port of ``flink_tpu/ml/regression.py``; FlinkML's
MultipleLinearRegression: a squared-loss linear model trained by
full-batch gradient descent).  The loop of GEMVs runs as torch ops on
the card, with the reference's ``stepsize / sqrt(i)`` schedule and its
convergence test on parameter movement, read on the host each step.
Fitted state and ``predict`` are host numpy; ``fit`` runs on ``cuda``
unless the caller passes ``device="cpu"``."""

from __future__ import annotations

import numpy as np
import torch

from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.ml.pipeline import Predictor


class MultipleLinearRegression(Predictor):
    fitted_params = ("weights", "intercept")

    def __init__(self, iterations: int = 200, stepsize: float = 0.1,
                 l2: float = 0.0, convergence_threshold: float = 0.0,
                 device: DeviceLike = None):
        self.iterations = iterations
        self.stepsize = stepsize
        self.l2 = l2
        self.convergence_threshold = convergence_threshold
        self.device = device
        self.weights = None
        self.intercept = None

    def fit(self, X, y=None):
        assert y is not None, "labels required"
        dev = resolve_device(self.device)
        X = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
        y = torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(dev)
        n, d = X.shape
        # standardize internally for conditioning; de-scale at the end
        mu = X.mean(0)
        sigma = torch.clamp(X.std(0, correction=0), min=1e-8)
        Xs = (X - mu) / sigma
        ymu = y.mean()
        yc = y - ymu
        step = np.float32(self.stepsize)
        w = torch.zeros(d, dtype=torch.float32, device=dev)
        b = torch.zeros((), dtype=torch.float32, device=dev)
        i, delta = 0, float("inf")
        while i < self.iterations and delta >= self.convergence_threshold:
            err = torch.mv(Xs, w) + b - yc
            eta = float(step / np.sqrt(np.float32(i + 1.0)))
            grad_w = torch.mv(Xs.t(), err) / n + self.l2 * w
            new_w = w - eta * grad_w
            new_b = b - eta * err.mean()
            # convergence = the largest parameter movement this step
            delta = float(torch.maximum(torch.max(torch.abs(new_w - w)),
                                        torch.abs(new_b - b)))
            i, w, b = i + 1, new_w, new_b
        # undo the standardization: y = (x - mu)/sigma . w + b + ymu
        mu_np, sigma_np = mu.cpu().numpy(), sigma.cpu().numpy()
        w_orig = w.cpu().numpy() / sigma_np
        self.weights = w_orig
        self.intercept = float(b.cpu().numpy() + ymu.cpu().numpy()
                               - mu_np @ w_orig)
        return self

    def predict(self, X):
        X = np.asarray(X, np.float32)
        return X @ self.weights + self.intercept

    def squared_residual_sum(self, X, y) -> float:
        pred = self.predict(X)
        return float(((pred - np.asarray(y)) ** 2).sum())
