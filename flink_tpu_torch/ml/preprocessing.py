"""Feature preprocessing (port of ``flink_tpu/ml/preprocessing.py``;
FlinkML's StandardScaler, MinMaxScaler, PolynomialFeatures).  Host
numpy, as in the reference; no device."""

from __future__ import annotations

from itertools import combinations_with_replacement

import numpy as np

from flink_tpu_torch.ml.pipeline import Transformer


class StandardScaler(Transformer):
    """(ref: preprocessing/StandardScaler.scala — scale to the given
    mean/std)."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.target_mean = mean
        self.target_std = std
        self.data_mean = None
        self.data_std = None

    def fit(self, X, y=None):
        X = np.asarray(X, np.float32)
        self.data_mean = X.mean(axis=0)
        self.data_std = X.std(axis=0)
        self.data_std = np.where(self.data_std == 0, 1.0, self.data_std)
        return self

    def transform(self, X):
        X = np.asarray(X, np.float32)
        return ((X - self.data_mean) / self.data_std * self.target_std
                + self.target_mean)


class MinMaxScaler(Transformer):
    """(ref: preprocessing/MinMaxScaler.scala)."""

    def __init__(self, min_value: float = 0.0, max_value: float = 1.0):
        self.lo = min_value
        self.hi = max_value
        self.data_min = None
        self.data_range = None

    def fit(self, X, y=None):
        X = np.asarray(X, np.float32)
        self.data_min = X.min(axis=0)
        rng = X.max(axis=0) - self.data_min
        self.data_range = np.where(rng == 0, 1.0, rng)
        return self

    def transform(self, X):
        X = np.asarray(X, np.float32)
        unit = (X - self.data_min) / self.data_range
        return unit * (self.hi - self.lo) + self.lo


class PolynomialFeatures(Transformer):
    """(ref: preprocessing/PolynomialFeatures.scala — maps a vector to
    the polynomial feature space up to the given degree: all monomials
    of the input features with total degree 1..degree)."""

    def __init__(self, degree: int = 2):
        self.degree = degree
        self._combos = None

    def fit(self, X, y=None):
        d = np.asarray(X).shape[1]
        self._combos = [c for deg in range(1, self.degree + 1)
                        for c in combinations_with_replacement(range(d), deg)]
        return self

    def transform(self, X):
        X = np.asarray(X, np.float32)
        if self._combos is None:
            self.fit(X)
        cols = [X[:, c].prod(axis=1) for c in self._combos]
        return np.stack(cols, axis=1)
