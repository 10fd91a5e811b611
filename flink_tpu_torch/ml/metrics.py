"""Distance metrics (port of ``flink_tpu/ml/metrics.py``; FlinkML's
Euclidean, squared Euclidean, cosine, Chebyshev, Manhattan, Minkowski
and Tanimoto distances), vectorised over trailing feature axes.  Host
numpy, as in the reference; no device."""

from __future__ import annotations

import numpy as np


def _ab(a, b):
    return np.asarray(a, np.float64), np.asarray(b, np.float64)


def squared_euclidean_distance(a, b):
    a, b = _ab(a, b)
    return ((a - b) ** 2).sum(axis=-1)


def euclidean_distance(a, b):
    return np.sqrt(squared_euclidean_distance(a, b))


def manhattan_distance(a, b):
    a, b = _ab(a, b)
    return np.abs(a - b).sum(axis=-1)


def chebyshev_distance(a, b):
    a, b = _ab(a, b)
    return np.abs(a - b).max(axis=-1)


def minkowski_distance(a, b, p: float = 3.0):
    a, b = _ab(a, b)
    return (np.abs(a - b) ** p).sum(axis=-1) ** (1.0 / p)


def cosine_distance(a, b):
    a, b = _ab(a, b)
    denom = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return 1.0 - (a * b).sum(axis=-1) / np.where(denom == 0, 1.0, denom)


def tanimoto_distance(a, b):
    a, b = _ab(a, b)
    dot = (a * b).sum(axis=-1)
    denom = (a * a).sum(axis=-1) + (b * b).sum(axis=-1) - dot
    return 1.0 - dot / np.where(denom == 0, 1.0, denom)
