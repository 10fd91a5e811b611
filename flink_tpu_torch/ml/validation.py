"""Model evaluation and cross-validation (port of
``flink_tpu/ml/validation.py``): scores over numpy arrays
(classification: accuracy, precision, recall, F1, confusion matrix;
regression: MSE, MAE, R^2), deterministic shuffled splits
(``train_test_split``, ``KFold``), ``cross_val_score`` refitting a fresh
clone of the estimator per fold, and ``GridSearchCV``.  Host numpy, as
in the reference.

Clones come from the estimator's class and its constructor's
parameters read back from same-named attributes, so a port estimator's
``device`` travels to its clones.
"""

from __future__ import annotations

import inspect
import itertools
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = [
    "accuracy_score", "precision_score", "recall_score", "f1_score",
    "confusion_matrix", "mean_squared_error", "mean_absolute_error",
    "r2_score", "train_test_split", "KFold", "cross_val_score",
    "GridSearchCV",
]


# ---------------------------------------------------------------------
# scores
# ---------------------------------------------------------------------

def accuracy_score(y_true, y_pred) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float(np.mean(y_true == y_pred)) if len(y_true) else 0.0

def _binary_counts(y_true, y_pred, positive):
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    tp = float(np.sum((y_pred == positive) & (y_true == positive)))
    fp = float(np.sum((y_pred == positive) & (y_true != positive)))
    fn = float(np.sum((y_pred != positive) & (y_true == positive)))
    return tp, fp, fn


def precision_score(y_true, y_pred, positive=1) -> float:
    tp, fp, _ = _binary_counts(y_true, y_pred, positive)
    return tp / (tp + fp) if tp + fp else 0.0


def recall_score(y_true, y_pred, positive=1) -> float:
    tp, _, fn = _binary_counts(y_true, y_pred, positive)
    return tp / (tp + fn) if tp + fn else 0.0


def f1_score(y_true, y_pred, positive=1) -> float:
    p = precision_score(y_true, y_pred, positive)
    r = recall_score(y_true, y_pred, positive)
    return 2 * p * r / (p + r) if p + r else 0.0


def confusion_matrix(y_true, y_pred
                     ) -> Tuple[np.ndarray, List[Any]]:
    """→ (matrix[label_i, label_j] = #(true i predicted j), labels)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    labels = sorted(set(y_true.tolist()) | set(y_pred.tolist()))
    index = {lab: i for i, lab in enumerate(labels)}
    m = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(y_true.tolist(), y_pred.tolist()):
        m[index[t], index[p]] += 1
    return m, labels


def mean_squared_error(y_true, y_pred) -> float:
    d = np.asarray(y_true, np.float64) - np.asarray(y_pred, np.float64)
    return float(np.mean(d * d))


def mean_absolute_error(y_true, y_pred) -> float:
    d = np.asarray(y_true, np.float64) - np.asarray(y_pred, np.float64)
    return float(np.mean(np.abs(d)))


def r2_score(y_true, y_pred) -> float:
    y = np.asarray(y_true, np.float64)
    p = np.asarray(y_pred, np.float64)
    ss_res = float(np.sum((y - p) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    if ss_res == 0.0:
        return 1.0   # perfect fit, even on a constant target
    return 1.0 - ss_res / ss_tot if ss_tot else 0.0


_SCORERS: Dict[str, Callable] = {
    "accuracy": accuracy_score,
    "f1": f1_score,
    "neg_mean_squared_error":
        lambda yt, yp: -mean_squared_error(yt, yp),
    "neg_mean_absolute_error":
        lambda yt, yp: -mean_absolute_error(yt, yp),
    "r2": r2_score,
}


# ---------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------

def train_test_split(X, y, test_size: float = 0.25, seed: int = 0):
    X = np.asarray(X)
    y = np.asarray(y)
    n = len(X)
    order = np.random.default_rng(seed).permutation(n)
    n_test = max(1, int(round(n * test_size)))
    test, train = order[:n_test], order[n_test:]
    return X[train], X[test], y[train], y[test]


class KFold:
    """Deterministic shuffled k-fold split."""

    def __init__(self, n_splits: int = 5, shuffle: bool = True,
                 seed: int = 0):
        if n_splits < 2:
            raise ValueError("need at least 2 folds")
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.seed = seed

    def split(self, X) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
        n = len(X)
        if n < self.n_splits:
            raise ValueError(
                f"cannot split {n} samples into {self.n_splits} "
                "folds (empty test folds would score 0)")
        idx = (np.random.default_rng(self.seed).permutation(n)
               if self.shuffle else np.arange(n))
        for fold in np.array_split(idx, self.n_splits):
            yield idx[~np.isin(idx, fold)], fold


# ---------------------------------------------------------------------
# estimator cloning + cross-validation
# ---------------------------------------------------------------------

def _clone(estimator, override: Optional[dict] = None):
    params = {}
    if hasattr(estimator, "get_params"):
        params = dict(estimator.get_params())
    else:
        sig = inspect.signature(type(estimator).__init__)
        for name in list(sig.parameters)[1:]:
            if hasattr(estimator, name):
                params[name] = getattr(estimator, name)
    if override:
        params.update(override)
    return type(estimator)(**params)


def cross_val_score(estimator, X, y, cv=5,
                    scoring: str = "accuracy") -> np.ndarray:
    """Fit a fresh clone per fold, score on the held-out fold."""
    X = np.asarray(X)
    y = np.asarray(y)
    folds = cv if isinstance(cv, KFold) else KFold(cv)
    scorer = _SCORERS[scoring] if isinstance(scoring, str) else scoring
    scores = []
    for train_idx, test_idx in folds.split(X):
        model = _clone(estimator)
        model.fit(X[train_idx], y[train_idx])
        scores.append(scorer(y[test_idx], model.predict(X[test_idx])))
    return np.asarray(scores, np.float64)


class GridSearchCV:
    """Exhaustive parameter search by mean cross-validation score;
    refits the winner on the full data (`best_estimator_`)."""

    def __init__(self, estimator, param_grid: Dict[str, list],
                 cv=3, scoring: str = "accuracy"):
        self.estimator = estimator
        self.param_grid = param_grid
        self.cv = cv
        self.scoring = scoring
        self.results_: List[Tuple[dict, float]] = []
        self.best_params_: Optional[dict] = None
        self.best_score_: Optional[float] = None
        self.best_estimator_ = None

    def fit(self, X, y) -> "GridSearchCV":
        keys = list(self.param_grid)
        for combo in itertools.product(
                *(self.param_grid[k] for k in keys)):
            params = dict(zip(keys, combo))
            model = _clone(self.estimator, params)
            score = float(np.mean(cross_val_score(
                model, X, y, cv=self.cv, scoring=self.scoring)))
            self.results_.append((params, score))
            if self.best_score_ is None or score > self.best_score_:
                self.best_score_ = score
                self.best_params_ = params
        self.best_estimator_ = _clone(self.estimator,
                                      self.best_params_)
        self.best_estimator_.fit(np.asarray(X), np.asarray(y))
        return self

    def predict(self, X):
        return self.best_estimator_.predict(np.asarray(X))
