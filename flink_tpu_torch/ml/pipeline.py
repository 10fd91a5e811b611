"""Pipeline abstractions (port of ``flink_tpu/ml/pipeline.py``; FlinkML's
Estimator, Transformer, Predictor and the chained pipeline built by
``chain_transformer`` / ``chain_predictor``).

Data is numpy arrays (features [n, d]; labels [n]).  Fitted state is
host numpy as in the reference, so ``params_from_numpy`` can set it from
the arrays a JAX-package estimator holds.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class Transformer(abc.ABC):
    """fit(X) learns transformation state; transform(X) applies it."""

    def fit(self, X, y=None) -> "Transformer":  # noqa: B027
        return self

    @abc.abstractmethod
    def transform(self, X) -> np.ndarray: ...

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X, y).transform(X)

    def chain_transformer(self, other: "Transformer") -> "Pipeline":
        return Pipeline([self, other])

    def chain_predictor(self, predictor: "Predictor") -> "Pipeline":
        return Pipeline([self, predictor])


class Estimator(abc.ABC):
    @abc.abstractmethod
    def fit(self, X, y=None) -> Any: ...


class Predictor(Estimator):
    """fit(X, y) trains; predict(X) scores."""

    @abc.abstractmethod
    def predict(self, X) -> np.ndarray: ...


class Pipeline(Predictor, Transformer):
    """Chained transformers with an optional terminal predictor
    (ref: the ChainedTransformer/ChainedPredictor pair)."""

    def __init__(self, stages: List[Any]):
        self.stages = list(stages)

    def fit(self, X, y=None) -> "Pipeline":
        data = np.asarray(X)
        for i, stage in enumerate(self.stages):
            last = i == len(self.stages) - 1
            if isinstance(stage, Transformer):
                data = stage.fit(data, y).transform(data)
            elif last:
                stage.fit(data, y)
            else:
                raise TypeError(
                    "non-terminal pipeline stages must be Transformers")
        return self

    def _apply_transformers(self, X) -> Tuple[np.ndarray, Optional[Any]]:
        data = np.asarray(X)
        terminal = None
        for i, stage in enumerate(self.stages):
            if isinstance(stage, Transformer) and not (
                    i == len(self.stages) - 1
                    and isinstance(stage, Predictor)):
                data = stage.transform(data)
            else:
                terminal = stage
        return data, terminal

    def transform(self, X) -> np.ndarray:
        data, _ = self._apply_transformers(X)
        return data

    def predict(self, X) -> np.ndarray:
        data, terminal = self._apply_transformers(X)
        if terminal is None or not isinstance(terminal, Predictor):
            raise TypeError("pipeline has no terminal predictor")
        return terminal.predict(data)


def params_from_numpy(estimator, arrays: Dict[str, Any]):
    """Set a port estimator's fitted state from the fitted state of the
    same estimator in the JAX package, read as numpy: ``weights`` and
    ``intercept`` (SVM, MultipleLinearRegression), ``_X`` and ``_y``
    (KNN), ``user_factors``, ``item_factors``, ``_users`` and ``_items``
    (ALS).  The names must be exactly the estimator's
    (``fitted_params``).  Returns the estimator."""
    names = getattr(type(estimator), "fitted_params", None)
    if names is None:
        raise TypeError(f"{type(estimator).__name__} has no fitted arrays")
    if set(arrays) != set(names):
        raise ValueError(f"{type(estimator).__name__} takes exactly "
                         f"{sorted(names)}, got {sorted(arrays)}")
    for name in names:
        value = arrays[name]
        if name == "intercept":
            value = float(value)
        elif name in ("_users", "_items"):
            value = dict(value)
        elif name == "_y":
            value = None if value is None else np.array(value)
        else:
            value = np.array(value, dtype=np.float32)
        setattr(estimator, name, value)
    return estimator
