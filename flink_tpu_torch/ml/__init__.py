"""Machine-learning library, the FlinkML analogue (port of
``flink_tpu/ml``): pipelines of transformers and predictors,
preprocessing, linear regression, SVM, KNN and ALS, distances, scores
and cross-validation.  Training and neighbour queries run full batch
on the card (GEMV loops, one GEMM, the ``knn_topk`` and
``gram_accumulate`` kernels, a batched solve); fitted state is host
numpy."""

from flink_tpu_torch.ml.pipeline import Estimator, Pipeline, Predictor, Transformer
from flink_tpu_torch.ml.preprocessing import (
    MinMaxScaler,
    PolynomialFeatures,
    StandardScaler,
)
from flink_tpu_torch.ml.regression import MultipleLinearRegression
from flink_tpu_torch.ml.classification import KNN, SVM
from flink_tpu_torch.ml.recommendation import ALS
from flink_tpu_torch.ml.validation import (
    GridSearchCV,
    KFold,
    accuracy_score,
    confusion_matrix,
    cross_val_score,
    f1_score,
    mean_absolute_error,
    mean_squared_error,
    precision_score,
    r2_score,
    recall_score,
    train_test_split,
)
from flink_tpu_torch.ml.metrics import (
    chebyshev_distance,
    cosine_distance,
    euclidean_distance,
    manhattan_distance,
    minkowski_distance,
    squared_euclidean_distance,
    tanimoto_distance,
)

__all__ = [
    "Estimator", "Transformer", "Predictor", "Pipeline",
    "StandardScaler", "MinMaxScaler", "PolynomialFeatures",
    "MultipleLinearRegression", "SVM", "KNN", "ALS",
    "euclidean_distance", "squared_euclidean_distance",
    "cosine_distance", "chebyshev_distance", "manhattan_distance",
    "minkowski_distance", "tanimoto_distance",
    "KFold", "GridSearchCV", "cross_val_score", "train_test_split",
    "accuracy_score", "precision_score", "recall_score", "f1_score",
    "confusion_matrix", "mean_squared_error", "mean_absolute_error",
    "r2_score",
]
