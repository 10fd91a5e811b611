"""The port's ML library (``flink_tpu_torch.ml``) against the JAX
package's (``flink_tpu.ml``) on the same numpy inputs, on the CPU
(``device="cpu"``: the kernels' plain versions).

Every case of ``tests/test_ml.py`` runs through both packages (the
case's own assertions hold for the port, and the outputs agree); then
each device program of the reference (K13a-d) against its port, and
``params_from_numpy``, which sets a port estimator from a JAX one's
fitted arrays so that ``predict``, ``kneighbors`` and
``decision_function`` compare on one fitted state.

Tolerances.  KNN indices are exact: every KNN case here has
integer-valued features, so distances are exact in float32 and ties are
real, and both packages put the lower index first.  Host numpy code
(scalers, metrics, predict on one fitted state) is bit-equal.  Float32
sums are not: two float32 sums of the same ``t`` terms in any two orders
differ by at most ``2 t eps sum|terms|`` (``reorder_bound``); each test
says how that carries through its fit.
"""

import numpy as np
import pytest
import torch

import flink_tpu.ml as jm
import flink_tpu_torch.ml as tm
from flink_tpu_torch import kernels as K
from flink_tpu_torch.kernels.gram_accumulate import rating_csr
from flink_tpu_torch.ml.pipeline import params_from_numpy

EPS = float(np.finfo(np.float32).eps)
CPU = {"device": "cpu"}


def reorder_bound(terms, abs_sum):
    """Largest difference of two float32 sums of ``terms`` numbers whose
    magnitudes add up to ``abs_sum``, taken in any two orders."""
    return 2.0 * np.asarray(terms, np.float64) * EPS * np.asarray(abs_sum, np.float64)


def _gd_atol(X, y, iterations, step_sum, w_max):
    """A full-batch gradient step's GEMVs sum n terms of |x| |r| each, so
    one step's gradient differs by at most reorder_bound(n, max|X| max|r|)
    over n (twice: the residuals fed in differ the same way); a weight
    moves by the step size times that, and each update rounds within an
    ulp or two of the largest weight ``w_max``.  No contraction is
    assumed: the differences add up over the steps."""
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    r = np.abs(np.asarray(y, np.float64)).max() + 1.0
    per_step = 2 * reorder_bound(n, np.abs(X).max() * r) / n
    return float(step_sum * per_step + iterations * 2 * EPS * w_max)


# ---------------------------------------------------------------------
# the cases of tests/test_ml.py, through both packages
# ---------------------------------------------------------------------

def test_standard_scaler():
    rng = np.random.default_rng(0)
    X = rng.normal(5.0, 3.0, (500, 4)).astype(np.float32)
    out = tm.StandardScaler().fit_transform(X)
    assert np.allclose(out.mean(0), 0.0, atol=1e-4)
    assert np.allclose(out.std(0), 1.0, atol=1e-4)
    out2 = tm.StandardScaler(mean=10.0, std=2.0).fit_transform(X)
    assert np.allclose(out2.mean(0), 10.0, atol=1e-3)
    assert np.allclose(out2.std(0), 2.0, atol=1e-3)
    np.testing.assert_array_equal(out2, jm.StandardScaler(mean=10.0, std=2.0).fit_transform(X))


def test_minmax_scaler():
    rng = np.random.default_rng(1)
    X = rng.uniform(-7, 9, (200, 3)).astype(np.float32)
    out = tm.MinMaxScaler(min_value=-1.0, max_value=1.0).fit_transform(X)
    assert np.allclose(out.min(0), -1.0, atol=1e-5)
    assert np.allclose(out.max(0), 1.0, atol=1e-5)
    np.testing.assert_array_equal(
        out, jm.MinMaxScaler(min_value=-1.0, max_value=1.0).fit_transform(X))


def test_polynomial_features():
    X = np.array([[2.0, 3.0]], np.float32)
    out = tm.PolynomialFeatures(degree=2).fit_transform(X)
    assert sorted(out[0].tolist()) == sorted([2.0, 3.0, 4.0, 6.0, 9.0])
    np.testing.assert_array_equal(out, jm.PolynomialFeatures(degree=2).fit_transform(X))


def test_linear_regression_recovers_coefficients():
    rng = np.random.default_rng(2)
    w_true = np.array([2.0, -3.5, 0.7])
    X = rng.normal(0, 2, (800, 3)).astype(np.float32)
    y = X @ w_true + 4.2 + rng.normal(0, 0.01, 800)
    mlr = tm.MultipleLinearRegression(iterations=400, stepsize=1.0, **CPU).fit(X, y)
    assert np.allclose(mlr.weights, w_true, atol=0.05)
    assert abs(mlr.intercept - 4.2) < 0.05
    assert mlr.squared_residual_sum(X, y) / len(y) < 0.01
    ref = jm.MultipleLinearRegression(iterations=400, stepsize=1.0).fit(X, y)
    # standardized features: |Xs| <= max |x - mu| / sigma; steps 1/sqrt(i)
    Xs = (X - X.mean(0)) / X.std(0)
    atol = _gd_atol(Xs, y - y.mean(), 400, sum(1 / np.sqrt(i + 1) for i in range(400)),
                    np.abs(ref.weights * X.std(0)).max())
    np.testing.assert_allclose(mlr.weights * X.std(0), ref.weights * X.std(0), atol=atol)


def test_svm_separable():
    rng = np.random.default_rng(3)
    X = rng.normal(0, 1, (400, 2)).astype(np.float32)
    y = np.where(X[:, 0] + X[:, 1] > 0.0, 1.0, -1.0)
    svm = tm.SVM(iterations=500, stepsize=1.0, regularization=0.01, **CPU).fit(X, y)
    assert (svm.predict(X) == y).mean() > 0.97
    ref = jm.SVM(iterations=500, stepsize=1.0, regularization=0.01).fit(X, y)
    atol = _svm_atol(X, 500, 1.0, 0.01, ref.weights)
    np.testing.assert_allclose(svm.weights, ref.weights, atol=atol)
    assert abs(svm.intercept - ref.intercept) <= atol


def test_knn_matches_bruteforce():
    rng = np.random.default_rng(4)
    X = rng.integers(-3, 4, (300, 5)).astype(np.float32)
    Q = rng.integers(-3, 4, (40, 5)).astype(np.float32)
    idx = tm.KNN(k=5, **CPU).fit(X).kneighbors(Q)
    d2 = ((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    brute = np.argsort(d2, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(idx, brute)          # ties: lower index first
    np.testing.assert_array_equal(idx, jm.KNN(k=5).fit(X).kneighbors(Q))


def test_knn_classification():
    X = np.array([[0, 0], [0, 1], [1, 0], [10, 10], [10, 11], [11, 10]], np.float32)
    y = np.array(["a", "a", "a", "b", "b", "b"])
    Q = np.array([[0, 0], [10, 11]], np.float32)        # integer queries
    pred = tm.KNN(k=3, **CPU).fit(X, y).predict(Q)
    assert pred.tolist() == ["a", "b"]
    assert pred.tolist() == jm.KNN(k=3).fit(X, y).predict(Q).tolist()


def _low_rank_ratings(seed=5):
    rng = np.random.default_rng(seed)
    U = rng.normal(0, 1, (30, 4))
    V = rng.normal(0, 1, (25, 4))
    R = U @ V.T
    ratings = [(u, i, R[u, i]) for u in range(30) for i in range(25)
               if rng.random() < 0.9]
    return R, ratings


def test_als_reconstructs_low_rank():
    R, ratings = _low_rank_ratings()
    held = [(u, i, R[u, i]) for u in range(30) for i in range(25)]
    preds = {}
    for ml, kw in ((tm, CPU), (jm, {})):
        als = ml.ALS(num_factors=4, lambda_=0.005, iterations=30, seed=0, **kw)
        als.fit(ratings)
        assert als.empirical_risk(ratings) < 1e-4
        assert als.empirical_risk(held) < 1e-3
        preds[ml] = als.predict([(u, i) for u, i, _ in held])
    # each fit is within RMS sqrt(1e-3) of R on every entry, so the two
    # fits are within twice that of each other (triangle inequality)
    rms = np.sqrt(np.mean((preds[tm].astype(np.float64) - preds[jm]) ** 2))
    assert rms <= 2 * np.sqrt(1e-3)


def test_pipeline_chaining():
    rng = np.random.default_rng(6)
    X = rng.normal(5, 2, (300, 2)).astype(np.float32)
    y = np.where(X[:, 0] - X[:, 1] > 0, 1.0, -1.0)
    pipe = tm.StandardScaler().chain_predictor(tm.SVM(iterations=400, stepsize=1.0, **CPU))
    pipe.fit(X, y)
    assert (pipe.predict(X) == y).mean() > 0.95
    ref = jm.StandardScaler().chain_predictor(jm.SVM(iterations=400, stepsize=1.0))
    ref.fit(X, y)
    Xs = ref.stages[0].transform(X)
    atol = _svm_atol(Xs, 400, 1.0, 0.01, ref.stages[1].weights)
    np.testing.assert_allclose(pipe.stages[1].weights, ref.stages[1].weights, atol=atol)


def test_distance_metrics():
    a = np.array([1.0, 0.0, 2.0])
    b = np.array([0.0, 1.0, 4.0])
    for ml in (tm, jm):
        assert ml.squared_euclidean_distance(a, b) == pytest.approx(6.0)
        assert ml.euclidean_distance(a, b) == pytest.approx(np.sqrt(6.0))
        assert ml.manhattan_distance(a, b) == pytest.approx(4.0)
        assert ml.chebyshev_distance(a, b) == pytest.approx(2.0)
        assert ml.minkowski_distance(a, b, 3) == pytest.approx((1 + 1 + 8) ** (1 / 3))
        batch = ml.cosine_distance(a, np.stack([2 * a, b]))
        assert batch[0] == pytest.approx(0.0)
        assert ml.cosine_distance(a, 2 * a) == pytest.approx(0.0)
        assert ml.tanimoto_distance(a, a) == pytest.approx(0.0)
    for fn in ("squared_euclidean_distance", "euclidean_distance", "manhattan_distance",
               "chebyshev_distance", "minkowski_distance", "cosine_distance",
               "tanimoto_distance"):
        np.testing.assert_array_equal(getattr(tm, fn)(a, np.stack([2 * a, b])),
                                      getattr(jm, fn)(a, np.stack([2 * a, b])))


def test_scores_hand_computed():
    yt = [1, 1, 0, 0, 1]
    yp = [1, 0, 0, 1, 1]
    for ml in (tm, jm):
        assert ml.accuracy_score(yt, yp) == 0.6
        assert ml.precision_score(yt, yp) == 2 / 3
        assert ml.recall_score(yt, yp) == 2 / 3
        assert abs(ml.f1_score(yt, yp) - 2 / 3) < 1e-12
        m, labels = ml.confusion_matrix(yt, yp)
        assert labels == [0, 1]
        assert m.tolist() == [[1, 1], [1, 2]]
        assert ml.mean_squared_error([1, 2, 3], [1, 2, 5]) == 4 / 3
        assert ml.mean_absolute_error([1, 2, 3], [1, 2, 5]) == 2 / 3
        assert ml.r2_score([1, 2, 3], [1, 2, 3]) == 1.0
        assert abs(ml.r2_score([1, 2, 3], [2, 2, 2])) < 1e-12


def test_kfold_partitions_exactly():
    X = np.arange(23)
    splits = {}
    for ml in (tm, jm):
        seen = []
        splits[ml] = []
        for train, test in ml.KFold(5, seed=3).split(X):
            assert len(np.intersect1d(train, test)) == 0
            assert len(train) + len(test) == 23
            seen.extend(test.tolist())
            splits[ml].append((train.tolist(), test.tolist()))
        assert sorted(seen) == list(range(23))
    assert splits[tm] == splits[jm]


def test_cross_val_score_separable():
    rng = np.random.default_rng(0)
    X = np.vstack([rng.integers(-1, 2, (40, 2)), rng.integers(2, 5, (40, 2))])
    y = np.asarray([0] * 40 + [1] * 40)
    scores = tm.cross_val_score(tm.KNN(k=3, **CPU), X, y, cv=4)
    assert len(scores) == 4
    assert scores.mean() > 0.95
    np.testing.assert_array_equal(scores, jm.cross_val_score(jm.KNN(k=3), X, y, cv=4))


def test_grid_search_picks_better_params():
    rng = np.random.default_rng(1)
    X = rng.integers(-4, 5, (120, 2))
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    X = X + rng.integers(-1, 2, X.shape)
    gs = tm.GridSearchCV(tm.KNN(k=1, **CPU), {"k": [1, 7]}, cv=4).fit(X, y)
    assert gs.best_params_["k"] in (1, 7)
    assert len(gs.results_) == 2
    assert gs.best_score_ == max(s for _, s in gs.results_)
    assert gs.best_estimator_.device == "cpu"           # clones keep it
    preds = gs.predict(X)
    assert len(preds) == len(y)
    ref = jm.GridSearchCV(jm.KNN(k=1), {"k": [1, 7]}, cv=4).fit(X, y)
    assert gs.results_ == ref.results_
    np.testing.assert_array_equal(preds, ref.predict(X))


def test_cross_val_regression_scoring():
    rng = np.random.default_rng(2)
    X = rng.normal(0, 1, (80, 3))
    y = X @ np.asarray([2.0, -1.0, 0.5]) + 0.01 * rng.normal(size=80)
    scores = tm.cross_val_score(tm.MultipleLinearRegression(**CPU), X, y, cv=4,
                                scoring="r2")
    assert scores.min() > 0.99
    ref = jm.cross_val_score(jm.MultipleLinearRegression(), X, y, cv=4, scoring="r2")
    # r2 = 1 - SSres/SStot; the fits' weights differ within _gd_atol, so
    # each prediction within atol * sum|x|, SSres within that times 2|res| n
    atol = _gd_atol(X / X.std(0), y, 200, sum(0.1 / np.sqrt(i + 1) for i in range(200)),
                    3.0 * X.std(0).max())
    dpred = atol * np.abs(X / X.std(0)).sum(1).max()
    ss_tot = ((y - y.mean()) ** 2).sum() / 4
    bound = 2 * dpred * np.abs(y).max() * len(y) / ss_tot + 1e-6
    np.testing.assert_allclose(scores, ref, atol=bound)


# ---------------------------------------------------------------------
# K13a: ALS solve_side (gram_accumulate + batched solve)
# ---------------------------------------------------------------------

def _ratings(rng, n_u, n_i, nnz):
    u = rng.integers(0, n_u, nnz)
    i = rng.integers(0, n_i, nnz)
    r = rng.integers(1, 11, nnz) / 2.0                  # 0.5-step stars
    return [(int(a), int(b), float(c)) for a, b, c in zip(u, i, r)]


def test_gram_accumulate_matches_jax_segment_sums():
    """The reference's two segment sums of ALS.solve_side, written as
    there, against the kernel's plain version: each entry within
    reorder_bound(ratings of its row, sum of |terms|)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    n_rows, n_cols, nnz, f = 50, 40, 3000, 6
    rows = rng.integers(0, n_rows, nnz).astype(np.int32)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    vals = (rng.integers(1, 11, nnz) / 2.0).astype(np.float32)
    fixed = rng.normal(0, 1, (n_cols, f)).astype(np.float32)
    vc = jnp.asarray(fixed)[jnp.asarray(cols)]
    want_g = np.asarray(jax.ops.segment_sum(vc[:, :, None] * vc[:, None, :],
                                            jnp.asarray(rows), num_segments=n_rows))
    want_b = np.asarray(jax.ops.segment_sum(jnp.asarray(vals)[:, None] * vc,
                                            jnp.asarray(rows), num_segments=n_rows))
    csr = rating_csr(*(torch.from_numpy(a) for a in (rows, cols, vals)), n_rows)
    got_g, got_b = K.gram_accumulate(torch.from_numpy(fixed), *csr)
    mag_g, mag_b = K.gram_accumulate(torch.from_numpy(np.abs(fixed)), csr[0], csr[1],
                                     csr[2].abs())
    terms = np.bincount(rows, minlength=n_rows)
    assert np.all(np.abs(got_g.numpy() - want_g)
                  <= reorder_bound(terms[:, None, None], mag_g.numpy()))
    assert np.all(np.abs(got_b.numpy() - want_b)
                  <= reorder_bound(terms[:, None], mag_b.numpy()))


def test_rating_csr_keeps_each_rows_order():
    rows = torch.tensor([2, 0, 2, 1, 0, 2], dtype=torch.int32)
    cols = torch.arange(6, dtype=torch.int32)
    indptr, c, v = rating_csr(rows, cols, cols.float(), 4)
    assert indptr.tolist() == [0, 2, 3, 6, 6]
    assert c.tolist() == [1, 4, 3, 0, 2, 5] and v.tolist() == [1, 4, 3, 0, 2, 5]


def test_als_one_sweep_matches_jax():
    """iterations=1: the user factors are one solve_side from the same
    initial item factors (both draw them from default_rng(seed)).  The
    Gram matrices and right-hand sides differ within reorder_bound, and
    a solve moves by at most cond(A) times the relative change of A and
    b (first order), with cond and norms taken in float64 per row; the
    solvers' own backward error adds f * eps * cond."""
    rng = np.random.default_rng(8)
    ratings = _ratings(rng, 60, 40, 1500)
    lam, f = 0.1, 5
    t = tm.ALS(num_factors=f, lambda_=lam, iterations=1, seed=3, **CPU).fit(ratings)
    j = jm.ALS(num_factors=f, lambda_=lam, iterations=1, seed=3).fit(ratings)
    assert t._users == j._users and t._items == j._items
    V0 = np.random.default_rng(3)
    V0.normal(0, 0.1, (60, f))
    V0 = V0.normal(0, 0.1, (40, f)).astype(np.float64)
    rows = np.array([j._users[u] for u, _, _ in ratings])
    cols = np.array([j._items[i] for _, i, _ in ratings])
    r = np.array([c for _, _, c in ratings])
    for e in range(len(j._users)):
        sel = rows == e
        vc = V0[cols[sel]]
        A = vc.T @ vc + lam * np.eye(f)
        b = vc.T @ r[sel]
        amag = np.abs(vc).T @ np.abs(vc) + lam * np.eye(f)
        bmag = np.abs(vc).T @ np.abs(r[sel])
        cond = np.linalg.cond(A)
        n = sel.sum()
        rel = (np.linalg.norm(reorder_bound(n, amag)) / np.linalg.norm(A)
               + np.linalg.norm(reorder_bound(n, bmag)) / np.linalg.norm(b)
               + 2 * f * EPS)
        x = np.linalg.solve(A, b)
        atol = 2 * cond * rel * np.linalg.norm(x) + 4 * EPS * np.abs(x).max()
        assert np.abs(t.user_factors[e] - j.user_factors[e]).max() <= atol, e


# ---------------------------------------------------------------------
# K13b: KNN nearest (GEMM + knn_topk)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("levels", [2, 5])
def test_knn_indices_equal_jax_with_ties(k, levels):
    rng = np.random.default_rng(k * 10 + levels)
    X = rng.integers(0, levels, (500, 6)).astype(np.float32)
    Q = rng.integers(0, levels, (70, 6)).astype(np.float32)
    got = tm.KNN(k=k, **CPU).fit(X).kneighbors(Q)
    want = jm.KNN(k=k).fit(X).kneighbors(Q)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    d2 = ((Q[:, None].astype(np.int64) - X[None].astype(np.int64)) ** 2).sum(-1)
    assert (np.diff(np.sort(d2, 1)[:, :k + 1], axis=1) == 0).any()   # real ties


def test_knn_topk_plain_is_a_stable_sort():
    qx = torch.tensor([[1.0, 2.0, 2.0, 0.0, 2.0]])
    qn, xn = torch.zeros(1), torch.zeros(5)
    # d2 = -2 qx: [-2, -4, -4, 0, -4] -> indices 1, 2, 4, 0
    assert K.knn_topk(qx, qn, xn, 4).tolist() == [[1, 2, 4, 0]]
    with pytest.raises(ValueError):
        K.knn_topk(qx, qn, xn, 6)


# ---------------------------------------------------------------------
# K13c, K13d: SVM and regression training loops
# ---------------------------------------------------------------------

def _svm_atol(X, iterations, step, lam, w_ref):
    """Pegasos: the step at i is step / (lam (i + 1)); the largest weight
    is the final one's or the first step's, eta_0 max|X|."""
    etas = [step / (lam * (i + 1)) for i in range(iterations)]
    w_max = max(np.abs(w_ref).max(), etas[0] * np.abs(X).max())
    return _gd_atol(X, np.ones(1), iterations, sum(etas), w_max)


@pytest.mark.parametrize("iterations", [1, 50, 300])
def test_svm_training_matches_jax(iterations):
    rng = np.random.default_rng(9)
    X = rng.integers(-4, 5, (600, 7)).astype(np.float32)
    y = np.where(X @ rng.normal(size=7) > 0, 1.0, -1.0)
    t = tm.SVM(iterations=iterations, **CPU).fit(X, y)
    j = jm.SVM(iterations=iterations).fit(X, y)
    atol = _svm_atol(X, iterations, 0.5, 0.01, j.weights)
    np.testing.assert_allclose(t.weights, j.weights, atol=atol)
    assert abs(t.intercept - j.intercept) <= atol


@pytest.mark.parametrize("threshold", [0.0, 1e-3])
def test_regression_training_matches_jax(threshold):
    """With a threshold the loop stops on parameter movement; near the
    threshold float reordering could move the stop by one step, so the
    weights are compared with the tolerance of one more step."""
    rng = np.random.default_rng(10)
    X = rng.normal(0, 3, (700, 5)).astype(np.float32)
    y = X @ rng.normal(size=5) - 2.0 + rng.normal(0, 0.1, 700)
    kw = dict(iterations=200, stepsize=0.5, convergence_threshold=threshold)
    t = tm.MultipleLinearRegression(**kw, **CPU).fit(X, y)
    j = jm.MultipleLinearRegression(**kw).fit(X, y)
    Xs = (X - X.mean(0)) / X.std(0)
    steps = sum(0.5 / np.sqrt(i + 1) for i in range(201))
    atol = _gd_atol(Xs, y - y.mean(), 201, steps,
                    np.abs(j.weights * X.std(0)).max()) + threshold
    np.testing.assert_allclose(t.weights * X.std(0), j.weights * X.std(0), atol=atol)


# ---------------------------------------------------------------------
# params_from_numpy: one fitted state, both packages' host code
# ---------------------------------------------------------------------

def test_params_from_numpy_gives_the_reference_predictions():
    rng = np.random.default_rng(11)
    X = rng.integers(-3, 4, (200, 4)).astype(np.float32)
    y = np.where(X.sum(1) > 0, 1.0, -1.0)
    Q = rng.integers(-3, 4, (30, 4)).astype(np.float32)
    jsvm = jm.SVM(iterations=20).fit(X, y)
    tsvm = params_from_numpy(tm.SVM(**CPU), {"weights": jsvm.weights,
                                             "intercept": jsvm.intercept})
    np.testing.assert_array_equal(tsvm.decision_function(Q), jsvm.decision_function(Q))
    np.testing.assert_array_equal(tsvm.predict(Q), jsvm.predict(Q))
    jmlr = jm.MultipleLinearRegression(iterations=30).fit(X, X @ np.arange(4.0))
    tmlr = params_from_numpy(tm.MultipleLinearRegression(**CPU),
                             {"weights": jmlr.weights, "intercept": jmlr.intercept})
    np.testing.assert_array_equal(tmlr.predict(Q), jmlr.predict(Q))
    jknn = jm.KNN(k=4).fit(X, y)
    tknn = params_from_numpy(tm.KNN(k=4, **CPU), {"_X": jknn._X, "_y": jknn._y})
    np.testing.assert_array_equal(tknn.kneighbors(Q), jknn.kneighbors(Q))
    np.testing.assert_array_equal(tknn.predict(Q), jknn.predict(Q))
    ratings = _ratings(rng, 20, 15, 200)
    jals = jm.ALS(num_factors=3, iterations=2).fit(ratings)
    tals = params_from_numpy(tm.ALS(**CPU), {
        "user_factors": jals.user_factors, "item_factors": jals.item_factors,
        "_users": jals._users, "_items": jals._items})
    pairs = [(u, i) for u, i, _ in ratings] + [(99, 0)]
    np.testing.assert_array_equal(tals.predict(pairs), jals.predict(pairs))
    with pytest.raises(ValueError, match="exactly"):
        params_from_numpy(tm.SVM(**CPU), {"weights": jsvm.weights})
    with pytest.raises(TypeError):
        params_from_numpy(tm.StandardScaler(), {})


# ---------------------------------------------------------------------
# device policy
# ---------------------------------------------------------------------

def test_device_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.eye(4, dtype=np.float32)
    y = np.array([1.0, -1.0, 1.0, -1.0])
    for call in (lambda: tm.SVM().fit(X, y),
                 lambda: tm.MultipleLinearRegression().fit(X, y),
                 lambda: tm.KNN(k=1).fit(X).kneighbors(X),
                 lambda: tm.ALS().fit([(0, 0, 1.0), (1, 1, 2.0)])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    # host-only classes take no device
    for cls in (tm.StandardScaler, tm.MinMaxScaler, tm.PolynomialFeatures, tm.KFold):
        with pytest.raises(TypeError):
            cls(device="cpu")
